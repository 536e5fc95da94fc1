"""Host utilities: image output."""
