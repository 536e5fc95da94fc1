"""Scene model: tensor dataclasses, the .svati parser, procedural scenes."""
