"""Compute ops: colors, camera rays, intersection (torch and CUDA kernel
paths), shading."""
