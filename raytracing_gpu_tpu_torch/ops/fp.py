"""Float32 helpers that keep the port's arithmetic IEEE round-to-nearest.

The port matches the JAX package (and its CUDA kernels match their plain
versions) bit for bit only if every float32 operation is correctly rounded.
PyTorch's CPU multiply, add, divide and reciprocal are; its CPU float32
sqrt is not (about 0.7% of random inputs land one ulp off). The square root
of the float64 value rounded to float32 is the correctly rounded float32
square root (float64 carries more than 2*24+2 bits), on every device.
"""

from __future__ import annotations

import numpy as np
import torch


def f32(x: float) -> float:
    """x rounded to float32, as a Python float: comparing a float32 tensor
    with it gives the same answer in float32 or float64."""
    return float(np.float32(x))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).to(x.dtype)
