"""Color algebra in the reference's two quantization regimes.

`match`: floats in [0,255] clamped at every operation in cpu/colors.c's
arithmetic order, so renders truncate to the oracle's uint8 values.
`smooth`: linear floats, clamped once at the end. Same functions as the JAX
package's `ops/colors.py`; colors are (...,3) float32 tensors.
"""

from __future__ import annotations

import torch


def m_init(c):
    """init_color (cpu/colors.c:3-22): clamp(c*255, 0, 255)."""
    return torch.clamp(c * 255.0, 0.0, 255.0)


def m_add(a, b):
    """color_add (cpu/colors.c:24-36): a+b, upper clamp only."""
    return torch.clamp(a + b, max=255.0)


def m_mul(a, coef):
    """color_mul (cpu/colors.c:38-41): init_color(a/255*coef)."""
    return m_init((a / 255.0) * coef)


def m_mul2(a, b):
    """color_mul2 (cpu/colors.c:43-49): init_color((a/255)*(b/255))."""
    return m_init((a / 255.0) * (b / 255.0))


def s_init(c):
    return c


def s_add(a, b):
    return a + b


def s_mul(a, coef):
    return a * coef


def s_mul2(a, b):
    return a * b


class ColorOps:
    """Dispatch table selected by RenderConfig.quantize."""

    def __init__(self, quantize: str):
        if quantize == "match":
            self.init, self.add, self.mul, self.mul2 = m_init, m_add, m_mul, m_mul2
        elif quantize == "smooth":
            self.init, self.add, self.mul, self.mul2 = s_init, s_add, s_mul, s_mul2
        else:
            raise ValueError(quantize)
        self.quantize = quantize

    def zeros(self, shape, device=None):
        return torch.zeros(tuple(shape) + (3,), dtype=torch.float32, device=device)

    def finalize(self, c):
        """Accumulated color -> the [0,255] float image domain."""
        if self.quantize == "match":
            return c
        return torch.clamp(c, 0.0, 1.0) * 255.0
