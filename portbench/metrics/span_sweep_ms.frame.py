"""span_sweep_ms.frame: device ms per graph frame in the program's `sweep`
spans (the listing and sweep kernels K1, K2, K4-K6 and K3's fetch of the
winners' rows), median over the recorded frames of `spans.py`'s stretch:
the graph frame's own counterpart of the eager stand-in `sweep_ms.frame`.
None where there is no stretch or a stamp was dropped."""

from portbench import spans


def read(ctx):
    return spans.median_ms(spans.sound(ctx, "frame"), "sweep")
