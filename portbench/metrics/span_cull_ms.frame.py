"""span_cull_ms.frame: device ms per graph frame in the program's `cull`
spans (the tile cull, `tile_cull_mask_hierarchical`, of the nearest-hit and
the shadow rays), median over the recorded frames of `spans.py`'s stretch.
None where there is no stretch or a stamp was dropped."""

from portbench import spans


def read(ctx):
    return spans.median_ms(spans.sound(ctx, "frame"), "cull")
