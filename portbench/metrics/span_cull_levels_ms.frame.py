"""span_cull_levels_ms.frame: device ms per graph frame in the program's
`levels` spans (inside `cull`: the hierarchical tile cull's union boxes
built from the leaf tiles, and the interval slab tests of the levels below
the top one), median over the recorded frames of `spans.py`'s stretch.
None where there is no stretch, a stamp was dropped, or no `levels` span was
recorded (a scene of at most 64 triangle tiles takes the flat cull)."""

from portbench import spans


def read(ctx):
    stretch = spans.sound(ctx, "frame")
    if stretch is None or not any(s.name == "levels" for s in stretch["device"]):
        return None
    return spans.median_ms(stretch, "levels")
