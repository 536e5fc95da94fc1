"""tile_keep_pct.frame: 100 x the program's `tile_pairs_kept` counter over
its `tile_pairs` counter over the recorded frames of `spans.py`'s stretch:
the share of the (triangle tile, ray tile) pairs that the tile cull keeps
for the sweeps, nearest-hit and shadow rays together. None where there is
no stretch, a stamp was dropped, or the counters were not recorded."""

from portbench import spans


def read(ctx):
    stretch = spans.sound(ctx, "frame")
    if stretch is None or not stretch["counters"].get("tile_pairs"):
        return None
    c = stretch["counters"]
    return 100.0 * c["tile_pairs_kept"] / c["tile_pairs"]
