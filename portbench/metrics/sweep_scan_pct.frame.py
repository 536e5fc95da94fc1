"""sweep_scan_pct.frame: 100 x the program's `sweep_units_scanned` counter
over its `sweep_units` counter over the recorded frames of `spans.py`'s
stretch: of the (warp, 64-triangle unit) scans that the nearest-hit and
shadow sweeps are offered by the kept pair tiles, the share they make
because some ray of the warp enters the unit's box. None where there is no
stretch, a stamp was dropped, or the program does not count its units."""

from portbench import spans


def read(ctx):
    stretch = spans.sound(ctx, "frame")
    if stretch is None or not stretch["counters"].get("sweep_units"):
        return None
    c = stretch["counters"]
    return 100.0 * c["sweep_units_scanned"] / c["sweep_units"]
