"""sweep_group_pct.frame: 100 x the program's `sweep_groups_scanned` counter
over the groups of its `sweep_units_scanned` scans (UNIT_T / GROUP_T, 8, a
scan) over the recorded frames of `spans.py`'s stretch: of the 8-triangle
groups of the (warp, 64-triangle unit) scans that the nearest-hit and shadow
sweeps make, the share whose triangles they test because some ray of the
warp enters the group's box (or starts beyond the unit's reach). None where
there is no stretch, a stamp was dropped, or the program does not count its
groups."""

from portbench import spans


def read(ctx):
    stretch = spans.sound(ctx, "frame")
    if stretch is None or "sweep_groups_scanned" not in stretch["counters"] \
            or not stretch["counters"].get("sweep_units_scanned"):
        return None
    from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck

    c = stretch["counters"]
    groups = c["sweep_units_scanned"] * (ck.UNIT_T // ck.GROUP_T)
    return 100.0 * c["sweep_groups_scanned"] / groups
