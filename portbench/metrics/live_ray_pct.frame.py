"""live_ray_pct.frame: 100 x the program's `live_rays` counter over its
`ray_slots` counter over the recorded frames of `spans.py`'s stretch: the
share of the ray slots of each bounce step (a whole chunk) that the step
traces. None where there is no stretch or a stamp was dropped."""

from portbench import spans


def read(ctx):
    return spans.live_ray_pct(spans.sound(ctx, "frame"))
