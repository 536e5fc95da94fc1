"""live_ray_pct.train: 100 x the program's `live_rays` counter over its
`ray_slots` counter over the recorded steps of `spans.py`'s stretch, the
captured step's dead fixed-depth bounce steps included. None where there is
no stretch or a stamp was dropped."""

from portbench import spans


def read(ctx):
    return spans.live_ray_pct(spans.sound(ctx, "step"))
