"""step_idle_pct.train: 100 x (the host wall time of the recorded steps of
`spans.py`'s stretch, each ending in a sync, minus the union of the
program's `step` device spans) / that wall time, with no profiler running.
None where there is no stretch or a stamp was dropped."""

from portbench import spans


def read(ctx):
    return spans.step_idle_pct(spans.sound(ctx, "step"))
