"""span_shade_ms.frame: device ms per graph frame of the program's `shade`
spans less the spans inside them (`shadow`): the light math and its
`ColorOps` chains, median over the recorded frames of `spans.py`'s
stretch. None where there is no stretch or a stamp was dropped."""

from portbench import spans


def read(ctx):
    return spans.median_ms(spans.sound(ctx, "frame"), "shade", self_time=True)
