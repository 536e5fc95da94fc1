"""sweep_roofline.frame: the least time the frame's counted sweep work
needs (`kernels.least_ms` of the benchmark's own work count, `kernels.py`)
over `sweep_ms.frame`, in %."""

from portbench import harness, kernels


def read(ctx):
    work, peaks = ctx.get("work"), ctx.get("peaks")
    ms = harness.reader("sweep_ms.frame")(ctx)
    if not work or not peaks or not ms:
        return None
    return kernels.least_ms(work, peaks) / ms * 100.0
