"""capture_ms.train: the step plan's `capture_ms` (the eager warm-up step
and the capture of the step graph; host clock)."""


def read(ctx):
    if ctx.get("window", {}).get("unit") != "step":
        return None
    return ctx["counters"].get("capture_ms")
