"""capture_ms.frame: the frame plan's `capture_ms` (warm-up, capture of the
three pieces and their assembly into the frame graph; host clock)."""


def read(ctx):
    if ctx.get("window", {}).get("unit") != "frame":
        return None
    return ctx["counters"].get("capture_ms")
