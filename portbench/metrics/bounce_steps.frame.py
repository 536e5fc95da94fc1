"""bounce_steps.frame: bounce steps a graph frame runs, summed over its
chunks, as the frame plan's condition kernels count them on the card
(`FramePlan.last_frame.steps`); the mean over the window's frames."""


def read(ctx):
    if ctx.get("window", {}).get("unit") != "frame":
        return None
    return ctx["counters"].get("steps_per_frame")
