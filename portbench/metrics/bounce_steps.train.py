"""bounce_steps.train: K1 launches in one captured training step
(`StepPlan.graph_launches["nearest_hit"]`): chunks x fixed depth, dead
bounce steps included."""


def read(ctx):
    if ctx.get("window", {}).get("unit") != "step":
        return None
    return ctx["counters"].get("k1_per_step")
