"""step_ms: the window's wall seconds over the training steps completed in
it (host clock; a step ends with torch.cuda.synchronize())."""


def read(ctx):
    w = ctx.get("window")
    if not w or w["unit"] != "step" or not w["items"]:
        return None
    return w["seconds"] / w["items"] * 1e3
