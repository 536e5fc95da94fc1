"""frame_ms: the window's wall seconds over the frames completed in it
(host clock; a frame ends with its uint8 image on the host)."""


def read(ctx):
    w = ctx.get("window")
    if not w or w["unit"] != "frame" or not w["items"]:
        return None
    return w["seconds"] / w["items"] * 1e3
