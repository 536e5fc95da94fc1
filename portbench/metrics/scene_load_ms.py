"""scene_load_ms: host clock around the program's `parse_scene` of the
cell's `.svati` file (native parser)."""


def read(ctx):
    return ctx["counters"].get("scene_load_ms")
