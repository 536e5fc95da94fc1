"""kernels_per_frame: the kernels (not memory copies or sets) that the
profiler records in the traced eager frame of the cell's configuration
(unroll="static"), whose launches of the port's kernels equal the graph
frame's: the profiler records none of the kernels inside the frame graph's
WHILE bodies."""

from portbench import kernels


def read(ctx):
    p, graph, eager = ctx.get("profile"), ctx.get("launches"), ctx.get("profile_launches")
    if ctx.get("window", {}).get("unit") != "frame" or not p or not p["kernels"]:
        return None
    if not graph or not eager or kernels.port_launches(graph) != kernels.port_launches(eager):
        return None
    return p["kernels"] / p["items"]
