"""sweep_ms.frame: device ms per frame of the intersection kernels (K1, K2,
K4, K5, K6 with their listing kernels, and K3's fetch), from the traced
eager frame of the cell's configuration (unroll="static"): the profiler
records none of the kernels inside the frame graph's WHILE bodies, and the
eager frame launches the same kernels one by one. Left out unless its
launch counters equal the graph frame's and the profile names as many
sweeps and fetches as they count."""

from portbench import kernels


def read(ctx):
    prof, graph, eager = ctx.get("profile"), ctx.get("launches"), ctx.get("profile_launches")
    if ctx.get("window", {}).get("unit") != "frame" or not prof or not graph or not eager:
        return None
    counted = kernels.port_launches(graph)
    named = (kernels.device_ms(prof, lambda n: "sweep_kernel<" in n)[1],
             kernels.device_ms(prof, kernels.is_fetch)[1])
    if kernels.port_launches(eager) != counted or named != counted:
        return None
    return kernels.device_ms(prof, lambda n: kernels.is_sweep(n) or kernels.is_fetch(n))[0]
