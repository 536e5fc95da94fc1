"""sweep_ms.train: device ms per captured training step of K1, K2 (with
their listing kernels), K3's fetch and K3's backward (`index_add_`), from
the traced steps (the step graph has no WHILE node: the profiler names its
kernels)."""

from portbench import kernels


def read(ctx):
    prof = ctx.get("profile")
    if ctx.get("window", {}).get("unit") != "step" or not prof or not prof["ops"]:
        return None
    keep = lambda n: (kernels.is_sweep(n) or kernels.is_fetch(n)  # noqa: E731
                      or any(s in n for s in kernels.FETCH_BACKWARD))
    ms, n = kernels.device_ms(prof, keep)
    return ms if n else None
