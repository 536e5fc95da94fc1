"""The yardstick's kernel arithmetic: which device operations are the
intersection kernels, and the least time the counted work needs.

The program's sweeps (K1, K2, K4, K5, K6) are each a `sweep_list_kernel`
launch and a `sweep_kernel<KIND>` launch; K3 is `fetch_rows_kernel<...>`;
K3's backward is torch's `index_add_`, whose CUDA kernels are named
`indexFunc...Index`.

Work rule (`reference.Tracer.count_pairs`, the benchmark's own count from
the cell's inputs): over every ray of every bounce that the plain reference
traces, the (ray, triangle) pairs whose triangle's own axis-aligned box the
ray's segment enters at or before the ray's nearest hit (a shadow ray: its
nearest occluder, or the light). Any box-based cull or traversal has to
test at least these pairs, so whatever implements the sweeps, the share
cannot pass 100%. Each pair is 60 float32 operations (Moller-Trumbore with
the reference's distance); each traced ray's origin and direction are read
once and its 8-byte result written once, each nearest-hit ray's 128-byte
winner row read and written once, each triangle's 36 bytes read once.
"""

SWEEP = ("sweep_kernel<", "sweep_list_kernel")
# the program's launch counters (`ops.cuda_intersect.LAUNCHES`) of the sweeps
SWEEP_COUNTERS = ("nearest_hit", "nearest_dist", "any_hit", "nearest_hit_matmul",
                  "nearest_dist_matmul")
FETCH = ("fetch_rows_kernel",)
FETCH_BACKWARD = ("indexFunc",)
OPS_PER_PAIR = 60


def is_sweep(name: str) -> bool:
    return any(s in name for s in SWEEP)


def is_fetch(name: str) -> bool:
    return any(s in name for s in FETCH)


def port_launches(launches: dict) -> tuple:
    """(sweep launches, fetch launches) in a dict of launch-counter
    deltas."""
    return (sum(launches.get(k, 0) for k in SWEEP_COUNTERS), launches.get("fetch_rows", 0))


def least_ms(work: dict, peaks: dict) -> float:
    """Least milliseconds the counted work needs on the card: the larger of
    operations over the float32 peak and bytes over the memory bandwidth."""
    ops = OPS_PER_PAIR * work["pairs"]
    nbytes = 32 * work["rays"] + 256 * work["nearest_rays"] + 36 * work["triangles"]
    return max(ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"]) * 1e3


def device_ms(profile: dict, keep) -> tuple:
    """(ms per item of the profile's device ops whose name `keep` accepts,
    their count per item)."""
    ops = [(n, d) for n, _, d in profile["ops"] if keep(n)]
    return sum(d for _, d in ops) * 1e-6 / profile["items"], len(ops) / profile["items"]
