"""Runtime configuration of the PyTorch port.

Same fields and validation as `raytracing_gpu_tpu.config.RenderConfig`, so a
config reads the same in both packages, plus `any_hit_min_tris` (a module
constant there). Only the intersection backends differ: "torch" is the
all-pairs Möller–Trumbore path in plain tensor ops (the counterpart of the
JAX package's "jnp"), "cuda" is the clustered, tile-culled path through the
hand-written kernels of `ops/cuda_intersect.py` (the counterpart of
"pallas"), and "cuda_matmul" is the same path with the sweeps in matmul
form (the counterpart of "mxu"). On CPU tensors the kernel backends run each
kernel's plain PyTorch version, so their packing, culling and worklist logic
is testable without a card.
"""

from __future__ import annotations

import dataclasses

# `any_hit_min_tris` value no scene reaches: the any-hit shadow sweep is off
ANY_HIT_OFF = 1 << 30


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All runtime knobs for a render (see the JAX package's RenderConfig for
    each field's meaning and reference citation).

    `mode` picks the reference pipeline: "cpu" (2x2 supersampling, recursive
    mirrors to `cpu_max_depth`) or "gpu" (one ray per pixel of an
    `aliasing`-times larger image, the do/while bounce loop capped at
    `max_bounce`, box downscale). `backend` is "torch", "cuda" or
    "cuda_matmul" (the JAX package's "jnp", "pallas" and "mxu"; other names
    are rejected). `f2b_tiles = K > 0` makes backend "cuda" sweep each ray
    tile's K nearest triangle tiles first and the rest only where a hit so
    far cannot rule them out (same image; 0 is off, and no environment
    variable is read). `any_hit_min_tris` is the padded triangle count from
    which backend "cuda" answers shadow rays with the any-hit sweep instead
    of the distance sweep (same image; the default keeps it off, 0 forces
    it). `unroll` and `remat` belong to the differentiable path, which is
    not ported yet: the port's bounce loops are eager Python loops that exit
    once every ray is dead, so both are validated and otherwise ignored.
    `ray_chunk` keeps the JAX package's default; it has not been tuned on
    the GPU yet.
    """

    mode: str = "cpu"
    quantize: str = "match"
    partitioning: str = "octree"
    backend: str = "cuda"
    max_bounce: int = 10
    cpu_max_depth: int = 64
    diff_max_depth: int = 6
    reflect_cutoff: float = 0.01
    self_hit_eps: float = 0.01
    mt_eps: float = 1e-7
    aliasing: int = 3
    ray_chunk: int = 65536
    pad_triangles: int = 128
    pad_objects: int = 8
    unroll: str = "auto"
    remat: bool = True
    block_rays: str = "auto"
    f2b_tiles: int = 0
    any_hit_min_tris: int = ANY_HIT_OFF

    def __post_init__(self):
        if self.mode not in ("cpu", "gpu"):
            raise ValueError(f"mode must be 'cpu' or 'gpu', got {self.mode!r}")
        if self.quantize not in ("match", "smooth"):
            raise ValueError(f"quantize must be 'match' or 'smooth', got {self.quantize!r}")
        if self.partitioning not in ("none", "aabb", "octree"):
            raise ValueError(f"bad partitioning {self.partitioning!r}")
        if self.backend not in ("torch", "cuda", "cuda_matmul"):
            raise ValueError(f"bad backend {self.backend!r}")
        if self.unroll not in ("auto", "while", "static"):
            raise ValueError(f"bad unroll {self.unroll!r}")
        if self.block_rays not in ("auto", "on", "off"):
            raise ValueError(f"bad block_rays {self.block_rays!r}")
        if self.f2b_tiles < 0:
            raise ValueError(f"f2b_tiles must be >= 0, got {self.f2b_tiles}")
        if self.any_hit_min_tris < 0:
            raise ValueError("any_hit_min_tris must be >= 0, got "
                             f"{self.any_hit_min_tris}")
