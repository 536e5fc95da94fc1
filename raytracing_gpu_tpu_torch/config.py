"""Runtime configuration of the PyTorch port.

Same fields and validation as `raytracing_gpu_tpu.config.RenderConfig`, so a
config reads the same in both packages. Only the intersection backends
differ: "torch" is the all-pairs Möller–Trumbore path in plain tensor ops
(the counterpart of the JAX package's "jnp"), "cuda" is the clustered,
tile-culled path through the hand-written kernels of `ops/cuda_intersect.py`
(the counterpart of "pallas"). On CPU tensors the "cuda" backend runs each
kernel's plain PyTorch version, so its packing, culling and worklist logic is
testable without a card.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All runtime knobs for a render (see the JAX package's RenderConfig for
    each field's meaning and reference citation).

    The port renders `mode="cpu"` only; `mode="gpu"` is accepted here and
    rejected by the renderer until GPU mode is ported. `unroll` and `remat`
    belong to the differentiable path, which is not ported yet: the port's
    bounce loop is an eager Python loop that exits once every ray is dead, so
    they are validated and otherwise ignored. `f2b_tiles > 0` (the two-round
    front-to-back sweep) is rejected by the renderer until it is ported.
    `ray_chunk` keeps the JAX package's default; it has not been tuned on the
    GPU yet.
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

    def __post_init__(self):
        if self.mode not in ("cpu", "gpu"):
            raise ValueError(f"mode must be 'cpu' or 'gpu', got {self.mode!r}")
        if self.quantize not in ("match", "smooth"):
            raise ValueError(f"quantize must be 'match' or 'smooth', got {self.quantize!r}")
        if self.partitioning not in ("none", "aabb", "octree"):
            raise ValueError(f"bad partitioning {self.partitioning!r}")
        if self.backend not in ("torch", "cuda"):
            raise ValueError(f"bad backend {self.backend!r}")
        if self.unroll not in ("auto", "while", "static"):
            raise ValueError(f"bad unroll {self.unroll!r}")
        if self.block_rays not in ("auto", "on", "off"):
            raise ValueError(f"bad block_rays {self.block_rays!r}")
        if self.f2b_tiles < 0:
            raise ValueError(f"f2b_tiles must be >= 0, got {self.f2b_tiles}")
