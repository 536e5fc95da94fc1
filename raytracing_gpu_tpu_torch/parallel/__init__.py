"""Sharding and training (the JAX package's `parallel/`): the rank mesh,
the sharded render, the multi-process wrappers, the train step and its
checkpoints.

Two mesh axes, as in the JAX package:

- ``tiles``: data parallelism over rays. The forward pass needs no
  collective on it but the final gather of the image; training sums the
  loss and the gradients over it once per step.
- ``scene``: the triangles are split over its ranks in contiguous ranges;
  nearest hits combine with an `all_gather` and a first-occurrence minimum
  over the shards, shadow tests with a MIN (or, through the any-hit sweep,
  an OR) in every bounce.

One process drives one device (`torchrun`, `multihost.initialize`); every
rank runs the same Python (`parallel/collectives.py`).
"""

from raytracing_gpu_tpu_torch.parallel import multihost
from raytracing_gpu_tpu_torch.parallel.mesh import default_mesh, make_mesh
from raytracing_gpu_tpu_torch.parallel.render import (
    make_sharded_renderer,
    render_scene_sharded,
)
from raytracing_gpu_tpu_torch.parallel.train import (
    PARAM_SPECS,
    TrainState,
    extract_params,
    init_train_state,
    insert_params,
    make_train_step,
    predict_pixels,
)

__all__ = [
    "make_mesh",
    "default_mesh",
    "render_scene_sharded",
    "make_sharded_renderer",
    "multihost",
    "PARAM_SPECS",
    "TrainState",
    "extract_params",
    "insert_params",
    "make_train_step",
    "init_train_state",
    "predict_pixels",
]
