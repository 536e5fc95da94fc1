"""Training on the differentiable render (the JAX package's `parallel/`,
single device so far): the train step and its checkpoints. The mesh, the
sharded render and the multi-host wrappers are not ported yet."""

from raytracing_gpu_tpu_torch.parallel.train import (
    TrainState,
    extract_params,
    init_train_state,
    insert_params,
    make_train_step,
    predict_pixels,
)

__all__ = [
    "TrainState",
    "extract_params",
    "insert_params",
    "make_train_step",
    "init_train_state",
    "predict_pixels",
]
