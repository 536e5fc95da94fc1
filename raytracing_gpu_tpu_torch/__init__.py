"""raytracing_gpu_tpu_torch — the PyTorch + CUDA port of raytracing_gpu_tpu.

Renders `.svati` scenes through the reference's CPU-mode pipeline (2x2
supersampling, recursive mirrors) or its GPU-mode pipeline (aliasing-x
supersampling, capped bounce loop, box downscale), in `match` or `smooth`
quantization, on an
NVIDIA GPU, with the intersection hot path in hand-written CUDA kernels
(`ops/cuda_intersect.py`, `csrc/intersect.cu`). The JAX package
`raytracing_gpu_tpu` is the reference it is tested against; this package
imports only torch and numpy.
"""

from raytracing_gpu_tpu_torch.config import RenderConfig
from raytracing_gpu_tpu_torch.models.parser import parse_scene, parse_scene_text
from raytracing_gpu_tpu_torch.models.scene import (
    Camera,
    Geometry,
    Lights,
    Materials,
    Scene,
    scene_from_numpy,
)
from raytracing_gpu_tpu_torch.render import SceneRenderer, render_scene

__all__ = [
    "RenderConfig",
    "Scene",
    "Camera",
    "Lights",
    "Geometry",
    "Materials",
    "scene_from_numpy",
    "parse_scene",
    "parse_scene_text",
    "render_scene",
    "SceneRenderer",
]
