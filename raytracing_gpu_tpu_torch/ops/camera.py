"""Primary-ray generation (the camera model of both reference pipelines).

The JAX package's `ops/camera.py` (camera_basis, cpu_subpixel_coords_traced,
gpu_pixel_coords_traced, make_rays), with every 3-term sum written out
left-associated so the rays
are bit-identical to the JAX package's eager functions: image-plane centre
C = position + w*L with L = width / (2 tan(fov*pi/360)); plane point
C + u*k + v*l; direction normalize(position - point), the reference's
camera-facing quirk (cpu/raytracer.c:59-62, 82-86).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np
import torch

from raytracing_gpu_tpu_torch.models.scene import Camera
from raytracing_gpu_tpu_torch.ops.fp import sqrt_rn


@functools.cache
def _libm_tanf():
    # The JAX package's f32 tan lowers to libm's tanf on the host (checked
    # bit-exact on 20,001 fov values); numpy's and torch's f32 tan differ
    # from it by an ulp on ~4% of angles, which would move every ray.
    fn = ctypes.CDLL(ctypes.util.find_library("m")).tanf
    fn.argtypes = [ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def camera_basis(camera: Camera):
    """(u, v, C), each a (3,) float32 tensor on the camera's device.

    Computed on the host in float32, like vector3_normalize and the plane
    centre of cpu/raytracer.c:82-86.
    """
    f32 = np.float32
    u_raw = camera.u.detach().cpu().numpy().astype(f32)
    v_raw = camera.v.detach().cpu().numpy().astype(f32)
    pos = camera.position.detach().cpu().numpy().astype(f32)
    fov = f32(camera.fov.detach().cpu().item())

    def norm(a):
        sq = a * a
        return a / np.sqrt((sq[0] + sq[1]) + sq[2])

    u = norm(u_raw)
    v = norm(v_raw)
    w = np.array([u[1] * v[2] - u[2] * v[1],
                  u[2] * v[0] - u[0] * v[2],
                  u[0] * v[1] - u[1] * v[0]], f32)
    tan = f32(_libm_tanf()(float(fov * f32(math.pi / 360.0))))
    L = f32(camera.width) / (f32(2.0) * tan)
    C = pos + w * L
    dev = camera.position.device
    return tuple(torch.from_numpy(np.ascontiguousarray(a, f32)).to(dev)
                 for a in (u, v, C))


def cpu_subpixel_coords_traced(width: int, height: int, ray_ids):
    """(R,2) float32 plane coords (k, l) for flat ray ids.

    Ray id r = ((p*width) + q)*4 + s: p the printed row, q the printed
    column, s the subsample in the reference's order [(0,0), (0,.5), (.5,0),
    (.5,.5)] (cpu/raytracer.c:55-68).
    """
    pix = ray_ids // 4
    s = ray_ids % 4
    q = pix % width
    p = pix // width
    halfw, halfh = width // 2, height // 2
    k = (width - halfw - q).to(torch.float32) + 0.5 * (s // 2).to(torch.float32)
    l = (height - halfh - p).to(torch.float32) + 0.5 * (s % 2).to(torch.float32)
    return torch.stack([k, l], dim=1)


def gpu_pixel_coords_traced(width: int, height: int, ray_ids):
    """(R,2) float32 plane coords (k, l) for flat hi-res ray ids
    r = py*width + px of the GPU-mode pipeline: kernel thread (px, py) uses
    offsets (px - width/2, py - height/2) (gpu/raytracer.cu:95-128)."""
    px = ray_ids % width
    py = ray_ids // width
    k = (px - width // 2).to(torch.float32)
    l = (py - height // 2).to(torch.float32)
    return torch.stack([k, l], dim=1)


def make_rays(u, v, C, position, coords):
    """(...,2) (k,l) coords -> origins (...,3), directions (...,3):
    point = C + u*k + v*l, direction = normalize(position - point)."""
    k = coords[..., 0:1]
    l = coords[..., 1:2]
    point = (C + u * k) + v * l
    d = position - point
    sq = d * d
    n2 = (sq[..., 0:1] + sq[..., 1:2]) + sq[..., 2:3]
    return point, d / sqrt_rn(n2)
