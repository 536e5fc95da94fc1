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


# glibc's float tanf as tensor operations: fdlibm's float kernel
# (k_tanf.c) behind a reduction of x - pi/2 in float64 for pi/4 < |x| <
# 3*pi/4, one correctly rounded, unfused operation per C operation in the
# C order, so it returns libm's value bit for bit (checked on the CPU and on
# the card against `_libm_tanf`; fdlibm's all-float reduction misses by an
# ulp near pi/2). It reads nothing back to the host.
def _f32_bits(i: int) -> float:
    return float(np.array([i], np.uint32).view(np.float32)[0])


_T = tuple(float(np.float32(c)) for c in (
    3.3333334327e-01, 1.3333334029e-01, 5.3968254477e-02, 2.1869488060e-02,
    8.8632395491e-03, 3.5920790397e-03, 1.4562094584e-03, 5.8804126456e-04,
    2.4646313977e-04, 7.8179444245e-05, 7.1407252108e-05, -1.8558637748e-05,
    2.5907305826e-05))
_PIO4, _PIO4LO = _f32_bits(0x3f490fda), _f32_bits(0x33222168)
_PIO2_HI, _PIO2_LO = math.pi / 2, 6.123233995736766e-17  # pi/2 = HI + LO


def _low_bits_cleared(x):
    """x with the low 12 bits of its float32 word cleared."""
    return (x.view(torch.int32) & -4096).view(torch.float32)


def _kernel_tanf(x, y, iy: int):
    """__kernel_tanf(x, y, iy): tan(x + y) (iy = 1, |x| >= 2**-13) or
    -1/tan(x + y) (iy = -1)."""
    hx = x.view(torch.int32)
    big = (hx & 0x7fffffff) >= 0x3f2ca140  # |x| >= 0.6744
    sign = torch.where(hx < 0, -1.0, 1.0)
    xa, ya = torch.where(hx < 0, -x, x), torch.where(hx < 0, -y, y)
    xb = (_PIO4 - xa) + (_PIO4LO - ya)
    x = torch.where(big, xb, x)
    y = torch.where(big, 0.0, y)
    z = x * x
    w = z * z
    r = _T[1] + w * (_T[3] + w * (_T[5] + w * (_T[7] + w * (_T[9] + w * _T[11]))))
    v = z * (_T[2] + w * (_T[4] + w * (_T[6] + w * (_T[8] + w * (_T[10] + w * _T[12])))))
    s = z * x
    r = y + z * (s * (r + v) + y)
    r = r + _T[0] * s
    w = x + r
    v = torch.full_like(x, float(iy))
    out_big = sign * (v - 2.0 * (x - (w * w / (w + v) - r)))
    # |pi/4 - x| under 2**-13: the kernel's own short form
    out_near = (sign * iy) * (1.0 - (2 * iy) * x)
    out_big = torch.where(x.abs() < 2.0 ** -13, out_near, out_big)
    if iy == 1:
        out = w
    else:  # -1/(x + r), computed accurately
        z = _low_bits_cleared(w)
        v = r - (z - x)
        a = -(torch.ones_like(w) / w)
        t = _low_bits_cleared(a)
        s = 1.0 + t * z
        out = t + a * (s + t * v)
    out = torch.where(big, out_big, out)
    if iy == -1:  # |x| < 2**-13
        out = torch.where((hx & 0x7fffffff) < 0x39000000,
                          -(torch.ones_like(x) / x), out)
    return out


def tanf(x):
    """libm's float32 `tanf` of a float32 tensor, bit for bit, on any
    device, for |x| in [2**-13, 3*pi/4) (an image-plane half-angle
    fov*pi/360 with fov in (0.015, 270) degrees); NaN outside that range."""
    bits = x.abs().view(torch.int32)
    # |x| <= pi/4: the kernel directly
    near = _kernel_tanf(x, torch.zeros_like(x), 1)
    # pi/4 < |x| < 3*pi/4: -1/tan(x - sign(x) pi/2), the difference taken in
    # float64 and split into two floats
    d = x.double()
    d = torch.where(x < 0, (d + _PIO2_HI) + _PIO2_LO, (d - _PIO2_HI) - _PIO2_LO)
    y0 = d.float()
    y1 = (d - y0.double()).float()
    out = torch.where(bits <= 0x3f490fda, near, _kernel_tanf(y0, y1, -1))
    ok = (bits >= 0x39000000) & (bits < 0x4016cbe4)
    return torch.where(ok, out, float("nan"))


class _Tanf(torch.autograd.Function):
    """tan of a () float32 tensor with libm's value (`tanf`, on the
    tensor's device) and the derivative 1 + tan^2."""

    @staticmethod
    def forward(ctx, x):
        t = tanf(x)
        ctx.save_for_backward(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        (t,) = ctx.saved_tensors
        return grad * (1.0 + t * t)


def _camera_basis_host(camera: Camera):
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


def camera_basis_on_device(camera: Camera):
    """`camera_basis` as tensor ops on the camera's device whether or not a
    camera tensor requires grad (then recorded by autograd): the same
    values, and nothing read back to the host (what a captured training
    step computes)."""

    def norm(a):
        sq = a * a
        return a / sqrt_rn((sq[0] + sq[1]) + sq[2])

    u = norm(camera.u)
    v = norm(camera.v)
    w = torch.stack([u[1] * v[2] - u[2] * v[1],
                     u[2] * v[0] - u[0] * v[2],
                     u[0] * v[1] - u[1] * v[0]])
    tan = _Tanf.apply(camera.fov * float(np.float32(math.pi / 360.0)))
    # a tensor numerator: float / tensor is reciprocal-then-multiply in torch;
    # filled on the device (a tensor made from Python data is a host copy)
    L = torch.full_like(tan, float(camera.width)) / (2.0 * tan)
    return u, v, camera.position + w * L


def camera_basis(camera: Camera):
    """(u, v, C), each a (3,) float32 tensor on the camera's device, in
    float32 like vector3_normalize and the plane centre of
    cpu/raytracer.c:82-86.

    Where no camera tensor requires grad (every plain render) the basis is
    computed on the host in numpy. Where one does, and grad is enabled, the
    same operations run as tensor ops, so u, v and C carry gradient to
    `position`, `u`, `v` and `fov`; the tangent keeps libm's value (`tanf`,
    on the device) and gets its derivative 1 + tan^2 from `_Tanf`. Every
    operation of either path is a correctly rounded float32 operation in
    the same order, so the two bases differ by 0 ulp (held by a test on the
    CPU)."""
    traced = torch.is_grad_enabled() and any(
        t.requires_grad for t in (camera.position, camera.u, camera.v, camera.fov))
    return camera_basis_on_device(camera) if traced else _camera_basis_host(camera)


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
