"""The plain reference: the reference renderer's semantics in plain PyTorch.

It imports torch and numpy only (nothing of the program, nor of the JAX
package) and reads the benchmark's own `scenes.SceneArrays`, never what the
program parsed or packed. What it follows, from the reference C sources
(blink97/raytracing-gpu `cpu/` and `gpu/`):

- camera (cpu/raytracer.c:55-86): u, v normalised, w = u x v, image-plane
  centre C = position + w * L with L = width / (2 tanf(fov * pi / 360)),
  libm's float `tanf`; plane point (C + u*k) + v*l; direction
  normalize(position - point). GPU mode uses the hi-res width.
- nearest hit (cpu/hit.c:4-91): Moller-Trumbore on every triangle in file
  order, the reference's distance |fl(o + nd*(t*|d|)) - o| > self_hit_eps,
  the nearest kept, the lowest triangle index on a tie; u, v, t recomputed
  on the winner; the normal interpolated from per-vertex normalised normals
  and never renormalised; a zero normal is a miss. Brute force, with no
  object-level cull that could drop a hit: each object's box is padded by
  1e-3 of its diagonal before rays are tested against it, so a hit on the
  box itself is never culled (the JAX package's unpadded slab cull drops a
  hit lying exactly on its object's box).
- shading (cpu/light.c:7-99): ambient rgb*ka; directional L = -v; point
  L = -position with N flipped toward it and a 1/|v - hit| falloff; any
  hit on the shadow ray occludes (t*|d| > self_hit_eps, to infinity);
  specular from an incident origin hit - 10*dir with the unflipped normal;
  contributions summed in declaration order.
- CPU mode (cpu/raytracer.c:19-68): 2x2 subsamples, colour += shade*coef
  while coef >= 0.01, coef *= nr, mirror rays from the unnormalised normal,
  the 0.25-weighted fold. GPU mode (gpu/raytracer.cu:49-128): one ray per
  hi-res pixel, a first unconditional bounce, nr_acc > 0.01 and at most
  max_bounce + 1 bounces, the uint8 box downscale flipped on both axes.
- "match" clamps at every colour operation (cpu/colors.c); "smooth" is
  linear (the training loss's domain).

Rounding hazards that the comparison depends on, all kept here: every
float32 operation is its own correctly rounded torch operation (no fused
multiply-add), sums of three terms are left-associated, square roots are
taken in float64 and rounded (`sqrt_rn`: torch's CPU float32 sqrt is not
correctly rounded), `tanf` is libm's, and a division by a Python number is
written as the program writes it (on the card torch multiplies by the
reciprocal there).

`q` is a rounding applied to every stored intermediate: the identity for
the reference, `round_tf32` for the control (the reference computed in
TF32, the precision below the configuration's float32).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math

import numpy as np
import torch

INF = float("inf")
PARKED = 3e29  # origin of a ray that no longer traces
BOX_PAD = 1e-3  # object boxes padded by this share of their diagonal
CUTOFF = 0.01
MT_EPS = 1e-7
SELF_HIT_EPS = 0.01


def f32(x) -> float:
    return float(np.float32(x))


def sqrt_rn(x):
    return torch.sqrt(x.double()).to(x.dtype)


def identity(x):
    return x


def round_tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), nearest even; the
    gradient passes through as if unrounded."""
    if not torch.is_floating_point(x) or x.dtype != torch.float32:
        return x
    u = x.detach().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    r = torch.where(r >= (1 << 31), r - (1 << 32), r)
    r = r.to(torch.int32).view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


@functools.cache
def _libm_tanf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).tanf
    fn.argtypes = [ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


@dataclasses.dataclass
class RefScene:
    """The scene as the reference reads it, on one device."""

    V: torch.Tensor  # (T,3,3)
    N: torch.Tensor  # (T,3,3)
    tri_obj: torch.Tensor  # (T,) int64
    mats: torch.Tensor  # (O,11) [ka kd ks ns nr]
    light_kind: tuple
    light_rgb: torch.Tensor  # (L,3)
    light_v: torch.Tensor
    width: int
    height: int
    position: np.ndarray
    cam_u: np.ndarray
    cam_v: np.ndarray
    fov: float
    ranges: list  # [(first triangle, end)] per object
    q: object = identity

    @property
    def device(self):
        return self.V.device


def ref_scene(arrays, device, q=identity, kd=None, vertices=None) -> RefScene:
    """The reference's scene from `scenes.SceneArrays`; `kd` (O,3) and
    `vertices` (T,3,3) tensors replace the arrays' own (the training
    reference's free groups, which may require grad)."""
    verts, norms, tri_obj, mats = arrays.soup()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    mats = t(mats)
    if kd is not None:
        mats = torch.cat([mats[:, :3], kd, mats[:, 6:]], 1)
    V = t(verts) if vertices is None else vertices
    ranges, at = [], 0
    for o in arrays.objects:
        ranges.append((at, at + o.vertices.shape[0]))
        at += o.vertices.shape[0]
    return RefScene(q(V), q(t(norms)), t(tri_obj), q(mats), arrays.light_kind,
                    q(t(arrays.light_rgb)), q(t(arrays.light_v)), arrays.width,
                    arrays.height, arrays.position, arrays.u, arrays.v, arrays.fov,
                    ranges, q)


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------

def camera_basis(sc: RefScene, width: int):
    """(u, v, C, position) as (3,) float32 tensors; `width` is the image
    width the plane distance uses (GPU mode: the hi-res one)."""
    f = np.float32

    def norm(a):
        sq = a * a
        return a / np.sqrt((sq[0] + sq[1]) + sq[2])

    u = norm(sc.cam_u.astype(f))
    v = norm(sc.cam_v.astype(f))
    w = np.array([u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                  u[0] * v[1] - u[1] * v[0]], f)
    tan = f(_libm_tanf()(float(f(sc.fov) * f(math.pi / 360.0))))
    L = f(width) / (f(2.0) * tan)
    C = sc.position.astype(f) + w * L
    return tuple(sc.q(torch.from_numpy(np.ascontiguousarray(a, f)).to(sc.device))
                 for a in (u, v, C, sc.position.astype(f)))


def cpu_coords(width: int, height: int, ray_ids):
    """(R,2) plane coordinates of CPU-mode ray ids ((row*W + col)*4 + s)."""
    pix, s = ray_ids // 4, ray_ids % 4
    col, row = pix % width, pix // width
    k = (width - width // 2 - col).to(torch.float32) + 0.5 * (s // 2).to(torch.float32)
    l = (height - height // 2 - row).to(torch.float32) + 0.5 * (s % 2).to(torch.float32)
    return torch.stack([k, l], 1)


def gpu_coords(width: int, height: int, ray_ids):
    """(R,2) plane coordinates of hi-res GPU-mode ray ids (row*W + col)."""
    col, row = ray_ids % width, ray_ids // width
    return torch.stack([(col - width // 2).to(torch.float32),
                        (row - height // 2).to(torch.float32)], 1)


def camera_rays(basis, coords, q=identity):
    u, v, C, pos = basis
    k, l = coords[:, 0:1], coords[:, 1:2]
    point = q((C + u * k) + v * l)
    d = q(pos - point)
    sq = d * d
    n2 = (sq[:, 0:1] + sq[:, 1:2]) + sq[:, 2:3]
    return point, q(d / sqrt_rn(n2))


# ---------------------------------------------------------------------------
# intersection
# ---------------------------------------------------------------------------

def _mt(o, d, v0, e1, e2, ref_dist: bool, q=identity):
    """(Rb,Tb) distances of every (ray, triangle) pair, +inf where the pair
    is rejected, and t. Rays (Rb,3), triangles (Tb,3)."""
    mt_eps, self_eps = f32(MT_EPS), f32(SELF_HIT_EPS)
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = v0[:, 0], v0[:, 1], v0[:, 2]
    e1x, e1y, e1z = e1[:, 0], e1[:, 1], e1[:, 2]
    e2x, e2y, e2z = e2[:, 0], e2[:, 1], e2[:, 2]
    hx = q(dy * e2z - dz * e2y)
    hy = q(dz * e2x - dx * e2z)
    hz = q(dx * e2y - dy * e2x)
    a = q((e1x * hx + e1y * hy) + e1z * hz)
    ok = a.abs() >= mt_eps
    f = q(1.0 / torch.where(ok, a, 1.0))
    sx, sy, sz = q(ox - v0x), q(oy - v0y), q(oz - v0z)
    u = q(f * ((sx * hx + sy * hy) + sz * hz))
    ok &= (u >= 0.0) & (u <= 1.0)
    qx = q(sy * e1z - sz * e1y)
    qy = q(sz * e1x - sx * e1z)
    qz = q(sx * e1y - sy * e1x)
    v = q(f * ((dx * qx + dy * qy) + dz * qz))
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = q(f * ((e2x * qx + e2y * qy) + e2z * qz))
    ok &= t > mt_eps
    dlen2 = (dx * dx + dy * dy) + dz * dz
    dlen = sqrt_rn(torch.where(dlen2 > 0.0, dlen2, 1.0))
    if ref_dist:
        td = t * dlen
        ddx = (ox + (dx / dlen) * td) - ox
        ddy = (oy + (dy / dlen) * td) - oy
        ddz = (oz + (dz / dlen) * td) - oz
        dist = q(sqrt_rn((ddx * ddx + ddy * ddy) + ddz * ddz))
    else:
        dist = q(t * dlen)
    ok &= dist > self_eps
    return torch.where(ok, dist, INF), torch.where(ok, t, INF)


def slab(o, d, lo, hi):
    """Entry and exit parameters of the lines o + t*d through boxes: rays
    (R,3) against boxes (K,3) -> (R,K) each; (+inf, -inf) where the line
    misses. A zero direction component keeps the line inside or outside
    that slab for every t."""
    o, d = o[:, None, :], d[:, None, :]
    zero = d == 0.0
    inv = 1.0 / torch.where(zero, 1.0, d)
    t1, t2 = (lo[None] - o) * inv, (hi[None] - o) * inv
    inside = (o >= lo[None]) & (o <= hi[None])
    tlo = torch.where(zero, torch.where(inside, -INF, INF), torch.minimum(t1, t2))
    thi = torch.where(zero, torch.where(inside, INF, -INF), torch.maximum(t1, t2))
    return tlo.amax(-1), thi.amin(-1)


def _boxes(V, ranges, pad: float):
    """(O,3) lo, hi of each object's triangles, padded by `pad` of the
    diagonal (plus 1e-4)."""
    lo, hi = [], []
    for a, b in ranges:
        p = V[a:b].reshape(-1, 3)
        bl, bh = p.amin(0), p.amax(0)
        m = pad * float((bh - bl).norm()) + 1e-4
        lo.append(bl - m)
        hi.append(bh + m)
    return torch.stack(lo), torch.stack(hi)


def _pairs_per_block(device) -> int:
    return (1 << 24) if torch.device(device).type == "cuda" else (1 << 20)


def _blocks(n: int, size: int):
    return [(i, min(i + size, n)) for i in range(0, n, size)]


class Tracer:
    """Nearest hits and shadow tests of one scene geometry, brute force per
    object behind padded object boxes. With `count=True` it also counts the
    work every box-based sweep must do (`count_pairs`) for each batch it
    traces, into `self.pairs`, `self.rays`, `self.nearest_rays`."""

    def __init__(self, sc: RefScene, count: bool = False, last_on_tie: bool = False):
        self.sc, self.last_on_tie = sc, last_on_tie
        V = sc.V.detach()
        self.v0 = V[:, 0]
        self.e1, self.e2 = sc.q(V[:, 1] - self.v0), sc.q(V[:, 2] - self.v0)
        self.lo, self.hi = _boxes(V, sc.ranges, BOX_PAD)
        self.count = count
        if count:
            self.tri_lo, self.tri_hi = V.amin(1), V.amax(1)
            self.pairs = self.rays = self.nearest_rays = 0
        self.block = _pairs_per_block(sc.device)

    def _candidates(self, o, d, j, limit=None):
        tlo, thi = slab(o, d, self.lo[j:j + 1], self.hi[j:j + 1])
        tlo, thi = tlo[:, 0], thi[:, 0]
        keep = thi >= torch.clamp(tlo, min=0.0)
        if limit is not None:
            keep &= tlo <= limit
        return keep.nonzero()[:, 0]

    @torch.no_grad()
    def nearest(self, o, d):
        """(distance (R,) +inf on a miss, winner (R,) int64): the lowest
        triangle index among equal distances, or the highest with
        `last_on_tie` (the other order, which measures how much of a frame
        rests on ties)."""
        R = o.shape[0]
        best = torch.full((R,), INF, device=o.device)
        best_t = torch.full((R,), INF, device=o.device)
        win = torch.zeros((R,), dtype=torch.int64, device=o.device)
        for j, (a, b) in enumerate(self.sc.ranges):
            rid = self._candidates(o, d, j)
            if rid.numel() == 0:
                continue
            tb = max(1, min(b - a, self.block // 64))
            rb = max(1, self.block // tb)
            for r0, r1 in _blocks(rid.numel(), rb):
                ids = rid[r0:r1]
                oo, dd = o[ids], d[ids]
                for t0, t1 in _blocks(b - a, tb):
                    s = slice(a + t0, a + t1)
                    dist, t = _mt(oo, dd, self.v0[s], self.e1[s], self.e2[s], True,
                                  self.sc.q)
                    dmin = dist.amin(1)
                    cols = torch.arange(t1 - t0, device=o.device)
                    if self.last_on_tie:
                        first = torch.where(dist == dmin[:, None], cols, 0).amax(1)
                        better = (dmin <= best[ids]) & torch.isfinite(dmin)
                    else:
                        first = torch.where(dist == dmin[:, None], cols, t1 - t0).amin(1)
                        better = dmin < best[ids]
                    best[ids] = torch.where(better, dmin, best[ids])
                    tw = t.gather(1, first.clamp(max=t1 - t0 - 1)[:, None])[:, 0]
                    best_t[ids] = torch.where(better, tw, best_t[ids])
                    win[ids] = torch.where(better, a + t0 + first, win[ids])
        if self.count:
            self.count_pairs(o, d, best_t)
            self.nearest_rays += R
        return best, win

    @torch.no_grad()
    def occluded(self, o, d, limit=None):
        """(R,) bool: any accepted hit (t*|d| > self_hit_eps) along the ray.
        With `count`, also the pairs up to the nearest occluder or `limit`
        (the light's parameter, +inf for a directional light)."""
        R = o.shape[0]
        occ = torch.zeros((R,), dtype=torch.bool, device=o.device)
        near = torch.full((R,), INF, device=o.device)
        for j, (a, b) in enumerate(self.sc.ranges):
            rid = self._candidates(o, d, j)
            if not self.count:
                rid = rid[~occ[rid]]
            if rid.numel() == 0:
                continue
            tb = max(1, min(b - a, self.block // 64))
            rb = max(1, self.block // tb)
            for r0, r1 in _blocks(rid.numel(), rb):
                ids = rid[r0:r1]
                for t0, t1 in _blocks(b - a, tb):
                    s = slice(a + t0, a + t1)
                    _, t = _mt(o[ids], d[ids], self.v0[s], self.e1[s], self.e2[s],
                               False, self.sc.q)
                    tmin = t.amin(1)
                    occ[ids] |= torch.isfinite(tmin)
                    near[ids] = torch.minimum(near[ids], tmin)
        if self.count:
            self.count_pairs(o, d, near if limit is None else torch.minimum(near, limit))
        return occ

    def count_pairs(self, o, d, limit):
        """Add the (ray, triangle) pairs whose triangle's own box the ray's
        segment [0, limit] enters: the least that a box-based cull or
        traversal must test before it knows the nearest hit (or, for a
        shadow ray, its nearest occluder or the light)."""
        live = (o[:, 0] != PARKED) & (d != 0.0).any(1)
        o, d, limit = o[live], d[live], limit[live]
        self.rays += int(o.shape[0])
        for j, (a, b) in enumerate(self.sc.ranges):
            rid = self._candidates(o, d, j, limit)
            if rid.numel() == 0:
                continue
            tb = max(1, min(b - a, self.block // 256))
            rb = max(1, self.block // (4 * tb))
            for r0, r1 in _blocks(rid.numel(), rb):
                ids = rid[r0:r1]
                for t0, t1 in _blocks(b - a, tb):
                    tlo, thi = slab(o[ids], d[ids], self.tri_lo[a + t0:a + t1],
                                    self.tri_hi[a + t0:a + t1])
                    hit = (thi >= torch.clamp(tlo, min=0.0)) & (tlo <= limit[ids][:, None])
                    self.pairs += int(hit.sum())


# ---------------------------------------------------------------------------
# colours, hits, shading
# ---------------------------------------------------------------------------

class Colours:
    """cpu/colors.c's arithmetic ("match": clamped at every operation) or
    the linear one ("smooth")."""

    def __init__(self, quantize: str, q=identity):
        self.match, self.q = quantize == "match", q

    def init(self, c):
        return self.q(torch.clamp(c * 255.0, 0.0, 255.0)) if self.match else c

    def add(self, a, b):
        return self.q(torch.clamp(a + b, max=255.0) if self.match else a + b)

    def mul(self, a, coef):
        return self.init(self.q((a / 255.0) * coef)) if self.match else self.q(a * coef)

    def mul2(self, a, b):
        if self.match:
            return self.init(self.q((a / 255.0) * (b / 255.0)))
        return self.q(a * b)


def _dot(a, b):
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _normalize(a):
    s = _dot(a, a)[..., None]
    return a / sqrt_rn(torch.where(s > 0.0, s, 1.0))


@dataclasses.dataclass
class Hit:
    point: torch.Tensor
    normal: torch.Tensor
    mask: torch.Tensor
    mats: torch.Tensor  # (R,11) of the winner's object


def collide(tracer: Tracer, o, d) -> Hit:
    """Nearest hits, the winner's u/v/t, point and normal recomputed with
    autograd recording (gradient reaches the winner's vertices)."""
    sc, q = tracer.sc, tracer.sc.q
    dist, win = tracer.nearest(o, d)
    mask = torch.isfinite(dist)
    tri = sc.V[win]
    v0 = tri[:, 0]
    e1, e2 = q(tri[:, 1] - v0), q(tri[:, 2] - v0)
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    hx = q(dy * e2[:, 2] - dz * e2[:, 1])
    hy = q(dz * e2[:, 0] - dx * e2[:, 2])
    hz = q(dx * e2[:, 1] - dy * e2[:, 0])
    a = q((e1[:, 0] * hx + e1[:, 1] * hy) + e1[:, 2] * hz)
    f = q(1.0 / torch.where(a.abs() >= f32(MT_EPS), a, 1.0))
    sx, sy, sz = q(o[:, 0] - v0[:, 0]), q(o[:, 1] - v0[:, 1]), q(o[:, 2] - v0[:, 2])
    u = q(f * ((sx * hx + sy * hy) + sz * hz))
    qx = q(sy * e1[:, 2] - sz * e1[:, 1])
    qy = q(sz * e1[:, 0] - sx * e1[:, 2])
    qz = q(sx * e1[:, 1] - sy * e1[:, 0])
    v = q(f * ((dx * qx + dy * qy) + dz * qz))
    t = q(f * ((e2[:, 0] * qx + e2[:, 1] * qy) + e2[:, 2] * qz))
    d2 = (dx * dx + dy * dy) + dz * dz
    dlen = sqrt_rn(torch.where(d2 > 0.0, d2, 1.0))
    point = q(o + (d / dlen[:, None]) * (t[:, None] * dlen[:, None]))
    tn = sc.N[win]
    n2 = ((tn[..., 0] * tn[..., 0] + tn[..., 1] * tn[..., 1])
          + tn[..., 2] * tn[..., 2])[..., None]
    nn = q(tn / sqrt_rn(torch.where(n2 > 0.0, n2, 1.0)))
    normal = q((nn[:, 0] * (1.0 - u - v)[:, None] + nn[:, 1] * u[:, None])
               + nn[:, 2] * v[:, None])
    mask = mask & (normal != 0.0).any(-1)
    return Hit(point, normal, mask, sc.mats[sc.tri_obj[win]])


def shade(tracer: Tracer, hit: Hit, cops: Colours):
    """(R,3) colour of each hit (garbage where ~hit.mask)."""
    sc, q = tracer.sc, tracer.sc.q
    R = hit.point.shape[0]
    ka, kd, ks, ns = hit.mats[:, 0:3], hit.mats[:, 3:6], hit.mats[:, 6:9], hit.mats[:, 9]
    N, hp = hit.normal, hit.point
    live = hit.mask[:, None]
    so = torch.where(live, hp.detach(), PARKED)
    color = torch.zeros((R, 3), device=hp.device)
    for li, kind in enumerate(sc.light_kind):
        rgb, lv = sc.light_rgb[li], sc.light_v[li]
        if kind == 0:
            contrib = cops.mul2(cops.init(rgb.expand(R, 3)), cops.init(ka))
            color = cops.add(color, contrib)
            continue
        L = (-lv).expand(R, 3)
        if kind == 1:
            sd = torch.where(live, -lv.detach(), 0.0)
            limit = torch.full((R,), INF, device=hp.device)
        else:
            sd = torch.where(live, q(lv.detach()[None, :] - hp.detach()), 0.0)
            limit = torch.ones((R,), device=hp.device)
        occluded = tracer.occluded(so, sd, limit)
        lrgb, kd_b = cops.init(rgb.expand(R, 3)), cops.init(kd)
        if kind == 1:
            dif = cops.mul(cops.mul2(lrgb, kd_b), q(_dot(L, N))[:, None])
            inc_dir = lv.expand(R, 3)
        else:
            flip = _dot(L, N) < 0.0
            Np = torch.where(flip[:, None], -N, N)
            dvec = q(lv[None, :] - hp)
            dist = sqrt_rn(_dot(dvec, dvec))
            safe = torch.where(dist > 0.0, dist, 1.0)
            dif = cops.mul(cops.mul2(lrgb, kd_b), q(_dot(L, Np) * (1.0 / safe))[:, None])
            inc_dir = dvec
        inc_org = q(hp + inc_dir * -10.0)
        kcolor = cops.init(ks)
        V = q(inc_org - hp)
        Rv = q(inc_dir - N * (2.0 * _dot(N, inc_dir))[:, None])
        Ls = q(torch.pow(torch.clamp(_dot(_normalize(Rv), _normalize(V)), min=0.0), ns))
        con = cops.add(dif, cops.mul(kcolor, Ls[:, None]))
        color = cops.add(color, torch.where(occluded[:, None], 0.0, con))
    return color


def trace(tracer: Tracer, o, d, n_steps: int, gpu: bool, cops: Colours):
    """(R,3) colours of rays o, d through the CPU pipeline's recursion
    (`n_steps` levels) or the GPU pipeline's bounce loop (`n_steps` =
    max_bounce + 1). Only the rays still in use are traced at each step;
    a ray out of use adds an exact zero in the program."""
    q = tracer.sc.q
    R = o.shape[0]
    cutoff = f32(CUTOFF)
    color = torch.zeros((R, 3), device=o.device)
    coef = torch.ones((R,), device=o.device)
    alive = torch.ones((R,), dtype=torch.bool, device=o.device)
    for _ in range(n_steps):
        if not gpu:
            alive = alive & (coef >= cutoff)
        ids = alive.nonzero()[:, 0]
        if ids.numel() == 0:
            break
        oo, dd, cc = o[ids], d[ids], coef[ids]
        hit = collide(tracer, oo, dd)
        local = shade(tracer, hit, cops)
        use = hit.mask
        add = torch.where(use[:, None], cops.mul(local, cc[:, None]), 0.0)
        color = color.index_copy(0, ids, cops.add(color[ids], add))
        n = hit.normal
        p = n * dd
        refl = q(dd - n * (2.0 * ((p[:, 0] + p[:, 1]) + p[:, 2]))[:, None])
        o = o.index_copy(0, ids, torch.where(use[:, None], hit.point, PARKED))
        d = d.index_copy(0, ids, torch.where(use[:, None], refl, 0.0))
        nr = hit.mats[:, 10]
        if gpu:
            cnew = q(cc * torch.where(use, nr, 0.0))
            anew = use & (cnew > cutoff)
        else:
            cnew = q(torch.where(use, nr * cc, 0.0))
            anew = use
        coef = coef.index_copy(0, ids, cnew)
        alive = torch.zeros_like(alive).index_copy(0, ids, anew)
    return color


# ---------------------------------------------------------------------------
# frames and training steps
# ---------------------------------------------------------------------------

def depth_for(max_nr: float, cap: int) -> int:
    """Smallest D with max_nr^D < 0.01, within [1, cap]."""
    if max_nr <= 0.0:
        return 1
    if max_nr >= 1.0:
        return cap
    return max(1, min(cap, int(math.ceil(math.log(CUTOFF) / math.log(max_nr)))))


def frame_pixels(sc: RefScene, render: dict, pixels, tracer=None) -> torch.Tensor:
    """(P,3) uint8 values of the frame's pixels `pixels` (flat ids row*W +
    col of the W x H output image, on sc.device), as `rt` writes them."""
    tracer = tracer or Tracer(sc)
    cops = Colours(render.get("quantize", "match"), sc.q)
    W, H = sc.width, sc.height
    if render.get("mode", "cpu") == "cpu":
        basis = camera_basis(sc, W)
        ids = (pixels[:, None] * 4 + torch.arange(4, device=pixels.device)).reshape(-1)
        o, d = camera_rays(basis, cpu_coords(W, H, ids), sc.q)
        depth = depth_for(float(sc.mats[:, 10].max()), render.get("cpu_max_depth", 64))
        c = trace(tracer, o, d, depth, False, cops).reshape(-1, 4, 3)
        acc = torch.zeros_like(c[:, 0])
        for s in range(4):
            acc = cops.add(acc, cops.mul(c[:, s], 0.25))
        img = acc if cops.match else torch.clamp(acc, 0.0, 1.0) * 255.0
    else:
        a = render["aliasing"]
        hw, hh = W * a, H * a
        basis = camera_basis(sc, hw)
        y, x = pixels // W, pixels % W
        by, bx = (H - 1 - y) * a, (W - 1 - x) * a  # the downscale flips both axes
        off = torch.arange(a, device=pixels.device)
        rows = (by[:, None, None] + off[None, :, None]).expand(-1, a, a)
        cols = (bx[:, None, None] + off[None, None, :]).expand(-1, a, a)
        ids = (rows * hw + cols).reshape(-1)
        o, d = camera_rays(basis, gpu_coords(hw, hh, ids), sc.q)
        c = trace(tracer, o, d, render.get("max_bounce", 10) + 1, True, cops)
        hi = c if cops.match else torch.clamp(c, 0.0, 1.0) * 255.0
        box = torch.trunc(hi).reshape(-1, a * a, 3).sum(1)
        img = torch.clamp(box / (255.0 * a * a) * 255.0, 0.0, 255.0)
    return torch.trunc(img).to(torch.uint8)


def frame_work(sc: RefScene, render: dict) -> dict:
    """The whole frame traced with the work count on: {"pairs", "rays",
    "nearest_rays", "triangles"}."""
    tracer = Tracer(sc, count=True)
    n = sc.width * sc.height
    step = 1 << 16
    for p0 in range(0, n, step):
        pix = torch.arange(p0, min(p0 + step, n), device=sc.device)
        frame_pixels(sc, render, pix, tracer)
    return {"pairs": tracer.pairs, "rays": tracer.rays,
            "nearest_rays": tracer.nearest_rays, "triangles": int(sc.V.shape[0])}


def predict(sc: RefScene, render: dict, depth: int, pixels=None, last_on_tie=False):
    """(P, 3) smooth pixel colours in [0,1] of the image's pixels `pixels`
    (flat ids; None: every pixel), unclamped: the mean of each pixel's 4
    subsamples (what the training loss reads)."""
    tracer = Tracer(sc, last_on_tie=last_on_tie)
    cops = Colours("smooth", sc.q)
    W, H = sc.width, sc.height
    basis = camera_basis(sc, W)
    if pixels is None:
        pixels = torch.arange(W * H, device=sc.device)
    ids = (pixels[:, None] * 4 + torch.arange(4, device=sc.device)).reshape(-1)
    o, d = camera_rays(basis, cpu_coords(W, H, ids), sc.q)
    return trace(tracer, o, d, depth, False, cops).reshape(-1, 4, 3).mean(1)


def train_steps(arrays, render: dict, start: dict, lrs: dict, n_steps: int, device,
                q=identity, pixels=None, last_on_tie=False, betas=(0.9, 0.999), eps=1e-8):
    """`n_steps` Adam steps of the inverse-rendering loss
    sum((pred - target)^2) / (3 W H) from `start` ({"kd": (O,3), "vertices":
    (T,3,3)} arrays); the target is the prediction at the arrays' own
    parameters. Returns {"losses": [...], "grads": {group: first step's
    gradient}, "params": {group: after the last step}} as NumPy."""
    mats = arrays.soup()[3]
    depth = depth_for(float(mats[:, 10].max()), render.get("diff_max_depth", 6))
    with torch.no_grad():
        target = predict(ref_scene(arrays, device, q), render, depth, pixels, last_on_tie)
    params = {k: torch.tensor(start[k], device=device, requires_grad=True) for k in lrs}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grads = [], {}
    scale = 1.0 / (3.0 * target.shape[0])
    for step in range(1, n_steps + 1):
        sc = ref_scene(arrays, device, q, kd=params.get("kd"), vertices=params.get("vertices"))
        err = predict(sc, render, depth, pixels, last_on_tie) - target
        loss = (err * err).sum() * scale
        g = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (k, p), gk in zip(params.items(), g):
                if step == 1:
                    grads[k] = gk.cpu().numpy().copy()
                m[k] = betas[0] * m[k] + (1 - betas[0]) * gk
                v[k] = betas[1] * v[k] + (1 - betas[1]) * gk * gk
                mhat = m[k] / (1 - betas[0] ** step)
                vhat = v[k] / (1 - betas[1] ** step)
                p -= lrs[k] * mhat / (torch.sqrt(vhat) + eps)
    return {"losses": losses, "grads": grads,
            "params": {k: p.detach().cpu().numpy().copy() for k, p in params.items()}}
