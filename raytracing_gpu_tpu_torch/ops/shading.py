"""Phong shading with hard shadows — `apply_light` (cpu/light.c:33-99).

The JAX package's `ops/shading.py` with every reference quirk: ambient
light_rgb*ka; directional L = -v; point L = -position (not toward the
light) with N flipped when dot(L,N) < 0 and a 1/|v - hit| falloff; ANY hit
on the shadow ray occludes (the distance test of has_direct_hit is dead
code); specular from an incident ray whose origin is hit - 10*dir, with the
unflipped N; pow(0,0) = 1. All directional and point lights share one shadow
pass; same-kind lights are batched over a leading axis; contributions fold
in declaration order through the saturating add. 3-term dot products are
written out left-associated.
"""

from __future__ import annotations

import torch

from raytracing_gpu_tpu_torch.config import ANY_HIT_OFF
from raytracing_gpu_tpu_torch.models.scene import AMBIENT, DIRECTIONAL, POINT
from raytracing_gpu_tpu_torch.ops.colors import ColorOps
from raytracing_gpu_tpu_torch.ops.fp import sqrt_rn
from raytracing_gpu_tpu_torch.ops.intersect import Hit, collide_any

# origin of the shadow rays of missed primaries: far outside every scene, so
# tile culling drops them (with a zero direction Möller–Trumbore rejects them
# too)
PARKED = 3e29


def _dot(a, b):
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _normalize(a):
    s = _dot(a, a)[..., None]
    return a / sqrt_rn(torch.where(s > 0.0, s, 1.0))


def material_rows(mats, obj):
    """(R,11) [ka kd ks ns nr] of each hit's object — an index gather."""
    table = torch.cat([mats.ka, mats.kd, mats.ks, mats.ns[:, None],
                       mats.nr[:, None]], 1)
    return table[obj.long()]


def apply_specular(color, inc_origin, inc_dir, hit_point, normal, ks, ns,
                   cops: ColorOps):
    """apply_specular (cpu/light.c:7-22), batched over (..., R)."""
    kcolor = cops.init(ks.expand(inc_dir.shape))
    V = inc_origin - hit_point
    Rv = inc_dir - normal * (2.0 * _dot(normal, inc_dir))[..., None]
    Ls = torch.pow(torch.clamp(_dot(_normalize(Rv), _normalize(V)), min=0.0), ns)
    return cops.add(color, cops.mul(kcolor, Ls[..., None]))


def shadow_rays(lights, hit: Hit):
    """The batched shadow rays of one shading pass: (origins (K*R,3),
    directions (K*R,3), {light index: row block}) for the K non-ambient
    lights. Rays of missed primaries are parked (origin PARKED, direction
    0); their results are discarded. Cut from the graph: a shadow ray is
    only tested for a hit."""
    R = hit.point.shape[0]
    point, light_v = hit.point.detach(), lights.v.detach()
    block, sdirs = {}, []
    for li, kind in enumerate(lights.kind):
        if kind == DIRECTIONAL:
            block[li] = len(sdirs)
            sdirs.append((-light_v[li]).expand(R, 3))
        elif kind == POINT:
            block[li] = len(sdirs)
            sdirs.append(light_v[li][None, :] - point)  # cpu/light.c:80
    if not sdirs:
        return None, None, block
    K = len(sdirs)
    live = hit.mask[:, None]
    so = torch.where(live, point, PARKED).repeat(K, 1)
    sd = torch.where(live.repeat(K, 1), torch.cat(sdirs, 0), 0.0)
    return so, sd, block


def shade(scene, hit: Hit, cops: ColorOps, mt_eps=1e-7, self_hit_eps=0.01,
          backend="torch", pack=None, partitioning="octree",
          any_hit_min_tris=ANY_HIT_OFF, tape=None):
    """(R,3) colors of a batch of hits in the cops domain; rays with
    hit.mask False get garbage (the caller masks them). The shadow pass only
    reads a boolean, so no gradient flows through it; `tape` is the
    `SweepTape` of a checkpointed bounce step."""
    R = hit.point.shape[0]
    lights = scene.lights
    mrows = hit.mat if hit.mat is not None else material_rows(scene.materials, hit.obj)
    ka, kd, ks, ns = mrows[:, 0:3], mrows[:, 3:6], mrows[:, 6:9], mrows[:, 9]
    N = hit.normal
    hp = hit.point

    so, sd, block = shadow_rays(lights, hit)
    if so is not None:
        occluded = collide_any(so, sd, scene.geometry, mt_eps, self_hit_eps,
                               backend, pack, partitioning,
                               any_hit_min_tris, tape).reshape(-1, R)

    contribs = {}
    for kind in (DIRECTIONAL, POINT):
        ix = [li for li, k in enumerate(lights.kind) if k == kind]
        if not ix:
            continue
        Kk = len(ix)
        lv = lights.v[ix]  # (Kk,3)
        lrgb = cops.init(lights.rgb[ix][:, None, :].expand(Kk, R, 3))
        kd_b = cops.init(kd[None].expand(Kk, R, 3))
        L = (-lv[:, None, :]).expand(Kk, R, 3)
        if kind == DIRECTIONAL:
            dif = cops.mul(cops.mul2(lrgb, kd_b), _dot(L, N[None])[..., None])
            inc_dir = lv[:, None, :].expand(Kk, R, 3)
        else:
            # N flipped toward the light; specular keeps the unflipped N
            flip = _dot(L, N[None]) < 0.0
            Np = torch.where(flip[..., None], -N[None], N[None])
            dvec = lv[:, None, :] - hp[None]
            dist = sqrt_rn(_dot(dvec, dvec))
            safe = torch.where(dist > 0.0, dist, 1.0)
            dif = cops.mul(cops.mul2(lrgb, kd_b),
                           (_dot(L, Np) * (1.0 / safe))[..., None])
            inc_dir = dvec
        inc_org = hp[None] + inc_dir * -10.0
        con = apply_specular(dif, inc_org, inc_dir, hp[None], N[None],
                             ks[None], ns[None], cops)
        for j, li in enumerate(ix):
            contribs[li] = torch.where(occluded[block[li]][:, None], 0.0, con[j])

    color = cops.zeros((R,), device=hp.device)
    for li, kind in enumerate(lights.kind):  # declaration-order fold
        if kind == AMBIENT:
            contrib = cops.mul2(cops.init(lights.rgb[li].expand(R, 3)), cops.init(ka))
        elif li in contribs:
            contrib = contribs[li]
        else:  # unknown kind: skipped (cpu/light.c:94-96)
            continue
        color = cops.add(color, contrib)
    return color
