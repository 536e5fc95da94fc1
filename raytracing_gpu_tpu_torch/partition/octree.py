"""Object-granularity octree as flat index tables.

The JAX package's `partition/octree.py` (reference: gpu/partitioning/
octree.cu): each object's box is quantized to an 8-level (256^3) grid, the
object gets the sort key `morton * 256 + level` (its 24-bit interleaved cell
path with the bits below its level zeroed, so a parent sorts just before its
subtree), objects are sorted by key, and the node graph becomes static-shape
tables over the (object, level) candidate rows: 9*O rows, first occurrences
valid, children and parents as row indices (-1 for none).

Every integer and boolean equals the JAX package's. Its keys are uint32 and
rely on XLA's shifts (a shift by 32 or more gives 0) and on wrap-around;
here the same values live in int64 and `_shl` / `_shr` / `_u32` reproduce
both.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_gpu_tpu_torch.models.scene import _Tensors
from raytracing_gpu_tpu_torch.partition.aabb import hit_aabb

MAX_DEPTH = 8  # grid bits per axis: 256^3 cells (octree.cu:13-16)
_MASK = 0xFFFFFFFF
_SENTINEL = 0xFFFFFFFF


def _u32(x):
    """Wrap an int64 value to uint32 range."""
    return x & _MASK


def _shl(x, s):
    """uint32 `x << s` for a tensor or int shift: 0 once s is outside
    [0, 32), the rest wrapped to 32 bits."""
    s = torch.as_tensor(s, dtype=torch.int64, device=x.device)
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, _u32(x << s.clamp(0, 31)), 0)


def _shr(x, s):
    """uint32 `x >> s`: 0 once s is outside [0, 32)."""
    s = torch.as_tensor(s, dtype=torch.int64, device=x.device)
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, x >> s.clamp(0, 31), 0)


@dataclasses.dataclass
class Octree(_Tensors):
    """Flat octree. N = 9*O candidate rows, invalid rows masked out.

    keys (O,) int64 sorted object keys (uint32 values); perm (O,) int32,
    sorted slot -> original object; obj_node (O,) int32, original object ->
    node row; node_valid (N,) bool; node_level (N,) int32 depth (0 = root);
    node_box (N,2,3) f32 grid-cell box; node_start/node_end (N,) int32, the
    sorted-object range the node owns; node_sub_start/node_sub_end its
    subtree's range; node_children (N,8) int32 and node_parent (N,) int32
    rows, -1 when absent; n_nodes () int32.
    """

    keys: torch.Tensor
    perm: torch.Tensor
    obj_node: torch.Tensor
    node_valid: torch.Tensor
    node_level: torch.Tensor
    node_box: torch.Tensor
    node_start: torch.Tensor
    node_end: torch.Tensor
    node_sub_start: torch.Tensor
    node_sub_end: torch.Tensor
    node_children: torch.Tensor
    node_parent: torch.Tensor
    n_nodes: torch.Tensor


@dataclasses.dataclass
class NodeCull(_Tensors):
    """The slice of the node graph the render walks (`Geometry.octree`)."""

    node_box: torch.Tensor     # (N,2,3) grid-cell boxes
    node_parent: torch.Tensor  # (N,) parent row, -1 at roots
    node_level: torch.Tensor   # (N,) depth, 0 = root
    node_valid: torch.Tensor   # (N,) bool
    obj_node: torch.Tensor     # (O,) original object -> owning node row


def node_cull_tables(tree: Octree) -> NodeCull:
    return NodeCull(node_box=tree.node_box, node_parent=tree.node_parent,
                    node_level=tree.node_level, node_valid=tree.node_valid,
                    obj_node=tree.obj_node)


def octree_object_reach(origins, dirs, nc: NodeCull):
    """(R,O) bool: the object is reachable by the ray through the node graph.

    The reference's stackful DFS (gpu/hit.cu:120-169) as a frontier mask
    pushed down the parent links: `reached[n] = hit_aabb(node n) and
    reached[parent[n]]`, roots seeded by their own slab test, settled after
    MAX_DEPTH sweeps. An object is reachable iff its owning node is.
    Conservative: a culled object holds no accepted hit. Padding objects own
    no node and are never culled (their triangles are invalid anyway)."""
    nhit = hit_aabb(origins, dirs, nc.node_box) & nc.node_valid[None, :]  # (R,N)
    is_root = ((nc.node_level == 0) & nc.node_valid)[None, :]
    has_parent = (nc.node_parent >= 0)[None, :]
    pidx = nc.node_parent.clamp(min=0).long()
    reached = nhit & is_root
    for _ in range(MAX_DEPTH):
        reached = torch.where(is_root, reached,
                              nhit & reached[:, pidx] & has_parent)
    oreach = reached[:, nc.obj_node.clamp(min=0).long()]
    return oreach | (nc.obj_node < 0)[None, :]


def _bitlength8(x):
    """Position of the highest set bit of an 8-bit value (0 for 0)."""
    bl = torch.zeros_like(x)
    for b in range(8):
        bl = torch.where((x >> b) & 1 == 1, b + 1, bl)
    return bl


def position_keys(obj_aabbs, scene_aabb, obj_valid):
    """Quantize object boxes to the grid and pack their sort keys
    (position_object, octree.cu:126-196): level = the number of leading grid
    bits the two corners share on every axis; key = (interleaved 3-bit child
    path of the min corner, cut at that level) * 256 + level.

    Returns (keys (O,) int64 holding uint32 values, 0xFFFFFFFF for invalid
    objects; level (O,) int32; morton (O,) int64)."""
    smin = scene_aabb[0]
    size = scene_aabb[1] - scene_aabb[0]
    size = torch.where(size > 0.0, size, 1.0)
    scale = 256.0 / size

    def quant(corner):
        # clamped before the cast: an empty box's infinite corners saturate
        # the way XLA's float-to-int conversion does
        return torch.floor((corner - smin) * scale).clamp(0, 255).to(torch.int64)

    qmin = quant(obj_aabbs[:, 0])  # (O,3)
    qmax = quant(obj_aabbs[:, 1])
    level = (8 - _bitlength8(qmin ^ qmax)).amin(-1)  # (O,)

    morton = torch.zeros_like(level)
    for d in range(MAX_DEPTH):
        bits = (qmin >> (7 - d)) & 1
        child = (bits[:, 0] << 2) | (bits[:, 1] << 1) | bits[:, 2]
        morton = morton | (child << (3 * (7 - d)))
    shift = 3 * (MAX_DEPTH - level)
    morton = torch.where(level >= 8, morton, _shl(_shr(morton, shift), shift))
    keys = _shl(morton, 8) | level
    keys = torch.where(obj_valid, keys, _SENTINEL)
    return keys, torch.where(obj_valid, level, 0).to(torch.int32), morton


def build_octree(obj_aabbs, scene_aabb, obj_valid) -> Octree:
    """Keys -> sort -> node enumeration -> ranges and links."""
    O = obj_aabbs.shape[0]
    keys, level, _ = position_keys(obj_aabbs, scene_aabb, obj_valid)
    i32 = torch.int32

    perm = torch.argsort(keys, stable=True)
    skeys = keys[perm]
    slevel = level[perm].long()
    smorton = skeys >> 8

    # candidate nodes: (object, depth) pairs, first occurrences kept
    d_grid = torch.arange(MAX_DEPTH + 1, device=keys.device)  # (9,)
    valid_pair = (d_grid[None, :] <= slevel[:, None]) & (skeys != _SENTINEL)[:, None]
    prefix = smorton[:, None] >> (3 * (MAX_DEPTH - d_grid))[None, :]  # (O,9)
    codes = _shl(prefix, 4) | d_grid[None, :]
    codes = torch.where(valid_pair, codes, _SENTINEL).reshape(-1)  # (9O,)
    codes = torch.sort(codes).values
    first = torch.cat([codes.new_ones((1,), dtype=torch.bool),
                       codes[1:] != codes[:-1]])
    node_valid = first & (codes != _SENTINEL)
    n_nodes = node_valid.sum().to(i32)

    node_level = codes & 15
    node_prefix = codes >> 4

    # node grid-cell box (get_aabb_box, octree.cu:231-243)
    smin = scene_aabb[0]
    size = torch.where(scene_aabb[1] - scene_aabb[0] > 0.0,
                       scene_aabb[1] - scene_aabb[0], 1.0)
    cell = torch.zeros((codes.shape[0], 3), dtype=torch.int64, device=keys.device)
    for b in range(MAX_DEPTH):  # de-interleave; group b counts from the path's end
        grp = (node_prefix >> (3 * b)) & 7
        take = (b < node_level)[:, None]
        axes = torch.stack([(grp >> 2) & 1, (grp >> 1) & 1, grp & 1], -1)
        cell = cell | torch.where(take, axes << b, 0)
    side = size[None, :] / (1 << node_level)[:, None].to(torch.float32)
    bmin = smin[None, :] + cell.to(torch.float32) * side
    node_box = torch.stack([bmin, bmin + side], 1)  # (N,2,3)

    # owned range: keys equal to the node's canonical (cell path, level) key
    below = 3 * (MAX_DEPTH - node_level)
    lo = _shl(_shl(node_prefix, below), 8)
    own_key = lo | node_level
    node_start = torch.searchsorted(skeys, own_key, right=False).to(i32)
    node_end = torch.searchsorted(skeys, own_key, right=True).to(i32)

    # subtree range: every key whose path starts with this node's; the root
    # and the last cell of a level (whose +1 wraps) end at the first invalid key
    hi = _shl(_shl(_u32(node_prefix + 1), below), 8)
    last_cell = node_prefix == _u32(_shl(torch.ones_like(node_level), 3 * node_level) - 1)
    hi = torch.where((node_level == 0) | last_cell, _SENTINEL, hi)
    node_sub_start = torch.searchsorted(skeys, lo, right=False).to(i32)
    node_sub_end = torch.searchsorted(skeys, hi, right=False).to(i32)

    def code_to_row(c):
        row = torch.searchsorted(codes, c, right=False).clamp(0, codes.shape[0] - 1)
        ok = (codes[row] == c) & (c != _SENTINEL)
        return torch.where(ok, row, -1).to(i32)

    kids = []
    for c in range(8):
        ccode = _shl(_shl(node_prefix, 3) | c, 4) | (node_level + 1)
        kids.append(code_to_row(torch.where(node_level < MAX_DEPTH, ccode, _SENTINEL)))
    node_children = torch.stack(kids, -1)  # (N,8)

    pcode = _shl(node_prefix >> 3, 4) | _u32(node_level - 1)
    node_parent = code_to_row(torch.where(node_level > 0, pcode, _SENTINEL))

    own_code = _shl(_shr(smorton, 3 * (MAX_DEPTH - slevel)), 4) | slevel
    own_code = torch.where(skeys != _SENTINEL, own_code, _SENTINEL)
    obj_node = torch.zeros((O,), dtype=i32, device=keys.device)
    obj_node[perm] = code_to_row(own_code)

    return Octree(
        keys=skeys, perm=perm.to(i32), obj_node=obj_node, node_valid=node_valid,
        node_level=node_level.to(i32), node_box=node_box,
        node_start=node_start, node_end=node_end,
        node_sub_start=node_sub_start, node_sub_end=node_sub_end,
        node_children=node_children, node_parent=node_parent, n_nodes=n_nodes)
