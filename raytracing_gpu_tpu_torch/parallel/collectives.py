"""The collectives of the sharded render and training step, over
`torch.distributed` process groups.

The JAX package calls `jax.lax.all_gather`, `pmin`, `pmax` and `psum` inside
`shard_map`; here every rank runs the same Python and calls these. A `None`
group, or a group of one rank, is the identity: each function returns its
input unchanged, so single-process code pays nothing.

gloo moves CUDA tensors only for `broadcast` and `all_reduce`. Where a
group's backend is gloo, `all_gather` stages a CUDA tensor through the host
(two ranks sharing one card can only form a gloo group; NCCL refuses two
ranks on one device).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

SUM = dist.ReduceOp.SUM
MIN = dist.ReduceOp.MIN
MAX = dist.ReduceOp.MAX


def group_size(group) -> int:
    """Ranks in `group`; 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


def _gather_cat(t, group):
    """Every rank's `t` (same shape on each), concatenated along dim 0 in
    group-rank order."""
    staged = t.device.type != "cpu" and dist.get_backend(group) == "gloo"
    src = (t.detach().cpu() if staged else t.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.to(t.device) if staged else out


class _AllGather(torch.autograd.Function):
    """all_gather whose backward keeps this rank's own slice of its own
    cotangent and sums nothing. Everything computed from the gathered
    tensor is computed alike on every rank of the group, so each rank
    already holds the whole cotangent; summing it over the ranks (the
    transpose of the gather) would count it once per rank."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.rows = t.shape[0]
        ctx.rank = dist.get_rank(group)
        return _gather_cat(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_gather(t, group=None):
    """(S*n, ...) every rank's (n, ...) `t` in group-rank order, recorded by
    autograd (see `_AllGather` for the backward)."""
    if group_size(group) == 1:
        return t
    return _AllGather.apply(t, group)


@torch.no_grad()
def all_reduce(t, op=SUM, group=None):
    """`t` reduced elementwise over `group` by `op` (SUM, MIN, MAX), as a new
    tensor; no gradient. bool tensors are reduced as int32 (MAX is an OR,
    MIN an AND)."""
    if group_size(group) == 1:
        return t
    out = t.to(torch.int32) if t.dtype == torch.bool else t.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def barrier(group=None) -> None:
    if group_size(group) > 1:
        dist.barrier(group=group)
