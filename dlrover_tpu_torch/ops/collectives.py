"""Decomposed (ring) collectives over a process group (port of
dlrover_tpu/ops/collectives.py).

The JAX package writes the all-gather and the reduce-scatter as N-1
``ppermute`` steps so that XLA's scheduler can interleave them with a
layer's matmuls. Here each step is one ``batch_isend_irecv`` hop to the
next rank of the group and from the previous one (as
``parallel/mesh.py`` ``ProcessGroupRing.exchange`` sends), so the ring
is N-1 independent operations a CUDA stream can place between others
(``parallel/overlap.py``'s ``"manual"`` mode runs them on a side
stream).

The JAX functions take a mesh axis' name and size inside a
``shard_map``; these take the axis' process group (a ``DeviceMesh``
dim's ``get_group``), whose size is the axis'. The contract is JAX's:

- a group of one rank is the identity;
- :func:`ring_all_gather` equals ``all_gather_into_tensor`` along
  ``dim`` (rank ``i``'s shard at tile ``i``), exactly;
- :func:`ring_reduce_scatter` gives rank ``i`` the sum of every rank's
  tile ``i`` along ``dim``, and raises ``ValueError`` when the group's
  size does not divide that dim;
- both are differentiable: the gather's gradient is the ring
  reduce-scatter and the reduce-scatter's the ring gather, as JAX's
  transpose of one ring is the other.

The partial sum for rank ``d`` starts at rank ``d + 1`` with that rank's
tile ``d`` and visits every rank once, so the summation order is the
ring's, not the library reduce-scatter's.

``ring_calls`` counts the calls of each ring (forward and backward, not
hops), for the measurement of which path ran.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["gather_into", "reduce_scatter", "ring_all_gather",
           "ring_calls", "ring_reduce_scatter"]

ring_calls = {"all_gather": 0, "reduce_scatter": 0}


def _hop(x, group):
    """Send ``x`` to the group's next rank and return what the previous
    one sends (one ``batch_isend_irecv`` of a send and a receive)."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prev = dist.get_global_rank(group, (rank - 1) % n)
    recv = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, nxt, group=group),
        dist.P2POp(dist.irecv, recv, prev, group=group)])
    for req in reqs:
        req.wait()
    return recv


def gather_into(out, x, group) -> None:
    """The ring all-gather along dim 0 into ``out`` (``n`` times ``x``'s
    rows, this rank's rows at tile ``rank``), no autograd."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    rows = x.shape[0]
    cur = x.contiguous()
    out.narrow(0, rank * rows, rows).copy_(cur)
    for t in range(1, n):
        cur = _hop(cur, group)
        out.narrow(0, ((rank - t) % n) * rows, rows).copy_(cur)
    ring_calls["all_gather"] += 1


def reduce_scatter(x, group):
    """The ring reduce-scatter (sum) along dim 0: this rank's tile of
    the sum over the group, no autograd."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of shape {tuple(x.shape)} not divisible "
                         f"by axis size {n}")
    tiles = x.chunk(n, dim=0)
    acc = tiles[(rank - 1) % n].contiguous()
    for t in range(1, n):
        acc = _hop(acc, group) + tiles[(rank - 1 - t) % n]
    ring_calls["reduce_scatter"] += 1
    return acc


def _gather(x, group, dim):
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((dist.get_world_size(group) * src.shape[0],)
                      + tuple(src.shape[1:]), dtype=x.dtype, device=x.device)
    gather_into(out, src, group)
    return out.movedim(0, dim)


def _scatter(x, group, dim):
    return reduce_scatter(x.movedim(dim, 0), group).movedim(0, dim)


class _RingAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _scatter(grad, ctx.group, ctx.dim), None, None


class _RingReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group, ctx.dim), None, None


def ring_all_gather(x, group, dim: int = 0):
    """All-gather ``x`` along ``dim`` over ``group`` as N-1 hops: the
    tiled array, the same on every rank (``all_gather_into_tensor``'s
    result)."""
    if dist.get_world_size(group) == 1:
        return x
    return _RingAllGather.apply(x, group, dim)


def ring_reduce_scatter(x, group, dim: int = 0):
    """Reduce-scatter (sum) ``x`` along ``dim`` over ``group`` as N-1
    hops: rank ``i`` gets the total of tile ``i``
    (``reduce_scatter_tensor``'s result)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} not "
                         f"divisible by axis size {n}")
    return _RingReduceScatter.apply(x, group, dim)
