"""The models' explicit collectives on a ``DeviceMesh`` (the explicit
form of what GSPMD derives for the JAX package's annotated arrays, and
of its ``_sharded_flash`` shard_map, dlrover_tpu/models/llama.py).

The params are DTensors placed by the rule table (parallel/sharding.py),
stacked per layer as ``llama_init`` lays them. A model takes each stack's
local shard once (:meth:`ShardContext.local`), and in each layer:

- gathers the layer's slice over every mesh axis but ``tensor`` that
  shards it (``fsdp`` under the default rules): an all-gather whose
  backward is a reduce-scatter (:class:`_AllGather`), so the gradient
  lands summed and sharded, as ZeRO-3's does. Under a checkpointed
  layer the gather runs again in the backward, as FSDP's
  reshard-after-forward does;
- computes on local tensors: its ``H/t`` heads, ``M/t`` mlp columns and
  ``V/t`` vocab rows, so the attention kernels see plain tensors;
- enters a column-parallel product through :meth:`to_tensor` (identity,
  its backward sums over ``tensor``) and leaves a row-parallel one
  through :meth:`from_tensor` (a sum over ``tensor``, its backward the
  identity): Megatron's f and g. Every tensor rank then holds the same
  activations and the same loss;
- on the ``expert`` axis the same f and g (:meth:`expert_group`) wrap
  the MoE FFN (parallel/moe.py): the rows are replicated over the axis
  as over ``tensor``, each rank runs its own experts, whose stacks it
  does not gather, and the partial outputs are summed.

Rows split over ``data`` and ``fsdp``, and the sequence over a ``seq``
dim (the ring or Ulysses over its sub-group, parallel/sequence.py): a
rank's loss is its tokens' term of the global mean, and the gradient of
a param replicated over one of these token axes is that axis' sum,
taken after the backward (the step redistributes each gradient from
``Partial`` to its param's placements). The fsdp gathers and the
tensor f and g stay on their own sub-groups under a seq dim.

Everything here is a no-op on a mesh axis of size 1: on a one-rank
mesh the model path makes no collective call.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from dlrover_tpu_torch.parallel.mesh import BATCH_AXES

__all__ = ["TOKEN_AXES", "ShardContext", "shard_box"]

# the mesh axes whose ranks hold different tokens of the global batch:
# the batch axes' rows, the seq axis' slices of the sequence
TOKEN_AXES = BATCH_AXES + ("seq",)


def shard_box(global_shape, device_mesh, placements) -> tuple:
    """(local shape, global offset) of this rank's shard of a DTensor
    with ``placements``, as DTensor itself splits (uneven shards as
    ``torch.chunk`` cuts them)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        tuple(global_shape), device_mesh, list(placements))
    return tuple(int(s) for s in shape), tuple(int(o) for o in offset)


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; the backward
    reduce-scatters (sums) the gradient back to this rank's shard."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        src = grad.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=grad.dtype, device=grad.device)
        dist.reduce_scatter_tensor(out, src, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


class _CopyToGroup(torch.autograd.Function):
    """f: identity; the backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """g: sum over ``group``; the backward is the identity (every rank
    of the group holds the same downstream, counted once)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ShardContext:
    """The collectives of one ``DeviceMesh`` for a model's forward."""

    def __init__(self, device_mesh):
        self.mesh = device_mesh
        self.names = tuple(device_mesh.mesh_dim_names)
        self.tensor_size = self._size("tensor")
        self.tensor_group = (device_mesh.get_group("tensor")
                             if self.tensor_size > 1 else None)
        self.tensor_rank = (device_mesh.get_local_rank("tensor")
                            if self.tensor_size > 1 else 0)
        self.expert_size = self._size("expert")
        self._expert_pg = (device_mesh.get_group("expert")
                           if self.expert_size > 1 else None)
        # the ranks whose tokens together make the global batch
        self.batch_size = math.prod(self._size(a) for a in TOKEN_AXES)

    @classmethod
    def of(cls, params: dict) -> Optional["ShardContext"]:
        """The context of ``params``' mesh, or None for plain tensors."""
        p = next(iter(params.values()), None)
        return cls(p.device_mesh) if isinstance(p, DTensor) else None

    def _size(self, name: str) -> int:
        if name not in self.names:
            return 1
        return self.mesh.size(self.names.index(name))

    # ------------------------------------------------------------ params

    def local(self, p):
        """The local shard of a DTensor param, differentiable. Its
        gradient is declared ``Partial`` on a token axis the param is
        replicated over (each rank's tokens contribute a term); the step
        sums it there."""
        if not isinstance(p, DTensor):
            return p
        grad_placements = [
            Partial() if name in TOKEN_AXES and isinstance(pl, Replicate)
            else pl for name, pl in zip(self.names, p.placements)]
        return p.to_local(grad_placements=grad_placements)

    def gathers(self, p, drop_leading: int = 0,
                local_axes: tuple = ("tensor",)) -> tuple:
        """The (mesh dim name, tensor dim) pairs to all-gather ``p``'s
        local shard over, innermost mesh dim first: every mesh axis that
        shards it but ``local_axes``, whose shards the model computes on
        (``tensor``; ``expert`` too for the expert stacks).
        ``drop_leading`` leading dims are unbound before the gather (a
        layer stack's)."""
        if not isinstance(p, DTensor):
            return ()
        out = []
        for name, pl in reversed(list(zip(self.names, p.placements))):
            if name in local_axes or not isinstance(pl, Shard):
                continue
            if pl.dim < drop_leading:
                raise NotImplementedError(
                    f"a param sharded on its stacked dim {pl.dim} over "
                    f"{name!r}: the layer loop needs every layer on every "
                    "rank (pipe parallelism is ROADMAP Queue 1 item 10)")
            if self._size(name) > 1:
                out.append((name, pl.dim - drop_leading))
        return tuple(out)

    def gather(self, x, gathers: tuple):
        """All-gather a local shard along the dims ``gathers`` names (from
        :meth:`gathers`); its backward reduce-scatters."""
        for name, dim in gathers:
            x = _AllGather.apply(x, dim, self.mesh.get_group(name))
        return x

    def tensor_dim(self, p, axis: str = "tensor") -> Optional[int]:
        """The dim of ``p`` sharded over ``axis`` (None: replicated)."""
        if self._size(axis) == 1 or not isinstance(p, DTensor):
            return None
        pl = p.placements[self.names.index(axis)]
        return pl.dim if isinstance(pl, Shard) else None

    def expect_expert_dim(self, name: str, p, dim: int):
        """Raise unless ``p`` is sharded over ``expert`` on ``dim`` (its
        experts' dim): each expert rank runs the experts it holds. Off an
        expert axis anything goes."""
        if self.expert_size == 1:
            return
        got = self.tensor_dim(p, "expert")
        if got != dim:
            raise NotImplementedError(
                f"{name} is sharded over 'expert' on dim {got}, the MoE "
                f"layer runs each rank's experts, dim {dim}: other expert "
                "layouts are not ported (ROADMAP Queue 1 item 10)")

    def expect_tensor_dim(self, name: str, p, dim: Optional[int]):
        """Raise unless ``p`` is sharded over ``tensor`` on ``dim`` (None:
        replicated), the layout the model's local compute is written
        for. Off a tensor axis anything goes."""
        if self.tensor_size == 1:
            return
        got = self.tensor_dim(p)
        if got != dim:
            raise NotImplementedError(
                f"{name} is sharded over 'tensor' on dim {got}, the model "
                f"computes with it sharded on dim {dim}: other tensor "
                "layouts are not ported (ROADMAP Queue 1 item 7)")

    def offset(self, p, dim: int) -> int:
        """The global index of the first element of this rank's shard of
        ``p`` along ``dim``."""
        return shard_box(p.shape, self.mesh, p.placements)[1][dim]

    # ------------------------------------------------------ activations

    def to_tensor(self, x):
        """Megatron's f before a column-parallel product."""
        if self.tensor_group is None:
            return x
        return _CopyToGroup.apply(x, self.tensor_group)

    def from_tensor(self, x):
        """Megatron's g after a row-parallel product."""
        if self.tensor_group is None:
            return x
        return _ReduceFromGroup.apply(x, self.tensor_group)

    def expert_group(self, p):
        """The :class:`~dlrover_tpu_torch.parallel.moe.ExpertGroup` of the
        experts this rank holds of an expert stack ``p`` (experts on its
        dim 1), or None off an expert axis."""
        from dlrover_tpu_torch.parallel.moe import ExpertGroup

        if self._expert_pg is None:
            return None
        group = self._expert_pg
        return ExpertGroup(
            first=self.offset(p, 1),
            copy=lambda x: _CopyToGroup.apply(x, group),
            reduce=lambda x: _ReduceFromGroup.apply(x, group))

    def tensor_max(self, x):
        """Elementwise max over ``tensor``, no gradient."""
        if self.tensor_group is None:
            return x
        out = x.detach().contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.tensor_group)
        return out

    def local_rows(self, x):
        """This rank's rows of a batch leaf (a DTensor split over the batch
        axes, and over ``seq`` its slice of the sequence; or already a
        local tensor)."""
        return x.to_local() if isinstance(x, DTensor) else x

    def batch_sum(self, x):
        """``x`` summed over the token axes (data, fsdp and seq), no
        gradient."""
        out = x.detach().contiguous().clone()
        for name in TOKEN_AXES:
            if name in self.names and self._size(name) > 1:
                dist.all_reduce(out, group=self.mesh.get_group(name))
        return out

    def batch_mean(self, x):
        """``x`` averaged over the token axes, no gradient."""
        return self.batch_sum(x) / self.batch_size

    def loss_term(self, term):
        """A rank's term of the global loss as a DTensor: ``Partial`` over
        the token axes (the terms sum to the loss), ``Replicate`` over
        ``tensor`` and ``expert`` (their ranks hold the same term)."""
        placements = [Partial() if name in TOKEN_AXES else Replicate()
                      for name in self.names]
        return DTensor.from_local(term, self.mesh, placements,
                                  run_check=False)
