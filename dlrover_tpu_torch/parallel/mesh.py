"""The port's mesh, as far as a ``seq`` axis goes (the counterpart of
dlrover_tpu/parallel/mesh.py).

The JAX package lays a ``jax.sharding.Mesh`` over its devices and lets
XLA derive the collectives. Here one axis is active so far: ``seq``,
sequence (context) parallelism for ring attention. Every other axis must
be 1: data, fsdp, tensor, expert and pipe parallelism are ROADMAP Queue 1
item 7.

The seq axis runs over one of two ring transports, which carry one ring
schedule (parallel/sequence.py):

- :class:`ProcessGroupRing`, when a ``torch.distributed`` process group
  exists: the axis is the group's ranks, one process per card (NCCL;
  gloo on the CPU). :meth:`~ProcessGroupRing.shift` sends to rank + 1 and
  receives from rank - 1 in one ``batch_isend_irecv``, into fresh
  buffers; every rank shifts on every tick.
- :class:`InProcessRing`, when none exists: this process holds every rank
  of the axis on its one device (the counterpart of the JAX tests'
  virtual CPU devices), and a shift rotates a list.

:func:`build_mesh` picks by whether a process group exists and says which
in its log line and in ``Strategy.describe(mesh)``; it raises for what
neither transport runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.parallel.strategy import AXIS_ORDER, MeshConfig

logger = get_logger(__name__)

__all__ = [
    "InProcessRing", "Mesh", "MeshConfig", "ProcessGroupRing",
    "axis_index", "build_mesh", "get_mesh", "seq_ring", "set_mesh",
]


class InProcessRing:
    """Every rank of the seq axis in this process, on one device. The
    ring schedule runs each held rank's blocks in turn; only the hop
    between cards is left out."""

    kind = "in-process"

    def __init__(self, size: int):
        self.size = size
        self.ranks = tuple(range(size))

    def shift(self, blocks: list) -> list:
        """``blocks[i]`` is what rank ``ranks[i]`` holds (a list of
        tensors); each rank passes it to the next and takes the previous
        one's."""
        return [blocks[-1]] + list(blocks[:-1])

    def describe(self) -> str:
        return f"in-process, {self.size} ranks on one device"


class ProcessGroupRing:
    """The seq axis as the ranks of the default process group."""

    kind = "process-group"

    def __init__(self, size: int):
        self.size = size
        self.rank = dist.get_rank()
        self.ranks = (self.rank,)

    def shift(self, blocks: list) -> list:
        """Send this rank's tensors (``blocks`` holds one list) to rank + 1
        and return rank - 1's. Differentiable: the gradient takes the
        reverse hop."""
        (tensors,) = blocks
        return [list(_Shift.apply(self, *tensors))]

    def exchange(self, tensors, step: int) -> list:
        """Send ``tensors`` to rank + step, receive the same shapes from
        rank - step into fresh buffers."""
        dst, src = (self.rank + step) % self.size, (self.rank - step) % self.size
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in tensors]
        ops = ([dist.P2POp(dist.isend, t, dst) for t in sends]
               + [dist.P2POp(dist.irecv, t, src) for t in recvs])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recvs

    def all_reduce(self, tensor):
        """Sum ``tensor`` over the ranks, in place."""
        dist.all_reduce(tensor)
        return tensor

    def describe(self) -> str:
        return (f"process-group ({dist.get_backend()}), rank {self.rank} of "
                f"{self.size}")


class _Shift(torch.autograd.Function):
    """One hop of the process-group ring; its gradient hops back."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        return tuple(ring.exchange(tensors, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.ring.exchange(grads, -1))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (every axis of ``AXIS_ORDER``) and the seq axis'
    transport (None when the axis is 1)."""

    shape: dict
    ring: Optional[object] = None


def build_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The mesh of ``config``. An axis of -1 absorbs what the others
    leave of the process group's ranks (1 without a group). Raises for
    any axis but seq above 1, and for a process group whose size is not
    the seq axis'."""
    config = config or MeshConfig()
    sizes = {a: getattr(config, a) for a in AXIS_ORDER}
    world = dist.get_world_size() if dist.is_initialized() else None
    if world is not None and sizes["seq"] not in (-1, world):
        raise ValueError(
            f"the process group has {world} ranks but the seq axis "
            f"{sizes['seq']}: the seq axis must span the whole group")
    wildcard = [a for a, s in sizes.items() if s == -1]
    if len(wildcard) > 1:
        raise ValueError(f"only one axis may be -1, got {wildcard}")
    if wildcard:
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if world is not None and world % fixed:
            raise ValueError(f"{world} ranks not divisible by the fixed "
                             f"axes' {fixed}")
        sizes[wildcard[0]] = 1 if world is None else world // fixed
    wide = {a: s for a, s in sizes.items() if a != "seq" and s != 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: only the seq axis is ported; data, fsdp, "
            "tensor, expert and pipe parallelism are ROADMAP Queue 1 item 7")
    n = sizes["seq"]
    if n < 1:
        raise ValueError(f"seq axis must be >= 1, got {n}")
    ring = None
    if n > 1:
        ring = ProcessGroupRing(n) if world is not None else InProcessRing(n)
    logger.info("built mesh %s, seq transport: %s", sizes,
                ring.describe() if ring else "none")
    return Mesh(shape=sizes, ring=ring)


_global_mesh: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _global_mesh
    _global_mesh = mesh


def get_mesh() -> Mesh:
    """The process-global mesh set by :func:`set_mesh`."""
    if _global_mesh is None:
        raise RuntimeError("no mesh: call build_mesh()+set_mesh() first")
    return _global_mesh


def seq_ring():
    """The seq transport of the active mesh, or None when there is no
    mesh or its seq axis is 1."""
    return None if _global_mesh is None else _global_mesh.ring


def axis_index(axis: str) -> int:
    """This process's index along ``axis``: its rank in the process
    group. With the in-process transport this process holds every index
    of the axis; the first, 0, is returned. 0 on an inactive axis."""
    ring = get_mesh().ring
    return ring.ranks[0] if axis == "seq" and ring is not None else 0
