"""The port's mesh (the counterpart of dlrover_tpu/parallel/mesh.py).

The JAX package lays a ``jax.sharding.Mesh`` over its devices and lets
XLA derive the collectives. Here the axes run one of two ways:

- over a ``torch.distributed`` process group, one process per card:
  :func:`build_mesh` lays a ``DeviceMesh`` over the group's ranks with
  the dims of size above 1 plus ``data`` and ``fsdp`` (the batch axes),
  in ``AXIS_ORDER``, as the JAX package lays devices (``seq`` inside
  ``data``/``fsdp``/``expert``, outside ``tensor``). The state lives on
  it as DTensors placed by the logical rule table
  (parallel/sharding.py), and the models gather and reduce explicitly
  (models/llama.py);
- ``seq``, sequence (context) parallelism for ring or Ulysses
  attention, over one of two transports that carry one schedule
  (parallel/sequence.py): :class:`ProcessGroupRing`, when the group
  holds one seq rank a process (the axis is a dim of the DeviceMesh and
  the ring runs over its sub-group; NCCL, gloo on the CPU;
  :meth:`~ProcessGroupRing.shift` sends to the next seq coordinate and
  receives from the previous one in one ``batch_isend_irecv``, into
  fresh buffers; :meth:`~ProcessGroupRing.all_to_all` is one
  ``all_to_all_single`` over the sub-group); and :class:`InProcessRing`,
  when this process holds every rank of the axis on its one device (no
  process group, or a group whose ranks the other axes use up, beside
  their DeviceMesh: the counterpart of a JAX process's several local
  devices; a shift rotates a list, an all-to-all regroups it).

Without a process group every axis but ``seq`` must be 1. ``pipe`` is
ROADMAP Queue 1 item 10's: it raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.parallel.strategy import AXIS_ORDER, MeshConfig

logger = get_logger(__name__)

__all__ = [
    "InProcessRing", "Mesh", "MeshConfig", "MeshError", "ProcessGroupRing",
    "axis_index", "axis_size", "batch_place", "build_mesh", "get_mesh",
    "layout", "reform_process_group", "resolve_sizes", "seq_ring",
    "set_mesh",
]

# the mesh axes a batch is split over; a DeviceMesh always has them
BATCH_AXES = ("data", "fsdp")


class MeshError(ValueError):
    """A mesh that does not fit the process group, the model or the
    batch (axis sizes, heads or a sequence an axis does not divide): a
    strategy search records its candidate as infeasible."""


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

    def all_to_all(self, xs: list, split_dim: int, concat_dim: int) -> list:
        """``xs[i]`` is what rank ``ranks[i]`` holds; each rank cuts its
        tensor into ``size`` chunks along ``split_dim`` and sends chunk
        r to rank r, which concatenates what it receives along
        ``concat_dim`` in rank order (``lax.all_to_all(tiled=True)``)."""
        chunks = [x.chunk(self.size, dim=split_dim) for x in xs]
        return [torch.cat([c[r] for c in chunks], dim=concat_dim)
                for r in range(self.size)]

    def describe(self) -> str:
        return f"in-process, {self.size} ranks on one device"


class ProcessGroupRing:
    """The seq axis as a process group: the DeviceMesh's ``seq``
    sub-group, one seq rank a process. ``rank`` is this process's seq
    coordinate, the P2P peers the sub-group's neighbours (as global
    ranks)."""

    kind = "process-group"

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = (self.rank,)
        self._peers = [dist.get_global_rank(group, r)
                       for r in range(self.size)]

    def shift(self, blocks: list) -> list:
        """Send this rank's tensors (``blocks`` holds one list) to the next
        seq coordinate and return the previous one's. Differentiable: the
        gradient takes the reverse hop."""
        (tensors,) = blocks
        return [list(_Shift.apply(self, *tensors))]

    def exchange(self, tensors, step: int) -> list:
        """Send ``tensors`` to seq coordinate rank + step, receive the same
        shapes from rank - step into fresh buffers."""
        dst = self._peers[(self.rank + step) % self.size]
        src = self._peers[(self.rank - step) % self.size]
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in tensors]
        ops = ([dist.P2POp(dist.isend, t, dst, self.group) for t in sends]
               + [dist.P2POp(dist.irecv, t, src, self.group) for t in recvs])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recvs

    def all_to_all(self, xs: list, split_dim: int, concat_dim: int) -> list:
        """As :meth:`InProcessRing.all_to_all`, over the sub-group (``xs``
        holds this rank's tensor). Differentiable: the gradient takes
        the inverse all-to-all."""
        (x,) = xs
        return [_AllToAll.apply(x, split_dim, concat_dim, self.group)]

    def describe(self) -> str:
        return (f"process-group ({dist.get_backend()}), seq rank "
                f"{self.rank} of {self.size}")


class _Shift(torch.autograd.Function):
    """One hop of the process-group ring; its gradient hops back."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        return tuple(ring.exchange(tensors, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.ring.exchange(grads, -1))


def _all_to_all(x, split_dim: int, concat_dim: int, group):
    """One ``all_to_all_single`` over ``group``: chunk r of ``x`` along
    ``split_dim`` to the group's rank r, the received chunks concatenated
    along ``concat_dim`` in rank order."""
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all`; its gradient goes back by the inverse one."""

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims = split_dim, concat_dim, group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim, group = ctx.dims
        return (_all_to_all(grad, concat_dim, split_dim, group), None, None,
                None)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (every axis of ``AXIS_ORDER``), the seq axis'
    transport (None when the axis is 1), and the ``DeviceMesh`` over the
    process group (None without one)."""

    shape: dict
    ring: Optional[object] = None
    device_mesh: Optional[DeviceMesh] = None

    @property
    def sharded(self) -> bool:
        return self.device_mesh is not None


def resolve_sizes(config: MeshConfig, world: Optional[int]) -> dict:
    """Every axis' size: an axis of -1 absorbs what the others leave of
    ``world`` ranks (1 without a process group, ``world`` None)."""
    sizes = {a: getattr(config, a) for a in AXIS_ORDER}
    wildcard = [a for a, s in sizes.items() if s == -1]
    if len(wildcard) > 1:
        raise MeshError(f"only one axis may be -1, got {wildcard}")
    if wildcard:
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if world is not None and world % fixed:
            raise MeshError(f"{world} ranks not divisible by the fixed "
                             f"axes' {fixed}")
        sizes[wildcard[0]] = 1 if world is None else world // fixed
    bad = {a: s for a, s in sizes.items() if s < 1}
    if bad:
        raise MeshError(f"mesh axes must be >= 1 (or one -1), got {bad}")
    return sizes


def _fits(config: MeshConfig, world: int) -> Optional[dict]:
    """``config``'s sizes when they use exactly ``world`` ranks, else
    None."""
    try:
        sizes = resolve_sizes(config, world)
    except MeshError:
        return None
    return sizes if math.prod(sizes.values()) == world else None


def layout(config: MeshConfig, world: Optional[int]) -> tuple:
    """(sizes, seq_in_process): the axis sizes of ``config`` over
    ``world`` ranks (None: no process group), and whether this process
    holds every rank of the seq axis. Over a group the axes use its
    ranks one seq rank a process when they can; else, with ``seq`` above
    1, the other axes must use them and the seq axis runs in each
    process beside their DeviceMesh (with a warning where a -1 axis took
    the ranks the seq axis could not: each process then holds the whole
    sequence). Any other split (a process holding some of the seq ranks)
    raises."""
    if world is None:
        sizes = resolve_sizes(config, None)
        return sizes, sizes["seq"] > 1
    sizes = _fits(config, world)
    if sizes is not None:
        return sizes, False
    if config.seq > 1:
        rest = _fits(dataclasses.replace(config, seq=1), world)
        if rest is not None:
            sizes = dict(rest, seq=config.seq)
            if world > 1 and -1 in (getattr(config, a) for a in AXIS_ORDER):
                logger.warning(
                    "mesh %s on %d ranks: seq=%d does not fit one seq rank "
                    "a process, so the -1 axis takes the ranks and every "
                    "process holds all %d seq ranks (the sequence is not "
                    "sharded across processes)", sizes, world, config.seq,
                    config.seq)
            return sizes, True
    sizes = resolve_sizes(config, world)
    used = math.prod(sizes.values())
    held = (f"; a process would hold {config.seq * world // used} of "
            f"the {config.seq} seq ranks" if config.seq > 1 else "")
    raise MeshError(
        f"mesh axes {sizes} use {used} ranks, the process group has "
        f"{world}: the axes must use the group's ranks (one seq rank a "
        f"process), or the axes but seq must, the seq axis then held "
        f"whole by each process{held}")


def _check_axes(sizes: dict, world: Optional[int]) -> None:
    """Raise for what no transport runs yet."""
    wide = {a: s for a, s in sizes.items() if s > 1}
    if world is None and set(wide) - {"seq"}:
        raise NotImplementedError(
            f"mesh axes {wide} without a process group: this process "
            "holds one card, so every axis but seq must be 1; data, fsdp, "
            "expert and tensor run over a torch.distributed process group, "
            "one process per card (ROADMAP Queue 1 item 7); pipe is item "
            "10")
    if "pipe" in wide:
        raise NotImplementedError(
            f"mesh axes {wide}: pipeline parallelism is not ported yet "
            "(ROADMAP Queue 1 item 10)")


def build_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The mesh of ``config``. An axis of -1 absorbs what the others
    leave of the process group's ranks (1 without a group).

    With a process group the axes become a ``DeviceMesh`` over it (on
    the group's device type: ``cuda`` under NCCL, ``cpu`` under gloo),
    ranks laid out row-major in ``AXIS_ORDER`` as the JAX package lays
    devices. A seq axis of one rank a process is a dim of it, its ring
    the dim's sub-group; a seq axis the other axes leave no ranks for
    runs in process beside it (see :func:`layout`). Raises for the rest
    (see :func:`_check_axes`)."""
    config = config or MeshConfig()
    world = dist.get_world_size() if dist.is_initialized() else None
    explicit = {a: getattr(config, a) for a in AXIS_ORDER}
    _check_axes({a: s for a, s in explicit.items() if s != -1}, world)
    sizes, in_process = layout(config, world)
    _check_axes(sizes, world)
    n = sizes["seq"]
    ring, device_mesh = None, None
    if world is not None:
        dims = tuple(a for a in AXIS_ORDER
                     if (sizes[a] > 1 or a in BATCH_AXES)
                     and not (a == "seq" and in_process))
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        device_mesh = init_device_mesh(
            device_type, tuple(sizes[a] for a in dims),
            mesh_dim_names=dims)
    if n > 1:
        ring = (InProcessRing(n) if in_process
                else ProcessGroupRing(device_mesh.get_group("seq")))
    logger.info("built mesh %s, seq transport: %s, device mesh: %s", sizes,
                ring.describe() if ring else "none",
                dict(zip(device_mesh.mesh_dim_names, device_mesh.shape))
                if device_mesh is not None else "none")
    return Mesh(shape=sizes, ring=ring, device_mesh=device_mesh)


def reform_process_group(url: str, rank: int, size: int, device) -> bool:
    """Leave this process's default process group, if it has one (locally:
    a dead peer is never waited on), and join a new one of ``size`` ranks
    at ``rank`` through the store at ``url`` (a ``tcp://host:port`` or
    ``file://`` URL ``init_process_group`` takes; a bare ``host:port`` is
    tcp): NCCL on a ``cuda`` device, gloo on the CPU. A group of one
    without a URL is none. Returns whether a group was formed. The
    in-process reshape's re-forming; a DeviceMesh built before it belongs
    to the group it left."""
    if dist.is_initialized():
        dist.destroy_process_group()
    if size <= 1 and not url:
        return False
    if "://" not in url:
        url = f"tcp://{url}"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=url, rank=rank,
                            world_size=size)
    logger.info("formed a %s process group: rank %d of %d at %s", backend,
                rank, size, url)
    return True


def batch_place(config: Optional[MeshConfig] = None) -> tuple:
    """(index, count) of this process's replica along the batch axes
    (``data`` x ``fsdp``, data major) under ``config`` over the process
    group; (0, 1) without one. A data sampler takes these, not the
    global rank: the tensor ranks of one replica must read the same
    rows, and so must its seq ranks (each takes its slice of the
    sequence from the same rows). Needs no DeviceMesh: the ranks are
    laid out row-major in ``AXIS_ORDER``, as :func:`build_mesh` lays
    them (an in-process seq axis takes no ranks)."""
    config = config or MeshConfig()
    if not dist.is_initialized():
        return 0, 1
    sizes, in_process = layout(config, dist.get_world_size())
    coord, rest = {}, dist.get_rank()
    for axis in reversed(AXIS_ORDER):
        size = 1 if axis == "seq" and in_process else sizes[axis]
        coord[axis] = rest % size
        rest //= size
    return (coord["data"] * sizes["fsdp"] + coord["fsdp"],
            sizes["data"] * sizes["fsdp"])


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


def axis_size(axis: str) -> int:
    """The size of ``axis`` on the active mesh."""
    return get_mesh().shape.get(axis, 1)


def axis_index(axis: str) -> int:
    """This process's index along ``axis``. On the seq axis: its seq
    coordinate (its rank in the DeviceMesh's seq sub-group); with the
    in-process transport this process holds every index of the axis,
    and the first, 0, is returned. On an axis
    of the DeviceMesh: its coordinate there. 0 on an inactive axis."""
    mesh = get_mesh()
    if axis == "seq":
        return mesh.ring.ranks[0] if mesh.ring is not None else 0
    dm = mesh.device_mesh
    if dm is not None and axis in dm.mesh_dim_names:
        return dm.get_local_rank(axis)
    return 0
