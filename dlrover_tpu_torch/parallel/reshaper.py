"""The in-process reshape's state mover (port of
dlrover_tpu/parallel/reshaper.py).

The JAX package moves a state pytree onto new shardings inside one
process: every leaf's ``device_put`` is dispatched device-to-device, and
only the leaves whose shards died with a host come through a checkpoint
fallback. Here each card is a process, so a reshape re-forms the process
group and each rank fills its new local shards itself:

- :func:`shard_boxes` — the global box each rank of a DeviceMesh holds
  of a leaf with given placements (DTensor's split: ``torch.chunk``
  along each sharded dim, mesh dims in order), computed from the mesh's
  rank layout alone, so it still answers after the mesh's group is gone.
- :func:`survivors_cover` — can a leaf be rebuilt from the ranks that
  survive? A replicated (or partly replicated) DTensor survives the loss
  of some ranks; one sharded across a dead rank does not. A plain tensor
  or host array is held by every rank alike and always survives.
- :func:`reshape_state` — the elastic entry point: the leaves the
  survivors cover go through ``move`` (the Trainer's mover: a slice this
  rank already holds stays on its device, the rest is read from the
  boundary save of the rank that held it, the targeted shard-wise load
  of the flash checkpoint engine), the lost ones through ``fallback`` (a
  checkpoint written before the boundary, at the live step), and the
  report says what each took.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

__all__ = ["ReshapeReport", "boxes_cover", "reshape_state", "shard_boxes",
           "survivors_cover"]


def shard_boxes(global_shape, mesh_ranks, placements) -> dict:
    """``{rank: box}``: the global region (a tuple of slices) each rank of
    a mesh holds of a leaf placed with ``placements``. ``mesh_ranks`` is
    the mesh's layout of global ranks (``DeviceMesh.mesh``, any nested
    sequence). A dim sharded over several mesh dims is split by each in
    mesh order, every split as ``torch.chunk`` cuts (uneven shards take
    the ceiling, trailing ones may be empty)."""
    layout = np.asarray(torch.as_tensor(mesh_ranks).tolist())
    boxes = {}
    for coord in np.ndindex(*layout.shape):
        ranges = [[0, int(n)] for n in global_shape]
        for mdim, pl in enumerate(placements):
            if not isinstance(pl, Shard):
                continue
            lo, hi = ranges[pl.dim]
            k = layout.shape[mdim]
            chunk = -(-(hi - lo) // k) if hi > lo else 0
            start = min(lo + coord[mdim] * chunk, hi)
            ranges[pl.dim] = [start, min(start + chunk, hi)]
        boxes[int(layout[coord])] = tuple(slice(a, b) for a, b in ranges)
    return boxes


def _volume(box) -> int:
    return math.prod(s.stop - s.start for s in box)


def boxes_cover(global_shape, mesh_ranks, placements, lost_ranks) -> bool:
    """True when the boxes that ranks outside ``lost_ranks`` hold of a leaf
    placed with ``placements`` on a mesh laid out as ``mesh_ranks`` tile
    its whole ``global_shape``."""
    lost = set(lost_ranks)
    boxes = shard_boxes(global_shape, mesh_ranks, placements)
    surviving = {box for rank, box in boxes.items() if rank not in lost}
    # distinct boxes of one placement never overlap: volumes add up
    total = math.prod(int(n) for n in global_shape)
    return bool(surviving) and sum(map(_volume, surviving)) >= total


def survivors_cover(leaf, lost_ranks) -> bool:
    """True when the boxes of ``leaf`` held by ranks outside
    ``lost_ranks`` still tile its global shape: a reshape then reads no
    byte that died with a lost rank. A plain tensor or host array is the
    same on every rank and survives while one rank does."""
    if not isinstance(leaf, DTensor) or not set(lost_ranks):
        return True
    return boxes_cover(leaf.shape, leaf.device_mesh.mesh, leaf.placements,
                       lost_ranks)


@dataclasses.dataclass
class ReshapeReport:
    """What a :func:`reshape_state` did. ``moved`` and ``pulled`` count
    the state's tensor leaves of at least one dimension (its scalars are
    host values that no reshape moves): ``moved`` those taken from ranks
    of the old world alive at the boundary, ``pulled`` those that came
    from a checkpoint written before it."""

    moved: int = 0
    pulled: int = 0
    lost_leaves: list = dataclasses.field(default_factory=list)
    seconds: float = 0.0       # total wall-clock of the reshape
    move_seconds: float = 0.0  # the mover's leg
    bytes_moved: int = 0


def _is_array(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dim() > 0


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, DTensor):
        leaf = leaf.to_local()
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def reshape_state(
    leaves: list,
    targets: list,
    names: list,
    move: Callable,
    lost_ranks=(),
    fallback: Optional[Callable] = None,
):
    """Move a state's leaves onto new placements.

    ``leaves`` are the live state's leaves (DTensors on the old mesh,
    tensors, host arrays), ``targets`` the same leaves laid out on the
    new mesh (their values unused), and ``names`` the flash checkpoint
    engine's leaf names of both, in the same order. ``lost_ranks``: old
    ranks that died with their state; a leaf whose surviving boxes do
    not tile it is LOST. ``move({name: target})`` must return ``{name:
    new leaf}`` for the leaves the survivors cover, ``fallback({name:
    target})`` the same for the lost ones (read from a checkpoint at the
    live step); without a fallback a lost leaf raises, as does a leaf
    either callable does not return or a count of names that does not
    match the leaves.

    Returns ``(new leaves, ReshapeReport)``."""
    t_start = time.perf_counter()
    if not (len(names) == len(leaves) == len(targets)):
        raise ValueError(f"{len(names)} names for {len(leaves)} leaves and "
                         f"{len(targets)} targets")
    movable, lost = [], []
    for i, leaf in enumerate(leaves):
        (movable if survivors_cover(leaf, lost_ranks) else lost).append(i)
    report = ReshapeReport(
        moved=sum(_is_array(leaves[i]) for i in movable),
        pulled=sum(_is_array(leaves[i]) for i in lost),
        lost_leaves=[names[i] for i in lost],
    )
    if lost and fallback is None:
        raise ValueError(
            f"{len(lost)} leaves lost their only shards (e.g. "
            f"{report.lost_leaves[:3]}) and no fallback loader was given "
            "- cannot reshape without losing state")
    out: list = [None] * len(leaves)
    for indices, loader, what in ((movable, move, "mover"),
                                  (lost, fallback, "fallback loader")):
        if not indices:
            continue
        t0 = time.perf_counter()
        got = loader({names[i]: targets[i] for i in indices})
        missing = [names[i] for i in indices if names[i] not in got]
        if missing:
            raise ValueError(f"the {what} did not return leaves "
                             f"{missing[:3]} ({len(missing)} in all)")
        for i in indices:
            out[i] = got[names[i]]
        if loader is move:
            report.move_seconds = time.perf_counter() - t0
            report.bytes_moved = sum(_leaf_nbytes(out[i]) for i in indices)
    report.seconds = time.perf_counter() - t_start
    logger.info("reshaped state: %d array leaves moved (%.1f MB, %.3f s), "
                "%d pulled from a checkpoint, %.3f s in all", report.moved,
                report.bytes_moved / 1e6, report.move_seconds,
                report.pulled, report.seconds)
    return out, report
