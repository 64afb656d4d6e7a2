"""What an optimizer step needs of a ``DeviceMesh``: the port's side of
the JAX package's ``compute_state_shardings``
(dlrover_tpu/parallel/accelerate.py).

The JAX package gives an optimizer-state subtree the params' shardings
only when it mirrors the params leaf for leaf (AdamW-style ``mu`` and
``nu``); everything else is replicated: ``fused_adamw``'s flat moments,
``adam8bit``'s codes and scales, group Adam's row counts. GSPMD then
computes each update over the global arrays. Here:

- a param-shaped moment is a DTensor placed as its param
  (``zeros_like``), and an elementwise step runs on the local shards
  (:func:`local`): the same operations on the same elements as the
  unsharded step;
- a replicated state is a plain tensor of the global layout, the same
  on every rank. A step that updates it takes every param and grad
  whole (:func:`whole`: all-gathered where sharded), updates the whole
  arrays as the unsharded step does, and each rank writes its own shard
  of each param back (:func:`write_local`);
- :func:`global_norm` is the norm of the global arrays from local
  shards: each leaf's sum of squares over its shard, summed over the
  mesh dims that shard it, counted once over the dims that replicate it;
- :func:`rows_any` is a per-row test (group Adam's "was this row
  touched") taken over every rank that holds a part of the row.

Each function takes plain tensors too, and then computes what the
unsharded step computes, with no collective. ``gathered["leaves"]``
counts the leaves :func:`whole` all-gathered, for the measurement of
the step's collectives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from dlrover_tpu_torch.parallel.shard_ops import shard_box

__all__ = ["gathered", "global_norm", "local", "placed_as", "rows_any",
           "whole", "write_local"]

gathered = {"leaves": 0}


def local(x):
    """A DTensor's local shard (the same storage: in-place writes reach
    the DTensor); anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def placed_as(g, p):
    """A DTensor gradient redistributed to its param ``p``'s placements
    (a ``Partial`` batch axis summed there); anything else as it is."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _partial(x) -> bool:
    return any(isinstance(pl, Partial) for pl in x.placements)


def whole(x):
    """``x``'s global value as a plain contiguous tensor on this rank:
    a DTensor's local shard itself when it already is the whole array
    (a one-rank mesh, a replicated param), so that writes reach the
    DTensor; else the global value gathered (and summed where
    ``Partial``) into a fresh tensor. A plain tensor or None as it is."""
    if not isinstance(x, DTensor):
        return x
    loc = x.to_local()
    if (not _partial(x) and tuple(loc.shape) == tuple(x.shape)
            and loc.is_contiguous()):
        return loc
    gathered["leaves"] += 1
    return x.full_tensor().contiguous()


def write_local(p, full) -> None:
    """Copy this rank's shard of ``full`` (``p``'s global value) into
    ``p``'s local shard; nothing to do when ``full`` is that shard
    (:func:`whole` returned it) or ``p`` is a plain tensor."""
    if not isinstance(p, DTensor):
        return
    loc = p.to_local()
    if full.data_ptr() == loc.data_ptr():
        return
    shape, offset = shard_box(p.shape, p.device_mesh, p.placements)
    loc.copy_(full[tuple(slice(o, o + n) for o, n in zip(offset, shape))])


def _sharding_dims(x) -> list:
    """The DeviceMesh dims of size above 1 that shard ``x``."""
    return [d for d, pl in enumerate(x.placements)
            if isinstance(pl, Shard) and x.device_mesh.size(d) > 1]


def global_norm(tensors):
    """The l2 norm of the global arrays (None entries skipped; None when
    there are none), optax.global_norm's order: per-leaf sums of squares
    in order, summed, one sqrt. A DTensor leaf's sum is its local
    shard's, all-reduced over the mesh dims that shard it and taken once
    over the dims that replicate it; a ``Partial`` one is summed first.
    Stays on the device (no host sync)."""
    sums = []
    for t in tensors:
        if t is None:
            continue
        if not isinstance(t, DTensor):
            sums.append(torch.sum(torch.square(t.float())))
            continue
        if _partial(t):
            t = t.redistribute(t.device_mesh, [
                Replicate() if isinstance(pl, Partial) else pl
                for pl in t.placements])
        s = torch.sum(torch.square(t.to_local().float()))
        for d in _sharding_dims(t):
            dist.all_reduce(s, group=t.device_mesh.get_group(d))
        sums.append(s)
    return torch.sqrt(sum(sums)) if sums else None


def rows_any(flags, p):
    """``flags`` marks (1, else 0) the rows of ``p``'s local shard (its
    leading dim; the elements of a 1-d ``p``) that hold a nonzero there.
    Returns the flags of every row of the global ``p``, the same on
    every rank: a row is marked where any rank's part of it is (a MAX
    over the mesh dims that shard ``p``: its rows' split or their
    trailing dims'). A plain ``p``'s flags as they are."""
    if not isinstance(p, DTensor) or p.dim() == 0:
        return flags
    shape, offset = shard_box(p.shape, p.device_mesh, p.placements)
    out = flags.new_zeros(p.shape[0])
    out[offset[0]:offset[0] + shape[0]] = flags
    for d in _sharding_dims(p):
        dist.all_reduce(out, op=dist.ReduceOp.MAX,
                        group=p.device_mesh.get_group(d))
    return out
