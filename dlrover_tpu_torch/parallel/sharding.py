"""Logical-axis sharding rules over a ``DeviceMesh`` (the counterpart of
dlrover_tpu/parallel/sharding.py).

Models name each array's dims with logical axes ("embed", "mlp",
"heads", ...) and the rule table (``strategy.DEFAULT_RULES``) maps them
to mesh axes; changing the parallelism changes the rule table, never
the model code. The JAX package turns a rule's result into a
``PartitionSpec`` for GSPMD; here the same spec becomes DTensor
placements: a mesh axis that shards tensor dim ``i`` is ``Shard(i)`` on
that axis' DeviceMesh dim, every other DeviceMesh dim is
``Replicate()``. Mesh axes that are not dims of the DeviceMesh (size 1)
drop out.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)

from dlrover_tpu_torch.parallel.strategy import DEFAULT_RULES, LogicalRules

__all__ = [
    "logical_to_mesh_axes", "placements_for", "logical_placements",
    "shard_logical", "distribute_logical", "tree_logical_placements",
]


def logical_to_mesh_axes(
    logical_axes: Optional[Sequence[Optional[str]]],
    rules: Optional[LogicalRules] = None,
) -> tuple:
    """The mesh axes of each dim, as the JAX package's
    ``logical_to_mesh_axes`` gives them (a ``PartitionSpec``'s entries:
    None, a mesh axis, or a tuple of them; trailing Nones dropped).

    An axis may appear only once: a later dim that maps to a used axis
    falls back to replicated (flax.linen.partitioning's resolution)."""
    if logical_axes is None:
        return ()
    table = dict(rules if rules is not None else DEFAULT_RULES)
    out, used = [], set()
    for name in logical_axes:
        axis = table.get(name) if name is not None else None
        if axis is not None:
            flat = (axis,) if isinstance(axis, str) else tuple(axis)
            if any(a in used for a in flat):
                axis = None
            else:
                used.update(flat)
        out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements_for(spec: tuple, device_mesh) -> tuple:
    """DTensor placements on ``device_mesh`` of a spec from
    :func:`logical_to_mesh_axes`. Where one tensor dim takes several mesh
    axes, they must come in the DeviceMesh's dim order (the first one
    major, as in JAX); a reversed order raises."""
    names = device_mesh.mesh_dim_names
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        flat = (entry,) if isinstance(entry, str) else tuple(entry)
        present = [a for a in flat if a in names]
        order = [names.index(a) for a in present]
        if order != sorted(order):
            raise NotImplementedError(
                f"dim {dim} sharded over {flat}, against the mesh's axis "
                f"order {names}: a DTensor shards one dim in mesh order")
        for axis in present:
            placements[names.index(axis)] = Shard(dim)
    return tuple(placements)


def logical_placements(logical_axes, device_mesh, rules=None) -> tuple:
    """Placements on ``device_mesh`` of an array with ``logical_axes``."""
    return placements_for(logical_to_mesh_axes(logical_axes, rules),
                          device_mesh)


def distribute_logical(tensor: torch.Tensor, logical_axes, device_mesh,
                       rules=None) -> DTensor:
    """``tensor`` (the same global value on every rank) as a DTensor
    placed by its logical axes: each rank keeps its shard, with no
    communication."""
    return distribute_tensor(
        tensor, device_mesh,
        list(logical_placements(logical_axes, device_mesh, rules)),
        src_data_rank=None)


def shard_logical(x, logical_axes, rules=None):
    """Redistribute a DTensor to the placements of ``logical_axes`` (the
    JAX package's ``with_sharding_constraint`` by logical names); a plain
    tensor passes through unchanged, as the JAX one does without a
    mesh."""
    if not isinstance(x, DTensor):
        return x
    placements = logical_placements(logical_axes, x.device_mesh, rules)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, list(placements))


def tree_logical_placements(axes_tree: dict, device_mesh,
                            rules=None) -> dict:
    """Placements of each leaf of a flat ``{name: logical axes}`` tree."""
    return {name: logical_placements(axes, device_mesh, rules)
            for name, axes in axes_tree.items()}
