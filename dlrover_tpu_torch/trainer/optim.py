"""Optimizer factory (the counterpart of ``_build_optimizer`` in
dlrover_tpu/trainer/trainer.py for adamw, sgd and adam8bit), and the
optimizer's state as a checkpoint tree (the Trainer's Flash Checkpoint).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from dlrover_tpu_torch.optimizers import adam8bit


def build_optimizer(
    optimizer: str = "adamw",
    learning_rate: float = 1e-3,
    weight_decay: float = 0.0,
) -> Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]:
    """Return ``params -> torch.optim.Optimizer`` for ``auto_accelerate``.

    ``adamw`` is ``torch.optim.AdamW`` with the ``weight_decay`` passed
    explicitly: torch's own default is 0.01, while the JAX trainer's
    ``optax.adamw`` receives ``TrainingArgs.weight_decay`` (0.0 by
    default). Betas (0.9, 0.999) and eps 1e-8 are optax's defaults too.
    ``sgd`` is plain SGD, as ``optax.sgd(lr)``. ``adam8bit`` is
    ``optimizers.adam8bit(lr, weight_decay=weight_decay)``, per-leaf
    8-bit moments on the K5/K6 kernels. ``agd`` is not ported yet
    (ROADMAP Queue 1 item 9)."""
    if optimizer == "adamw":
        return lambda params: torch.optim.AdamW(
            params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay)
    if optimizer == "sgd":
        return lambda params: torch.optim.SGD(params, lr=learning_rate)
    if optimizer == "adam8bit":
        return adam8bit(learning_rate, weight_decay=weight_decay)
    if optimizer == "agd":
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet (ROADMAP Queue 1 "
            "item 9)")
    raise ValueError(f"unknown optimizer {optimizer!r}")


# ----------------------------------------------- optimizer state <-> tree


def materialize_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Create the zeroed per-param state ``torch.optim.Adam``/``AdamW``
    build at their first step, as they build it, so a checkpoint tree
    taken before step 1 names every moment a later checkpoint holds.
    The first step then finds the state and uses it as it would have
    created it; other optimizers are left as they are."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return
    from torch.optim.optimizer import _get_scalar_dtype

    for group in optimizer.param_groups:
        on_device = group.get("capturable") or group.get("fused")
        for p in group["params"]:
            state = optimizer.state[p]
            if state:
                continue
            state["step"] = (
                torch.zeros((), dtype=_get_scalar_dtype(
                    is_fused=group.get("fused")), device=p.device)
                if on_device
                else torch.tensor(0.0, dtype=_get_scalar_dtype()))
            keys = ["exp_avg", "exp_avg_sq"]
            if group.get("amsgrad"):
                keys.append("max_exp_avg_sq")
            for key in keys:
                state[key] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def _param_names(optimizer, params: dict) -> list:
    """The param name of each index of ``optimizer.state_dict()``."""
    name_of = {id(p): name for name, p in params.items()}
    return [name_of[id(p)] for g in optimizer.param_groups
            for p in g["params"]]


def _scalar_leaf(value):
    """A param-group or state value as a tree leaf: tensors as they are,
    numbers and bools (and tuples of them) as numpy arrays, as the JAX
    state's scalars are arrays; anything else (None, strings) stays out
    of the checkpoint."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    if isinstance(value, (bool, int, float)) or (
            isinstance(value, tuple) and value
            and all(isinstance(v, (bool, int, float)) for v in value)):
        return np.asarray(value)
    return None


def optimizer_state_tree(optimizer: torch.optim.Optimizer,
                         params: dict) -> dict:
    """``optimizer.state_dict()`` as a checkpoint tree: ``state`` by
    param name, the optimizer's own non-param entries (a count, flat
    moments) under ``extra``, and the param groups' hyperparameters
    under ``param_groups``."""
    sd = optimizer.state_dict()
    names = _param_names(optimizer, params)
    state, extra = {}, {}
    for key, value in sd["state"].items():
        if isinstance(key, int):
            state[names[key]] = {k: leaf for k, v in value.items()
                                 if (leaf := _scalar_leaf(v)) is not None}
        elif (leaf := _scalar_leaf(value)) is not None:
            extra[str(key)] = leaf
    groups = [{k: leaf for k, v in g.items()
               if k != "params" and (leaf := _scalar_leaf(v)) is not None}
              for g in sd["param_groups"]]
    return {"state": state, "extra": extra, "param_groups": groups}


def _like(restored, live):
    """A restored leaf in the type of the live value it replaces."""
    if isinstance(live, (torch.Tensor, np.ndarray)):
        return restored
    value = np.asarray(restored)
    if isinstance(live, tuple):
        return tuple(type(v)(x) for v, x in zip(live, value.tolist()))
    return type(live)(value.item())


def restore_optimizer_state(optimizer: torch.optim.Optimizer, params: dict,
                            tree: dict) -> None:
    """Load a tree of :func:`optimizer_state_tree` into ``optimizer``
    through ``load_state_dict``."""
    sd = optimizer.state_dict()
    names = _param_names(optimizer, params)
    new_state = {}
    for index, name in enumerate(names):
        saved = tree["state"].get(name)
        if saved:
            live = sd["state"].get(index, {})
            new_state[index] = {k: _like(v, live.get(k, v))
                                for k, v in saved.items()}
    for key, value in sd["state"].items():
        if not isinstance(key, int):
            saved = tree["extra"].get(str(key))
            new_state[key] = value if saved is None else _like(saved,
                                                               value)
    groups = []
    for live, saved in zip(sd["param_groups"], tree["param_groups"]):
        group = dict(live)
        group.update({k: _like(v, live[k]) for k, v in saved.items()
                      if k in live})
        groups.append(group)
    optimizer.load_state_dict({"state": new_state, "param_groups": groups})
