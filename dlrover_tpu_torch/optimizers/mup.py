"""muP (Maximal Update Parametrization) scaling helpers (port of
dlrover_tpu/optimizers/mup.py).

Tune on a small model, scale the width, keep the optimum. Two functions
over the params by name and their logical axes (``llama_logical_axes``),
and Adam whose per-param lr carries the multipliers.

Rules (Tensor Programs V, Adam variant):

- "hidden" weights (two or more dims scale with width, e.g. embed x
  mlp): lr multiplier 1/width_mult, init scaled by 1/sqrt(width_mult);
- output (readout) weights (hidden -> vocab): lr 1/width_mult, init
  scaled by 1/width_mult;
- input embeddings, biases, norms (at most one width dim): unchanged.

Everything here keys on param names, never on positions: the params
reach an optimizer factory as ``(name, tensor)`` pairs
(``auto_accelerate``), and the multipliers are looked up by name.
"""

from __future__ import annotations

from typing import Callable, Iterable, Union

import torch

# logical axis names whose size scales with model width
WIDTH_AXES = frozenset({"embed", "mlp", "heads", "kv_heads", "head_dim"})
# axis names marking the readout dimension
OUTPUT_AXES = frozenset({"vocab", "logits"})


def _classify(axes) -> str:
    """'hidden' | 'output' | 'input' from a leaf's logical axes."""
    if not axes:
        return "input"
    names = [a for a in axes if a]
    width = sum(1 for a in names if a in WIDTH_AXES)
    has_out = any(a in OUTPUT_AXES for a in names)
    if has_out and width >= 1:
        # embed x vocab: output when width feeds the readout (vocab
        # last); input embedding when vocab is the leading (lookup) dim
        return "output" if names[-1] in OUTPUT_AXES else "input"
    if width >= 2:
        return "hidden"
    return "input"


def mup_lr_multipliers(param_logical_axes: dict,
                       width_mult: float) -> dict:
    """Per-param lr multipliers for the muP Adam rules, by name."""
    return {name: (1.0 / width_mult
                   if _classify(axes) in ("hidden", "output") else 1.0)
            for name, axes in param_logical_axes.items()}


def mup_rescale_init(params: dict, param_logical_axes: dict,
                     width_mult: float) -> dict:
    """Rescale a standard init to muP at ``width_mult`` x the base width
    (new tensors, by name)."""
    out = {}
    for name, p in params.items():
        kind = _classify(param_logical_axes[name])
        if kind == "hidden":
            out[name] = p / torch.sqrt(torch.tensor(
                width_mult, dtype=p.dtype, device=p.device))
        elif kind == "output":
            out[name] = p / width_mult
        else:
            out[name] = p
    return out


def _named(params) -> list:
    """``(name, tensor)`` pairs from a dict or an iterable of pairs."""
    pairs = list(params.items() if isinstance(params, dict) else params)
    if not all(isinstance(x, tuple) and len(x) == 2
               and isinstance(x[0], str) for x in pairs):
        raise ValueError(
            "muP keys its lr multipliers on param names: give (name, "
            "tensor) pairs or a dict, as auto_accelerate does")
    return pairs


def scale_by_mup(params, param_logical_axes: dict, width_mult: float,
                 learning_rate: float) -> list:
    """Param groups for a torch optimizer, one per muP multiplier, each
    with ``lr = learning_rate * multiplier``: the counterpart of chaining
    ``scale_by_mup`` between the base transform and the learning rate."""
    mults = mup_lr_multipliers(param_logical_axes, width_mult)
    groups: dict = {}
    for name, p in _named(params):
        g = groups.setdefault(mults[name], {"params": [], "param_names": [],
                                            "lr": learning_rate
                                            * mults[name]})
        g["params"].append(p)
        g["param_names"].append(name)
    return list(groups.values())


def mup_adam(learning_rate: float, param_logical_axes: dict,
             width_mult: float, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8) -> Callable[
                 [Union[dict, Iterable]], torch.optim.Optimizer]:
    """``named params -> torch.optim.Adam`` with the muP lr rules baked
    in: one param group per multiplier (``scale_by_mup``)."""
    return lambda params: torch.optim.Adam(
        scale_by_mup(params, param_logical_axes, width_mult, learning_rate),
        lr=learning_rate, betas=(b1, b2), eps=eps)
