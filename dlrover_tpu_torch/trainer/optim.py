"""Optimizer factory (the counterpart of ``_build_optimizer`` in
dlrover_tpu/trainer/trainer.py for adamw, sgd and adam8bit)."""

from __future__ import annotations

from typing import Callable, Iterable

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
