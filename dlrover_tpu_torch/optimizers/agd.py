"""AGD: auto-switchable optimizer preconditioned by gradient differences
(port of dlrover_tpu/optimizers/agd.py).

The second moment accumulates the squared difference of successive
bias-corrected first moments, and the update switches between SGD-like
scaling (where ``sqrt(nu_hat)`` is clamped at ``delta``) and adaptive
scaling. Per step, with ``t`` the step count and ``bc_i = 1 - b_i**t``:

- ``mu_t = (1-b1)*g + b1*mu_{t-1}`` (optax's ``incremental_update``);
- ``diff_t = mu_t/bc1_t - mu_{t-1}/bc1_{t-1}``, just ``mu_1/bc1_1`` at
  t = 1;
- ``nu_t = b2*nu_{t-1} + (1-b2)*diff_t**2`` (with ``amsgrad`` the running
  maximum of ``nu`` takes its place in the denominator);
- ``u = (mu_t/bc1_t) / max(sqrt(nu_t/bc2_t), delta)``, clipped to
  ``[-clip, clip]`` when ``clip`` is set;
- then, as the JAX chain ``scale_by_agd -> add_decayed_weights ->
  scale_by_learning_rate`` does, ``p += -lr * (u + weight_decay * p)``.

The math runs as ``torch._foreach_*`` ops over each group's params (the
JAX package has no Pallas kernel for AGD either). The bias corrections
are f32, as JAX computes them on the device. The step count is global,
as JAX's ``ScaleByAgdState.count``: ``state["count"]``, beside each
param's ``mu``/``nu`` (and ``max_nu`` only with ``amsgrad``), all
created with the optimizer.

On a DeviceMesh the moments are DTensors placed as their params (JAX
shards a state that mirrors the params as the params), and the
``_foreach`` ops run on the local shards (``parallel/mesh_state.py``
``local``): the unsharded step's operations on the same elements.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from dlrover_tpu_torch.ops.fused_optim import Schedule, _bias_correction
from dlrover_tpu_torch.parallel.mesh_state import local


class AGD(torch.optim.Optimizer):
    """AGD with decoupled (AdamW-style) weight decay. A param without a
    grad counts as a zero grad, as in the JAX step, whose grad tree is
    whole. ``lr`` may be a schedule of the pre-increment count
    (``optax.scale_by_schedule``)."""

    steps_on_mesh = True

    def __init__(self, params, lr: Union[float, Schedule] = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, delta: float = 1e-5,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 clip: Optional[float] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, delta=delta,
                                      weight_decay=weight_decay,
                                      amsgrad=amsgrad, clip=clip))
        self.state["count"] = 0
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st["mu"] = torch.zeros_like(p, dtype=torch.float32)
                st["nu"] = torch.zeros_like(p, dtype=torch.float32)
                if group["amsgrad"]:
                    st["max_nu"] = torch.zeros_like(p, dtype=torch.float32)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        count = self.state["count"]
        t = count + 1
        for group in self.param_groups:
            self._group_step(group, count, t)
        self.state["count"] = t
        return loss

    def _group_step(self, group, count: int, t: int) -> None:
        b1, b2, delta = group["b1"], group["b2"], group["delta"]
        if not group["params"]:
            return
        # the local shards of DTensor params and moments
        params = [local(p) for p in group["params"]]
        grads = [local(p.grad).float() if p.grad is not None
                 else torch.zeros_like(lp, dtype=torch.float32)
                 for p, lp in zip(group["params"], params)]
        states = [self.state[p] for p in group["params"]]
        mus = [local(st["mu"]) for st in states]
        nus = [local(st["nu"]) for st in states]
        bc1 = _bias_correction(b1, t)
        bc2 = _bias_correction(b2, t)
        # the previous bias-corrected moment, before mu moves
        old = (torch._foreach_div(mus, max(_bias_correction(b1, count),
                                           1e-38))
               if t > 1 else None)
        new = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_mul_(mus, 1.0 - (1 - b1))
        torch._foreach_add_(mus, new)
        del new, grads
        diff = torch._foreach_div(mus, bc1)
        if old is not None:
            torch._foreach_sub_(diff, old)
            del old
        sq = torch._foreach_mul(diff, 1 - b2)
        torch._foreach_mul_(sq, diff)
        del diff
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, sq)
        del sq
        if group["amsgrad"]:
            max_nus = [local(st["max_nu"]) for st in states]
            torch._foreach_maximum_(max_nus, nus)
            nus = max_nus
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_clamp_min_(den, delta)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, den)
        del den
        if group["clip"] is not None:
            torch._foreach_clamp_min_(upd, -group["clip"])
            torch._foreach_clamp_max_(upd, group["clip"])
        if group["weight_decay"]:
            wd = torch._foreach_mul(params, group["weight_decay"])
            torch._foreach_add_(upd, wd)
            del wd
        lr = group["lr"]
        lr = lr(count) if callable(lr) else lr
        torch._foreach_mul_(upd, -float(lr))
        torch._foreach_add_(params, upd)


def agd(
    learning_rate: Union[float, Schedule] = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    delta: float = 1e-5,
    weight_decay: float = 0.0,
    amsgrad: bool = False,
    clip: Optional[float] = None,
) -> Callable:
    """``params -> AGD``: AGD with decoupled (AdamW-style) weight decay,
    the JAX ``agd``'s chain."""
    return lambda params: AGD(params, lr=learning_rate, b1=b1, b2=b2,
                              delta=delta, weight_decay=weight_decay,
                              amsgrad=amsgrad, clip=clip)
