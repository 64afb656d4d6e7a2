"""Group sparse optimizers: per-row adaptive state for embedding tables
(port of dlrover_tpu/optimizers/group_sparse.py).

"Group" means each embedding row is its own optimization group: its
moments and its bias-correction step count advance only on steps where
the row was touched, so a rarely seen feature keeps a fresh adaptive
scale instead of one decayed by every step it took no part in. A row is
touched when any element of its grad is nonzero (a lookup's backward
leaves zero rows elsewhere). The update is a dense masked computation
over the whole table.

State per param, created with the optimizer: ``steps`` (int32, one per
row: ``[rows, 1, ...]``, a 0-d count for a 0-d param), ``mu``, ``nu``
(``GroupAdam``); ``accum`` (``GroupAdagrad``).
"""

from __future__ import annotations

from typing import Callable

import torch


def _row_mask(g: torch.Tensor) -> torch.Tensor:
    """``[rows, 1, ...]`` float mask of the rows with any nonzero grad."""
    if g.dim() < 2:
        return (g != 0).to(g.dtype)
    return (g != 0).any(dim=tuple(range(1, g.dim())),
                        keepdim=True).to(g.dtype)


def _grad(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


class GroupAdam(torch.optim.Optimizer):
    """Adam whose moments and bias corrections advance per row; untouched
    rows keep their state and get no update (no weight decay either)."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        for group in self.param_groups:
            for p in group["params"]:
                rows = (() if p.dim() == 0
                        else (p.shape[0],) + (1,) * (p.dim() - 1))
                self.state[p] = {
                    "steps": torch.zeros(rows, dtype=torch.int32,
                                         device=p.device),
                    "mu": torch.zeros_like(p),
                    "nu": torch.zeros_like(p),
                }

    def load_state_dict(self, state_dict):
        """torch casts every state tensor to its param's dtype on load:
        put the row counts back in int32 (their values are integers)."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st["steps"] = st["steps"].to(torch.int32)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            wd = group["weight_decay"]
            for p in group["params"]:
                st, g = self.state[p], _grad(p)
                m = _row_mask(g)
                touched = m > 0
                st["steps"] += m.to(torch.int32)
                st["mu"] = torch.where(touched, b1 * st["mu"] + (1 - b1) * g,
                                       st["mu"])
                st["nu"] = torch.where(
                    touched, b2 * st["nu"] + (1 - b2) * g * g, st["nu"])
                t = st["steps"].clamp(min=1).to(p.dtype)
                mo_hat = st["mu"] / (1 - torch.pow(b1, t))
                v_hat = st["nu"] / (1 - torch.pow(b2, t))
                upd = mo_hat / (torch.sqrt(v_hat) + eps)
                upd = torch.where(touched, upd, torch.zeros_like(upd))
                if wd:
                    upd = upd + wd * p * touched
                p.add_(-group["lr"] * upd)
        return loss


class GroupAdagrad(torch.optim.Optimizer):
    """Adagrad with per-row accumulators: an untouched row keeps its
    accumulator and gets no update."""

    def __init__(self, params, lr: float = 1e-2,
                 initial_accumulator: float = 0.1, eps: float = 1e-10):
        super().__init__(params, dict(lr=lr, eps=eps))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {
                    "accum": torch.full_like(p, initial_accumulator)}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                st, g = self.state[p], _grad(p)
                touched = _row_mask(g) > 0
                st["accum"] = torch.where(touched, st["accum"] + g * g,
                                          st["accum"])
                upd = torch.where(
                    touched, g / (torch.sqrt(st["accum"]) + group["eps"]),
                    torch.zeros_like(g))
                p.add_(-group["lr"] * upd)
        return loss


def group_adam(learning_rate: float = 1e-3, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0) -> Callable:
    """``params -> GroupAdam`` (the JAX ``group_adam``)."""
    return lambda params: GroupAdam(params, lr=learning_rate, b1=b1, b2=b2,
                                    eps=eps, weight_decay=weight_decay)


def group_adagrad(learning_rate: float = 1e-2,
                  initial_accumulator: float = 0.1,
                  eps: float = 1e-10) -> Callable:
    """``params -> GroupAdagrad`` (the JAX ``group_adagrad``)."""
    return lambda params: GroupAdagrad(
        params, lr=learning_rate, initial_accumulator=initial_accumulator,
        eps=eps)
