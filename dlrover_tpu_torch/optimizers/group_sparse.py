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

On a DeviceMesh, as the JAX package lays them there: ``mu``, ``nu`` and
``accum`` mirror the params and are DTensors placed as them; ``steps``
does not, and is a plain tensor of every row, the same on every rank.
The update runs on the local shards. A row is touched when any element
of the whole row is nonzero, so each rank's test over its part of the
rows is taken over the ranks that share them (``parallel/mesh_state.py``
``rows_any``: a MAX over the mesh dims that shard the param), and every
rank counts every row alike.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch.parallel.mesh_state import local, rows_any
from dlrover_tpu_torch.parallel.shard_ops import shard_box


def _row_mask(g: torch.Tensor) -> torch.Tensor:
    """``[rows, 1, ...]`` float mask of the rows with any nonzero grad."""
    if g.dim() < 2:
        return (g != 0).to(g.dtype)
    return (g != 0).any(dim=tuple(range(1, g.dim())),
                        keepdim=True).to(g.dtype)


def _local_grad(p: torch.Tensor) -> torch.Tensor:
    """The local shard of ``p``'s grad (zeros where it has none)."""
    return (local(p.grad) if p.grad is not None
            else torch.zeros_like(local(p)))


def _touched(p, g):
    """(float flags of the touched rows of the whole ``p``, the same on
    every rank; a bool mask of the local shard's rows shaped as
    ``_row_mask``'s; the index of those rows among ``p``'s)."""
    mask = _row_mask(g)
    if p.dim() == 0:
        return mask, mask > 0, ...
    flags = rows_any(mask.reshape(-1), p)
    start = (shard_box(p.shape, p.device_mesh, p.placements)[1][0]
             if isinstance(p, DTensor) else 0)
    rows = slice(start, start + mask.shape[0])
    return flags, flags[rows].view(mask.shape) > 0, rows


class GroupAdam(torch.optim.Optimizer):
    """Adam whose moments and bias corrections advance per row; untouched
    rows keep their state and get no update (no weight decay either)."""

    steps_on_mesh = True

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
                st, g, lp = self.state[p], _local_grad(p), local(p)
                mu, nu = local(st["mu"]), local(st["nu"])
                flags, touched, rows = _touched(p, g)
                st["steps"] += flags.view(st["steps"].shape).to(torch.int32)
                mu.copy_(torch.where(touched, b1 * mu + (1 - b1) * g, mu))
                nu.copy_(torch.where(touched, b2 * nu + (1 - b2) * g * g, nu))
                # the bias corrections of every row, then this shard's
                t = st["steps"].clamp(min=1).to(p.dtype)
                mo_hat = mu / (1 - torch.pow(b1, t))[rows]
                v_hat = nu / (1 - torch.pow(b2, t))[rows]
                upd = mo_hat / (torch.sqrt(v_hat) + eps)
                upd = torch.where(touched, upd, torch.zeros_like(upd))
                if wd:
                    upd = upd + wd * lp * touched
                lp.add_(-group["lr"] * upd)
        return loss


class GroupAdagrad(torch.optim.Optimizer):
    """Adagrad with per-row accumulators: an untouched row keeps its
    accumulator and gets no update."""

    steps_on_mesh = True

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
                g, accum = _local_grad(p), local(self.state[p]["accum"])
                touched = _touched(p, g)[1]
                accum.copy_(torch.where(touched, accum + g * g, accum))
                upd = torch.where(
                    touched, g / (torch.sqrt(accum) + group["eps"]),
                    torch.zeros_like(g))
                local(p).add_(-group["lr"] * upd)
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
