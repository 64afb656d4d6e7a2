"""Mixture-of-Experts FFN (port of dlrover_tpu/parallel/moe.py).

The GShard formulation of the JAX package, on plain tensors:

- tokens live in groups ``[G, T, D]`` (G = the batch rows);
- :func:`top_k_gating` routes each token to its top-k experts in f32
  with per-expert capacity C, slot-major priority (every token's first
  choice beats any token's second choice), the Switch load-balancing
  loss on first choices and the router z-loss, and gives the one-hot
  ``dispatch`` and weighted ``combine`` tensors ``[G, T, E, C]``;
- :func:`moe_ffn` dispatches with one einsum to ``[E, G, C, D]``, runs
  the stacked SwiGLU experts as batched matmuls and combines back.

``dispatch`` and ``combine`` are scattered from each kept route's
(expert, position) pair: the JAX package's ``[G, T, k, E, C]`` einsum
operand, k times the result's size, is never formed. Ties in the router
go to the lower expert index, as ``jax.lax.top_k`` breaks them.

Expert parallelism (the ``expert`` mesh axis, models/llama.py): the rows
are replicated over the axis and each rank holds ``E/n`` experts. Every
rank routes all tokens; its FFN dispatches them to its own experts only,
and the partial outputs are summed over the axis. ``moe_ffn`` takes the
axis as an :class:`ExpertGroup`: the gate values and the FFN's input
enter through its ``copy`` (identity; the backward sums over the axis),
the output leaves through its ``reduce`` (a sum; the backward is the
identity). The router's own gradient is then whole on every rank.

No kernel: as in the JAX package, where this module is plain ``jnp``,
the gating, the dispatch and the expert GEMMs are torch ops.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

__all__ = ["ExpertGroup", "MoEConfig", "moe_ffn", "moe_init",
           "record_metrics", "top_k_gating"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25

    def capacity(self, tokens_per_group: int) -> int:
        c = int(self.capacity_factor * self.top_k * tokens_per_group
                / self.n_experts)
        return max(c, self.top_k)


@dataclasses.dataclass(frozen=True)
class ExpertGroup:
    """This rank's share of the experts on an ``expert`` axis: the global
    index of its first expert, and the axis' f (``copy``) and g
    (``reduce``) collectives."""

    first: int
    copy: Callable
    reduce: Callable


@dataclasses.dataclass
class _Routes:
    """Each (token, slot)'s expert, position in its expert's buffer and
    gate value, whether it fits the capacity, and the metrics."""

    expert: torch.Tensor   # [G, T, k] int64
    position: torch.Tensor  # [G, T, k] int64
    kept: torch.Tensor     # [G, T, k] f32, 1 where within capacity
    gate: torch.Tensor     # [G, T, k] f32, renormalised
    capacity: int
    metrics: dict


def _top_k(probs, k: int):
    """Top-k along the last dim, ties to the lower index (a stable sort:
    ``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routes(logits, config: MoEConfig, batch_mean=None) -> _Routes:
    """The JAX package's gating up to its dispatch einsums, in f32.
    ``batch_mean`` (no gradient) averages the first-choice share over
    the batch ranks, so that each rank's aux loss is its term of the
    global one (see :func:`top_k_gating`)."""
    g, t, e = logits.shape
    k, c = config.top_k, config.capacity(t)
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert = _top_k(probs, k)                          # [G,T,k]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    masks = F.one_hot(expert, e).float()                     # [G,T,k,E]
    # slot-major priority: all 1st choices first, then 2nd choices
    flat = masks.transpose(1, 2).reshape(g, k * t, e)
    pos = (flat.cumsum(dim=1) - flat).reshape(g, k, t, e).transpose(1, 2)
    within = (pos < c).float() * masks                       # [G,T,k,E]
    position = (pos * within).sum(dim=-1).long()             # [G,T,k]
    kept = within.sum(dim=-1)                                # [G,T,k]

    # Switch-style load-balancing loss on 1st-choice routing
    me = probs.mean(dim=(0, 1))                              # [E]
    ce = masks[:, :, 0, :].mean(dim=(0, 1))                  # [E]
    if batch_mean is not None:
        ce = batch_mean(ce)
    z = torch.logsumexp(logits, dim=-1)
    metrics = {
        "aux_loss": e * (me * ce).sum(),
        "z_loss": (z ** 2).mean(),
        # the share of (token, slot) routes dropped by capacity
        "dropped": 1.0 - kept.sum() / (g * t * k),
    }
    _record(metrics)
    return _Routes(expert, position, kept, gate, c, metrics)


def _scatter(routes: _Routes, values, first: int, count: int):
    """``[G, T, count, C]``: each kept route's value at (its expert -
    ``first``, its position); the routes to other experts drop out."""
    g, t, _ = routes.expert.shape
    c = routes.capacity
    local = routes.expert - first
    mine = (local >= 0) & (local < count)
    index = local.clamp(0, count - 1) * c + routes.position
    src = values * routes.kept * mine
    out = values.new_zeros((g, t, count * c))
    return out.scatter_add(-1, index, src).view(g, t, count, c)


def top_k_gating(logits, config: MoEConfig, batch_mean=None):
    """Top-k routing with capacity. logits: [G, T, E].

    Returns (dispatch [G,T,E,C] f32 of 0/1, combine [G,T,E,C] f32,
    metrics: ``aux_loss``, ``z_loss`` and ``dropped``), the JAX
    package's. With ``batch_mean`` (a mean over the batch ranks, no
    gradient) the first-choice share is the global batch's, so the aux
    losses of the ranks average to the global one, gradients included:
    with that share fixed the loss is linear in each rank's mean
    probabilities."""
    routes = _routes(logits, config, batch_mean)
    e = logits.shape[-1]
    dispatch = _scatter(routes, torch.ones_like(routes.gate), 0, e)
    combine = _scatter(routes, routes.gate, 0, e)
    return dispatch, combine, routes.metrics


def moe_init(seed: int, n_experts: int, dim: int, mlp_dim: int,
             device=None) -> dict:
    """Stacked expert weights (llama-style gated FFN) and router, drawn
    as the JAX package's ``moe_init`` draws them: N(0, 1/fan_in)."""
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed)

    def normal(shape, fan_in):
        std = fan_in ** -0.5
        return torch.randn(shape, generator=gen, device=device) * std

    return {
        "router": normal((dim, n_experts), dim),
        "w_gate": normal((n_experts, dim, mlp_dim), dim),
        "w_up": normal((n_experts, dim, mlp_dim), dim),
        "w_down": normal((n_experts, mlp_dim, dim), mlp_dim),
    }


def moe_ffn(x, params, config: MoEConfig,
            group: Optional[ExpertGroup] = None, batch_mean=None):
    """MoE feed-forward. x: [G, T, D] in the compute dtype. Returns
    (y [G, T, D], metrics).

    ``params``: ``router`` [D, E] and the experts' ``w_gate``/``w_up``
    [E', D, M], ``w_down`` [E', M, D], E' = E, or this rank's E/n under
    ``group``. The router runs in the compute dtype, the gating in f32,
    dispatch and combine are cast back, then the JAX package's
    ``egcd`` dispatch, ``silu(x w_gate) * (x w_up)``, ``w_down`` and the
    ``gtd`` combine. ``batch_mean``: see :func:`top_k_gating`."""
    dtype = x.dtype
    routes = _routes(x @ params["router"].to(dtype), config, batch_mean)
    w_gate = params["w_gate"].to(dtype)
    w_up = params["w_up"].to(dtype)
    w_down = params["w_down"].to(dtype)
    count = w_gate.shape[0]
    first, gate = 0, routes.gate
    if group is not None:
        first = group.first
        x, gate = group.copy(x), group.copy(gate)
    dispatch = _scatter(routes, torch.ones_like(gate), first, count)
    combine = _scatter(routes, gate, first, count)
    dispatch, combine = dispatch.to(dtype), combine.to(dtype)

    # [E', G, C, D]: the tokens in their experts' buffers
    expert_in = torch.einsum("gtec,gtd->egcd", dispatch, x)
    h = F.silu(torch.einsum("egcd,edm->egcm", expert_in, w_gate))
    h = h * torch.einsum("egcd,edm->egcm", expert_in, w_up)
    expert_out = torch.einsum("egcm,emd->egcd", h, w_down)
    y = torch.einsum("egcd,gtec->gtd", expert_out, combine)
    if group is not None:
        y = group.reduce(y)
    return y, routes.metrics


# ---------------------------------------------------------------------------
# the metrics of each MoE layer a step runs
# ---------------------------------------------------------------------------

_recording: list = []


def _record(metrics: dict) -> None:
    if _recording:
        _recording[-1].append({k: v.detach() for k, v in metrics.items()})


@contextlib.contextmanager
def record_metrics():
    """Collect each gating's metrics (detached 0-d tensors) while active:
    yields a list that gets one dict per MoE layer call, in call order
    (a layer checkpoint's recompute in the backward adds its own)."""
    out: list = []
    _recording.append(out)
    try:
        yield out
    finally:
        _recording.pop()
