"""WSAM: sharpness-aware minimization with a weighted sharpness term
(port of dlrover_tpu/optimizers/wsam.py).

The loss is regularized by weighted sharpness ``L + gamma/(1-gamma) *
(L(w+eps) - L(w))``. With ``alpha = gamma/(1-gamma)`` the coupled
gradient given to the base optimizer is ``g + alpha*(g_adv - g)``. The
default mode is decoupled: the base optimizer steps on the plain
gradient, then ``lr*alpha*(g_adv - g)`` is subtracted from the weights,
outside the base optimizer's preconditioning.

A step runs two forward and backward passes: the plain one at ``w``, and
the adversarial one at ``w + eps``, ``eps = rho * g / (|g| + sam_eps)``
(``|g|`` the global norm; ``adaptive`` scales ``eps`` by ``w**2``). The
weights are perturbed in place for the second pass and put back bit for
bit from a copy before anything steps.

Here ``params`` is the dict of leaf tensors the loss takes and the base
optimizer updates (``loss_fn(params, batch, rng)``, as
``auto_accelerate``'s); grads come from ``torch.autograd.grad``, so no
``.grad`` is left behind but the one the base optimizer steps on.

On a DeviceMesh (DTensor params, as ``auto_accelerate`` lays them out)
each gradient is first placed as its param (a ``Partial`` batch axis
summed, ``parallel/mesh_state.py`` ``placed_as``), ``|g|`` is the norm of
the global gradient (``global_norm``: local sums of squares reduced
over the mesh dims that shard each leaf), and the weights move on
their local shards.
"""

from __future__ import annotations

from typing import Callable

import torch

from dlrover_tpu_torch.parallel.mesh_state import (
    global_norm,
    local,
    placed_as,
)


def _alpha(gamma: float) -> float:
    if gamma >= 1.0:
        raise ValueError(f"gamma must be < 1, got {gamma}")
    return gamma / (1.0 - gamma)


def wsam_update(grads: dict, adv_grads: dict, gamma: float = 0.9) -> dict:
    """Coupled WSAM gradient ``g + alpha*(g_adv - g)``,
    alpha = gamma/(1-gamma): gamma 0 gives the plain gradient, 0.5 the
    SAM gradient, the default 0.9 over-weights the sharpness term."""
    alpha = _alpha(gamma)
    return {k: g + alpha * (adv_grads[k] - g) for k, g in grads.items()}


def _grads(loss_fn, params: dict, batch, rng, has_aux: bool):
    out = loss_fn(params, batch, rng)
    loss = out[0] if has_aux else out
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names])
    return out, {k: placed_as(g, params[k]) for k, g in zip(names, grads)}


@torch.no_grad()
def _perturb(params: dict, grads: dict, rho: float, adaptive: bool,
             eps: float) -> dict:
    """Move ``params`` in place to ``w + eps``; returns copies of ``w``."""
    scale = rho / (global_norm(list(grads.values())) + eps)
    saved = {k: local(p).clone() for k, p in params.items()}
    for k, p in params.items():
        lp, g = local(p), local(grads[k])
        if adaptive:
            lp.add_(torch.square(lp) * g * scale)
        else:
            lp.add_(scale * g)
    return saved


@torch.no_grad()
def _restore(params: dict, saved: dict) -> None:
    for k, p in params.items():
        local(p).copy_(saved[k])


def _adversarial(loss_fn, params, batch, rng, grads, rho, adaptive,
                 sam_eps, has_aux) -> dict:
    saved = _perturb(params, grads, rho, adaptive, sam_eps)
    try:
        _, adv = _grads(loss_fn, params, batch, rng, has_aux)
    finally:
        _restore(params, saved)
    return adv


def make_wsam_grad_fn(
    loss_fn: Callable,
    rho: float = 0.05,
    gamma: float = 0.9,
    has_aux: bool = False,
    adaptive: bool = False,
    sam_eps: float = 1e-12,
) -> Callable:
    """Returns ``grad_fn(params, batch, rng) -> (out, grads)``: the
    coupled WSAM direction by name. For the default decoupled step use
    :func:`make_wsam_step_fn`."""
    _alpha(gamma)

    def wsam_grad(params, batch, rng):
        out, grads = _grads(loss_fn, params, batch, rng, has_aux)
        adv = _adversarial(loss_fn, params, batch, rng, grads, rho,
                           adaptive, sam_eps, has_aux)
        return out, wsam_update(grads, adv, gamma)

    return wsam_grad


def make_wsam_step_fn(
    loss_fn: Callable,
    base_optimizer: torch.optim.Optimizer,
    learning_rate,
    rho: float = 0.05,
    gamma: float = 0.9,
    decouple: bool = True,
    adaptive: bool = False,
    has_aux: bool = False,
    sam_eps: float = 1e-12,
) -> Callable:
    """One WSAM step over ``base_optimizer``, which holds ``params``.

    Returns ``step(params, batch, rng, step=None) -> out``, updating the
    params in place. Decoupled (the default): the base optimizer steps on
    the plain gradient, then ``lr*alpha*(g_adv - g)`` is subtracted from
    the weights. ``decouple=False`` gives the base optimizer the coupled
    blend. ``learning_rate`` is the base optimizer's: a float, or a
    schedule, which then needs ``step`` so that the sharpness term
    follows the decayed lr."""
    alpha = _alpha(gamma)

    def step(params, batch, rng, step=None):
        if callable(learning_rate):
            if step is None:
                raise ValueError(
                    "learning_rate is a schedule: pass the current step "
                    "to make_wsam_step_fn's step(..., step=...)")
            lr = learning_rate(step)
        else:
            lr = learning_rate
        out, grads = _grads(loss_fn, params, batch, rng, has_aux)
        adv = _adversarial(loss_fn, params, batch, rng, grads, rho,
                           adaptive, sam_eps, has_aux)
        feed = grads if decouple else wsam_update(grads, adv, gamma)
        for k, p in params.items():
            p.grad = feed[k]
        base_optimizer.step()
        base_optimizer.zero_grad(set_to_none=True)
        if decouple:
            with torch.no_grad():
                for k, p in params.items():
                    local(p).sub_((lr * alpha)
                                  * (local(adv[k]) - local(grads[k])))
        return out

    return step
