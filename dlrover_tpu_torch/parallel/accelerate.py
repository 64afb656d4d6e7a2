"""``auto_accelerate`` — from (loss fn, init fn, optimizer) to a train step
(port of dlrover_tpu/parallel/accelerate.py for one device).

The step keeps the JAX step's semantics: fp32 master params are cast to
the compute dtype for the forward and backward, gradients land in fp32
on the masters, ``grad_accum`` microbatches are averaged, the optimizer
steps and ``step`` advances. PyTorch is stateful, so the step updates the
state in place (params, optimizer moments) instead of returning fresh
buffers; that keeps one copy of the model state in device memory, which
is what ``Strategy.donate`` buys the JAX step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.device import resolve_device
from dlrover_tpu_torch.ops.fused_optim import tree_order
from dlrover_tpu_torch.parallel.strategy import (
    AXIS_ORDER,
    DEFAULT_RULES,
    Strategy,
)

logger = get_logger(__name__)

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class TrainState:
    """Train state: step count, fp32 master params, the optimizer (which
    holds the moments)."""

    step: int
    params: dict
    optimizer: torch.optim.Optimizer


@dataclasses.dataclass
class AccelerateResult:
    """What auto_accelerate hands back."""

    strategy: Strategy
    device: torch.device
    state: TrainState
    train_step: Callable  # (state, batch, rng) -> (state, metrics)


def _check_strategy(strategy: Strategy) -> None:
    # -1 absorbs the remaining devices: 1 on one device
    wide = {a: getattr(strategy.mesh, a) for a in AXIS_ORDER
            if getattr(strategy.mesh, a) not in (1, -1)}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} need more than one device; multi-GPU "
            "parallelism is ROADMAP Queue 1 item 7")
    if strategy.remat != "none":
        raise NotImplementedError(
            f"remat={strategy.remat!r}: only 'none' is ported (numerics do "
            "not depend on remat; ROADMAP Queue 1 item 7)")
    if strategy.compute_dtype not in _COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype={strategy.compute_dtype!r} is not ported yet "
            "(fp8/int8: ROADMAP Queue 1 item 12)")
    if strategy.overlap_collectives != "off":
        raise NotImplementedError(
            "overlap_collectives needs a sharded mesh (ROADMAP Queue 1 "
            "item 7)")
    if not strategy.donate:
        raise NotImplementedError(
            "donate=False: the port's step always updates the state in "
            "place; keeping the old buffers is not ported (ROADMAP Queue 1 "
            "item 7)")
    if strategy.quant_sites != "all":
        raise NotImplementedError(
            f"quant_sites={strategy.quant_sites!r} selects int8/fp8 matmul "
            "sites, not ported yet (ROADMAP Queue 1 item 12)")
    if tuple(tuple(r) for r in strategy.rules) != DEFAULT_RULES:
        raise NotImplementedError(
            "custom logical sharding rules need a sharded mesh (ROADMAP "
            "Queue 1 item 7)")
    if int(strategy.grad_accum) < 1:
        raise ValueError(f"grad_accum must be >= 1, got {strategy.grad_accum}")


def auto_accelerate(
    loss_fn: Callable,  # (params, batch, rng) -> scalar loss
    init_fn: Callable,  # (seed, device) -> dict of fp32 params
    optimizer_factory: Callable,  # iterable of params -> torch Optimizer
    strategy: Optional[Strategy] = None,
    device=None,
    seed: int = 0,
) -> AccelerateResult:
    """Build the state and the train step for ``strategy`` on one device
    (``cuda`` unless ``device`` says otherwise).

    ``optimizer_factory`` receives the params in the JAX package's leaf
    order (``ops.fused_optim.tree_order`` of their names).
    ``strategy.fused_optim`` is recorded, as in the JAX package: the
    optimizer factory acts on it (``adam8bit(fused=True)``,
    ``fused_adamw``), the step does not change.

    ``train_step(state, batch, rng)`` takes a dict batch of arrays or
    tensors (moved to the device), runs ``strategy.grad_accum``
    microbatches split along dim 0, applies the optimizer and returns
    ``(state, {"loss": ...})``; the loss is the microbatch mean, a 0-d
    f32 tensor on the device.
    """
    strategy = strategy or Strategy()
    _check_strategy(strategy)
    device = resolve_device(device)
    compute_dtype = _COMPUTE_DTYPES[strategy.compute_dtype]
    accum = int(strategy.grad_accum)

    params = {
        name: p.to(device=device, dtype=torch.float32).requires_grad_()
        for name, p in init_fn(seed, device).items()
    }
    # the optimizer sees the params in the JAX package's leaf order, so
    # that flat optimizer state and per-leaf seeds line up with JAX's
    state = TrainState(step=0, params=params, optimizer=optimizer_factory(
        [params[name] for name in tree_order(params)]))

    def to_device(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    def train_step(state: TrainState, batch, rng):
        batch = {k: to_device(v) for k, v in batch.items()}
        for k, v in batch.items():
            if v.ndim < 1 or v.shape[0] % accum:
                raise ValueError(
                    f"batch[{k!r}] dim {tuple(v.shape)} not divisible by "
                    f"grad_accum={accum}")
        micro = [
            {k: v.chunk(accum)[i] for k, v in batch.items()}
            for i in range(accum)
        ]
        loss_sum = torch.zeros((), device=device)
        for mb in micro:
            cparams = {n: p.to(compute_dtype)
                       for n, p in state.params.items()}
            loss = loss_fn(cparams, mb, rng)
            # grads accumulate in fp32 on the masters; /accum averages
            (loss / accum).backward()
            loss_sum += loss.detach().float()
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss_sum / accum}

    logger.info("auto_accelerate ready on %s: %s", device,
                strategy.describe())
    return AccelerateResult(strategy=strategy, device=device, state=state,
                            train_step=train_step)
