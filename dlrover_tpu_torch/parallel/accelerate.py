"""``auto_accelerate`` — from (loss fn, init fn, optimizer) to a train step
(port of dlrover_tpu/parallel/accelerate.py for one device, or for a
``seq`` mesh axis).

The step keeps the JAX step's semantics: fp32 master params are cast to
the compute dtype for the forward and backward, gradients land in fp32
on the masters, ``grad_accum`` microbatches are averaged, the optimizer
steps and ``step`` advances. PyTorch is stateful, so the step updates the
state in place (params, optimizer moments) instead of returning fresh
buffers; that keeps one copy of the model state in device memory, which
is what ``Strategy.donate`` buys the JAX step.

A ``seq`` axis (``MeshConfig(seq=n)``) shards the sequence for ring
attention (parallel/mesh.py, parallel/sequence.py). With the in-process
transport the step is unchanged: the model runs every rank's shard.
With a process group each rank takes its slice of the shifted tokens,
its loss is weighted by its share of the valid labels, and the loss and
the gradients are summed over the group, so every rank returns the
global loss and applies the same update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.device import resolve_device
from dlrover_tpu_torch.ops.cross_entropy import IGNORE_INDEX
from dlrover_tpu_torch.ops.fused_optim import tree_order
from dlrover_tpu_torch.parallel.mesh import (
    Mesh,
    ProcessGroupRing,
    build_mesh,
    set_mesh,
)
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
    mesh: Mesh


def _check_strategy(strategy: Strategy) -> None:
    # -1 absorbs what the seq axis leaves: 1
    wide = {a: getattr(strategy.mesh, a) for a in AXIS_ORDER
            if a != "seq" and getattr(strategy.mesh, a) not in (1, -1)}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: only the seq axis is ported; data, fsdp, "
            "tensor, expert and pipe parallelism are ROADMAP Queue 1 item 7")
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


def _seq_slice(batch, ring):
    """This rank's slice of a token batch: the shifted inputs and labels
    of its sequence shard (the shift comes first, so a shard's last
    label is the next shard's first token)."""
    if set(batch) != {"tokens"}:
        raise ValueError("a seq process group slices batch['tokens'] and "
                         f"takes no other key, got {sorted(batch)}")
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    if inputs.shape[1] % ring.size:
        raise ValueError(f"a seq axis of {ring.size} ranks does not divide "
                         f"the sequence of {inputs.shape[1]}")
    shard = inputs.shape[1] // ring.size
    cut = slice(ring.rank * shard, (ring.rank + 1) * shard)
    return {"tokens": inputs[:, cut], "labels": labels[:, cut]}


def auto_accelerate(
    loss_fn: Callable,  # (params, batch, rng) -> scalar loss
    init_fn: Callable,  # (seed, device) -> dict of fp32 params
    optimizer_factory: Callable,  # iterable of params -> torch Optimizer
    strategy: Optional[Strategy] = None,
    device=None,
    seed: int = 0,
) -> AccelerateResult:
    """Build the state and the train step for ``strategy`` on one device
    (``cuda`` unless ``device`` says otherwise), and set its mesh as the
    active one; each ``train_step`` sets it again before it runs.

    ``optimizer_factory`` receives the params in the JAX package's leaf
    order (``ops.fused_optim.tree_order`` of their names).
    ``strategy.fused_optim`` is recorded, as in the JAX package: the
    optimizer factory acts on it (``adam8bit(fused=True)``,
    ``fused_adamw``), the step does not change.

    ``train_step(state, batch, rng)`` takes a dict batch of arrays or
    tensors (moved to the device), runs ``strategy.grad_accum``
    microbatches split along dim 0, applies the optimizer and returns
    ``(state, {"loss": ...})``; the loss is the microbatch mean, a 0-d
    f32 tensor on the device. Under a seq process group ``batch`` is the
    whole batch on every rank (``tokens`` [B, S+1], S divisible by the
    seq size) and the loss is the global one.
    """
    strategy = strategy or Strategy()
    _check_strategy(strategy)
    device = resolve_device(device)
    mesh = build_mesh(strategy.mesh)
    set_mesh(mesh)
    # a process group splits the batch; the in-process ring needs nothing
    group = mesh.ring if isinstance(mesh.ring, ProcessGroupRing) else None
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
        # the model reads the seq ring from the active mesh: make it this
        # step's, whatever was set since, so a step that slices shards
        # always runs the ring it was built for
        set_mesh(mesh)
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
            if group is not None:
                mb = _seq_slice(mb, group)
                valid = (mb["labels"] != IGNORE_INDEX).sum().float()
                # this rank's mean, weighted by its share of the labels
                share = valid / group.all_reduce(valid.clone()).clamp(min=1)
                loss = loss_fn(cparams, mb, rng) * share
            else:
                loss = loss_fn(cparams, mb, rng)
            # grads accumulate in fp32 on the masters; /accum averages
            (loss / accum).backward()
            loss_sum += loss.detach().float()
        if group is not None:
            for p in state.params.values():
                if p.grad is not None:
                    group.all_reduce(p.grad)
            group.all_reduce(loss_sum)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss_sum / accum}

    logger.info("auto_accelerate ready on %s: %s", device,
                strategy.describe(mesh))
    return AccelerateResult(strategy=strategy, device=device, state=state,
                            train_step=train_step, mesh=mesh)
