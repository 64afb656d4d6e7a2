"""``auto_accelerate`` — from (loss fn, init fn, optimizer) to a train step
(port of dlrover_tpu/parallel/accelerate.py: one device with an
in-process ``seq`` axis, or the ``data``, ``fsdp``, ``expert``, ``seq``
and ``tensor`` axes over a process group).

The step keeps the JAX step's semantics: fp32 master params are cast to
the compute dtype for the forward and backward, the loss runs under the
strategy's remat (parallel/remat.py: ``"minimal"``, ``"offload"`` and
``"full"`` checkpoint it whole; ``"none"`` also turns off the model's
per-layer checkpoints), gradients land in fp32 on the masters,
``grad_accum`` microbatches are averaged, the optimizer steps and
``step`` advances. PyTorch is stateful, so the step updates the
state in place (params, optimizer moments) instead of returning fresh
buffers; that keeps one copy of the model state in device memory, which
is what ``Strategy.donate`` buys the JAX step.

A ``seq`` axis (``MeshConfig(seq=n)``) shards the sequence for ring
attention (parallel/mesh.py, parallel/sequence.py). With the in-process
transport the step is unchanged: the model runs every rank's shard.
Over a process group (one seq rank a process) ``seq`` is a dim of the
DeviceMesh: each rank takes its seq coordinate's slice of its replica's
shifted tokens, its loss is its tokens' term of the global mean
(``Partial`` over ``seq`` as over the batch axes), and each gradient is
summed over ``seq`` where it is redistributed to its param's
placements, so every rank returns the global loss and applies the same
update.

Low-precision compute (``compute_dtype`` "fp8" or "int8", the JAX
package's): the masters are cast to bf16 and each microbatch's loss runs
under ``quant_autocast(mode, sites=strategy.quant_sites)``, so that the
models' tagged matmuls (ops/fp8.py ``qdot``/``qeinsum``) run on the fp8
or int8 tensor cores. On a CUDA device, "fp8" needs compute capability
8.9 (Ada, Hopper) and "int8" 8.0; below that the step raises rather than
emulate. A quant mode on a process group (a DeviceMesh) raises:
per-tensor fp8 scales over local shards are not the global tensor's
(ROADMAP Queue 1 item 12).

A process group lays a ``DeviceMesh`` over its ranks
(parallel/mesh.py). Each fp32
master param becomes a DTensor placed by its logical axes under the
strategy's rule table (parallel/sharding.py), built on every rank from
the same seed-made global tensor, as the JAX package's jitted init gives
every device its shard of the same global values; the optimizer's
state is laid out as the JAX package's ``compute_state_shardings`` lays
it (parallel/mesh_state.py: moments that mirror the params are DTensors
placed as them, the rest replicated). ``batch`` is this rank's rows: its
share, by its
``(data, fsdp)`` index (``mesh.batch_place``), of the global batch; the
seq ranks of a replica get the same rows. The loss function gets
DTensor params (cast to the compute dtype) and a DTensor batch,
``Shard(0)`` over ``data`` and ``fsdp``, ``Shard(1)`` over ``seq`` (the
rank's slice) and ``Replicate`` over ``tensor``. A plain loss function
runs on them through DTensor's sharding propagation, as GSPMD runs the
JAX one; the models take their
local shards and gather explicitly (parallel/shard_ops.py). The loss it
returns is a DTensor (the models': ``Partial`` over the token axes);
after the backward each gradient is redistributed to its param's
placements (a ``Partial`` batch axis is summed there), the optimizer
steps on the DTensors, and the step returns the global loss on every
rank. Under ``Strategy.overlap_collectives`` the models' layer loops
issue each layer's fsdp gathers one layer ahead (parallel/overlap.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.device import resolve_device
from dlrover_tpu_torch.ops.fp8 import QUANT_MODES, quant_autocast
from dlrover_tpu_torch.ops.fused_optim import tree_order
from dlrover_tpu_torch.parallel import remat as remat_lib
from dlrover_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    Mesh,
    MeshError,
    ProcessGroupRing,
    build_mesh,
    set_mesh,
)
from dlrover_tpu_torch.parallel.mesh_state import local, placed_as
from dlrover_tpu_torch.parallel.overlap import (
    OVERLAP_MODES,
    overlap_autocast,
    wait_pending,
)
from dlrover_tpu_torch.parallel.shard_ops import shard_box
from dlrover_tpu_torch.parallel.sharding import (
    distribute_logical,
    logical_placements,
)
from dlrover_tpu_torch.parallel.strategy import DEFAULT_RULES, Strategy

logger = get_logger(__name__)

# the dtype the masters are cast to for the forward and backward; a quant
# mode computes in bf16 around its quantized matmuls
_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                   "fp8": torch.bfloat16, "int8": torch.bfloat16}
# the least CUDA compute capability with the mode's tensor cores
_QUANT_CAPABILITY = {"fp8": (8, 9), "int8": (8, 0)}


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


# torch's optimizers that step DTensor params elementwise through
# DTensor's own ops; they declare nothing themselves
_TORCH_ELEMENTWISE = (torch.optim.AdamW, torch.optim.Adam, torch.optim.SGD)


def steps_on_mesh(optimizer) -> bool:
    """Whether ``optimizer`` steps DTensor params on a DeviceMesh with the
    JAX package's numbers there: the port's optimizers declare it in
    their class attribute ``steps_on_mesh`` (parallel/mesh_state.py says
    how each lays out its state); torch's AdamW, Adam and SGD do it
    through DTensor's elementwise ops."""
    return bool(getattr(optimizer, "steps_on_mesh",
                        isinstance(optimizer, _TORCH_ELEMENTWISE)))


def _check_strategy(strategy: Strategy) -> None:
    """Raise for what the port does not run; the mesh axes are checked by
    ``build_mesh``."""
    if strategy.remat != "none":
        remat_lib.strategy_policy(strategy.remat)  # raises if unknown
    if strategy.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype={strategy.compute_dtype!r}: want one of "
            f"{', '.join(_COMPUTE_DTYPES)}")
    if strategy.overlap_collectives not in OVERLAP_MODES:
        raise ValueError(
            f"overlap_collectives={strategy.overlap_collectives!r}: want "
            f"one of {', '.join(OVERLAP_MODES)}")
    if not strategy.donate:
        raise NotImplementedError(
            "donate=False: the port's step always updates the state in "
            "place; keeping the old buffers is not ported (ROADMAP Queue 1 "
            "item 7)")
    if int(strategy.grad_accum) < 1:
        raise ValueError(f"grad_accum must be >= 1, got {strategy.grad_accum}")


def _check_quant(quant, device, mesh: Mesh) -> None:
    """Raise where a quant mode has no tensor cores or no port yet."""
    if quant is None:
        return
    if device.type == "cuda":
        have = torch.cuda.get_device_capability(device)
        need = _QUANT_CAPABILITY[quant]
        if have < need:
            raise NotImplementedError(
                f"compute_dtype={quant!r} needs compute capability "
                f"{need[0]}.{need[1]} ({quant} tensor cores); "
                f"{torch.cuda.get_device_name(device)} has "
                f"{have[0]}.{have[1]}")
    if mesh.sharded:
        raise NotImplementedError(
            f"compute_dtype={quant!r} on a process group (per-tensor scales "
            "over local shards) is not ported yet (ROADMAP Queue 1 item 12)")


def _remat_wrap(loss_fn: Callable, mode: str) -> Callable:
    """``loss_fn`` under the strategy's remat: the whole loss in one
    checkpoint that keeps what ``mode`` saves (the JAX package's
    ``jax.checkpoint(loss_fn, policy)``); ``"none"`` leaves it as it
    is.

    A loss whose tail recomputes itself in its own backward names its
    halves as ``loss_fn.remat_split = (body, head)`` (the chunked CE,
    models/llama.py): only the body is checkpointed, and the head runs
    once forward, outside. Checkpointed whole, the backward would run
    the head's forward again to recompute what the head saved; in the
    JAX package that recompute's outputs are dead and XLA drops it."""
    if mode == "none":
        return loss_fn
    policy = remat_lib.strategy_policy(mode)
    split = getattr(loss_fn, "remat_split", None)
    if split is not None:
        body, head = split

        def wrapped_split(params, batch, rng):
            body_out = remat_lib.checkpoint(body, params, batch, rng,
                                            policy=policy)
            return head(params, batch, body_out)

        return wrapped_split

    def wrapped(params, batch, rng):
        return remat_lib.checkpoint(loss_fn, params, batch, rng,
                                    policy=policy)

    return wrapped


def _seq_slice(batch, ring):
    """This rank's slice of a token batch: the shifted inputs and labels
    of its seq coordinate's sequence shard (the shift comes first, so a
    shard's last label is the next shard's first token). A batch that
    brings its ``labels`` [B, S] comes shifted (``tokens`` [B, S], the
    inputs, as the models take them): both are cut."""
    if set(batch) not in ({"tokens"}, {"tokens", "labels"}):
        raise ValueError("a seq process group slices batch['tokens'] (and "
                         "batch['labels']) and takes no other key, got "
                         f"{sorted(batch)}")
    tokens = batch["tokens"]
    if "labels" in batch:
        inputs, labels = tokens, batch["labels"]
    else:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    if inputs.shape[1] % ring.size:
        raise MeshError(f"a seq axis of {ring.size} ranks does not divide "
                        f"the sequence of {inputs.shape[1]}")
    shard = inputs.shape[1] // ring.size
    cut = slice(ring.rank * shard, (ring.rank + 1) * shard)
    return {"tokens": inputs[:, cut], "labels": labels[:, cut]}


def _sharded_params(raw: dict, device, mesh: Mesh, axes, rules) -> dict:
    """The fp32 masters as DTensors placed by their logical axes (a param
    without axes is replicated), each a leaf that takes gradients."""
    axes = axes or {}
    return {
        name: distribute_logical(
            p.to(device=device, dtype=torch.float32), axes.get(name),
            mesh.device_mesh, rules).requires_grad_()
        for name, p in raw.items()}


def empty_params(like: dict, device, mesh: Mesh, axes=None,
                 rules=None) -> dict:
    """Uninitialised fp32 masters of ``like``'s global shapes laid out on
    ``mesh`` as ``auto_accelerate`` lays them (DTensors placed by their
    logical axes on a DeviceMesh, plain tensors off one): each rank
    allocates its shard only. An in-process reshape fills them from the
    live state (``auto_accelerate(reuse_params=...)``)."""
    axes = axes or {}
    out = {}
    for name, p in like.items():
        shape = tuple(int(n) for n in p.shape)
        if not mesh.sharded:
            out[name] = torch.empty(shape, dtype=torch.float32,
                                    device=device)
            continue
        dm = mesh.device_mesh
        placements = logical_placements(axes.get(name), dm, rules)
        local, _ = shard_box(shape, dm, placements)
        out[name] = DTensor.from_local(
            torch.empty(local, dtype=torch.float32, device=device), dm,
            list(placements), run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    return out


def _batch_placements(device_mesh, seq_sliced: bool = False) -> list:
    """A batch leaf's placements: rows split over the batch axes (data
    major), replicated over the rest; with ``seq_sliced``, a seq rank's
    slice of the sequence (dim 1) split over ``seq``."""
    return [Shard(0) if name in BATCH_AXES
            else Shard(1) if name == "seq" and seq_sliced else Replicate()
            for name in device_mesh.mesh_dim_names]


def _microbatch_rows(x, device_mesh, accum: int):
    """This rank's rows of a batch leaf, reordered so that its i-th of
    ``accum`` chunks is its share of the JAX step's microbatch i: the
    global batch's i-th contiguous chunk, cut over the batch replicas in
    ``batch_place`` order (data major). The global batch is gathered
    over the batch ranks first (an all_gather: token ids, a few KB),
    never over ``seq``, whose ranks hold the same rows."""
    full = DTensor.from_local(x, device_mesh, _batch_placements(device_mesh),
                              run_check=False).full_tensor()
    sizes = dict(zip(device_mesh.mesh_dim_names, device_mesh.shape))
    coord = dict(zip(device_mesh.mesh_dim_names,
                     device_mesh.get_coordinate()))
    index = coord["data"] * sizes["fsdp"] + coord["fsdp"]
    count = sizes["data"] * sizes["fsdp"]
    chunks = full.view(accum, count, x.shape[0] // accum, *x.shape[1:])
    return chunks[:, index].reshape(x.shape)


def global_value(x):
    """A loss's global value: a DTensor's ``full_tensor()``, a plain
    tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def auto_accelerate(
    loss_fn: Callable,  # (params, batch, rng) -> scalar loss
    init_fn: Callable,  # (seed, device) -> dict of fp32 params
    optimizer_factory: Callable,  # named params -> torch Optimizer
    strategy: Optional[Strategy] = None,
    device=None,
    seed: int = 0,
    param_logical_axes: Optional[dict] = None,
    reuse_params: Optional[dict] = None,
) -> AccelerateResult:
    """Build the state and the train step for ``strategy`` on this
    process's device (``cuda`` unless ``device`` says otherwise), and set
    its mesh as the active one; each ``train_step`` sets it again before
    it runs.

    ``optimizer_factory`` receives the params as ``(name, tensor)``
    pairs (torch's named parameters) in the JAX package's leaf order
    (``ops.fused_optim.tree_order`` of their names).
    ``strategy.fused_optim`` is recorded, as in the JAX package: the
    optimizer factory acts on it (``adam8bit(fused=True)``,
    ``fused_adamw``), the step does not change.

    ``param_logical_axes`` (``{name: logical axes}``, as
    ``llama_logical_axes`` gives them) places the params on a
    DeviceMesh; a param without an entry is replicated. Off a DeviceMesh
    it is not used. On one the optimizer must step DTensor params
    (:func:`steps_on_mesh`: the port's optimizers, torch's AdamW, Adam
    and SGD); another raises.

    ``strategy.overlap_collectives`` ("xla", "manual") runs each
    microbatch's forward under ``overlap_autocast``: the models' layer
    loops issue each layer's fsdp gathers one layer ahead, and their
    backward reduce-scatters are waited for before the gradients settle
    (parallel/overlap.py). Off a DeviceMesh, or with fsdp 1, it changes
    nothing.

    ``train_step(state, batch, rng)`` takes a dict batch of arrays or
    tensors (moved to the device), runs ``strategy.grad_accum``
    microbatches split along dim 0, applies the optimizer and returns
    ``(state, {"loss": ...})``; the loss is the microbatch mean, a 0-d
    f32 tensor on the device. On a DeviceMesh ``batch`` is this rank's
    rows (see the module's docstring); under a seq dim every seq rank of
    a replica gets them whole (``tokens`` [B, S+1], S divisible by the
    seq size) and takes its slice. With ``grad_accum >
    1`` microbatch ``i`` is this rank's share of the global batch's
    ``i``-th contiguous chunk, as the JAX package cuts it (the batch is
    gathered over the batch ranks to cut it so); the loss is the global
    one on every rank.

    ``reuse_params`` (the JAX package's ``reuse_state``): fp32 masters
    already laid out on this strategy's mesh over the current process
    group (an in-process reshape's, see :func:`empty_params`) become the
    state's params as they are; ``init_fn`` is not called, and the
    optimizer is a fresh one over them.
    """
    strategy = strategy or Strategy()
    _check_strategy(strategy)
    device = resolve_device(device)
    mesh = build_mesh(strategy.mesh)
    if mesh.sharded and mesh.device_mesh.device_type != device.type:
        # distribute_tensor would move every master to the mesh's device
        raise ValueError(
            f"the process group's backend lays the DeviceMesh on "
            f"{mesh.device_mesh.device_type}, the step runs on "
            f"{device.type}: use NCCL for cuda, gloo for cpu")
    set_mesh(mesh)
    if not mesh.sharded and (
            tuple(tuple(r) for r in strategy.rules) != DEFAULT_RULES):
        raise NotImplementedError(
            "custom logical sharding rules need a DeviceMesh: a process "
            "group (ROADMAP Queue 1 item 7)")
    # a seq dim slices the sequence; the in-process ring needs nothing
    group = mesh.ring if isinstance(mesh.ring, ProcessGroupRing) else None
    compute_dtype = _COMPUTE_DTYPES[strategy.compute_dtype]
    quant = (strategy.compute_dtype if strategy.compute_dtype in QUANT_MODES
             else None)
    _check_quant(quant, device, mesh)
    accum = int(strategy.grad_accum)
    inner_loss = _remat_wrap(loss_fn, strategy.remat)

    if reuse_params is not None:
        params = {name: p.detach().requires_grad_()
                  for name, p in reuse_params.items()}
    else:
        raw = init_fn(seed, device)
        if mesh.sharded:
            params = _sharded_params(raw, device, mesh, param_logical_axes,
                                     strategy.rules)
        else:
            params = {
                name: p.to(device=device,
                           dtype=torch.float32).requires_grad_()
                for name, p in raw.items()
            }
        del raw
    # the optimizer sees the params in the JAX package's leaf order, so
    # that flat optimizer state and per-leaf seeds line up with JAX's, and
    # by name, so that what keys on names (muP's multipliers) finds them
    state = TrainState(step=0, params=params, optimizer=optimizer_factory(
        [(name, params[name]) for name in tree_order(params)]))
    if mesh.sharded and not steps_on_mesh(state.optimizer):
        raise NotImplementedError(
            f"{type(state.optimizer).__name__} on a DeviceMesh: it does not "
            "declare steps_on_mesh (the port's optimizers and torch's "
            "AdamW, Adam and SGD do; ROADMAP Queue 1 item 7)")

    def to_device(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    def as_rows(x):
        """A batch leaf (this rank's rows, and under a seq dim its slice)
        as a DTensor over the mesh."""
        dm = mesh.device_mesh
        return DTensor.from_local(
            x, dm, _batch_placements(dm, seq_sliced=group is not None),
            run_check=False)

    def train_step(state: TrainState, batch, rng):
        # the model reads the seq ring from the active mesh: make it this
        # step's, whatever was set since, so a step that slices shards
        # always runs the ring it was built for
        set_mesh(mesh)
        batch = {k: to_device(local(v)) for k, v in batch.items()}
        for k, v in batch.items():
            if v.ndim < 1 or v.shape[0] % accum:
                raise ValueError(
                    f"batch[{k!r}] dim {tuple(v.shape)} not divisible by "
                    f"grad_accum={accum}")
        if mesh.sharded and accum > 1:
            batch = {k: _microbatch_rows(v, mesh.device_mesh, accum)
                     for k, v in batch.items()}
        micro = [
            {k: v.chunk(accum)[i] for k, v in batch.items()}
            for i in range(accum)
        ]
        loss_sum = torch.zeros((), device=device)
        # remat="none" means none: the model checkpoints no layer either
        rctx = (remat_lib.no_remat if strategy.remat == "none"
                else contextlib.nullcontext)
        qctx = (contextlib.nullcontext if quant is None else
                functools.partial(quant_autocast, quant,
                                  sites=strategy.quant_sites))
        # the layer loops' fsdp gathers one layer ahead (parallel/
        # overlap.py), with the rule table the params were placed with
        octx = functools.partial(overlap_autocast,
                                 strategy.overlap_collectives,
                                 rules=strategy.rules)
        for mb in micro:
            cparams = {n: p.to(compute_dtype)
                       for n, p in state.params.items()}
            if group is not None:
                mb = _seq_slice(mb, group)
            if mesh.sharded:
                mb = {k: as_rows(v) for k, v in mb.items()}
            with rctx(), qctx(), octx():
                loss = inner_loss(cparams, mb, rng)
            # grads accumulate in fp32 on the masters; /accum averages
            (loss / accum).backward()
            loss_sum += global_value(loss).detach().float()
        if mesh.sharded:
            # every reduce-scatter an overlapped backward left in flight
            wait_pending()
            # a Partial token axis is summed (DTensor makes no collective
            # call over a mesh dim of size 1)
            for p in state.params.values():
                p.grad = placed_as(p.grad, p)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss_sum / accum}

    logger.info("auto_accelerate ready on %s: %s", device,
                strategy.describe(mesh))
    return AccelerateResult(strategy=strategy, device=device, state=state,
                            train_step=train_step, mesh=mesh)
