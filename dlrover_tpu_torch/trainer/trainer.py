"""Trainer: the high-level training loop (port of
dlrover_tpu/trainer/trainer.py's ``TrainingArgs`` and ``Trainer``).

The loop is the JAX loop's: each batch from ``train_data`` (an
:class:`~dlrover_tpu_torch.trainer.elastic.ElasticDataLoader`, say) goes
through the optional ``prestep`` hook and the ``auto_accelerate`` train
step, inside a ``train.step`` tracing span; then the telemetry the
control plane reads (``compile`` for the first step, ``step.end`` after,
``train.step.seconds``, ``train.step.last_s``, ``train.steps_per_s``,
``train.tokens_per_s``, ``train.mfu``, ``device.hbm.*``) and the
runtime-metrics file for the agent. The loss is read on the host only at
``log_steps``: no other per-step host sync.

What the port does not run yet raises ``NotImplementedError`` naming its
ROADMAP Queue 1 item: Flash Checkpoint (``flash_checkpoint=True``,
``save_steps``, ``maybe_resume``, ``save_checkpoint``; item 5, which also
brings the shm step timer the JAX loop feeds where shm exists, and the
brain's checkpoint-cadence adoption that rides on ``save_steps``),
profiling (``profile=True`` and the device-time sampler; item 12), and
the in-process reshape channel (``reshape_channel``,
``NodeEnv.RESHAPE_DIR``; item 8).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from dlrover_tpu_torch.agent.monitor import write_runtime_metrics
from dlrover_tpu_torch.common import flight, mfu, telemetry, tracing
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.parallel.accelerate import auto_accelerate
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.trainer.optim import build_optimizer

logger = get_logger(__name__)


@dataclasses.dataclass
class TrainingArgs:
    """The JAX package's ``TrainingArgs``, field for field."""

    output_dir: str = "/tmp/dlrover_tpu/output"
    max_steps: int = 0               # 0 = run the data out
    num_epochs: int = 1
    micro_batch_size: int = 8
    grad_accum: int = 1
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    optimizer: str = "adamw"         # adamw | sgd | adam8bit (agd: item 9)
    strategy: Optional[Strategy] = None
    # None = keep the strategy's compute dtype (default bfloat16)
    compute_dtype: Optional[str] = None
    seed: int = 0
    # checkpointing: Flash Checkpoint is ROADMAP Queue 1 item 5; until
    # then pass flash_checkpoint=False (and save_steps=0)
    flash_checkpoint: bool = True
    save_steps: int = 0              # 0 = only at end
    save_storage_every: int = 1      # persist every Nth shm save
    # the brain's checkpoint cadence; acts only on save_steps (item 5)
    adopt_cadence: bool = True
    # logging/eval
    log_steps: int = 10
    eval_steps: int = 0
    # profiling (ROADMAP Queue 1 item 12)
    profile: bool = False
    profile_start_step: int = 10
    profile_num_steps: int = 3
    # model FLOPs per TOKEN for the live ``train.mfu`` gauge. 0 = the
    # dense estimate 6 * param_count (common/mfu.py for the exact value)
    model_flops_per_token: float = 0.0


def _unported(what: str, item: int, hint: str = "") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item}){hint}")


def _leaves(tree):
    """Leaves of a nested dict/list/tuple in ``jax.tree_util`` order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for child in tree:
            yield from _leaves(child)
    else:
        yield tree


def _is_integer(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex
                    or dtype == torch.bool)
    return np.issubdtype(np.dtype(dtype), np.integer)


class Trainer:
    """Train a (loss_fn, init_fn) model over a batch iterable.

    ``loss_fn(params, batch, rng)`` and ``init_fn(seed, device)`` are
    ``auto_accelerate``'s; ``param_logical_axes`` is kept for the JAX
    signature (the port shards nothing, None is accepted). ``train_data``
    is re-iterable for several epochs. ``prestep``: an optional host-side
    hook ``(state, batch) -> (state, batch)`` run before every step, and
    for eval batches too (with ``count=False`` where it takes one).
    ``device`` is resolved as ``auto_accelerate`` resolves it: ``cuda``
    unless the caller asks for the CPU.
    """

    def __init__(
        self,
        loss_fn: Callable,
        init_fn: Callable,
        param_logical_axes: Any,
        args: TrainingArgs,
        train_data: Iterable,
        eval_data: Optional[Iterable] = None,
        eval_fn: Optional[Callable] = None,
        optimizer=None,
        prestep: Optional[Callable] = None,
        reshape_channel=None,
        reshape_devices_fn: Optional[Callable] = None,
        device=None,
    ):
        if args.flash_checkpoint:
            raise _unported(
                "flash_checkpoint=True (Flash Checkpoint)", 5,
                "; pass TrainingArgs(flash_checkpoint=False) until then")
        if args.save_steps:
            raise _unported(
                f"save_steps={args.save_steps} (checkpoint saves, and the "
                "brain's cadence adoption on them)", 5)
        if args.profile:
            raise _unported("profile=True (the step profiler and the "
                            "device-time sampler)", 12)
        if (reshape_channel is not None or reshape_devices_fn is not None
                or os.environ.get(NodeEnv.RESHAPE_DIR, "")):
            raise _unported("the in-process reshape channel", 8)
        self.args = args
        self.loss_fn = loss_fn
        self.init_fn = init_fn
        self.param_logical_axes = param_logical_axes
        self.train_data = train_data
        self.eval_data = eval_data
        self.eval_fn = eval_fn or loss_fn
        self.prestep = prestep
        self._prestep_accepts_count = False
        if prestep is not None:
            try:
                self._prestep_accepts_count = (
                    "count" in inspect.signature(prestep).parameters)
            except (TypeError, ValueError):
                pass
        self.optimizer = optimizer or build_optimizer(
            args.optimizer, args.learning_rate, args.weight_decay)
        strategy = args.strategy or Strategy()
        overrides = dict(grad_accum=max(args.grad_accum,
                                        strategy.grad_accum))
        if args.compute_dtype is not None:
            overrides["compute_dtype"] = args.compute_dtype
        strategy = dataclasses.replace(strategy, **overrides)
        self._accel = auto_accelerate(loss_fn, init_fn, self.optimizer,
                                      strategy=strategy, device=device,
                                      seed=args.seed)
        self.device = self._accel.device
        self.state = self._accel.state
        self.global_step = 0
        # the first train_step of this process is attributed to the
        # "compile" goodput category, as in the JAX loop
        self._compiled_once = False
        self._refresh_flops()
        self._hbm_limit = (
            torch.cuda.get_device_properties(self.device).total_memory
            if self.device.type == "cuda" else 0)
        # the per-step rng: one generator on the device, seeded from
        # (seed, step) before each step
        self._rng = torch.Generator(device=self.device)

    # -------------------------------------------------------- checkpoints

    def maybe_resume(self) -> int:
        raise _unported("maybe_resume (Flash Checkpoint restore)", 5)

    def save_checkpoint(self, persist: bool = False):
        raise _unported("save_checkpoint (Flash Checkpoint)", 5)

    # -------------------------------------------------------------- train

    def _step_rng(self) -> torch.Generator:
        seed = np.random.SeedSequence(
            [self.args.seed, self.global_step]).generate_state(1)[0]
        self._rng.manual_seed(int(seed))
        return self._rng

    def train(self):
        args = self.args
        # post-mortem coverage for the worker: a SIGTERM (preemption,
        # agent stop) dumps the last spans/events + thread stacks
        flight.install()
        metrics = {}
        stop = bool(args.max_steps) and self.global_step >= args.max_steps
        sampler = getattr(self.train_data, "sampler", None)
        for epoch in range(args.num_epochs):
            if stop:
                break
            if epoch and sampler is not None and hasattr(sampler,
                                                         "set_epoch"):
                sampler.set_epoch(epoch)
            for batch in self.train_data:
                t0 = time.time_ns()
                with tracing.span("train.step", step=self.global_step + 1):
                    rng = self._step_rng()
                    if self.prestep is not None:
                        self.state, batch = self.prestep(self.state, batch)
                    self.state, metrics = self._accel.train_step(
                        self.state, batch, rng)
                    self.global_step += 1
                dur_s = (time.time_ns() - t0) / 1e9
                self._step_telemetry(batch, dur_s)
                if args.log_steps and self.global_step % args.log_steps == 0:
                    loss = float(metrics.get("loss", float("nan")))
                    logger.info("step %d epoch %d loss %.5f",
                                self.global_step, epoch, loss)
                    telemetry.flush()
                write_runtime_metrics(self.global_step)
                if args.eval_steps and self.eval_data is not None \
                        and self.global_step % args.eval_steps == 0:
                    self.evaluate()
                if args.max_steps and self.global_step >= args.max_steps:
                    stop = True
                    break
        telemetry.flush()
        return self.state, metrics

    def _step_telemetry(self, batch, dur_s: float):
        steady = self._compiled_once
        if steady:
            telemetry.event("step.end", step=self.global_step, dur=dur_s)
        else:
            telemetry.event("compile", step=self.global_step, dur=dur_s)
            self._compiled_once = True
        telemetry.observe("train.step.seconds", dur_s)
        if dur_s > 0:
            telemetry.gauge_set("train.steps_per_s", 1.0 / dur_s)
            tokens = self._batch_tokens(batch)
            if tokens:
                telemetry.gauge_set("train.tokens_per_s", tokens / dur_s)
            # steady state only: the first step's wall time is no
            # step-time/MFU sample
            if steady:
                telemetry.gauge_set("train.step.last_s", dur_s)
                if tokens and self._flops_per_token > 0:
                    telemetry.gauge_set(
                        "train.mfu",
                        mfu.mfu(self._flops_per_token * tokens, dur_s))
        self._emit_device_gauges()

    # -------------------------------------------- live MFU / HBM gauges

    def _refresh_flops(self):
        """Model FLOPs per token, computed once: the explicit
        ``model_flops_per_token``, else the dense 6 * params estimate."""
        if self.args.model_flops_per_token > 0:
            self._flops_per_token = float(self.args.model_flops_per_token)
            return
        self._flops_per_token = 6.0 * sum(
            p.numel() for p in self.state.params.values())

    def _emit_device_gauges(self):
        """``device.hbm.*`` gauges from the caching allocator's stats and
        the card's memory; a CPU run has none."""
        if self.device.type != "cuda":
            return
        stats = torch.cuda.memory_stats(self.device)
        index = str(self.device.index or 0)
        telemetry.gauge_set("device.hbm.live_bytes",
                            stats.get("allocated_bytes.all.current", 0),
                            device=index)
        telemetry.gauge_set("device.hbm.peak_bytes",
                            stats.get("allocated_bytes.all.peak", 0),
                            device=index)
        telemetry.gauge_set("device.hbm.limit_bytes", self._hbm_limit,
                            device=index)

    @staticmethod
    def _batch_tokens(batch) -> int:
        """Token count for the throughput gauge from shapes only: the
        first 2-D integer leaf (token ids) wins; 0 when the batch has
        none."""
        for leaf in _leaves(batch):
            shape = getattr(leaf, "shape", None)
            dtype = getattr(leaf, "dtype", None)
            if shape is not None and len(shape) == 2 and dtype is not None \
                    and _is_integer(dtype):
                return int(shape[0]) * int(shape[1])
        return 0

    # ---------------------------------------------------------------- eval

    def _to_device(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        return torch.as_tensor(batch).to(self.device, non_blocking=True)

    def evaluate(self) -> float:
        """The mean of ``eval_fn(params, batch, rng)`` over ``eval_data``
        on the fp32 master params, without gradients."""
        if self.eval_data is None:
            return float("nan")
        rng = torch.Generator(device=self.device)
        rng.manual_seed(0)
        losses = []
        with torch.no_grad():
            for batch in self.eval_data:
                if self.prestep is not None:
                    if self._prestep_accepts_count:
                        self.state, batch = self.prestep(
                            self.state, batch, count=False)
                    else:
                        self.state, batch = self.prestep(self.state, batch)
                losses.append(self.eval_fn(
                    self.state.params, self._to_device(batch), rng).float())
        loss = (float(torch.stack(losses).mean()) if losses
                else float("nan"))
        logger.info("eval at step %d: loss %.5f", self.global_step, loss)
        return loss

    def close(self):
        """Nothing to release until Flash Checkpoint and the profiler are
        ported (items 5 and 12); kept for the JAX API."""
