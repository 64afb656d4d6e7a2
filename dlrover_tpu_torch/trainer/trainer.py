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
``log_steps``: no other per-step host sync. The data wait and the step
go into the shm timing ring (``trainer/timer.py``) as in the JAX loop.

Flash Checkpoint (``flash_checkpoint=True``, the default): the Trainer
saves its state to shm every ``save_steps`` (blocking only for the
save), persists every ``save_storage_every``-th save to ``output_dir``
through the saver, makes a final persisted save, and ``maybe_resume``
(called by ``train``) restores the newest step, shm before storage,
with the elastic loader's position. The checkpoint tree is the JAX
Trainer's ``{"train": state, "data": loader state as uint8}``; the
train state is ``{"step", "params", "opt"}``, with ``opt`` the
optimizer's ``state_dict()`` keyed by param name.

Profiling, as in the JAX loop: ``profile=True`` captures steps
``[profile_start_step, +profile_num_steps)`` into ``output_dir/profile``
(``trainer/profiler.py``) and publishes their top kernels where the
agent's ``/metrics`` serves them (``dlrtpu_kernel_self_ms``); the
always-on ``DeviceTimeSampler`` (``common/profiling.py``) profiles one
step every ``DLROVER_PROF_SAMPLE_STEPS`` into ``device.optime_ms``
gauges and the op-cost baseline, and runs the agent's deep captures
(``DLROVER_PROF_CAPTURE_DIR``). Kineto runs one window per process: on a
step where both would open, the ``profile`` window opens first and the
sampler's is refused and re-armed, as the JAX loop's ``jax.profiler``
refuses it.

What the port does not run yet raises ``NotImplementedError`` naming its
ROADMAP Queue 1 item: the in-process reshape (``reshape_channel``,
``reshape_devices_fn``; item 8). The channel an agent offers through
``NodeEnv.RESHAPE_DIR`` is declined: the Trainer installs no watcher and
never marks the channel ready, so the agent restarts the worker on a
membership change. Under a master, ``adopt_cadence`` adopts the brain's
checkpoint cadence (``save_steps``) at log boundaries.

With ``log_steps`` set, each step's loss stays on the device until the
next log boundary (or the end of ``train()``), where it is read and
published as a ``train.loss`` telemetry event, with the kernels' launch
counts as ``kernel.launches`` gauges.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import tempfile
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from dlrover_tpu_torch.agent.monitor import write_runtime_metrics
from dlrover_tpu_torch.common import flight, mfu, telemetry, tracing
from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.ipc import set_default_job_name
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.ops import launch_counts
from dlrover_tpu_torch.parallel.accelerate import (
    auto_accelerate,
    global_value,
)
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.trainer.fault_tolerance import notify_progress_reset
from dlrover_tpu_torch.trainer.optim import (
    materialize_optimizer_state,
    optimizer_state_tree,
    restore_optimizer_state,
)
from dlrover_tpu_torch.trainer.optim import build_optimizer
from dlrover_tpu_torch.trainer.timer import Tag

logger = get_logger(__name__)


@dataclasses.dataclass
class TrainingArgs:
    """The JAX package's ``TrainingArgs``, field for field."""

    # under the caller's temp dir, in a directory of the port's own
    output_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "dlrover_tpu_torch", "output"))
    max_steps: int = 0               # 0 = run the data out
    num_epochs: int = 1
    micro_batch_size: int = 8
    grad_accum: int = 1
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    optimizer: str = "adamw"         # adamw | sgd | agd | adam8bit
    strategy: Optional[Strategy] = None
    # None = keep the strategy's compute dtype (default bfloat16)
    compute_dtype: Optional[str] = None
    seed: int = 0
    # checkpointing
    flash_checkpoint: bool = True
    save_steps: int = 0              # 0 = only at end
    save_storage_every: int = 1      # persist every Nth shm save
    # adopt the brain's checkpoint cadence (save_steps) from the master
    adopt_cadence: bool = True
    # logging/eval
    log_steps: int = 10
    eval_steps: int = 0
    # profiling: capture a trace of steps
    # [profile_start_step, +profile_num_steps) into output_dir/profile
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


def default_job_name(output_dir: str) -> str:
    """The job name of a run without ``ELASTIC_JOB_NAME`` (no agent):
    one of its resolved output dir, so two runs that write different
    dirs never meet in a shm segment, and a rerun into the same dir
    resumes from its own."""
    digest = hashlib.sha1(
        os.path.realpath(output_dir).encode()).hexdigest()[:12]
    return f"local{digest}"


class Trainer:
    """Train a (loss_fn, init_fn) model over a batch iterable.

    ``loss_fn(params, batch, rng)`` and ``init_fn(seed, device)`` are
    ``auto_accelerate``'s, and so is ``param_logical_axes`` (``{name:
    logical axes}``, which places the params on a DeviceMesh; None
    replicates them there, and off a mesh it is not used). On a
    DeviceMesh each ``train_data`` batch is this rank's rows (a sampler
    over the replicas along the batch axes, ``mesh.batch_place``), and
    the checkpoint holds each rank's shards (the sharded engine, one
    segment per local rank). ``train_data``
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
        if reshape_channel is not None or reshape_devices_fn is not None:
            raise _unported("the in-process reshape channel", 8)
        if os.environ.get(NodeEnv.RESHAPE_DIR, ""):
            logger.info("the agent's reshape channel is declined (the "
                        "in-process reshape is ROADMAP Queue 1 item 8): "
                        "a membership change restarts this worker")
        self.args = args
        # the shm segments' job name where no agent set one
        set_default_job_name(default_job_name(args.output_dir))
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
                                      seed=args.seed,
                                      param_logical_axes=param_logical_axes)
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
        # step the on-disk pending/latest prestep sidecar was last
        # serialized at (skip-rewrite cache; None = dirty)
        self._prestep_sidecar_step = None
        # brain cadence adoption: the master client, probed lazily on
        # the first log boundary (None = unprobed, False = no master)
        self._cadence_client = None
        # (step, loss on the device) since the last log boundary
        self._pending_losses: list = []
        self._engine = None
        if args.flash_checkpoint:
            from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
                ShardedCheckpointEngine,
            )

            # lazily created moments (torch AdamW's) exist from here on,
            # so a restore target built before step 1 names every leaf
            # a checkpoint holds
            materialize_optimizer_state(self.state.optimizer)
            from dlrover_tpu_torch.trainer.flash_checkpoint.checkpointer \
                import host_place

            # one segment per local rank; the shards per host
            host_rank, num_hosts = host_place()
            self._engine = ShardedCheckpointEngine(
                os.path.join(args.output_dir, "checkpoints"),
                local_rank=int(os.environ.get(NodeEnv.LOCAL_RANK, "0")),
                host_rank=host_rank, num_hosts=num_hosts)
        self._timer = None
        try:
            from dlrover_tpu_torch.trainer.timer import get_step_timer

            self._timer = get_step_timer()
        except Exception:  # noqa: BLE001 - shm unavailable (bare env)
            pass
        self._profiler = None
        if args.profile:
            from dlrover_tpu_torch.trainer.profiler import StepProfiler

            self._profiler = StepProfiler(
                os.path.join(args.output_dir, "profile"),
                start_step=args.profile_start_step,
                num_steps=args.profile_num_steps,
                # publish top-kernel self times where the agent's
                # /metrics endpoint serves them (dlrtpu_kernel_self_ms)
                publish_top_ops=True,
                device=self.device,
            )
        # always-on device-time accounting + deep-capture execution
        # (common/profiling.py): one sampled step every
        # DLROVER_PROF_SAMPLE_STEPS becomes device.optime_ms gauges +
        # the persisted op-cost baseline; the agent's capture channel
        # (DLROVER_PROF_CAPTURE_DIR) is polled at every step boundary.
        # Sampling is off where no card can be recorded (the CPU): the
        # hooks then cost one branch per step.
        from dlrover_tpu_torch.common import profiling

        self._prof = profiling.DeviceTimeSampler(
            os.path.join(args.output_dir, "prof"), device=self.device,
        )
        self._refresh_prof_context()

    # -------------------------------------------------------------- resume

    _DATA_STATE_BYTES = 4096

    def _pack_data_state(self):
        """Dataloader/sampler progress as a fixed-size JSON leaf so it
        rides the same checkpoint tree (and target matching) as the
        train state."""
        sd = dict(self.train_data.state_dict())
        replicas = getattr(getattr(self.train_data, "sampler", None),
                           "num_replicas", None)
        if replicas is not None:
            # the loader's batch size is per replica: a restore onto
            # another replica count rescales it (_data_state_for_now)
            sd["num_replicas"] = int(replicas)
        raw = json.dumps(sd).encode()
        if len(raw) > self._DATA_STATE_BYTES:
            logger.warning(
                "dataloader state too large to checkpoint (%d bytes)",
                len(raw),
            )
            return None
        buf = np.zeros(self._DATA_STATE_BYTES, np.uint8)
        buf[: len(raw)] = np.frombuffer(raw, np.uint8)
        return buf

    def _data_state_for_now(self, sd: dict) -> dict:
        """A saved loader state for this run's replicas along the batch
        axes: saved on a mesh with another replica count, the per-replica
        batch size is rescaled so the global batch stays the saved one
        (where the new count divides it)."""
        sd = dict(sd)
        saved = int(sd.pop("num_replicas", 0))
        now = getattr(getattr(self.train_data, "sampler", None),
                      "num_replicas", None)
        bs = int(sd.get("batch_size", 0))
        if bs and saved and now and saved != now and (bs * saved) % now == 0:
            sd["batch_size"] = bs * saved // now
        return sd

    def _state_tree(self) -> dict:
        """The train state as a checkpoint tree: the step, the fp32
        master params by name, the optimizer's state by param name."""
        st = self.state
        return {
            "step": np.asarray(st.step, np.int64),
            "params": {name: p.detach() for name, p in st.params.items()},
            "opt": optimizer_state_tree(st.optimizer, st.params),
        }

    def _load_state_tree(self, tree: dict):
        st = self.state
        with torch.no_grad():
            for name, p in st.params.items():
                p.copy_(tree["params"][name])
        restore_optimizer_state(st.optimizer, st.params, tree["opt"])
        st.step = int(tree["step"])

    def _ckpt_tree(self):
        tree = {"train": self._state_tree()}
        if hasattr(self.train_data, "state_dict"):
            packed = self._pack_data_state()
            if packed is not None:
                tree["data"] = packed
        return tree

    def maybe_resume(self) -> int:
        """Restore the newest checkpoint (shm preferred, then storage),
        including dataloader/sampler progress so a restarted job picks
        up mid-epoch instead of replaying from offset 0.
        Returns the restored step (0 = fresh)."""
        if self._engine is None:
            return 0
        # fallback targets: a checkpoint written without the data leaf
        # (oversized loader state) and the bare train state must both
        # keep restoring
        targets = [self._ckpt_tree()]
        if "data" in targets[0]:
            targets.append({"train": targets[0]["train"]})
        targets.append(targets[0]["train"])
        restored = None
        first_err = None
        for tgt in targets:
            try:
                restored = self._engine.load(target=tgt)
            except ValueError as err:
                if first_err is None:
                    first_err = err
                continue
            if restored is not None:
                break
        if restored is None:
            if first_err is not None:
                if os.environ.get("DLROVER_TPU_IGNORE_CKPT"):
                    logger.warning(
                        "ignoring incompatible checkpoint "
                        "(DLROVER_TPU_IGNORE_CKPT set): %s", first_err,
                    )
                    return 0
                raise ValueError(
                    f"existing checkpoint is incompatible with the "
                    f"current model/optimizer layout: {first_err}. "
                    f"Delete the checkpoint dir or set "
                    f"DLROVER_TPU_IGNORE_CKPT=1 to start fresh."
                ) from first_err
            return 0
        tree, step = restored
        if "train" in tree:
            self._load_state_tree(tree["train"])
            if "data" in tree and hasattr(self.train_data,
                                          "load_state_dict"):
                raw = np.asarray(tree["data"]).tobytes().rstrip(b"\x00")
                if raw:
                    self.train_data.load_state_dict(
                        self._data_state_for_now(json.loads(raw.decode())))
        else:
            self._load_state_tree(tree)
        self.global_step = int(step)
        self._restore_prestep_state()
        self._refresh_prof_context()
        # a multi-GB restore takes wall time with zero step progress;
        # any active hang detector must restart its stall clock
        notify_progress_reset("checkpoint-restore")
        logger.info("resumed from checkpoint step %s", step)
        return self.global_step

    # --------------------------------------------------------- checkpoints

    def save_checkpoint(self, persist: bool = False):
        """Save the state to shm (and persist it when ``persist``);
        False when the save was skipped (a persist still holds the shm
        lock) or checkpointing is off."""
        if self._engine is None:
            return False
        tree = self._ckpt_tree()
        # PENDING sidecar before the engine commit, promoted to latest
        # only after the save succeeds: a crash on either side of the
        # engine's two-phase shm publish leaves the restored step
        # matching either the pending sidecar or the promoted one
        self._write_prestep_pending()
        if persist:
            ok = self._engine.save_to_storage(self.global_step, tree)
        else:
            ok = self._engine.save_to_memory(self.global_step, tree)
        if ok:
            self._promote_prestep_pending(persist)
        return ok

    # three sidecars: the latest SUCCESSFUL (memory-cadence) save, the
    # pre-commit PENDING one (crash bracket, see save_checkpoint), and
    # the latest PERSISTED save — a restore can land on any of those
    # steps, and the hook's state must pair with the exact step
    _PRESTEP_FILES = (
        "prestep_state.npy",
        "prestep_state_pending.npy",
        "prestep_state_persist.npy",
    )
    _PRESTEP_STEP_PREFIX = "prestep_state_step"
    _PRESTEP_KEEP_STEPS = 4

    def _prestep_stateful(self) -> bool:
        """Save and restore gate on the SAME capability check."""
        return hasattr(self.prestep, "state_dict") and hasattr(
            self.prestep, "load_state_dict"
        )

    def _write_prestep_pending(self):
        """Sidecar for stateful prestep hooks: variable-sized host state
        can't ride the engine's shape-matched tree, so it is written
        next to the checkpoint at every save, tagged with the step, to
        the PENDING slot (promoted on success)."""
        if not self._prestep_stateful():
            return
        # the prestep state cannot change while global_step stands
        # still: retries of the same step must not re-serialize it
        if self._prestep_sidecar_step == self.global_step:
            return
        os.makedirs(self.args.output_dir, exist_ok=True)
        payload = np.array(
            {"step": self.global_step,
             "state": self.prestep.state_dict()},
            dtype=object,
        )
        pending = os.path.join(
            self.args.output_dir, self._PRESTEP_FILES[1]
        )
        chaos_point("ckpt.prestep", step=self.global_step)
        tmp = pending + ".tmp"
        with open(tmp, "wb") as f:  # np.save(str) appends .npy
            np.save(f, payload, allow_pickle=True)
        os.replace(tmp, pending)
        self._prestep_sidecar_step = self.global_step

    def _promote_prestep_pending(self, persist: bool):
        """The save landed: the pending sidecar becomes the latest (and
        a per-step persist snapshot when the save persisted), by rename
        and hard link."""
        if not self._prestep_stateful():
            return
        pending = os.path.join(
            self.args.output_dir, self._PRESTEP_FILES[1]
        )
        latest = os.path.join(
            self.args.output_dir, self._PRESTEP_FILES[0]
        )
        if os.path.exists(pending):
            os.replace(pending, latest)
        if not os.path.exists(latest):
            return
        if persist:
            for dst in (
                os.path.join(
                    self.args.output_dir, self._PRESTEP_FILES[2]
                ),
                # one snapshot PER persisted step: a verified restore
                # may fall back past the newest step
                os.path.join(
                    self.args.output_dir,
                    self._PRESTEP_STEP_PREFIX
                    + f"{self.global_step}.npy",
                ),
            ):
                tmp = dst + ".tmp"
                try:
                    os.link(latest, tmp)
                except OSError:
                    import shutil

                    shutil.copyfile(latest, tmp)
                os.replace(tmp, dst)
            self._prune_prestep_steps()

    def _prestep_keep_steps(self) -> int:
        """Per-step sidecar retention follows the checkpoint retention
        policy when one is configured."""
        try:
            keep = int(
                os.environ.get("DLROVER_TPU_MAX_CKPTS_TO_KEEP", "0")
            )
        except ValueError:
            keep = 0
        return max(keep, self._PRESTEP_KEEP_STEPS)

    def _prestep_step_files(self) -> list[str]:
        """Per-persisted-step sidecar snapshots, newest step first."""
        import glob

        def step_of(p):
            stem = os.path.basename(p)[
                len(self._PRESTEP_STEP_PREFIX):-len(".npy")
            ]
            try:
                return int(stem)
            except ValueError:
                return -1

        return sorted(
            glob.glob(os.path.join(
                self.args.output_dir,
                self._PRESTEP_STEP_PREFIX + "*.npy",
            )),
            key=step_of,
            reverse=True,
        )

    def _prune_prestep_steps(self):
        for path in self._prestep_step_files()[
            self._prestep_keep_steps():
        ]:
            try:
                os.remove(path)
            except OSError:
                pass

    def _restore_prestep_state(self):
        """Load the sidecar whose step matches the restored checkpoint
        exactly; no match raises unless DLROVER_TPU_IGNORE_CKPT opts into
        starting the hook from empty state."""
        if not self._prestep_stateful():
            return
        seen_steps = []
        candidates = [
            os.path.join(self.args.output_dir, name)
            for name in self._PRESTEP_FILES
        ] + self._prestep_step_files()
        for path in candidates:
            if not os.path.exists(path):
                continue
            try:
                payload = np.load(path, allow_pickle=True).item()
                step = int(payload["step"])
            except Exception as e:  # noqa: BLE001 - torn/bit-rotted
                logger.warning(
                    "unreadable prestep sidecar %s (%s); skipping", path, e
                )
                continue
            if step == self.global_step:
                self.prestep.load_state_dict(payload["state"])
                return
            seen_steps.append(step)
        seen_steps = sorted(set(seen_steps))
        if os.environ.get("DLROVER_TPU_IGNORE_CKPT"):
            logger.warning(
                "no prestep sidecar matches restored step %s (found "
                "steps %s); starting the prestep hook from empty state "
                "(DLROVER_TPU_IGNORE_CKPT set)",
                self.global_step, seen_steps,
            )
            return
        raise ValueError(
            f"checkpoint restored step {self.global_step} but the "
            f"prestep sidecar(s) in {self.args.output_dir} hold steps "
            f"{seen_steps}: loading a mismatched state would silently "
            f"corrupt the restored model. Delete the checkpoint dir or "
            f"set DLROVER_TPU_IGNORE_CKPT=1 to start the prestep hook "
            f"from empty state."
        )

    def _maybe_adopt_cadence(self):
        """Adopt the master brain's goodput-aware checkpoint cadence
        (Young/Daly-tuned ``save_steps``) from the run-config channel.
        Polled at log cadence, fail-fast and best-effort: no master
        (or an unreachable one) just keeps the configured value, and
        adoption never stalls the step loop."""
        if (
            not self.args.adopt_cadence
            or self._engine is None
            or not self.args.save_steps
            or self._cadence_client is False
        ):
            return
        if self._cadence_client is None:
            try:
                from dlrover_tpu_torch.agent.master_client import (
                    build_master_client,
                )

                self._cadence_client = build_master_client() or False
            except Exception:  # noqa: BLE001 - env without a master
                self._cadence_client = False
            if self._cadence_client is False:
                return
        try:
            configs = self._cadence_client.get_elastic_run_config(
                retries=1
            )
        except (ConnectionError, OSError):
            return
        except Exception:  # noqa: BLE001 - advisory channel
            return
        from dlrover_tpu_torch.master.brain import CADENCE_CONFIG_KEY

        steps = int(configs.get(CADENCE_CONFIG_KEY, 0) or 0)
        if steps <= 0 or steps == self.args.save_steps:
            return
        was = self.args.save_steps
        self.args.save_steps = steps
        telemetry.event(
            "brain.cadence.adopted", save_steps=steps, was=was
        )
        telemetry.gauge_set("train.save_steps", steps)
        logger.info(
            "adopted brain checkpoint cadence: save_steps %d -> %d",
            was, steps,
        )

    def _publish_losses(self):
        """Read the losses kept since the last log boundary (one host
        sync) into ``train.loss`` events, and the kernels' launch counts
        into ``kernel.launches`` gauges."""
        for step, loss in self._pending_losses:
            telemetry.event("train.loss", step=step, loss=float(loss))
        self._pending_losses = []
        for name, count in launch_counts().items():
            if count:
                telemetry.gauge_set("kernel.launches", count, kernel=name)

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
        resumed = self.maybe_resume()
        metrics = {}
        shm_saves = 0
        # a job resumed at/after max_steps is already done: don't train
        # an extra step or overwrite the final checkpoint
        stop = bool(args.max_steps) and self.global_step >= args.max_steps
        sampler = getattr(self.train_data, "sampler", None)
        # resume into the restored sampler epoch; don't set_epoch on the
        # resumed epoch itself (it would clear the mid-epoch offset)
        start_epoch = 0
        if resumed and sampler is not None:
            start_epoch = min(int(getattr(sampler, "epoch", 0)),
                              args.num_epochs - 1)
        for epoch in range(start_epoch, args.num_epochs):
            if stop:
                break
            if epoch != start_epoch and sampler is not None and hasattr(
                    sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            data_iter = iter(self.train_data)
            while True:
                # the input pipeline's stall, timed into the shm ring
                t_wait = time.time_ns()
                try:
                    batch = next(data_iter)
                except StopIteration:
                    break
                if self._timer is not None:
                    self._timer.record(Tag.DATA_WAIT, t_wait,
                                       time.time_ns() - t_wait)
                if self._profiler is not None:
                    self._profiler.maybe_start(self.global_step)
                self._prof.on_step_start(self.global_step)
                t0 = time.time_ns()
                with tracing.span("train.step", step=self.global_step + 1):
                    rng = self._step_rng()
                    if self.prestep is not None:
                        self.state, batch = self.prestep(self.state, batch)
                    self.state, metrics = self._accel.train_step(
                        self.state, batch, rng)
                    self.global_step += 1
                    if self._profiler is not None:
                        self._profiler.maybe_stop(self.global_step - 1,
                                                  block_on=metrics)
                if args.log_steps and "loss" in metrics:
                    self._pending_losses.append(
                        (self.global_step, metrics["loss"]))
                dur_ns = time.time_ns() - t0
                if self._timer is not None:
                    self._timer.record(Tag.STEP, t0, dur_ns)
                # the step number the window opened at (pre-increment);
                # the backend synchronises the device before a window
                # stops, and a finished window parses off-thread
                self._prof.on_step_end(self.global_step - 1, dur_ns / 1e9,
                                       block_on=metrics)
                self._step_telemetry(batch, dur_ns / 1e9)
                if args.log_steps and self.global_step % args.log_steps == 0:
                    loss = float(metrics.get("loss", float("nan")))
                    logger.info("step %d epoch %d loss %.5f",
                                self.global_step, epoch, loss)
                    self._publish_losses()
                    telemetry.flush()
                    self._maybe_adopt_cadence()
                write_runtime_metrics(self.global_step)
                if (self._engine is not None and args.save_steps
                        and self.global_step % args.save_steps == 0):
                    shm_saves += 1
                    self.save_checkpoint(
                        persist=shm_saves % max(args.save_storage_every, 1)
                        == 0)
                if args.eval_steps and self.eval_data is not None \
                        and self.global_step % args.eval_steps == 0:
                    self.evaluate()
                if args.max_steps and self.global_step >= args.max_steps:
                    stop = True
                    break
        self._publish_losses()
        if self._engine is not None:
            self._final_save()
        telemetry.flush()
        return self.state, metrics

    def _final_save(self):
        """The final persisted save. A cadence save's persist may still
        hold the shm lock, and a silently skipped save here would drop
        the end-of-run state: retry, woken by the saver's persist-done
        queue, within a deadline; then wait for the persist."""
        deadline = time.time() + 120
        while not self.save_checkpoint(persist=True):
            remaining = deadline - time.time()
            if remaining <= 0:
                logger.error(
                    "final checkpoint save at step %d kept getting "
                    "skipped; giving up", self.global_step,
                )
                return
            self._engine.wait_for_persist_progress(min(remaining, 2.0))
        t_wait = time.monotonic()
        self._engine.wait_for_persist(self.global_step, timeout=300)
        # the ONLY persist the training loop blocks on
        telemetry.event("ckpt.persist.wait", step=self.global_step,
                        dur=time.monotonic() - t_wait)

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

    def _refresh_prof_context(self):
        """The op-cost baseline key (model fingerprint + mesh shape),
        computed once after the build and after a restore, never in the
        step loop."""
        from dlrover_tpu_torch.common import profiling

        try:
            self._prof.set_context(
                profiling.model_fingerprint(self.state.params),
                profiling.mesh_shape_key(self._accel.mesh),
            )
        except Exception:  # noqa: BLE001 - an odd state tree only
            # loses baseline keying, never the training loop
            self._prof.set_context("unfingerprinted", "devices=?")

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
        on the fp32 master params, without gradients (on a DeviceMesh the
        global loss of every rank's rows)."""
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
                losses.append(global_value(self.eval_fn(
                    self.state.params, self._to_device(batch), rng)).float())
        loss = (float(torch.stack(losses).mean()) if losses
                else float("nan"))
        logger.info("eval at step %d: loss %.5f", self.global_step, loss)
        return loss

    def close(self):
        if self._profiler is not None:
            self._profiler.close()
        self._prof.close()
        if self._engine is not None:
            self._engine.close()
