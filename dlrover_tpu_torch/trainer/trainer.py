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

The in-process reshape, as in the JAX loop: with a ``reshape_channel``
(or the one an agent offers through ``NodeEnv.RESHAPE_DIR``) the Trainer
adopts a membership change at a step boundary without a restart. The
ranks first agree on the newest pending round (a MAX all-reduce over a
CPU gloo group; nothing at a world of one), so that every rank enters
the reshape at one boundary. Where every rank of the old world is alive,
each saves its shards at the live step into its shm segment (the Flash
Checkpoint save), the ranks that depart then ack and leave, and the
others re-form the process group (``reshape_devices_fn(request)`` gives
the new rank, size and store URL; by default the request's offset plus
the local rank, its total and its coordinator), rebuild the DeviceMesh
and the optimizer, and fill each new shard through the engine's targeted
load at exactly that step: what a rank held stays on its device, the
rest is read from the segment of the rank that held it (storage for one
on another host). A dead rank took its shards along: what the survivors
cover moves, the rest comes from a checkpoint at the live step, an older
one rolls the state back in process, and none fails the ack. A failure
restores the old world, its process group included, where every rank of
it is still there; the round is acked either way, and a failed ack
sends the agent down the restart path. A worker that cannot reshape
(Flash Checkpoint off, an optimizer with no DeviceMesh step, a seq axis
or a quant mode) leaves the agent's channel unmarked, so the agent
restarts it instead, and raises on a channel passed in. Under a master,
``adopt_cadence`` adopts the brain's checkpoint cadence (``save_steps``)
at log boundaries.

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
import torch.distributed as dist
from torch.distributed.tensor import DTensor

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
from dlrover_tpu_torch.parallel.mesh import reform_process_group
from dlrover_tpu_torch.parallel.reshaper import (
    _is_array,
    reshape_state,
    shard_boxes,
    survivors_cover,
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
        self._make_side_group()
        # restart-free elasticity: the channel the agent exports (or a
        # test passes) is polled at every step boundary
        self._reshape_devices_fn = reshape_devices_fn
        self._reshape_round = -1
        self._departed = False    # this worker left at a reshape
        self._world_lost = False  # a failed reshape could not restore it
        self._reshape_channel = self._install_reshape_channel(
            reshape_channel)

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
        self._shm_saves = 0
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
            # a reshape re-enters iter(self.train_data) WITHOUT advancing
            # the epoch: the remainder was re-sharded over the new world,
            # and consumption is recorded before each yield, so the fresh
            # iterator continues exactly after the trained batches
            reshaped = True
            while reshaped and not stop:
                reshaped = False
                stop, reshaped, metrics = self._train_epoch(epoch, metrics)
        self._publish_losses()
        if self._engine is not None and not self._departed:
            self._final_save()
        telemetry.flush()
        return self.state, metrics

    def _train_epoch(self, epoch: int, metrics: dict):
        """Steps over one iterator of ``train_data``: (stop, reshaped,
        metrics). ``reshaped``: a reshape was adopted at a boundary and
        the epoch goes on over a fresh iterator."""
        args = self.args
        data_iter = iter(self.train_data)
        while True:
            # the step boundary: adopt a pending membership change
            if self._maybe_reshape():
                return self._departed, not self._departed, metrics
            if self._world_lost:
                raise RuntimeError(
                    "an in-process reshape failed and the old world is "
                    "gone: this worker must be restarted")
            # the input pipeline's stall, timed into the shm ring
            t_wait = time.time_ns()
            try:
                batch = next(data_iter)
            except StopIteration:
                return False, False, metrics
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
                self._shm_saves += 1
                self.save_checkpoint(
                    persist=self._shm_saves
                    % max(args.save_storage_every, 1) == 0)
            if args.eval_steps and self.eval_data is not None \
                    and self.global_step % args.eval_steps == 0:
                self.evaluate()
            if args.max_steps and self.global_step >= args.max_steps:
                return True, False, metrics

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

    # ------------------------------------------- in-process reshape

    # how long a rank waits for its own request once its peers agreed on
    # a round, and for another host's persist of the boundary step
    reshape_wait_s = 120.0

    def _reshape_unsupported(self) -> str:
        """Why this worker cannot reshape in process ('' when it can)."""
        from dlrover_tpu_torch.parallel.accelerate import steps_on_mesh

        strategy = self._accel.strategy
        if self._engine is None:
            return ("flash_checkpoint is off, and the reshape moves the "
                    "state through it (a device-to-device mover is "
                    "ROADMAP Queue 1 item 8)")
        if not steps_on_mesh(self.state.optimizer):
            return (f"{type(self.state.optimizer).__name__} has no "
                    "DeviceMesh step (ROADMAP Queue 1 item 7)")
        if strategy.mesh.seq != 1:
            return "a seq axis (ROADMAP Queue 1 item 8)"
        if strategy.compute_dtype in ("fp8", "int8"):
            return (f"compute_dtype={strategy.compute_dtype!r} on a process "
                    "group (ROADMAP Queue 1 item 12)")
        return ""

    def _install_reshape_channel(self, channel):
        """The channel to poll: the one passed in (raising when this
        worker cannot reshape), else the agent's, marked ready only when
        it can; unmarked, the agent keeps the restart path."""
        from dlrover_tpu_torch.trainer.elastic.reshape import ReshapeChannel

        why = self._reshape_unsupported()
        if channel is not None and why:
            raise NotImplementedError(f"in-process reshape: {why}")
        if channel is None:
            rdir = os.environ.get(NodeEnv.RESHAPE_DIR, "")
            if not rdir:
                return None
            if why:
                logger.info("the agent's reshape channel is declined (%s): "
                            "a membership change restarts this worker", why)
                return None
            channel = ReshapeChannel(rdir)
        # advertise the watcher: only now does the agent signal a reshape
        # instead of restarting this worker
        channel.mark_ready()
        return channel

    def _make_side_group(self):
        """The CPU group the boundary agreement runs over: the default
        group under gloo, a gloo group beside NCCL (created by every rank
        after each mesh, a collective), none at a world of one."""
        self._side_group = None
        if (dist.is_initialized() and dist.get_world_size() > 1
                and dist.get_backend() != "gloo"):
            self._side_group = dist.new_group(backend="gloo")

    @staticmethod
    def _world() -> tuple:
        """(rank, size) of this process in the default group; (0, 1)
        without one."""
        if not dist.is_initialized():
            return 0, 1
        return dist.get_rank(), dist.get_world_size()

    def _await_request(self, least_round: int):
        """This worker's request of ``least_round`` or later, waited for up
        to ``reshape_wait_s``; None on timeout."""
        deadline = time.monotonic() + self.reshape_wait_s
        while True:
            req = self._reshape_channel.poll(least_round - 1)
            if req is not None or time.monotonic() >= deadline:
                return req
            time.sleep(0.02)

    def _agreed_request(self):
        """The request every rank adopts at this boundary, or None. Ranks
        read their requests at different boundaries, so with a world above
        one they first take the MAX of their newest pending rounds over
        the side group; a rank behind waits for its own request. A request
        naming a dead departure skips the old group (a dead rank never
        answers), and so does a rank whose agreement failed because a peer
        died: its agent's request names the death."""
        req = self._reshape_channel.poll(self._reshape_round)
        if self._world()[1] <= 1 or (req is not None and req.dead()):
            return req
        mine = torch.tensor([req.round if req is not None else -1])
        try:
            dist.all_reduce(mine, op=dist.ReduceOp.MAX,
                            group=self._side_group)
        except RuntimeError:
            logger.warning("the boundary agreement failed (a peer died); "
                           "waiting for this worker's request")
            req = self._await_request(self._reshape_round + 1)
            if req is None or not req.departed:
                raise
            # a peer gone before the boundary save took its shards along,
            # whatever its agent reported (a drained worker late to ack
            # its departure is stopped unsaved): a dead departure
            req.departed = {n: "dead" for n in req.departed}
            return req
        agreed = int(mine.item())
        if agreed <= self._reshape_round:
            return None
        if req is None or req.round < agreed:
            req = self._await_request(agreed)
            if req is None:
                raise RuntimeError(
                    f"the ranks agreed on reshape round {agreed} and this "
                    f"worker's request did not come in "
                    f"{self.reshape_wait_s:.0f} s")
        return req

    def _reshape_place(self, req) -> tuple:
        """(rank, size, store URL) of this worker in the request's group:
        ``reshape_devices_fn(req)``, else the request's offset plus the
        local rank, its total and its coordinator."""
        if self._reshape_devices_fn is not None:
            rank, size, url = self._reshape_devices_fn(req)
            return int(rank), int(size), str(url)
        local = int(os.environ.get(NodeEnv.LOCAL_RANK, "0") or 0)
        return req.rank_offset + local, max(int(req.total), 1), req.coordinator

    @staticmethod
    def _node_ranks(world: dict, node: int) -> range:
        """The global ranks of ``node`` in ``world`` (node ranks ascending,
        each with its local world)."""
        offset = sum(n for r, n in sorted(world.items()) if r < node)
        return range(offset, offset + world.get(node, 0))

    def _departed_ranks(self, req, reason: str) -> set:
        """Old ranks of the nodes that left for ``reason``."""
        nodes = [n for n, why in req.departed.items() if why == reason]
        if nodes and not req.prev_world:
            raise ValueError(
                f"round {req.round}: nodes {nodes} {reason} but the request "
                "has no prev_world to place their ranks")
        return {r for n in nodes for r in self._node_ranks(req.prev_world, n)}

    def _maybe_reshape(self) -> bool:
        """Adopt a pending membership change IN PROCESS at this step
        boundary. Returns True when a reshape happened (the caller
        restarts its epoch iterator, or stops when this worker departed).
        A failed reshape acks failure, after restoring the old world where
        it can; the agent then falls back to the restart path."""
        if self._reshape_channel is None or self._departed:
            return False
        t_agree = time.monotonic()
        req = self._agreed_request()
        if req is None:
            return False
        t0 = time.monotonic()
        self._reshape_legs = {"agree_s": round(t0 - t_agree, 6)}
        ok, stats = False, {}
        # transaction snapshot: a failure past any mutation must not
        # leave a half-adopted world behind a failed ack
        sampler = getattr(self.train_data, "sampler", None)
        snap = dict(
            accel=self._accel, state=self.state, step=self.global_step,
            compiled=self._compiled_once, world=self._world(),
            group=dist.group.WORLD if dist.is_initialized() else None,
            sampler=((sampler.num_replicas, sampler.rank,
                      sampler.state_dict())
                     if sampler is not None and hasattr(sampler, "state_dict")
                     else None),
            batch_size=getattr(self.train_data, "batch_size", None))
        with tracing.span("elastic.reshape", round=req.round,
                          step=self.global_step):
            try:
                stats = self._apply_reshape(req, snap)
                ok = True
            except Exception as e:  # noqa: BLE001 - ANY failure here must
                # surface as a failed ack, never hang the agent on it
                logger.exception(
                    "in-process reshape for round %s failed; acking failure "
                    "(the agent restarts this worker)", req.round)
                stats = {"error": f"{type(e).__name__}: {e}"[:200]}
                self._restore_world(req, snap)
        dur = time.monotonic() - t0
        stats.update(self._reshape_legs)
        # ``step``: the boundary the new world takes over at (the step
        # rolled back to on the rollback path)
        self._reshape_channel.ack(req.round, ok, dur=dur,
                                  step=self.global_step, **stats)
        # consume the round even on failure: the agent's restart is the
        # retry path, and re-polling it would re-run the reshape
        self._reshape_round = req.round
        if not ok:
            return False
        telemetry.event(
            "elastic.reshape", dur=dur, round=req.round,
            step=self.global_step, shards_moved=stats.get("moved", 0),
            shards_pulled=stats.get("pulled", 0),
            rolled_back_to=stats.get("rolled_back_to", -1))
        telemetry.observe("elastic.reshape.seconds", dur)
        telemetry.counter_inc("elastic.reshape.count")
        if stats.get("pulled"):
            telemetry.counter_inc("elastic.reshape.shards_pulled",
                                  stats["pulled"])
        telemetry.gauge_set("elastic.reshape.last_s", dur)
        telemetry.flush()
        logger.info(
            "%s round %s in process in %.3fs (world=%s, moved=%s pulled=%s "
            "rolled_back_to=%s)",
            "left at" if self._departed else "adopted", req.round, dur,
            req.world, stats.get("moved"), stats.get("pulled"),
            stats.get("rolled_back_to", -1))
        return True

    def _leg(self, name: str, t0: float) -> float:
        """Record a reshape leg's seconds since ``t0``; returns now."""
        now = time.monotonic()
        self._reshape_legs[f"{name}_s"] = round(now - t0, 6)
        return now

    def _apply_reshape(self, req, snap: dict) -> dict:
        from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
            _tree_flatten_with_names,
        )

        chaos_point("elastic.reshape", verb="drain", step=self.global_step,
                    round=req.round)
        rank, size, url = self._reshape_place(req)
        old_rank, old_size = snap["world"]
        dead = self._departed_ranks(req, "dead") if req.dead() else set()
        names, old_leaves, _ = _tree_flatten_with_names(
            {"train": self._state_tree()})
        held = self._held_pieces(names, old_leaves, old_rank)
        t = time.monotonic()
        if req.leaving and dead:
            # its peers could not agree on a boundary: it goes unsaved
            self._leave()
            return {"departed": True, "moved": 0, "pulled": 0}
        if not dead:
            # every rank of the old world is alive here: each saves its
            # shards at this step, and none reads before all have. A node
            # that joins or leaves may be another host, whose slices cross
            # through storage: then the step is persisted too
            self._boundary_save(persist=bool(
                req.prev_world and set(req.world) != set(req.prev_world)))
            if old_size > 1:
                dist.barrier(group=self._side_group)
            t = self._leg("boundary_save", t)
            if req.leaving:
                self._leave()
                return {"departed": True, "moved": 0, "pulled": 0}
        else:
            survivors = (sum(req.prev_world.values()) - len(dead)
                         - len(self._departed_ranks(req, "drained")))
            if size > survivors:
                raise NotImplementedError(
                    f"round {req.round}: a dead departure and a joining "
                    "rank in one round (the joiner would restore at a step "
                    "the survivors may roll back from)")
            if any(not survivors_cover(leaf, dead) for leaf in old_leaves):
                # CONSISTENCY GATE: a lost shard can only come from a
                # checkpoint, and one older than the live step would mix
                # steps inside one state: pull at the live step, roll the
                # whole state back in process when older, fail when none
                ckpt_step = self._engine.latest_step()
                if ckpt_step < 0:
                    raise ValueError(
                        "shards lost with a dead rank and no checkpoint "
                        "exists - in-process reshape would lose state")
                if ckpt_step != self.global_step:
                    return self._reshape_rollback(req, rank, size, url)
            elif self._engine.latest_step() != self.global_step:
                # the survivors hold everything: save it at this step
                self._boundary_save(persist=False)
        chaos_point("elastic.reshape", verb="reshard", step=self.global_step,
                    round=req.round)
        reform_process_group(url, rank, size, self.device)
        if dead and size > 1:
            dist.barrier()  # every survivor's boundary save landed
        t = self._leg("group_reform", t)
        self._adopt_accel(self._empty_params())
        t = self._leg("adopt", t)
        report = self._move_state(names, old_leaves, held, dead)
        t = self._leg("restore", t)
        chaos_point("elastic.reshape", verb="resume", step=self.global_step,
                    round=req.round)
        self._reshape_data(req)
        return {"moved": report.moved, "pulled": report.pulled,
                "move_s": round(report.move_seconds, 6), "devices": size}

    def _leave(self):
        """This worker departs: out of the group, and no more steps."""
        if dist.is_initialized():
            dist.destroy_process_group()
        self._departed = True

    def _held_pieces(self, names, leaves, rank: int) -> dict:
        """``{name: (global box, local tensor)}`` of what this rank holds
        of each tensor leaf: the mover copies these, not reads them."""
        held = {}
        for name, leaf in zip(names, leaves):
            if isinstance(leaf, DTensor):
                box = shard_boxes(leaf.shape, leaf.device_mesh.mesh,
                                  leaf.placements)[rank]
                held[name] = (box, leaf.to_local())
            elif isinstance(leaf, torch.Tensor):
                held[name] = (tuple(slice(0, n) for n in leaf.shape), leaf)
        return held

    def _empty_params(self) -> dict:
        """The params' layout on the mesh of the current group, unfilled."""
        from dlrover_tpu_torch.parallel.accelerate import empty_params
        from dlrover_tpu_torch.parallel.mesh import build_mesh

        strategy = self._accel.strategy
        return empty_params(self.state.params, self.device,
                            build_mesh(strategy.mesh),
                            self.param_logical_axes, strategy.rules)

    def _move_state(self, names, old_leaves, held, dead):
        """Fill the adopted (empty) state from the live one at this step:
        ``reshape_state`` over the engine's targeted load, held pieces
        copied, the dead ranks' leaves from the checkpoint."""
        from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
            _tree_flatten_with_names,
            _unflatten,
        )

        materialize_optimizer_state(self.state.optimizer)
        tnames, targets, treedef = _tree_flatten_with_names(
            {"train": self._state_tree()})
        if tnames != names:
            raise ValueError("the state's leaves changed across the "
                             f"reshape: {sorted(set(tnames) ^ set(names))[:3]}")

        def move(requests):
            got = self._engine.load(target=dict(requests),
                                    step=self.global_step, held=held,
                                    wait_s=self.reshape_wait_s)
            if got is None:
                raise ValueError(f"step {self.global_step} is in no local "
                                 "segment and not in storage")
            return got[0]

        leaves, report = reshape_state(old_leaves, targets, names, move,
                                       lost_ranks=dead,
                                       fallback=self._pull_lost_shards)
        self._load_state_tree(_unflatten(treedef, leaves)["train"])
        return report

    def _pull_lost_shards(self, requests: dict) -> dict:
        """Fallback loader for leaves whose only shards died with a rank:
        a TARGETED engine load at exactly the live step, keyed by the
        checkpoint's leaf names, so each new shard reads only the byte
        ranges it needs from shm (preferred) or verified storage."""
        result = self._engine.load(target=dict(requests),
                                   step=self.global_step)
        if result is None:
            raise ValueError(
                f"lost shards {sorted(requests)[:3]} are not restorable at "
                f"the live step {self.global_step} from any checkpoint")
        return result[0]

    def _reshape_rollback(self, req, rank: int, size: int, url: str) -> dict:
        """Lost shards and no checkpoint at the live step: the whole state
        returns to the newest restorable checkpoint IN PROCESS (train
        state, loader progress, prestep sidecar) on the new group."""
        logger.warning(
            "reshape round %s: shards lost with a dead rank and the newest "
            "checkpoint predates the live step - rolling back in process",
            req.round)
        chaos_point("elastic.reshape", verb="reshard", step=self.global_step,
                    round=req.round)
        reform_process_group(url, rank, size, self.device)
        self._adopt_accel(self._empty_params())
        materialize_optimizer_state(self.state.optimizer)
        self.global_step = 0
        resumed = self.maybe_resume()
        chaos_point("elastic.reshape", verb="resume", step=self.global_step,
                    round=req.round)
        self._reshape_data(req)
        from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
            _tree_flatten_with_names,
        )

        leaves = _tree_flatten_with_names({"train": self._state_tree()})[1]
        return {"moved": 0, "pulled": sum(map(_is_array, leaves)),
                "rolled_back_to": resumed, "devices": size}

    def _adopt_accel(self, params: dict):
        """A fresh ``auto_accelerate`` over the current process group with
        ``params`` (already laid out on its mesh) as the state's params;
        the optimizer is new and its state empty until filled."""
        self._accel = auto_accelerate(
            self.loss_fn, self.init_fn, self.optimizer,
            strategy=self._accel.strategy, device=self.device,
            seed=self.args.seed, param_logical_axes=self.param_logical_axes,
            reuse_params=params)
        self.state = self._accel.state
        self._compiled_once = False
        self._make_side_group()
        self._refresh_flops()
        self._refresh_prof_context()

    def _reshape_data(self, req):
        """Exactly-once re-accounting: the epoch remainder re-sharded over
        the new world's replicas along the batch axes, with the
        per-replica batch rescaled so the global batch stays the same."""
        loader = self.train_data
        if not hasattr(loader, "reshape"):
            return
        from dlrover_tpu_torch.parallel.mesh import batch_place

        index, count = batch_place(self._accel.strategy.mesh)
        old = getattr(getattr(loader, "sampler", None), "num_replicas", count)
        bs = int(getattr(loader, "batch_size", 0) or 0)
        if bs and old != count:
            if (bs * old) % count:
                raise ValueError(
                    f"a global batch of {bs * old} rows does not split over "
                    f"{count} replicas")
            loader.update_batch_size(bs * old // count)
        loader.reshape(count, index)

    def _boundary_save(self, persist: bool):
        """Save this step for a reshape (blocking), retried while a
        persist holds the shm lock; with ``persist``, wait for it. A step
        already committed to storage is not saved again: a round adopted
        at the boundary of the one before, with no step between, finds it
        there from that round's save, at that world's layout, and a second
        save at this world's layout would leave pieces of both layouts at
        one step, in shm and in its storage dir, which no restore tiles."""
        if self._engine.persisted_step() == self.global_step:
            return
        deadline = time.monotonic() + self.reshape_wait_s
        while not self.save_checkpoint(persist=persist):
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"the reshape's save at step {self.global_step} kept "
                    "getting skipped")
            self._engine.wait_for_persist_progress(1.0)
        if persist and not self._engine.wait_for_persist(
                self.global_step, timeout=self.reshape_wait_s):
            raise RuntimeError(f"the persist of step {self.global_step} did "
                               "not land")

    def _restore_world(self, req, snap: dict):
        """After a failed reshape: back to the snapshot's world. Where the
        old group was left, it is formed again (every rank of it must be
        here: no departure, the same size) and the old state re-laid on it
        from what this rank held; otherwise the world is lost and the
        agent's restart takes over."""
        self.global_step = snap["step"]
        if snap["sampler"] is not None:
            sampler = self.train_data.sampler
            sampler.num_replicas, sampler.rank = snap["sampler"][:2]
            sampler.load_state_dict(snap["sampler"][2])
        if snap["batch_size"] is not None:
            self.train_data.update_batch_size(snap["batch_size"])
        self._departed = False
        group = dist.group.WORLD if dist.is_initialized() else None
        if group is snap["group"]:
            self._accel, self.state = snap["accel"], snap["state"]
            self._compiled_once = snap["compiled"]
            # a dead rank's group answers no collective again
            self._world_lost = req.dead()
            return
        old_rank, old_size = snap["world"]
        if req.departed or req.leaving or int(req.total) != old_size:
            self._world_lost = True
            return
        from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
            _tree_flatten_with_names,
        )

        try:
            _, _, url = self._reshape_place(req)
            if url.startswith("file://"):
                url += f".rollback{req.round}"
            reform_process_group(url, old_rank, old_size, self.device)
            self._accel, self.state = snap["accel"], snap["state"]
            names, leaves, _ = _tree_flatten_with_names(
                {"train": self._state_tree()})
            held = self._held_pieces(names, leaves, old_rank)
            self._adopt_accel(self._empty_params())
            self._move_state(names, leaves, held, set())
        except Exception:  # noqa: BLE001 - then the world is lost
            logger.exception("could not restore the world before round %s",
                             req.round)
            self._world_lost = True

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
