"""Per-host elastic training agent.

Equivalent capability: reference dlrover/python/elastic_agent/torch/
training.py — ElasticTrainingAgent (:346) with master-driven rendezvous
(MasterRendezvousHandler :165), run loop (_invoke_run :544: monitor
workers, save-checkpoint-then-restart on failure :589, membership-change
restart :602), launcher (launch_agent :673), ElasticLaunchConfig (:107);
NetworkCheckElasticAgent (:783) running probe rounds and reporting to the
master's pairing logic.

The PyTorch port's copy of dlrover_tpu/agent/training_agent.py. Worker
processes are torch processes, one per card; the rendezvous hands them
the store address ``init_distributed`` reads
(``NodeEnv.JAX_COORDINATOR_ADDR``) with ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``; the failure taxonomy maps process exit codes AND
CUDA/NCCL error patterns to hardware-vs-software errors. The agent
hosts the checkpoint saver and never creates a CUDA context itself (its
probe's device legs run in a child process, and so do the network
check's: ``--network-check`` runs agent/node_check.py in one child per
local rank, on the cards unless ``accelerator`` is "cpu"). A master's
deep-capture directive is relayed into local worker 0's capture channel
by a background thread, one at a time, and its outcome reported back.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

from dlrover_tpu_torch.agent.ckpt_saver import AGENT_SAVER_ENV
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import flight, telemetry, tracing
from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.agent.monitor import (
    HeartbeatReporter,
    ResourceMonitor,
    TelemetryReporter,
    TimerRingExporter,
)
from dlrover_tpu_torch.agent.paral_config_tuner import ParalConfigTuner
from dlrover_tpu_torch.common.constants import (
    ConfigPath,
    ExitCode,
    JobConstant,
    NodeEnv,
    RendezvousName,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


def default_log_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "dlrover_tpu_torch", "logs")


def apply_compilation_cache_env(cache_dir: str, env: dict) -> dict:
    """Point a worker env at the kernel build directory shared across
    worker restarts (``ops/_build.py``): the port's counterpart of the
    persistent XLA compilation cache. A restarted worker then loads its
    built kernels instead of running ``nvcc`` again. A user-provided
    value wins; "" keeps the package's own ``ops/build/``."""
    from dlrover_tpu_torch.ops._build import BUILD_DIR_ENV

    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        env.setdefault(BUILD_DIR_ENV, cache_dir)
    return env


@dataclasses.dataclass
class ElasticLaunchConfig:
    """Launch configuration (reference ElasticLaunchConfig :107)."""

    min_nodes: int = 1
    max_nodes: int = 1
    nproc_per_node: int = 1
    node_rank: int = 0
    max_restarts: int = 3
    monitor_interval: float = JobConstant.TRAINING_AGENT_LOOP_INTERVAL
    rdzv_timeout: float = JobConstant.RDZV_JOIN_TIMEOUT_DEFAULT
    # elastic (--nnodes lo:hi): how long the master waits for more
    # nodes beyond min before forming the world
    rdzv_elastic_wait: float = 30.0
    network_check: bool = False
    comm_perf_test: bool = False
    node_unit: int = 1
    auto_config: bool = False
    auto_tunning: bool = False
    exclude_straggler: bool = False
    save_at_breakpoint: bool = False
    accelerator: str = "gpu"
    log_dir: str | None = None
    run_id: str = "dlrover-tpu"
    # the kernel build directory shared across worker restarts: a
    # restarted worker must load its kernels, not rebuild them, or the
    # build eats the goodput the flash checkpoint bought. "" = the
    # package's own ops/build/
    compilation_cache_dir: str = ""
    # Prometheus /metrics endpoint on the agent (reference xpu_timer
    # brpc/Prometheus export): -1 = disabled (default: an HTTP listener
    # is opt-in), 0 = ephemeral port, >0 = fixed port
    metrics_port: int = -1
    # how long one ride-through attempt waits for an unreachable master
    # to come back before logging the outage as (still) lost; workers
    # keep training either way and the agent re-probes on its next tick
    master_ride_through: float = JobConstant.MASTER_RIDE_THROUGH_DEFAULT
    # restart-free elasticity: on a membership change where the master's
    # verdict for this node is "reshape" AND every local worker
    # advertised a reshape watcher, signal the live workers to rebuild
    # their mesh in process instead of restarting them. Workers without
    # a watcher (or a failed/timed-out reshape) keep the classic
    # restart path, so this is safe to leave on.
    reshape_in_process: bool = True
    # how long the agent waits for all local workers to ack an
    # in-process reshape before falling back to the restart path
    reshape_ack_timeout: float = 60.0

    def auto_configure_params(self):
        """--auto-config: one worker process per visible card
        (``device_count`` creates no CUDA context in the agent)."""
        if not self.auto_config:
            return
        try:
            import torch

            self.nproc_per_node = max(torch.cuda.device_count(), 1)
        except Exception:  # noqa: BLE001
            self.nproc_per_node = max(self.nproc_per_node, 1)


class WorkerSpec:
    def __init__(self, entrypoint: str, args: tuple, config: ElasticLaunchConfig):
        self.entrypoint = entrypoint
        self.args = args
        self.config = config


def world_rank_offset(world: dict, node_rank: int) -> int:
    """Global-rank offset of ``node_rank`` in a formed world: the local
    world sizes of every lower rank, summed in sorted order. One
    definition shared by spawn-time rank assignment and reshape-time
    signaling — the two must never disagree on a worker's global rank."""
    return sum(
        size
        for rank, size in sorted(world.items())
        if rank < node_rank
    )


class MasterRendezvousHandler:
    """Joins the master rendezvous and polls for the formed world
    (reference MasterRendezvousHandler :165)."""

    def __init__(
        self,
        name: str,
        node_rank: int,
        client: MasterClient,
        local_world_size: int,
        timeout: float,
        verified_step_fn=None,
        probe_scheduler=None,
    ):
        self._name = name
        self._node_rank = node_rank
        self._client = client
        self._local_world_size = local_world_size
        self._timeout = timeout
        # hardware-probe cadence cache (agent/probe.py): joins ship the
        # freshest per-leg timings; the process-wide default means a
        # net-check round and the training join share one probe
        from dlrover_tpu_torch.agent.probe import default_scheduler

        self._probe = (
            probe_scheduler if probe_scheduler is not None
            else default_scheduler()
        )
        # callable -> list of locally-restorable checkpoint steps,
        # reported at join for the master's restore consensus (the
        # master forces only a step common to EVERY member)
        self._verified_step_fn = verified_step_fn
        # consensus the master broadcast with the latest formed world
        self.last_restore_step = -1

    def _local_verified_steps(self) -> list[int]:
        if self._verified_step_fn is None:
            return []
        try:
            return sorted(
                {int(s) for s in self._verified_step_fn() if int(s) >= 0},
                reverse=True,
            )
        except Exception:  # noqa: BLE001 - reporting steps is best-
            # effort; a scan error must not block the rendezvous
            logger.warning(
                "verified-step scan failed; joining without one",
                exc_info=True,
            )
            return []

    def next_rendezvous(self):
        """Returns (round, world, rank_offset, total_world, coordinator)."""
        # root span of the round's trace: every join/poll RPC under it
        # propagates this context, so the master-side join/form spans
        # nest under it — one cross-host tree per rendezvous round
        with tracing.span(
            "rdzv.round", rank=self._node_rank, rdzv=self._name
        ):
            return self._next_rendezvous()

    def _probe_report(self, fresh: bool = False) -> dict:
        """The hardware probe report to ship with a join: the cached
        sample while it is fresh, a re-run when the gate demanded one
        (``fresh``) or nothing is cached yet. Empty when disabled."""
        from dlrover_tpu_torch.agent import probe as hw_probe

        if hw_probe.probe_disabled():
            return {}
        if fresh or self._probe.last_report is None:
            return self._probe.run(self._node_rank)
        return self._probe.last_report

    def _next_rendezvous(self):
        t0 = time.monotonic()
        verified_steps = self._local_verified_steps()
        newest = verified_steps[0] if verified_steps else -1
        # probe BEFORE the join: the master's health gate judges these
        # per-leg timings against the fleet and this host's own history
        probe_report = self._probe_report()
        joined = self._client.join_rendezvous(
            self._node_rank, self._local_world_size, self._name,
            verified_ckpt_step=newest,
            verified_ckpt_steps=verified_steps,
            probe_report=probe_report,
        )
        start = time.time()
        while True:
            if not joined:
                # the master acked False (its join handler faulted —
                # e.g. an injected rdzv.join drop): the node was never
                # recorded as waiting, so re-send the join or this node
                # polls an empty world until the timeout
                joined = self._client.join_rendezvous(
                    self._node_rank, self._local_world_size, self._name,
                    verified_ckpt_step=newest,
                    verified_ckpt_steps=verified_steps,
                    probe_report=probe_report,
                )
            world = self._client.get_comm_world(self._name, self._node_rank)
            if world and world.world and self._node_rank in world.world:
                break
            # an acked join with no world forming is EITHER a round
            # still filling or this host parked at the health gate —
            # only the verdict poll can tell them apart
            verdict = self._client.get_node_health(self._node_rank)
            if verdict.verdict in ("quarantine", "refuse"):
                remaining = start + self._timeout - time.time()
                wait = max(min(verdict.retry_after_s, remaining), 1.0)
                if remaining <= wait:
                    raise TimeoutError(
                        f"rendezvous {self._name}: host "
                        f"{self._node_rank} {verdict.verdict}d by the "
                        f"health gate ({verdict.reason}) and the "
                        f"backoff outlives the {self._timeout}s window"
                    )
                logger.warning(
                    "health gate %sd this host (%s); re-probing in "
                    "%.0fs (strike %d)",
                    verdict.verdict, verdict.reason, wait,
                    verdict.strikes,
                )
                telemetry.event(
                    "probe." + verdict.verdict,
                    rank=self._node_rank,
                    reason=verdict.reason,
                    retry_after_s=wait,
                    strikes=verdict.strikes,
                )
                # wait out the backoff, then re-join with a FRESH
                # probe — the gate re-serves the standing verdict to
                # anything staler
                time.sleep(wait)
                probe_report = self._probe_report(fresh=True)
                joined = self._client.join_rendezvous(
                    self._node_rank, self._local_world_size, self._name,
                    verified_ckpt_step=newest,
                    verified_ckpt_steps=verified_steps,
                    probe_report=probe_report,
                )
                continue
            if time.time() - start > self._timeout:
                raise TimeoutError(
                    f"rendezvous {self._name} timed out after "
                    f"{self._timeout}s (world={getattr(world, 'world', None)})"
                )
            time.sleep(1)
        rank_offset = world_rank_offset(world.world, self._node_rank)
        total = sum(world.world.values())
        # Rendezvous can block for the whole elastic-wait window; reset
        # stall clocks in THIS process so the wait is not read as a
        # hang. Scope note: detectors live per-process, so this covers
        # in-process/standalone trainers that drive a rendezvous
        # handler directly; subprocess workers are restarted after a
        # rendezvous and start with fresh clocks anyway (and their
        # restore path resets via Trainer.maybe_resume).
        from dlrover_tpu_torch.trainer.fault_tolerance import (
            notify_progress_reset,
        )

        notify_progress_reset("rendezvous-resume")
        self.last_restore_step = getattr(world, "restore_step", -1)
        telemetry.event(
            "rdzv.wait",
            dur=time.monotonic() - t0,
            name=self._name,
            round=world.round,
            world=len(world.world),
            restore_step=self.last_restore_step,
        )
        return world.round, world.world, rank_offset, total, world.coordinator_addr


class WorkerProcess:
    def __init__(self, proc: subprocess.Popen, local_rank: int, global_rank: int):
        self.proc = proc
        self.local_rank = local_rank
        self.global_rank = global_rank

    @property
    def returncode(self):
        return self.proc.poll()


# CUDA/NCCL stderr patterns that indicate a device (hardware) problem
# rather than a user-code bug — the GPU analogue of the reference's
# exit-code taxonomy (training.py:353-356).
_DEVICE_ERROR_PATTERNS = (
    "CUDA error: an illegal memory access",
    "CUDA error: unspecified launch failure",
    "cudaErrorLaunchFailure",
    "uncorrectable ECC error",
    "NCCL error",
    "GPU is lost",
    "device or resource busy",
)


def classify_exit(
    returncode: int, log_tail: str = "", stopping: bool = False,
    draining: bool = False,
) -> str:
    if returncode == 0:
        return "succeeded"
    if (stopping or draining) and (
        -returncode == signal.SIGTERM or returncode == ExitCode.TERMED
    ):
        # the AGENT sent that SIGTERM (stop/restart path): a worker
        # dying of it is a clean stop, not a software failure — it must
        # not burn a restart budget or be reported as a fault. The same
        # holds for a SIGTERM landing during an announced-preemption
        # drain: the teardown is the PLAN, not a failure — without the
        # draining flag this exact notice-then-SIGTERM shape was
        # charged as a software failure (and the ledger billed the
        # whole event to restart even when the drain succeeded).
        return "stopped"
    if draining and (
        -returncode in (signal.SIGKILL, signal.SIGTERM)
        or returncode in (ExitCode.KILLED, ExitCode.TERMED)
    ):
        # the platform's announced kill landed while (or after) the
        # drain ran: account it as the preemption it is — no restart
        # budget burned, no software-failure report
        return "preempted"
    if returncode in ExitCode.HARDWARE_ERRORS or -returncode in (
        signal.SIGABRT,
        signal.SIGBUS,
    ):
        return "hardware"
    if any(p in log_tail for p in _DEVICE_ERROR_PATTERNS):
        return "hardware"
    if returncode == ExitCode.OOM or -returncode == signal.SIGKILL:
        return "oom"
    return "software"


class ElasticTrainingAgent:
    """Runs and supervises the local worker processes of one node."""

    def __init__(
        self,
        config: ElasticLaunchConfig,
        spec: WorkerSpec,
        client: MasterClient,
    ):
        self._config = config
        self._spec = spec
        self._client = client
        self._workers: list[WorkerProcess] = []
        self._restart_count = 0
        self._remaining_restarts = config.max_restarts
        self._rdzv_handler = MasterRendezvousHandler(
            RendezvousName.ELASTIC_TRAINING,
            config.node_rank,
            client,
            config.nproc_per_node,
            config.rdzv_timeout,
            verified_step_fn=self._restorable_steps,
        )
        self._heartbeat = HeartbeatReporter(client)
        self._resource_monitor = ResourceMonitor(client)
        self._telemetry_reporter = TelemetryReporter(client)
        self._paral_tuner = ParalConfigTuner(client) \
            if config.auto_tunning else None
        self._timer_exporter = TimerRingExporter()
        self._log_files: list[str] = []
        self._ckpt_saver = None
        # set while the agent itself is terminating workers, so their
        # -SIGTERM exits classify as "stopped" instead of "software"
        self._stopping = False
        # set once an announced-preemption drain ran (the run loop
        # returns right after, so this is observable state for tests
        # and the exit taxonomy, not a loop flag)
        self._draining = False
        self._start_mono = time.monotonic()
        # True while the current contiguous hang-diagnosis episode has
        # already been flight-dumped (one artifact per episode, not one
        # per monitor tick); cleared when the verdict clears
        self._hang_episode_dumped = False
        # restart-free elasticity: the rendezvous round the running
        # workers were spawned into (or last reshaped to), and the
        # per-local-rank agent<->worker reshape channels
        self._last_round = -1
        self._last_world: dict = {}
        self._reshape_channels: dict[int, object] = {}
        # deep-profiling capture channels (agent <-> worker), plus the
        # executor thread and the in-flight directive id: the one-capture
        # discipline means at most one capture runs here at a time
        self._capture_channels: dict[int, object] = {}
        self._capture_thread = None
        self._capture_inflight = ""

    # ----------------------------------------------------------- lifecycle

    def _restorable_steps(self) -> list[int]:
        """The checkpoint steps this host could restore right now:
        verified storage steps, plus the shm step — but the latter only
        on single-host jobs, because a multi-host sharded engine dedups
        replicated leaves to one writer and a host's shm may then be
        target-incomplete (its restore path would refuse it), so
        advertising it could broadcast a consensus step some host
        cannot actually load. Reported at rendezvous join; the master
        forces the newest step common to every member."""
        from dlrover_tpu_torch.agent.ckpt_saver import (
            AsyncCheckpointSaver,
            SharedMemoryHandler,
            verified_storage_steps,
        )

        saver = self._ckpt_saver or AsyncCheckpointSaver.get_ckpt_saver()
        if saver is None:
            return []
        steps: set[int] = set()
        if saver.num_hosts <= 1:
            for local_rank in range(saver.local_shard_num):
                # throwaway handler: the saver's own handlers may be in
                # use by a concurrent persist thread
                handler = SharedMemoryHandler(local_rank)
                try:
                    if handler.attach():
                        step = handler.get_checkpoint_step()
                        if step >= 0:
                            steps.add(step)
                finally:
                    handler.close()
        if saver.checkpoint_dir:
            steps.update(verified_storage_steps(saver.checkpoint_dir))
        return sorted(steps, reverse=True)

    def _initialize_workers(self):
        rdzv_round, world, rank_offset, total, coordinator = (
            self._rdzv_handler.next_rendezvous()
        )
        logger.info(
            "rendezvous round %s: world=%s rank_offset=%s total=%s "
            "restore_step=%s",
            rdzv_round,
            world,
            rank_offset,
            total,
            self._rdzv_handler.last_restore_step,
        )
        self._last_round = rdzv_round
        self._last_world = dict(world)
        self._start_worker_processes(rank_offset, total, coordinator)

    def _worker_env(self, local_rank: int, global_rank: int, total: int, coordinator: str):
        env = dict(os.environ)
        # Workers must import dlrover_tpu_torch no matter where their
        # script lives — propagate the framework's location.
        import dlrover_tpu_torch

        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(dlrover_tpu_torch.__file__))
        )
        existing = env.get("PYTHONPATH", "")
        if pkg_root not in existing.split(os.pathsep):
            env["PYTHONPATH"] = (
                f"{pkg_root}{os.pathsep}{existing}" if existing else pkg_root
            )
        # Job identity scopes shm segment names: stable across worker
        # restarts of THIS job, distinct between jobs (a stale segment
        # from a previous job must never be restored). The agent sets the
        # same name in its own environ so the saver daemon and workers
        # resolve identical segment names.
        env.update(
            {
                NodeEnv.JOB_NAME: self._job_name(),
                NodeEnv.DLROVER_MASTER_ADDR: self._client.master_addr,
                NodeEnv.NODE_RANK: str(self._config.node_rank),
                NodeEnv.NODE_ID: str(self._client.node_id),
                NodeEnv.LOCAL_RANK: str(local_rank),
                NodeEnv.RANK: str(global_rank),
                NodeEnv.WORLD_SIZE: str(total),
                NodeEnv.LOCAL_WORLD_SIZE: str(self._config.nproc_per_node),
                NodeEnv.RESTART_COUNT: str(self._restart_count),
                # the store init_distributed joins (RANK and WORLD_SIZE
                # give the process's place in it)
                NodeEnv.JAX_COORDINATOR_ADDR: coordinator,
                AGENT_SAVER_ENV: "1",
                ConfigPath.ENV_PARAL_CONFIG: ConfigPath.PARAL_CONFIG,
                ConfigPath.ENV_RUNTIME_METRICS: ConfigPath.RUNTIME_METRICS,
            }
        )
        # Telemetry: workers label their snapshots as role=worker (the
        # goodput ledger keys incarnation gaps off it), and the
        # master-brokered consensus restore step rides the env so the
        # engine restores exactly the agreed step.
        env[telemetry.ENV_ROLE] = "worker"
        if self._config.reshape_in_process:
            # per-worker reshape channel: a fresh incarnation must not
            # see the previous incarnation's request/ack/ready files
            from dlrover_tpu_torch.trainer.elastic.reshape import (
                ReshapeChannel,
            )

            rdir = os.path.join(
                self._config.log_dir or default_log_dir(),
                f"reshape_{self._config.node_rank}_{local_rank}",
            )
            channel = ReshapeChannel(rdir)
            channel.clear()
            self._reshape_channels[local_rank] = channel
            env[NodeEnv.RESHAPE_DIR] = rdir
        # deep-capture channel: the worker's sampler polls it at step
        # boundaries; the agent relays master capture directives into
        # it. Per-incarnation like the reshape channel — a fresh
        # worker must not see a dead incarnation's request/ack.
        from dlrover_tpu_torch.common import profiling

        cdir = os.path.join(
            self._config.log_dir or default_log_dir(),
            f"capture_{self._config.node_rank}_{local_rank}",
        )
        capture_channel = profiling.CaptureChannel(cdir)
        capture_channel.clear()
        self._capture_channels[local_rank] = capture_channel
        env[profiling.ENV_CAPTURE_DIR] = cdir
        restore_step = self._rdzv_handler.last_restore_step
        if restore_step >= 0:
            env[NodeEnv.RESTORE_STEP] = str(restore_step)
        else:
            env.pop(NodeEnv.RESTORE_STEP, None)
        apply_compilation_cache_env(
            self._config.compilation_cache_dir, env
        )
        return env

    def _start_worker_processes(self, rank_offset, total, coordinator):
        chaos_point(
            "agent.spawn",
            restart=self._restart_count,
            rank_offset=rank_offset,
        )
        telemetry.event(
            "worker.spawn",
            restart=self._restart_count,
            rank_offset=rank_offset,
            total=total,
        )
        self._workers = []
        self._log_files = []
        log_dir = self._config.log_dir or default_log_dir()
        os.makedirs(log_dir, exist_ok=True)
        for local_rank in range(self._config.nproc_per_node):
            global_rank = rank_offset + local_rank
            env = self._worker_env(
                local_rank, global_rank, total, coordinator
            )
            if self._spec.entrypoint.endswith(".py"):
                cmd = [sys.executable, self._spec.entrypoint, *self._spec.args]
            else:
                cmd = [self._spec.entrypoint, *self._spec.args]
            log_path = os.path.join(
                log_dir,
                f"worker_{global_rank}_restart{self._restart_count}.log",
            )
            log_f = open(log_path, "ab")
            proc = subprocess.Popen(  # noqa: S603
                cmd,
                env=env,
                stdout=log_f,
                stderr=subprocess.STDOUT,
            )
            log_f.close()
            self._log_files.append(log_path)
            self._workers.append(
                WorkerProcess(proc, local_rank, global_rank)
            )
        logger.info(
            "started %d worker process(es) (pids %s), restart=%d",
            len(self._workers),
            [w.proc.pid for w in self._workers],
            self._restart_count,
        )

    def _stop_workers(self, timeout: float = 30.0):
        self._stopping = True
        try:
            for w in self._workers:
                if w.returncode is None:
                    w.proc.terminate()
            deadline = time.time() + timeout
            for w in self._workers:
                if w.returncode is None:
                    remaining = max(deadline - time.time(), 0.1)
                    try:
                        w.proc.wait(timeout=remaining)
                    except subprocess.TimeoutExpired:
                        w.proc.kill()
                        w.proc.wait()
            self._workers = []
        finally:
            self._stopping = False

    def _restart_workers(self):
        self._restart_count += 1
        self._stop_workers()
        self._initialize_workers()

    def _log_tail(self, idx: int, nbytes: int = 4096) -> str:
        try:
            path = self._log_files[idx]
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(size - nbytes, 0))
                return f.read().decode(errors="replace")
        except Exception:  # noqa: BLE001
            return ""

    def _save_ckpt_at_breakpoint(self):
        """Flush any checkpoint still in shared memory to storage before
        restarting (reference _save_ckpt_to_storage :589)."""
        from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver

        saver = self._ckpt_saver or AsyncCheckpointSaver.get_ckpt_saver()
        if saver is not None:
            try:
                saver.save_shm_to_storage()
            except Exception:  # noqa: BLE001
                logger.exception("breakpoint checkpoint flush failed")

    def set_ckpt_saver(self, saver):
        self._ckpt_saver = saver

    def _cleanup_job_shm(self):
        """Unlink this job's checkpoint shm segments after a clean finish
        (they intentionally survive crashes, so nobody else reclaims
        them)."""
        from dlrover_tpu_torch.agent.ckpt_saver import shm_name
        from dlrover_tpu_torch.common.ipc import PersistentSharedMemory

        for local_rank in range(self._config.nproc_per_node):
            name = shm_name(local_rank)
            try:
                seg = PersistentSharedMemory(name=name)
                seg.close()
                seg.unlink()
            except FileNotFoundError:
                pass
            except Exception:  # noqa: BLE001
                logger.warning("shm cleanup failed for %s", name)

    # ------------------------------------------------------------ run loop

    def run(self) -> int:
        from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver

        # The agent hosts the async checkpoint-saver daemon so shm
        # checkpoints survive (and get flushed) when workers die.
        os.environ.setdefault(NodeEnv.JOB_NAME, self._job_name())
        AsyncCheckpointSaver.start_async_saving_ckpt()
        try:
            AsyncCheckpointSaver.register_signal_handlers()
        except ValueError:
            pass  # not the main thread (tests)
        # a preempted/SIGTERMed agent leaves its flight record (last
        # spans/events + thread stacks) before dying
        flight.install()
        self._heartbeat.start()
        self._resource_monitor.start()
        self._telemetry_reporter.start()
        self._timer_exporter.start()
        if self._config.metrics_port >= 0:
            from dlrover_tpu_torch.agent.monitor import MetricsEndpoint

            self._metrics_endpoint = MetricsEndpoint(
                self._timer_exporter, port=self._config.metrics_port
            )
            try:
                self._metrics_endpoint.start()
            except OSError as e:  # port in use: log, don't kill the job
                logger.warning("metrics endpoint failed to bind: %s", e)
                self._metrics_endpoint = None
        else:
            self._metrics_endpoint = None
        if self._paral_tuner is not None:
            self._paral_tuner.start()
        try:
            self._initialize_workers()
            return self._invoke_run()
        finally:
            self._stop_workers()
            self._heartbeat.stop()
            self._resource_monitor.stop()
            self._telemetry_reporter.stop()
            self._timer_exporter.stop()
            if self._metrics_endpoint is not None:
                self._metrics_endpoint.stop()
            if self._paral_tuner is not None:
                self._paral_tuner.stop()
            # final best-effort publish: the post-run obs report (and
            # the master, while it still listens) must see the agent's
            # rendezvous/spawn tail even after an abrupt job end
            self._telemetry_reporter.report_once(swallow=True)
            telemetry.flush()

    def _job_name(self) -> str:
        return os.environ.get(NodeEnv.JOB_NAME) or "job_" + (
            self._client.master_addr.replace(".", "_").replace(":", "_")
        )

    def _invoke_run(self) -> int:
        while True:
            time.sleep(self._config.monitor_interval)
            codes = [w.returncode for w in self._workers]
            if all(c == 0 for c in codes):
                logger.info("all workers succeeded")
                # the master's ledger must hold the whole run (the
                # workers' final snapshots too) before it hears of the
                # job's end, because it exits right after
                self._telemetry_reporter.report_once(swallow=True)
                self._log_goodput()
                try:
                    self._client.report_job_end(True)
                except ConnectionError:
                    pass  # master already gone; local outcome stands
                self._cleanup_job_shm()
                return 0
            failed = [
                (i, c) for i, c in enumerate(codes) if c not in (None, 0)
            ]
            if failed:
                idx, code = failed[0]
                tail = self._log_tail(idx)
                # NOTE draining never reaches this classify: the drain
                # path stops its workers synchronously and returns from
                # the loop in the same iteration. classify_exit's
                # draining arms serve platform integrations that
                # observe worker deaths after a notice out-of-band.
                kind = classify_exit(code, tail, stopping=self._stopping)
                if kind == "stopped":
                    continue  # our own SIGTERM; the stop path finishes it
                telemetry.event(
                    "worker.exit", local_rank=idx, rc=code,
                    exit_kind=kind, restart=self._restart_count,
                )
                logger.warning(
                    "worker %d exited rc=%s (%s)", idx, code, kind
                )
                try:
                    self._client.report_failure(
                        f"worker rc={code} kind={kind}: {tail[-1000:]}",
                        TrainingExceptionLevel.PROCESS_ERROR,
                        self._restart_count,
                    )
                except (ConnectionError, OSError):
                    # a worker death DURING a master outage must still
                    # be handled locally; the report is best-effort
                    logger.warning(
                        "could not report worker failure (master "
                        "unreachable)"
                    )
                if self._config.save_at_breakpoint:
                    self._save_ckpt_at_breakpoint()
                if kind in ("software", "oom") and self._remaining_restarts <= 0:
                    logger.error("restarts exhausted; failing node")
                    self._client.report_job_end(False, "restarts exhausted")
                    return 1
                if kind == "hardware":
                    # A device-level fault: exit with the hardware code so
                    # the master relaunches this node elsewhere.
                    logger.error("hardware-level fault; exiting agent")
                    return ExitCode.DEVICE_ERROR
                self._remaining_restarts -= 1
                self._restart_workers()
                continue
            # workers healthy: probe the master cheaply (single-attempt
            # ping) so a coordinator outage is detected and attributed
            # promptly, instead of surfacing one exhausted retry budget
            # at a time; the heartbeat's budget-exhaustion flag is the
            # slow-path backstop
            if self._heartbeat.master_unreachable or not self._client.ping():
                self._ride_through_master_outage()
            # master-side diagnosis: a hang verdict naming THIS host
            # triggers a local flight-recorder dump (the worker's own
            # detector may be the thing that's stuck)
            self._poll_diagnosis()
            # continuous hardware check: a governed low-cadence
            # re-probe (floor interval stretched until the probe costs
            # under its overhead budget) feeding the master's
            # fingerprint store — sustained degradation becomes a
            # hw_degraded verdict and a drain, not a mystery slowdown
            self._maybe_reprobe()
            # announced preemption: the platform (simulated by the
            # ``preempt.notice`` chaos action) says this host dies at a
            # deadline — relay to the brain and, when directed, drain
            # (checkpoint + drained departure + clean worker stop) so
            # the whole event lands in the reshape bucket. An
            # unconsumed/unannounced kill keeps the restart path.
            if self._poll_preempt_notice():
                logger.info(
                    "predictive drain complete; awaiting preemption"
                )
                return 0
            # check membership changes: a waiting node, or a round the
            # master already re-formed from carried-over survivors
            # (reshape-first elasticity forms rounds without survivors
            # re-joining, so waiting can drop back to 0 between ticks)
            if self._membership_changed():
                self._handle_membership_change()
            if self._heartbeat.action == "stop":
                logger.info("master asked this node to stop")
                self._stop_workers()
                return 0
            if self._heartbeat.action == "restart":
                self._heartbeat.action = ""
                self._restart_workers()

    def _log_goodput(self):
        """Log the job's goodput ledger as the master computed it, the
        last moment it holds the whole run (best-effort)."""
        try:
            ledger = self._client.get_telemetry_report().get("ledger")
        except (ConnectionError, OSError):
            return
        logger.info("job goodput ledger (master): %s", json.dumps(ledger))

    def _maybe_reprobe(self):
        """In-band hardware re-probe on the shared scheduler's cadence;
        best-effort shipping to the master's fingerprint store."""
        from dlrover_tpu_torch.agent import probe as hw_probe

        if hw_probe.probe_disabled():
            return
        sched = hw_probe.default_scheduler()
        if not sched.due():
            return
        report = sched.run(self._config.node_rank)
        try:
            self._client.report_probe(self._config.node_rank, report)
        except Exception:  # noqa: BLE001 - the health signal is
            # advisory; a dropped sample waits for the next window
            logger.warning("in-band probe report failed", exc_info=True)

    def _poll_diagnosis(self):
        """Best-effort: fetch the master's runtime verdicts; when a
        hang diagnosis names this host, dump the flight recorder once
        per episode so the post-mortem exists even if the stuck worker
        can never write its own. The same poll delivers deep-capture
        directives (``DiagnosisResult.capture``)."""
        try:
            result = self._client.get_diagnosis()
        except Exception:  # noqa: BLE001 - diagnosis is advisory
            return
        directive = getattr(result, "capture", None) or {}
        if directive.get("capture_id"):
            self._maybe_execute_capture(directive)
        hangs = getattr(result, "hangs", None) or {}
        info = hangs.get(self._config.node_rank)
        if info is None:
            self._hang_episode_dumped = False
            return
        if self._hang_episode_dumped:
            return
        self._hang_episode_dumped = True
        telemetry.event(
            "diagnosis.hang.received",
            rank=self._config.node_rank, **info,
        )
        flight.dump("hang-diagnosis", diagnosis=info)

    # ------------------------------------------------- deep captures

    def _maybe_execute_capture(self, directive: dict):
        """Run a master capture directive against local worker 0 (one
        device trace per host is the contract) in a background thread:
        the capture spans multiple worker steps and must not stall the
        monitor loop. The directive re-serves on every diagnosis poll
        while it stands, so the in-flight guard below also absorbs the
        re-serves."""
        import threading

        from dlrover_tpu_torch.common import profiling

        cid = str(directive["capture_id"])
        if self._capture_inflight == cid or (
            self._capture_thread is not None
            and self._capture_thread.is_alive()
        ):
            return
        channel = self._capture_channels.get(0)
        if channel is None:
            try:
                self._client.report_capture_result(
                    cid, self._config.node_rank, False,
                    error="no worker capture channel",
                )
            except (ConnectionError, OSError):
                pass
            return
        self._capture_inflight = cid
        worker0 = self._workers[0] if self._workers else None

        def report_fn(capture_id, ok, artifact, summary, error):
            try:
                self._client.report_capture_result(
                    capture_id, self._config.node_rank, ok,
                    artifact=artifact, summary=summary, error=error,
                )
            except (ConnectionError, OSError):
                # the master re-serves the directive on the next poll;
                # the in-flight marker clears with the thread
                logger.warning("capture result report failed")

        def run():
            try:
                profiling.execute_capture(
                    directive, channel, report_fn,
                    alive_fn=(
                        (lambda: worker0.returncode is None)
                        if worker0 is not None else None
                    ),
                )
            except Exception:  # noqa: BLE001 - a capture bug must not
                # take the agent's monitor loop down
                logger.exception("capture execution failed")
            finally:
                self._capture_inflight = ""

        self._capture_thread = threading.Thread(
            target=run, name="capture-executor", daemon=True
        )
        self._capture_thread.start()

    # --------------------------------------------- announced preemptions

    def _poll_preempt_notice(self) -> bool:
        """Consume a pending preemption notice, relay it to the
        master's brain, and execute the directed predictive drain.
        Returns True when the drain ran (the agent should shut down
        gracefully and wait for the kill). Master unreachable or
        directive \"none\" leaves the unannounced-kill fallback path
        untouched."""
        from dlrover_tpu_torch.common import chaos

        chaos_point(
            "preempt.notice", rank=self._config.node_rank,
            elapsed=time.monotonic() - self._start_mono,
        )
        notice = chaos.take_preempt_notice()
        if notice is None:
            return False
        deadline = float(notice.get("deadline", 0.0))
        lead = max(deadline - time.time(), 0.0)
        telemetry.event(
            "preempt.notice", rank=self._config.node_rank,
            lead=round(lead, 3), deadline=deadline,
        )
        logger.warning(
            "preemption notice: this host dies in %.2fs; asking the "
            "brain", lead,
        )
        directive = None
        try:
            directive = self._client.report_preempt_notice(
                self._config.node_rank, deadline, lead
            )
        except (ConnectionError, OSError):
            # master unreachable inside the lead window: the
            # unannounced-kill path (restart + checkpoint replay) is
            # the unchanged fallback
            logger.warning(
                "could not relay the preemption notice (master "
                "unreachable); the kill will land unannounced"
            )
        except Exception:  # noqa: BLE001 - advisory path
            logger.warning("preempt notice relay failed", exc_info=True)
        if directive is None or getattr(directive, "action", "") != "drain":
            return False
        self._execute_predrain(
            deadline, getattr(directive, "plan_id", "")
        )
        return True

    # the seconds a drained host keeps for persisting its segments and
    # stopping its workers after they acked their departure
    PERSIST_BUDGET_S = 5.0

    def _execute_predrain(self, deadline: float, plan_id: str):
        """The doomed host's half of a predictive-drain plan. Its workers
        are alive at the drain point, so they take part in the survivors'
        in-process reshape before they go: (1) the drain report; (2) wait
        for the round formed without this host; (3) signal the workers a
        request that marks them leaving: they save their shards at the
        round's boundary with every other rank and ack; (4) wait for the
        acks, within the plan's deadline less the persist's budget (a
        worker late to ack stops unsaved, and its peers' boundary
        agreement then finds it gone: a dead departure for them); (5)
        flush the shm checkpoint to storage, where survivors on other
        hosts read this host's slices and a replacement resumes with zero
        replay; (6) stop the workers before the platform kill lands. The
        ``elastic.drained`` marker re-charges the teardown gap from
        ``restart`` to ``reshape`` in the goodput ledger."""
        t0 = time.monotonic()
        self._draining = True
        try:
            self._client.drain_node(self._config.node_rank)
        except (ConnectionError, OSError):
            logger.warning(
                "drain report failed; survivors will see a dead "
                "departure instead"
            )
        acked = self._depart_in_process(deadline)
        self._save_ckpt_at_breakpoint()
        budget = max(deadline - time.time() - 1.0, 1.0)
        self._stop_workers(timeout=min(budget, 30.0))
        telemetry.event(
            "elastic.drained", rank=self._config.node_rank,
            plan=plan_id, dur=time.monotonic() - t0,
            deadline=deadline, acked=acked,
        )
        telemetry.flush()

    def _depart_in_process(self, deadline: float) -> bool:
        """Steps (2)-(4) of a drain: True when every local worker acked
        its departure at the new round's boundary."""
        if not self._workers_reshape_ready() or not self._workers_alive():
            return False
        budget = deadline - time.time() - self.PERSIST_BUDGET_S
        if budget <= 0:
            return False
        world = self._await_departure_round(budget)
        if world is None:
            logger.warning("no round formed without this host before the "
                           "drain's deadline; its workers stop unsaved")
            return False
        acked = self._signal_reshape(
            world, leaving=True,
            timeout=max(deadline - time.time() - self.PERSIST_BUDGET_S,
                        0.1))
        if acked:
            self._last_round = world.round
            logger.info("workers left at round %s in process", world.round)
        else:
            logger.warning(
                "workers did not ack their departure at round %s in time; "
                "they stop unsaved (a dead departure for the survivors)",
                world.round)
            telemetry.event("elastic.drain.late_ack", round=world.round,
                            rank=self._config.node_rank)
        return acked

    def _await_departure_round(self, timeout: float):
        """The next formed round without this host, or None on timeout
        (or when a worker died)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if not self._workers_alive():
                return None
            try:
                world = self._client.get_comm_world(
                    RendezvousName.ELASTIC_TRAINING,
                    self._config.node_rank,
                )
            except (ConnectionError, OSError):
                time.sleep(0.5)
                continue
            if (world and world.world and world.round != self._last_round
                    and self._config.node_rank not in world.world):
                return world
            time.sleep(0.2)
        return None

    def _membership_changed(self) -> bool:
        try:
            waiting = self._client.num_nodes_waiting(
                RendezvousName.ELASTIC_TRAINING
            )
            if waiting > 0:
                return True
            # carried-over survivors never re-join, so the new round
            # can form (and waiting return to 0) entirely between two
            # monitor ticks — compare the formed round number too
            world = self._client.get_comm_world(
                RendezvousName.ELASTIC_TRAINING, self._config.node_rank
            )
            return bool(
                world and world.world and world.round != self._last_round
            )
        except (ConnectionError, OSError):
            # master unreachable, not a membership change: ride through
            # (workers keep training on their last formed world)
            self._ride_through_master_outage()
            return False
        except Exception:  # noqa: BLE001
            return False

    # ------------------------------------------- reshape-first elasticity

    def _workers_alive(self) -> bool:
        return bool(self._workers) and all(
            w.returncode is None for w in self._workers
        )

    def _workers_reshape_ready(self) -> bool:
        """Every local worker advertised a reshape watcher (the Trainer
        writes the ready marker when it installs one). Bare workers
        keep the classic restart path."""
        if not self._config.reshape_in_process:
            return False
        channels = [
            self._reshape_channels.get(w.local_rank)
            for w in self._workers
        ]
        return bool(channels) and all(
            c is not None and c.worker_ready() for c in channels
        )

    def _await_formed_world(self, timeout: float):
        """Poll the master until the NEXT round is formed with this
        node in it (polling is also what triggers formation once the
        waiting set is ready). None = timeout, excluded, or a worker
        died while waiting."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if not self._workers_alive():
                return None
            try:
                world = self._client.get_comm_world(
                    RendezvousName.ELASTIC_TRAINING,
                    self._config.node_rank,
                )
            except (ConnectionError, OSError):
                time.sleep(1.0)
                continue
            if world and world.world and world.round != self._last_round:
                if self._config.node_rank not in world.world:
                    return None
                return world
            time.sleep(0.5)
        return None

    def _handle_membership_change(self):
        """Reshape-first: when the master's verdict for this node is
        "reshape" and every local worker runs a reshape watcher, the
        membership change is signaled INTO the live workers (drain ->
        in-process mesh rebuild + reshard -> resume). Everything else
        — no watcher, verdict "restart", excluded from the round, a
        failed or timed-out reshape, a worker killed mid-reshape —
        falls back to the classic restart path."""
        if not self._workers_reshape_ready() or not self._workers_alive():
            logger.info("membership changed; restarting workers")
            self._restart_workers()
            return
        world = self._await_formed_world(
            min(self._config.rdzv_timeout, 120.0)
        )
        if world is None:
            logger.info(
                "membership changed but no new round formed with this "
                "node; restarting workers"
            )
            self._restart_workers()
            return
        verdict = (getattr(world, "verdicts", None) or {}).get(
            self._config.node_rank, "restart"
        )
        if verdict != "reshape":
            logger.info(
                "membership changed (verdict=%s); restarting workers",
                verdict,
            )
            self._restart_workers()
            return
        if self._signal_reshape(world):
            self._last_round = world.round
            self._last_world = dict(world.world)
            telemetry.event(
                "elastic.reshape.adopted",
                round=world.round,
                world=len(world.world),
            )
            logger.info(
                "round %s adopted in process (no worker restart)",
                world.round,
            )
        else:
            logger.warning(
                "in-process reshape for round %s failed or timed out; "
                "falling back to the restart path", world.round,
            )
            self._restart_workers()

    def _signal_reshape(self, world, leaving: bool = False,
                        timeout: float | None = None) -> bool:
        """Write the reshape request to every local worker and wait for
        all acks (``leaving``: the workers depart at the round's
        boundary). False = restart fallback required."""
        from dlrover_tpu_torch.trainer.elastic.reshape import ReshapeRequest

        request = ReshapeRequest(
            round=world.round,
            world=world.world,
            rank_offset=world_rank_offset(
                world.world, self._config.node_rank
            ),
            total=sum(world.world.values()),
            coordinator=world.coordinator_addr,
            departed=dict(getattr(world, "departed", None) or {}),
            prev_world=dict(self._last_world),
            leaving=leaving,
        )
        if timeout is None:
            timeout = self._config.reshape_ack_timeout
        try:
            for w in self._workers:
                self._reshape_channels[w.local_rank].signal(request)
            deadline = time.time() + timeout
            for w in self._workers:
                channel = self._reshape_channels[w.local_rank]
                ack = channel.await_ack(
                    world.round,
                    max(deadline - time.time(), 0.1),
                    alive_fn=lambda w=w: w.returncode is None,
                )
                if ack is None or not ack.get("ok"):
                    return False
            return True
        except Exception:  # noqa: BLE001 - the signal write is itself
            # a fault seam (elastic.signal chaos site, ENOSPC on the
            # request file): a failed signal must DEGRADE to the
            # restart path, never crash the agent out of its monitor
            # loop with workers still running
            logger.exception(
                "reshape signaling for round %s failed; falling back "
                "to the restart path", world.round,
            )
            return False

    # ------------------------------------------------- master ride-through

    def _ride_through_master_outage(self):
        """The master is gone (every retry budget exhausted). Workers
        keep training — only data-plane collectives involve them, and
        shard fetches ride their own retry policies — while this agent
        polls for the master (old or restarted, re-resolving the
        address each probe) and re-registers when it answers. Only a
        GENUINE membership change reported by the restored master
        triggers a worker restart, via the normal num_nodes_waiting
        path after this returns."""
        t0 = time.monotonic()
        telemetry.event(
            "master.unreachable", restart=self._restart_count
        )
        logger.warning(
            "master unreachable at %s; riding through (workers keep "
            "training)", self._client.master_addr,
        )
        ok = self._client.await_master(
            timeout=self._config.master_ride_through
        )
        dur = time.monotonic() - t0
        if not ok:
            telemetry.event("master.lost", dur=dur)
            logger.error(
                "master still unreachable after %.0fs; workers keep "
                "training, will re-probe next tick", dur,
            )
            return
        # the outage interval: the goodput ledger charges it to the
        # ``restart`` bucket (anything workers productively overlapped
        # still wins by sweep priority)
        telemetry.event(
            "master.restart", dur=dur, addr=self._client.master_addr
        )
        logger.info(
            "master back after %.1fs at %s; re-registering",
            dur, self._client.master_addr,
        )
        self._heartbeat.reset_misses()
        self._re_register()

    def _re_register(self):
        """Re-push the state a restored master may be missing: node
        meta, the newest locally-restorable checkpoint steps (persists
        during the outage aren't in its snapshot), and this host's
        telemetry. Deliberately NOT a rendezvous join — that would
        dissolve the restored round and restart healthy workers."""
        try:
            self._client.report_node_meta(
                self._config.node_rank, addr=self._client.host_ip
            )
            self._client.report_verified_steps(
                self._config.node_rank, self._restorable_steps()
            )
        except (ConnectionError, OSError):
            logger.warning(
                "post-outage re-registration failed; next tick retries"
            )
        except Exception:  # noqa: BLE001 - best-effort: a scan error
            # must not take down a healthy agent
            logger.warning("post-outage re-registration error",
                           exc_info=True)
        self._telemetry_reporter.reset_shipped()
        self._telemetry_reporter.report_once(swallow=True)


class NodeCheckElasticAgent:
    """Runs probe rounds + reports to the master's pairing logic
    (reference NetworkCheckElasticAgent :783)."""

    def __init__(
        self, config: ElasticLaunchConfig, client: MasterClient, rounds=2
    ):
        self._config = config
        self._client = client
        self._rounds = rounds
        self._rdzv_handler = MasterRendezvousHandler(
            RendezvousName.NETWORK_CHECK,
            config.node_rank,
            client,
            config.nproc_per_node,
            config.rdzv_timeout,
        )

    def _wait_round_verdict(self, timeout: float):
        """Poll until every node of the round reported (the master stops
        answering 'Waiting node') or the timeout passes."""
        from dlrover_tpu_torch.common.constants import NetworkFailureReason

        deadline = time.time() + timeout
        result = None
        while time.time() < deadline:
            result = self._client.check_network_ready()
            if result is not None and (
                result.normal
                or result.reason != NetworkFailureReason.WAITING_NODE
            ):
                break
            time.sleep(2)
        return result

    def run(self) -> bool:
        from dlrover_tpu_torch.agent.node_check import run_node_check

        node_rank = self._config.node_rank
        round_timeout = min(self._config.rdzv_timeout, 90)
        result = None
        for _ in range(self._rounds):
            self._rdzv_handler.next_rendezvous()
            # returns once its children (one per local rank) have
            # exited: the agent holds no CUDA context, no NCCL group
            normal, elapsed = run_node_check(
                device="cpu" if self._config.accelerator == "cpu"
                else "cuda",
                nprocs=self._config.nproc_per_node,
            )
            self._client.report_node_check_result(
                node_rank, normal, elapsed
            )
            result = self._wait_round_verdict(round_timeout)
            if result is not None and result.normal:
                logger.info("network check: the master's verdict is "
                            "normal (elapsed %.2fs)", elapsed)
                if self._config.exclude_straggler:
                    straggler = self._client.check_straggler()
                    if straggler and node_rank in straggler.nodes:
                        logger.error(
                            "this node is a straggler; excluding"
                        )
                        return False
                return True
            if result is not None and node_rank in result.nodes:
                logger.error(
                    "node %s isolated as faulty by the master", node_rank
                )
                return False
            # round complete but undecided -> run another probe round
        if result is None:
            return False
        if node_rank in result.nodes:
            logger.error("node %s isolated as faulty", node_rank)
            return False
        if not result.normal:
            logger.warning(
                "network check inconclusive (%s); this node is not in the "
                "fault set, continuing",
                result.reason,
            )
        return True


_SHARED_CONFIG_KEYS = ("nproc_per_node", "network_check", "node_unit")


def _share_run_config(client: MasterClient, config: ElasticLaunchConfig,
                      wait: float = 30.0):
    """Flag consistency across hosts (reference auto_config sharing).

    Rank 0 publishes the launch flags that must match job-wide; later
    joiners poll for them (all hosts start concurrently, so a single
    fetch would race rank 0's publish) and adopt, so a fat-fingered
    per-host flag can't split the rendezvous world.
    """
    if config.node_rank == 0:
        client.report_elastic_run_config({
            k: getattr(config, k) for k in _SHARED_CONFIG_KEYS
        })
        return
    deadline = time.time() + wait
    published: dict = {}
    while time.time() < deadline:
        published = client.get_elastic_run_config()
        if published:
            break
        time.sleep(0.5)
    if not published:
        logger.warning(
            "rank 0 never published a run config within %.0fs; keeping "
            "local flags", wait,
        )
        return
    for key in _SHARED_CONFIG_KEYS:
        if key in published and published[key] != getattr(config, key):
            logger.warning(
                "adopting job-wide %s=%r (was %r)",
                key, published[key], getattr(config, key),
            )
            setattr(config, key, published[key])


def launch_agent(
    config: ElasticLaunchConfig,
    entrypoint: str,
    args: tuple,
    master_addr: str,
) -> int:
    """Build the client + agent and run (reference launch_agent :673)."""
    config.auto_configure_params()
    client = MasterClient(
        master_addr, config.node_rank, "worker"
    )
    _share_run_config(client, config)
    if config.min_nodes != config.max_nodes:
        # elastic --nnodes lo:hi: the master must form the world at
        # >= min after the waiting window instead of insisting on max
        client.report_rdzv_params(
            config.min_nodes, config.max_nodes,
            waiting_timeout=config.rdzv_elastic_wait,
            node_unit=config.node_unit,
        )
    if config.network_check:
        checker = NodeCheckElasticAgent(config, client)
        if not checker.run():
            logger.error("node check failed; aborting this node")
            return ExitCode.NETWORK_CHECK_FAILED
    agent = ElasticTrainingAgent(
        config, WorkerSpec(entrypoint, args, config), client
    )
    try:
        return agent.run()
    finally:
        client.close()
