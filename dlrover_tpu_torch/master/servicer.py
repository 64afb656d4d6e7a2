"""MasterServicer: dispatches the 2-verb control plane to managers.

Equivalent capability: reference dlrover/python/master/servicer.py:62
(MasterServicer.get :88 / report :285 dispatching on message type to the
task manager, job manager, rendezvous managers, kv-store and sync
service).

The PyTorch port's copy of dlrover_tpu/master/servicer.py.
"""

from __future__ import annotations

import threading
import time

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common import tracing
from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.rpc import RpcServer, RpcService
from dlrover_tpu_torch.common.telemetry import JobTelemetry

logger = get_logger(__name__)


class CheckpointBarrierService:
    """Host-side all-rank-ready barrier for flash checkpoint.

    Replaces the reference's in-band device collective
    (flash_checkpoint/engine.py:51 check_all_rank_ready) with a
    master-mediated barrier so the save path never touches the TPU.
    """

    # Bound the barrier book-keeping: only this many recent (group, step)
    # entries are retained (a long-lived master checkpoints indefinitely).
    MAX_ENTRIES = 64

    def __init__(self):
        self._lock = threading.Lock()
        # (group, step) -> set of node ids that said ready (insertion
        # ordered: oldest evicted first)
        self._ready: dict[tuple[str, int], set[int]] = {}
        # (group, step) -> node ids that abandoned the step (lock busy):
        # peers stop waiting immediately. Per-NODE, not a sticky bool:
        # a skipper that retries the same step (the trainer's final-
        # checkpoint retry loop) re-reports ready and un-aborts itself;
        # the barrier stays aborted only while some OTHER node's skip
        # stands, so a single transient skip cannot poison the step
        # forever.
        self._aborted: dict[tuple[str, int], set[int]] = {}
        # node agreement that step shards were persisted
        self._persisted: dict[int, set[int]] = {}

    def _evict(self, d: dict):
        while len(d) > self.MAX_ENTRIES:
            d.pop(next(iter(d)))

    def report_ready(
        self, group: str, step: int, node_id: int, world: int,
        ready: bool = True,
    ):
        with self._lock:
            key = (group, step)
            if not ready:
                self._aborted.setdefault(key, set()).add(node_id)
                self._evict(self._aborted)
                return False
            skippers = self._aborted.get(key)
            if skippers is not None:
                # this node retried the step it once skipped; its own
                # abort no longer stands
                skippers.discard(node_id)
                if not skippers:
                    del self._aborted[key]
            members = self._ready.setdefault(key, set())
            members.add(node_id)
            self._evict(self._ready)
            return len(members) >= world

    def check_ready(self, group: str, step: int, world: int):
        """-> (passed, aborted)"""
        with self._lock:
            if self._aborted.get((group, step)):
                return False, True
            return (
                len(self._ready.get((group, step), set())) >= world,
                False,
            )

    def sync_checkpoint(self, step: int, node_id: int, world: int) -> bool:
        with self._lock:
            members = self._persisted.setdefault(step, set())
            members.add(node_id)
            self._evict(self._persisted)
            return len(members) >= world

    # -------------------------------------------------- failover durability

    def export_state(self) -> dict:
        with self._lock:
            return {
                "ready": [
                    [g, s, sorted(m)]
                    for (g, s), m in self._ready.items()
                ],
                "aborted": [
                    [g, s, sorted(m)]
                    for (g, s), m in self._aborted.items()
                ],
                "persisted": [
                    [s, sorted(m)] for s, m in self._persisted.items()
                ],
            }

    def restore_state(self, state: dict):
        with self._lock:
            self._ready = {
                (g, int(s)): set(m)
                for g, s, m in state.get("ready", [])
            }
            self._aborted = {
                (g, int(s)): set(m)
                for g, s, m in state.get("aborted", [])
            }
            self._persisted = {
                int(s): set(m) for s, m in state.get("persisted", [])
            }


class MasterServicer(RpcService):
    def __init__(
        self,
        task_manager=None,
        job_manager=None,
        rdzv_managers=None,
        kv_store=None,
        sync_service=None,
        job_metric_collector=None,
        elastic_ps_service=None,
    ):
        self.task_manager = task_manager
        self.job_manager = job_manager
        self.rdzv_managers = rdzv_managers or {}
        self.kv_store = kv_store
        self.sync_service = sync_service
        self.job_metric_collector = job_metric_collector
        self.elastic_ps_service = elastic_ps_service
        self.ckpt_barrier = CheckpointBarrierService()
        # elastic serving arm: every master owns the decode-pool node
        # group (workers join it like trainers join theirs) and the
        # request ledger fronting the continuous-batching pool
        if RendezvousName.DECODE_POOL not in self.rdzv_managers:
            from dlrover_tpu_torch.master.rendezvous import (
                DecodePoolRendezvousManager,
            )

            self.rdzv_managers[RendezvousName.DECODE_POOL] = (
                DecodePoolRendezvousManager()
            )
        from dlrover_tpu_torch.serving.manager import ServingRequestManager

        self.serving = ServingRequestManager()
        # job-wide telemetry merge: agents ship registry snapshots
        # (delta-encoded after the first ack), the report query serves
        # the goodput ledger + merged timeline
        self.telemetry = JobTelemetry()
        # live metrics plane: every shipped gauge's time-series points
        # fold into the bounded tiered store (raw -> 10s -> 1min), the
        # queryable history behind /series.json, MetricsQueryRequest
        # and the SLO watchdog's rolling baselines
        from dlrover_tpu_torch.master.metrics_store import (
            MetricsStore,
            SloWatchdog,
        )

        self.metrics_store = MetricsStore()
        # the elastic repair brain: straggler verdicts, SLO breaches
        # and preemption notices become durable reshape-first
        # ScalePlans executed through drain_node + the run-config
        # channel. Its plan WAL/snapshot hooks resolve the state store
        # lazily (set after construction by the owning JobMaster).
        from dlrover_tpu_torch.master.brain import RepairBrain

        self.brain = RepairBrain(
            servicer=self,
            rdzv_manager=self.rdzv_managers.get(
                RendezvousName.ELASTIC_TRAINING
            ),
            wal_fn=lambda op, **fields: self._wal(op, **fields),
            dirty_fn=self._mark_dirty,
        )
        # deep-profiling capture plane: SLO breaches, straggler
        # verdicts and operator requests become bounded capture
        # directives to the blamed host's agent, exactly-once across
        # failover (WAL + snapshot, like brain plans)
        from dlrover_tpu_torch.master.capture import CaptureManager

        self.capture = CaptureManager(
            wal_fn=lambda op, **fields: self._wal(op, **fields),
            dirty_fn=self._mark_dirty,
        )
        # hardware health plane: join-time probe reports judged
        # against the fleet median and each host's own persisted
        # fingerprint — pass/quarantine/refuse at the rendezvous door,
        # plus continuous in-band degradation detection feeding the
        # diagnosis sweep (durable like brain plans: WAL + snapshot)
        from dlrover_tpu_torch.master.health import HostHealthManager

        self.health = HostHealthManager(
            wal_fn=lambda op, **fields: self._wal(op, **fields),
            dirty_fn=self._mark_dirty,
        )
        # runtime straggler/hang diagnosis over the merged telemetry
        # (per-host TimerRing phase gauges + step.end activity); checks
        # are pull-driven from heartbeats and diagnosis queries. The
        # SLO watchdog rides the same rate-limited sweep so breaches
        # surface next to straggler/hang verdicts — and the brain and
        # capture manager ride it too, turning fresh verdicts into
        # ScalePlans and deep-capture directives.
        from dlrover_tpu_torch.master.diagnosis import DiagnosisManager

        self.diagnosis = DiagnosisManager(
            self.telemetry,
            speed_monitor=getattr(task_manager, "speed_monitor", None),
            slo_watchdog=SloWatchdog(
                self.metrics_store, self.telemetry, serving=self.serving
            ),
            brain=self.brain,
            capture=self.capture,
            health=self.health,
        )
        # durable control-plane state (master failover); set by the
        # owning JobMaster when a state dir is configured
        self.state_store = None
        # rdzv_name -> last formed round already persisted via
        # _mark_dirty (steady-state world polls must not re-dirty)
        self._marked_rounds: dict[str, int] = {}
        self._start_training_time = 0.0
        self._job_ended = threading.Event()
        # servicer-local scalar state written by concurrent RPC handler
        # threads (dlint DL008 / dtsan first-run findings): one leaf
        # lock, never held across a call into another component
        self._state_lock = threading.Lock()
        self._job_success = True
        self._run_configs: dict = {}

    # ------------------------------------------------- state-store plumbing

    def _mark_dirty(self):
        store = self.state_store
        if store is not None:
            store.mark_dirty()

    def _wal(self, op: str, **fields):
        store = self.state_store
        if store is not None:
            store.wal_append(op, **fields)

    @property
    def _wal_hook(self):
        """The raw append for callees that must log under their OWN
        lock (kv-store write ordering); None when durability is off."""
        store = self.state_store
        return None if store is None else store.wal_append

    # ------------------------------------------------------------------ get

    def get(self, node_type: str, node_id: int, message):
        # master-side kill/hang site: the server half of coordinator
        # loss (agents' ride-through and the state store's restore are
        # what a schedule here exercises)
        chaos_point(
            "master.kill", verb="get", msg=type(message).__name__
        )
        if isinstance(message, msg.PsVersionRequest):
            if self.elastic_ps_service is None:
                return msg.PsVersionResponse()
            return msg.PsVersionResponse(
                version=self.elastic_ps_service.get_ps_version(
                    message.version_type, node_id
                )
            )
        if isinstance(message, msg.TaskRequest):
            return self._get_task(node_type, node_id, message)
        if isinstance(message, msg.ShardCheckpointRequest):
            content = self.task_manager.get_dataset_checkpoint(
                message.dataset_name
            )
            return msg.ShardCheckpoint(content=content)
        if isinstance(message, msg.CommWorldRequest):
            return self._get_comm_world(message)
        if isinstance(message, msg.WaitingNodeNumRequest):
            mgr = self.rdzv_managers.get(message.rdzv_name)
            n = mgr.num_nodes_waiting() if mgr else 0
            return msg.WaitingNodeNum(waiting_num=n)
        if isinstance(message, msg.NetworkReadyRequest):
            mgr = self.rdzv_managers.get(RendezvousName.NETWORK_CHECK)
            # ``reason`` is WAITING_NODE only while reports are missing —
            # agents use that to tell "round still filling" apart from
            # "round complete but fault undecided, run another round".
            ok, reason = mgr.network_check_success()
            fault_nodes, _ = mgr.check_fault_node()
            return msg.NetworkCheckResult(
                normal=ok and not fault_nodes,
                reason=reason,
                nodes=fault_nodes,
            )
        if isinstance(message, msg.StragglerExistRequest):
            # two sources, merged: the network-check probe-time rule
            # (only populated during dedicated probe rounds) and the
            # runtime diagnosis over live telemetry — check_straggler
            # now answers DURING training instead of from the probe-
            # round-only stub
            mgr = self.rdzv_managers.get(RendezvousName.NETWORK_CHECK)
            stragglers, done = mgr.get_stragglers()
            diagnosed = self.diagnosis.stragglers()
            # third source (the TPU-side producer the merge path waited
            # for since PR 6): hosts the health plane has quarantined
            # or flagged as hw-degraded from probe timings
            unhealthy = set(self.health.quarantined()) | set(
                self.health.hw_degraded()
            )
            nodes = sorted(
                set(stragglers) | set(diagnosed) | unhealthy
            )
            blame = ";".join(
                f"{rank}:{info.get('phase', '?')}"
                for rank, info in sorted(diagnosed.items())
            )
            if unhealthy:
                hw_blame = ";".join(
                    f"{rank}:hw" for rank in sorted(unhealthy)
                )
                blame = f"{blame};{hw_blame}" if blame else hw_blame
            return msg.NetworkCheckResult(
                normal=done or bool(diagnosed) or bool(unhealthy),
                nodes=nodes,
                reason=blame,
            )
        if isinstance(message, msg.PreemptNoticeRequest):
            # the doomed host's lead window is ticking: decide (or
            # re-serve — idempotent key, exactly once across a master
            # failover) the predictive-drain plan and answer with the
            # directive the agent executes locally
            directive = self.brain.handle_preempt_notice(
                message.node_rank, message.deadline, message.lead_s
            )
            self._mark_dirty()
            return msg.PreemptNoticeDirective(**directive)
        if isinstance(message, msg.DiagnosisRequest):
            verdicts = self.diagnosis.check()
            return msg.DiagnosisResult(
                stragglers=verdicts["stragglers"],
                hangs=verdicts["hangs"],
                slo=verdicts.get("slo", {}),
                hw=verdicts.get("hw", {}),
                # the polling host's pending deep-capture directive
                # (idempotent re-serve while it stands)
                capture=self.capture.poll_directive(message.node_rank),
            )
        if isinstance(message, msg.NodeHealthRequest):
            # a parked host polling why its (acked) join never formed a
            # world: pass = round still filling, keep polling the comm
            # world; quarantine/refuse = sleep retry_after_s, re-probe,
            # re-join with the fresh report
            return msg.NodeHealthVerdict(
                **self.health.verdict(message.node_rank)
            )
        if isinstance(message, msg.ProfileCaptureRequest):
            return msg.ProfileCaptureAck(**self.capture.request(
                message.node_rank, steps=message.steps,
                reason=message.reason,
            ))
        if isinstance(message, msg.CaptureListRequest):
            return msg.CaptureList(captures=self.capture.list())
        if isinstance(message, msg.ServeLeaseRequest):
            requests, depth = self.serving.lease(
                message.node_rank, message.max_requests
            )
            return msg.ServeLease(requests=requests, queue_depth=depth)
        if isinstance(message, msg.ServeStatusRequest):
            return msg.ServeStatus(summary=self.serving.summary())
        if isinstance(message, msg.ServeFetchRequest):
            result = self.serving.fetch(message.request_id)
            return msg.ServeResult(
                request_id=message.request_id,
                state=result["state"],
                tokens=result["tokens"],
                finish_reason=result["finish_reason"],
            )
        if isinstance(message, msg.MetricsQueryRequest):
            return msg.MetricsSeries(
                series=self.metrics_store.query(
                    message.name,
                    source=message.source or None,
                    resolution=message.resolution or "raw",
                    since=message.since,
                    limit=message.limit,
                )
            )
        if isinstance(message, msg.KeyValueGetRequest):
            value = self.kv_store.get(message.key)
            return msg.KeyValuePair(key=message.key, value=value)
        if isinstance(message, msg.KeyValueAddRequest):
            # the WAL hook runs under the kv lock so racing writes log
            # in apply order; the record carries the RESULT (idempotent)
            value = self.kv_store.add(
                message.key, message.delta, wal=self._wal_hook
            )
            return msg.KeyValueAddResult(value=value)
        if isinstance(message, msg.HeartBeat):
            action = self.job_manager.update_node_heartbeat(
                node_type, node_id, message.timestamp
            )
            # heartbeats are the master's steady pulse: piggyback the
            # (rate-limited) diagnosis sweep on them so verdicts stay
            # fresh without a dedicated scanner thread
            self.diagnosis.check()
            return msg.HeartbeatResponse(action=action or "")
        if isinstance(message, msg.ParallelConfigRequest):
            return self._get_paral_config(node_type, node_id)
        if isinstance(message, msg.CheckpointReadyRequest):
            passed, aborted = self.ckpt_barrier.check_ready(
                message.group, message.step, message.world
            )
            return msg.BarrierResponse(passed=passed, aborted=aborted)
        if isinstance(message, msg.TelemetryReportRequest):
            # fold in THIS process's registry (rendezvous events live
            # here): the master is a telemetry source like any other
            from dlrover_tpu_torch.common import telemetry as _telemetry

            local_snap = _telemetry.snapshot()
            if local_snap is not None:
                self.telemetry.update(local_snap)
                self.metrics_store.ingest_snapshot(local_snap)
            return msg.TelemetryReport(payload=self.telemetry.report())
        if isinstance(message, msg.ElasticRunConfigRequest):
            return msg.ElasticRunConfig(configs=self.get_run_configs())
        if isinstance(message, msg.SyncBarrierRequest):
            if message.notify:
                self.sync_service.notify_barrier(message.sync_name)
                return msg.Response(success=True)
            return msg.Response(
                success=self.sync_service.sync_finished(message.sync_name)
            )
        logger.warning("get: unhandled message %r", type(message).__name__)
        return None

    # --------------------------------------------------------------- report

    def report(self, node_type: str, node_id: int, message) -> bool:
        chaos_point(
            "master.kill", verb="report", msg=type(message).__name__
        )
        if isinstance(message, msg.ElasticRunConfig):
            self.set_run_configs(message.configs)
            self._mark_dirty()
            return True
        if isinstance(message, msg.DrainNodeRequest):
            mgr = self.rdzv_managers.get(
                RendezvousName.ELASTIC_TRAINING
            )
            if mgr is not None:
                mgr.drain_node(message.node_rank)
                self._mark_dirty()
            return True
        if isinstance(message, msg.ServeSubmitRequest):
            ok = self.serving.submit({
                "request_id": message.request_id,
                "prompt": list(message.prompt),
                "max_new_tokens": message.max_new_tokens,
                "temperature": message.temperature,
                "eos_id": message.eos_id,
            })
            if ok:
                # the ledger rides the master snapshot: an accepted
                # request must survive a failover, like a dataset shard
                self._mark_dirty()
            return ok
        if isinstance(message, msg.ServeResultReport):
            ok = self.serving.complete(
                message.request_id,
                message.node_rank,
                message.tokens,
                finish_reason=message.finish_reason,
            )
            if ok:
                self._mark_dirty()
            return ok
        if isinstance(message, msg.RdzvParamsReport):
            for name, mgr in self.rdzv_managers.items():
                if name == RendezvousName.DECODE_POOL:
                    # the training job's --nnodes elasticity bounds do
                    # not govern the decode pool: a min_nodes=2 here
                    # would stop a lone decode worker's round forming
                    continue
                mgr.update_rdzv_params(
                    min_nodes=message.min_nodes,
                    max_nodes=message.max_nodes,
                    waiting_timeout=message.waiting_timeout,
                    node_unit=message.node_unit,
                )
            logger.info(
                "rendezvous params updated: min=%d max=%d wait=%.0fs "
                "unit=%d", message.min_nodes, message.max_nodes,
                message.waiting_timeout, message.node_unit,
            )
            self._mark_dirty()
            return True
        if isinstance(message, msg.StreamingFeed):
            ok = self.task_manager.feed_streaming_dataset(
                message.dataset_name, message.count, message.end
            )
            if ok:
                ds = self.task_manager.get_dataset(message.dataset_name)
                if ds is not None:
                    # resulting totals, not the delta: replay moves the
                    # high-water mark at most forward (idempotent)
                    self._wal(
                        "stream",
                        ds=message.dataset_name,
                        reported=ds._reported,
                        ended=ds._ended,
                    )
            return ok
        if isinstance(message, msg.PsVersionReport):
            if self.elastic_ps_service is None:
                return False
            self.elastic_ps_service.update_ps_version(
                node_id, message.version_type, message.version
            )
            return True
        if isinstance(message, msg.DatasetShardParams):
            params = {
                "batch_size": message.batch_size,
                "dataset_size": message.dataset_size,
                "dataset_name": message.dataset_name,
                "task_type": message.task_type,
                "num_epochs": message.num_epochs,
                "shuffle": message.shuffle,
                "num_minibatches_per_shard": (
                    message.num_minibatches_per_shard
                ),
                "storage_type": message.storage_type,
                "dataset_type": message.dataset_type,
            }
            self.task_manager.new_dataset(**params)
            # durable BEFORE the ack: a crash right here must not leave
            # acked dispatches against a dataset recovery can't rebuild
            self._wal("dataset", params=params)
            if self.job_metric_collector is not None:
                self.job_metric_collector.collect_dataset_metric(message)
            return True
        if isinstance(message, msg.TaskResult):
            return self._report_task_result(message)
        if isinstance(message, msg.JoinRendezvousRequest):
            mgr = self.rdzv_managers.get(message.rdzv_name)
            if mgr is None:
                return False
            # health gate BEFORE the rendezvous manager sees the join:
            # a quarantined/refused host never enters the waiting set,
            # so it cannot flap a forming round. Ack True regardless —
            # a False ack means "handler faulted, re-send join" to the
            # agent; parked hosts learn their verdict (and backoff) by
            # polling NodeHealthRequest instead.
            gate = self.health.gate(
                message.node_rank,
                # older clients' pickles predate the probe field;
                # an empty report passes the gate (old behavior)
                getattr(message, "probe_report", None) or {},
            )
            if gate["verdict"] != "pass":
                from dlrover_tpu_torch.common import telemetry as _telemetry

                _telemetry.event(
                    "health." + gate["verdict"],
                    rank=message.node_rank,
                    reason=gate["reason"],
                )
                return True
            if gate.get("cleared"):
                from dlrover_tpu_torch.common import telemetry as _telemetry

                _telemetry.event(
                    "health.readmit", rank=message.node_rank
                )
            mgr.join_rendezvous(
                message.node_rank,
                message.local_world_size,
                message.node_ip,
                # older clients' pickles predate these fields
                verified_ckpt_step=getattr(
                    message, "verified_ckpt_step", -1
                ),
                verified_ckpt_steps=getattr(
                    message, "verified_ckpt_steps", None
                ),
            )
            self._mark_dirty()
            return True
        if isinstance(message, msg.VerifiedStepsReport):
            # post-failover re-registration: refresh the node's
            # restorable-step set WITHOUT a join (a join would dissolve
            # the formed round and force a worker restart)
            mgr = self.rdzv_managers.get(message.rdzv_name)
            if mgr is None:
                return False
            mgr.update_verified_steps(message.node_rank, message.steps)
            self._mark_dirty()
            return True
        if isinstance(message, msg.HostProbeReport):
            # in-band re-probe from an admitted host: folds into the
            # fingerprint store; sustained degradation surfaces on the
            # next diagnosis sweep as a hw_degraded verdict
            self.health.observe(message.node_rank, message.report)
            return True
        if isinstance(message, msg.NodeCheckResultRequest):
            mgr = self.rdzv_managers.get(RendezvousName.NETWORK_CHECK)
            mgr.report_network_check_result(
                message.node_id, message.normal, message.elapsed_time
            )
            return True
        if isinstance(message, msg.ResourceStats):
            self.job_manager.update_node_resource_usage(
                node_type,
                node_id,
                message.cpu_percent,
                message.memory_mb,
                message.tpu_stats,
            )
            return True
        if isinstance(message, msg.GlobalStep):
            with self._state_lock:
                # locked check-then-act: two first-step reports racing
                # here must not both rewrite the start time
                if self._start_training_time == 0:
                    self._start_training_time = time.time()
            # node identity threaded through so per-node progress is
            # trackable (hang diagnosis second source) — the message
            # itself predates diagnosis and stays unchanged
            self.task_manager.speed_monitor.collect_global_step(
                message.step, message.timestamp,
                node=(node_type, node_id),
            )
            return True
        if isinstance(message, msg.NodeFailure):
            self.job_manager.handle_training_failure(
                node_type,
                node_id,
                message.restart_count,
                message.error_data,
                message.level,
            )
            return True
        if isinstance(message, msg.KeyValuePair):
            self.kv_store.set(
                message.key, message.value, wal=self._wal_hook
            )
            return True
        if isinstance(message, msg.SyncJoin):
            ok = self.sync_service.join_sync(
                message.sync_name, node_type, node_id
            )
            self._mark_dirty()
            return ok
        if isinstance(message, msg.SyncFinish):
            ok = self.sync_service.notify_barrier(message.sync_name)
            self._mark_dirty()
            return ok
        if isinstance(message, msg.CheckpointReadyRequest):
            ok = self.ckpt_barrier.report_ready(
                message.group, message.step, message.node_id, message.world,
                ready=message.ready,
            )
            self._mark_dirty()
            return ok
        if isinstance(message, msg.CheckpointSyncRequest):
            world = self._alive_worker_num()
            ok = self.ckpt_barrier.sync_checkpoint(
                message.step, message.node_id, max(world, 1)
            )
            self._mark_dirty()
            return ok
        if isinstance(message, msg.ShardCheckpoint):
            ok = self.task_manager.restore_dataset_from_checkpoint(
                message.content
            )
            if ok:
                # an acked worker-pushed restore must survive a crash:
                # the content is absolute dataset state (idempotent)
                self._wal("restore_ds", content=message.content)
            return ok
        if isinstance(message, msg.DatasetTaskEnd):
            return True
        if isinstance(message, msg.NodeMeta):
            node = self.job_manager.get_node(node_type, node_id)
            if node is not None:
                node.update_service_address(message.addr)
            return True
        if isinstance(message, msg.JobEnd):
            with self._state_lock:
                self._job_success = message.success
            self._job_ended.set()
            return True
        if isinstance(message, msg.TelemetrySnapshot):
            ok = self.telemetry.update(message.payload)
            if ok:
                # series points fold into the tiered store with
                # sample-seq dedup, so re-sent snapshots are as
                # idempotent here as in the merge above
                self.metrics_store.ingest_snapshot(message.payload)
                self._mark_dirty()
            return ok
        if isinstance(message, msg.CaptureResultReport):
            return self.capture.report_result(
                message.capture_id, message.node_rank, message.ok,
                artifact=message.artifact, summary=message.summary,
                error=message.error,
            )
        if isinstance(message, msg.DiagnosisReport):
            logger.info(
                "diagnosis from %s-%s [%s]: %s",
                node_type,
                node_id,
                message.tag,
                message.content[:200],
            )
            return True
        logger.warning("report: unhandled message %r", type(message).__name__)
        return False

    # -------------------------------------------------------------- helpers

    def _alive_worker_num(self) -> int:
        from dlrover_tpu_torch.common.constants import NodeStatus, NodeType

        nodes = self.job_manager.get_job_nodes(NodeType.WORKER)
        return sum(
            1 for n in nodes.values() if n.status == NodeStatus.RUNNING
        ) or len(nodes)

    def _get_task(self, node_type, node_id, request: msg.TaskRequest):
        # child of the worker's shard.fetch span (context propagated in
        # the RPC envelope): dispatch + WAL land in one shard trace
        with tracing.span(
            "shard.dispatch", node=f"{node_type}-{node_id}",
            dataset=request.dataset_name,
        ) as sp:
            task = self._get_task_traced(node_type, node_id, request)
            sp.annotate(task_id=task.task_id)
            return task

    def _get_task_traced(self, node_type, node_id, request):
        task = self.task_manager.get_dataset_task(
            node_type, node_id, request.dataset_name
        )
        if task.task_id >= 0:
            # durable dispatch record AFTER the mutation, BEFORE the
            # ack: a restored master re-binds this task id to the same
            # shard, so the worker's eventual completion report lands
            # exactly once
            self._wal(
                "dispatch",
                ds=request.dataset_name,
                task_id=task.task_id,
                start=task.shard.start,
                end=task.shard.end,
                indices=list(task.shard.record_indices),
                node_type=node_type,
                node_id=node_id,
            )
        return msg.Task(
            task_id=task.task_id,
            task_type=task.task_type,
            shard=msg.Shard(
                name=task.shard.name,
                start=task.shard.start,
                end=task.shard.end,
                record_indices=list(task.shard.record_indices),
            ),
        )

    def _report_task_result(self, result: msg.TaskResult) -> bool:
        with tracing.span("shard.result", task_id=result.task_id):
            success = not result.err_message
            ok = self.task_manager.report_dataset_task(
                result.dataset_name, result.task_id, success
            )
            if ok or not success:
                self._wal(
                    "task_result",
                    ds=result.dataset_name,
                    task_id=result.task_id,
                    success=success,
                )
            return ok

    def _get_comm_world(self, request: msg.CommWorldRequest):
        mgr = self.rdzv_managers.get(request.rdzv_name)
        if mgr is None:
            return msg.CommWorld(rdzv_name=request.rdzv_name)
        rdzv_round, group, world, coordinator = mgr.get_comm_world(
            request.node_id
        )
        with self._state_lock:
            # this poll may just have FORMED the round — the membership
            # and consensus step must survive a master failover. Only
            # the round TRANSITION dirties the snapshot: agents poll
            # the formed world every monitor tick (reshape-first
            # membership detection), and re-marking on every poll
            # would make the snapshot writer persist unchanged state
            # forever. Locked: concurrent polls of a fresh round must
            # produce exactly one transition.
            newly_marked = world and self._marked_rounds.get(
                request.rdzv_name
            ) != rdzv_round
            if newly_marked:
                self._marked_rounds[request.rdzv_name] = rdzv_round
        if newly_marked:
            self._mark_dirty()
        # pass rdzv_round so a round dissolved+re-formed between the
        # two manager calls cannot attach the new round's verdicts to
        # this (stale) world
        verdicts, departed = (
            mgr.round_verdicts(rdzv_round) if world else ({}, {})
        )
        return msg.CommWorld(
            rdzv_name=request.rdzv_name,
            round=rdzv_round,
            group=group,
            world=world,
            coordinator_addr=coordinator,
            restore_step=(
                mgr.consensus_restore_step() if world else -1
            ),
            verdicts=verdicts,
            departed=departed,
        )

    def _get_paral_config(self, node_type, node_id):
        node = self.job_manager.get_node(node_type, node_id)
        if node is not None and node.paral_config is not None:
            return node.paral_config
        return msg.ParallelConfig()

    @property
    def job_ended(self) -> bool:
        return self._job_ended.is_set()

    @property
    def job_success(self) -> bool:
        with self._state_lock:
            return self._job_success

    def set_run_configs(self, configs: dict):
        with self._state_lock:
            self._run_configs = dict(configs)

    def get_run_configs(self) -> dict:
        """Snapshot copy for readers (the run-config RPC arm and the
        state-store collector) — the write side replaces the whole dict
        under the state lock, so a copy here can never tear."""
        with self._state_lock:
            return dict(self._run_configs)


def create_master_service(port: int, **managers) -> tuple[RpcServer, MasterServicer]:
    """Build the servicer + RPC server (reference servicer.py:580)."""
    servicer = MasterServicer(**managers)
    server = RpcServer(port, servicer)
    return server, servicer
