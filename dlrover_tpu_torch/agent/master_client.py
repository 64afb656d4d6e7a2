"""MasterClient: the agent/worker-side control-plane client.

Equivalent capability: reference dlrover/python/elastic_agent/
master_client.py:50 — singleton client with retry, covering the full API:
tasks/shards, rendezvous join/comm-world, network status, parallel config,
heartbeats, kv-store, metrics, failure reports.

The PyTorch port's copy of dlrover_tpu/agent/master_client.py.
"""

from __future__ import annotations

import os
import socket
import threading
import time

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.constants import (
    JobConstant,
    NodeEnv,
    NodeType,
    RendezvousName,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.rpc import RpcClient

logger = get_logger(__name__)

# Ride-through knobs (agent-side master-failover tolerance).
ENV_RIDE_THROUGH = "DLROVER_MASTER_RIDE_THROUGH"  # seconds
ENV_RIDE_POLL = "DLROVER_MASTER_RIDE_POLL"        # probe interval


def resolve_master_addr(default: str = "") -> str:
    """The master's CURRENT address: the address file (written by
    ``master.main --addr-file``, atomically re-written on restart) wins
    over the launch-time env var, which wins over ``default``."""
    path = os.environ.get(NodeEnv.DLROVER_MASTER_ADDR_FILE, "")
    if path:
        try:
            with open(path) as f:
                addr = f.read().strip()
            if addr:
                return addr
        except OSError:
            pass
    return os.environ.get(NodeEnv.DLROVER_MASTER_ADDR, "") or default


class MasterClient:
    _instance = None
    _instance_lock = threading.Lock()

    def __init__(
        self, master_addr: str, node_id: int, node_type: str,
        addr_resolver=None,
    ):
        self._addr = master_addr
        self._node_id = node_id
        self._node_type = node_type
        self._rpc = RpcClient(
            master_addr,
            addr_resolver=(
                addr_resolver
                if addr_resolver is not None
                else lambda: resolve_master_addr(master_addr)
            ),
        )
        self._host = socket.gethostname()
        try:
            self._host_ip = socket.gethostbyname(self._host)
        except OSError:
            self._host_ip = "127.0.0.1"

    # ------------------------------------------------------------ plumbing

    @property
    def master_addr(self) -> str:
        # the RpcClient's view: follows resolver-driven re-resolution
        return self._rpc.addr

    @property
    def host_ip(self) -> str:
        return self._host_ip

    @property
    def node_id(self) -> int:
        return self._node_id

    def _get(self, message, retries: int | None = None):
        # retries=None -> the shared RetryPolicy decides (DLROVER_RPC_*
        # env, one place); explicit retries = fail-fast best-effort calls
        return self._rpc.get(self._node_type, self._node_id, message, retries)

    def _report(self, message, retries: int | None = None) -> bool:
        return self._rpc.report(
            self._node_type, self._node_id, message, retries
        )

    def ping(self) -> bool:
        return self._rpc.ping()

    def close(self):
        self._rpc.close()

    # ------------------------------------------------- master ride-through

    def await_master(
        self, timeout: float | None = None, poll: float | None = None
    ) -> bool:
        """Bounded ride-through for an unreachable master.

        Ordinary RPC exhaustion (a reachable master answering with
        errors) surfaces as RuntimeError and is NOT what this handles;
        this is for transport-level loss — the coordinator died or
        moved. Each probe closes the cached socket so the next connect
        re-resolves the address (env / address file), then pings.
        Returns True the moment the master (old or restarted) answers;
        False when the budget runs out — the caller decides whether to
        keep training and retry or give up."""
        if timeout is None:
            timeout = float(os.environ.get(
                ENV_RIDE_THROUGH,
                str(JobConstant.MASTER_RIDE_THROUGH_DEFAULT),
            ))
        if poll is None:
            poll = float(os.environ.get(ENV_RIDE_POLL, "2.0"))
        deadline = time.monotonic() + timeout
        while True:
            self._rpc.close()  # force re-resolve + reconnect
            if self.ping():
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(min(poll, max(deadline - time.monotonic(), 0.0)))

    # ------------------------------------------------------- data sharding

    def report_dataset_shard_params(
        self,
        batch_size: int,
        num_epochs: int,
        dataset_size: int,
        shuffle: bool = False,
        num_minibatches_per_shard: int = 2,
        dataset_name: str = "train",
        task_type: str = "training",
        storage_type: str = "",
        dataset_type: str = "table",
    ) -> bool:
        return self._report(
            msg.DatasetShardParams(
                batch_size=batch_size,
                num_epochs=num_epochs,
                dataset_size=dataset_size,
                shuffle=shuffle,
                num_minibatches_per_shard=num_minibatches_per_shard,
                dataset_name=dataset_name,
                task_type=task_type,
                storage_type=storage_type,
                dataset_type=dataset_type,
            )
        )

    def get_task(self, dataset_name: str) -> msg.Task:
        task = self._get(msg.TaskRequest(dataset_name=dataset_name))
        return task if task is not None else msg.Task()

    def report_task_result(
        self, dataset_name: str, task_id: int, err_message: str = ""
    ) -> bool:
        return self._report(
            msg.TaskResult(
                dataset_name=dataset_name,
                task_id=task_id,
                err_message=err_message,
            )
        )

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        ckpt = self._get(msg.ShardCheckpointRequest(dataset_name=dataset_name))
        return ckpt.content if ckpt else ""

    def report_shard_checkpoint(self, content: str) -> bool:
        return self._report(msg.ShardCheckpoint(content=content))

    # ----------------------------------------------------------- rendezvous

    def join_rendezvous(
        self, node_rank: int, local_world_size: int, rdzv_name: str,
        verified_ckpt_step: int = -1, verified_ckpt_steps=None,
        probe_report=None,
    ) -> bool:
        return self._report(
            msg.JoinRendezvousRequest(
                node_id=self._node_id,
                node_rank=node_rank,
                local_world_size=local_world_size,
                rdzv_name=rdzv_name,
                node_ip=self._host_ip,
                verified_ckpt_step=verified_ckpt_step,
                verified_ckpt_steps=list(verified_ckpt_steps or ()),
                # the hardware probe's per-leg timings; empty = no
                # probe ran, the master's gate admits (old behavior)
                probe_report=dict(probe_report or {}),
            )
        )

    def report_verified_steps(
        self, node_rank: int, steps,
        rdzv_name: str = RendezvousName.ELASTIC_TRAINING,
    ) -> bool:
        """Refresh this node's restorable-step set without joining —
        used when re-registering after a master failover (a join would
        dissolve the restored round and restart healthy workers)."""
        return self._report(
            msg.VerifiedStepsReport(
                node_rank=node_rank,
                rdzv_name=rdzv_name,
                steps=[int(s) for s in (steps or ())],
            ),
            retries=2,
        )

    def drain_node(self, node_rank: int) -> bool:
        """Graceful scale-in announcement: ``node_rank`` leaves the job
        with its host still alive, so survivors get a "drained"
        departure (reshape in place, shards readable device-to-device)
        instead of the "dead" a heartbeat timeout would record. Called
        by a platform scaler or by a preempted node's agent ahead of
        its own shutdown."""
        return self._report(
            msg.DrainNodeRequest(node_rank=node_rank)
        )

    def report_preempt_notice(
        self, node_rank: int, deadline: float, lead_s: float = 0.0,
    ) -> msg.PreemptNoticeDirective:
        """Relay an announced preemption (this host dies at
        ``deadline``) and fetch the brain's directive. Fail-fast: the
        lead window is short, and an unreachable master just means the
        unannounced-kill fallback path — never a stall."""
        res = self._get(
            msg.PreemptNoticeRequest(
                node_rank=node_rank, deadline=deadline, lead_s=lead_s,
            ),
            retries=2,
        )
        return res if res is not None else msg.PreemptNoticeDirective()

    def get_comm_world(self, rdzv_name: str, node_rank: int):
        world: msg.CommWorld = self._get(
            msg.CommWorldRequest(node_id=node_rank, rdzv_name=rdzv_name)
        )
        return world

    def num_nodes_waiting(self, rdzv_name: str) -> int:
        res: msg.WaitingNodeNum = self._get(
            msg.WaitingNodeNumRequest(rdzv_name=rdzv_name)
        )
        return res.waiting_num if res else 0

    # --------------------------------------------------- node health check

    def report_node_check_result(
        self, node_rank: int, normal: bool, elapsed: float
    ) -> bool:
        return self._report(
            msg.NodeCheckResultRequest(
                node_id=node_rank, normal=normal, elapsed_time=elapsed
            )
        )

    def check_network_ready(self) -> msg.NetworkCheckResult:
        return self._get(msg.NetworkReadyRequest())

    def get_node_health(self, node_rank: int) -> msg.NodeHealthVerdict:
        """This host's standing health-gate verdict — polled while a
        join has been acked but no world forms, to tell "round still
        filling" apart from "parked in quarantine"."""
        res = self._get(
            msg.NodeHealthRequest(node_rank=node_rank), retries=1
        )
        return res if res is not None else msg.NodeHealthVerdict()

    def report_probe(self, node_rank: int, report: dict) -> bool:
        """Ship an in-band re-probe report to the fingerprint store.
        Best-effort: a dropped sample just waits for the next window."""
        return self._report(
            msg.HostProbeReport(
                node_rank=node_rank, report=dict(report or {})
            ),
            retries=1,
        )

    def check_straggler(self) -> msg.NetworkCheckResult:
        return self._get(msg.StragglerExistRequest())

    def get_diagnosis(self) -> msg.DiagnosisResult:
        """The master's current runtime verdicts (stragglers + hangs).
        Best-effort fail-fast poll like the stats reports."""
        res = self._get(msg.DiagnosisRequest(node_rank=self._node_id),
                        retries=1)
        return res if res is not None else msg.DiagnosisResult()

    # -------------------------------------------------- deep captures

    def request_capture(
        self, node_rank: int = -1, steps: int = 0,
        reason: str = "operator",
    ) -> msg.ProfileCaptureAck:
        """Ask the master's CaptureManager for a deep capture of
        ``node_rank`` (the obs_report --capture front door)."""
        res = self._get(msg.ProfileCaptureRequest(
            node_rank=node_rank, steps=steps, reason=reason,
        ))
        return res if res is not None else msg.ProfileCaptureAck(
            reason="no response"
        )

    def list_captures(self) -> list:
        res: msg.CaptureList = self._get(msg.CaptureListRequest())
        return list(res.captures) if res else []

    def report_capture_result(
        self, capture_id: str, node_rank: int, ok: bool,
        artifact: str = "", summary: dict | None = None,
        error: str = "",
    ) -> bool:
        """Land a capture outcome on the master ledger (fail-fast:
        the directive re-serves on the next diagnosis poll if this
        report is lost)."""
        return self._report(
            msg.CaptureResultReport(
                capture_id=capture_id,
                node_rank=node_rank,
                ok=ok,
                artifact=artifact,
                summary=dict(summary or {}),
                error=error,
            ),
            retries=2,
        )

    def report_failure(
        self, error_data: str, level: str, restart_count: int = 0
    ) -> bool:
        return self._report(
            msg.NodeFailure(
                node_id=self._node_id,
                error_data=error_data,
                level=level,
                restart_count=restart_count,
            )
        )

    # ------------------------------------------------- heartbeat & metrics

    def report_heart_beat(self, timestamp=None) -> msg.HeartbeatResponse:
        resp = self._get(
            msg.HeartBeat(
                node_id=self._node_id, timestamp=timestamp or time.time()
            )
        )
        return resp if resp is not None else msg.HeartbeatResponse()

    def report_used_resource(
        self, cpu_percent: float, memory_mb: int, tpu_stats=None
    ) -> bool:
        return self._report(
            msg.ResourceStats(
                node_id=self._node_id,
                cpu_percent=cpu_percent,
                memory_mb=memory_mb,
                tpu_stats=tpu_stats or [],
            ),
            retries=1,
        )

    def report_global_step(self, step: int, timestamp=None) -> bool:
        return self._report(
            msg.GlobalStep(
                step=step, timestamp=timestamp or time.time()
            ),
            retries=1,
        )

    def report_telemetry(self, snapshot: dict) -> bool:
        """Ship a telemetry registry snapshot (cumulative, idempotent);
        best-effort like the other stats reports."""
        return self._report(
            msg.TelemetrySnapshot(
                node_id=self._node_id, payload=snapshot
            ),
            retries=1,
        )

    def get_telemetry_report(self) -> dict:
        """The master's merged job view (goodput ledger + timeline)."""
        res: msg.TelemetryReport = self._get(msg.TelemetryReportRequest())
        return res.payload if res else {}

    def query_metrics(
        self,
        name: str,
        source: str = "",
        resolution: str = "raw",
        since: float = 0.0,
        limit: int = 0,
    ) -> list:
        """Time series from the master's tiered metrics store (the
        live metrics plane); see ``MetricsQueryRequest``."""
        res: msg.MetricsSeries = self._get(
            msg.MetricsQueryRequest(
                name=name, source=source, resolution=resolution,
                since=since, limit=limit,
            )
        )
        return res.series if res else []

    # ------------------------------------------------------------- serving

    def serve_submit(
        self,
        request_id: str,
        prompt,
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        eos_id: int = -1,
    ) -> bool:
        """Submit one generation request to the master's serving
        ledger (idempotent by request_id — retries after a dropped ack
        cannot double-serve)."""
        return self._report(
            msg.ServeSubmitRequest(
                request_id=request_id,
                prompt=list(prompt),
                max_new_tokens=max_new_tokens,
                temperature=temperature,
                eos_id=eos_id,
            )
        )

    def serve_lease(self, max_requests: int) -> list:
        """Pull up to ``max_requests`` queued requests for this decode
        worker (payload dicts; the lease deadline lives on the
        master)."""
        res: msg.ServeLease = self._get(
            msg.ServeLeaseRequest(
                node_rank=self._node_id, max_requests=max_requests
            )
        )
        return list(res.requests) if res else []

    def serve_report_result(self, request_id: str, tokens,
                            finish_reason: str = "") -> bool:
        return self._report(
            msg.ServeResultReport(
                request_id=request_id,
                node_rank=self._node_id,
                tokens=list(tokens),
                finish_reason=finish_reason,
            )
        )

    def serve_status(self) -> dict:
        res: msg.ServeStatus = self._get(msg.ServeStatusRequest())
        return dict(res.summary) if res else {}

    def serve_fetch(self, request_id: str) -> msg.ServeResult:
        return self._get(msg.ServeFetchRequest(request_id=request_id))

    def report_node_meta(
        self, node_rank: int, addr: str, tpu_chips: int = 0
    ) -> bool:
        return self._report(
            msg.NodeMeta(
                node_type=self._node_type,
                node_id=self._node_id,
                node_rank=node_rank,
                addr=addr,
                tpu_chips=tpu_chips,
            )
        )

    # -------------------------------------------------------------- config

    def report_rdzv_params(self, min_nodes: int, max_nodes: int,
                           waiting_timeout: float = 30.0,
                           node_unit: int = 1) -> bool:
        return self._report(msg.RdzvParamsReport(
            min_nodes=min_nodes, max_nodes=max_nodes,
            waiting_timeout=waiting_timeout, node_unit=node_unit,
        ))

    def feed_streaming_dataset(self, dataset_name: str, count: int,
                               end: bool = False) -> bool:
        return self._report(msg.StreamingFeed(
            dataset_name=dataset_name, count=count, end=end
        ))

    def get_ps_version(self, version_type: str = "global") -> int:
        resp = self._get(msg.PsVersionRequest(version_type=version_type))
        return resp.version if resp is not None else 0

    def report_ps_version(self, version: int,
                          version_type: str = "local") -> bool:
        return self._report(msg.PsVersionReport(
            version_type=version_type, version=version
        ))

    def get_paral_config(self) -> msg.ParallelConfig:
        # best-effort tuning poll: fail fast and let the tuner's
        # NonCriticalGuard degrade, like the stats reports above
        return self._get(msg.ParallelConfigRequest(), retries=2)

    def report_elastic_run_config(self, configs: dict) -> bool:
        return self._report(msg.ElasticRunConfig(configs=configs))

    def get_elastic_run_config(self, retries: int | None = None) -> dict:
        # explicit retries = fail-fast advisory polls (the trainer's
        # cadence adoption must never stall a step boundary)
        res: msg.ElasticRunConfig = self._get(
            msg.ElasticRunConfigRequest(), retries
        )
        return res.configs if res else {}

    # ------------------------------------------------------------ kv store

    def kv_store_set(self, key: str, value: bytes) -> bool:
        return self._report(msg.KeyValuePair(key=key, value=value))

    def kv_store_get(self, key: str) -> bytes:
        pair: msg.KeyValuePair = self._get(msg.KeyValueGetRequest(key=key))
        return pair.value if pair else b""

    def kv_store_add(self, key: str, delta: int) -> int:
        res: msg.KeyValueAddResult = self._get(
            msg.KeyValueAddRequest(key=key, delta=delta)
        )
        return res.value if res else 0

    # ----------------------------------------------------------- ckpt sync

    def report_ckpt_ready(
        self, step: int, group: str, world: int
    ) -> bool:
        return self._report(
            msg.CheckpointReadyRequest(
                node_id=self._node_id,
                step=step,
                group=group,
                world=world,
            )
        )

    def check_ckpt_barrier(
        self, step: int, group: str, world: int
    ) -> tuple[bool, bool]:
        """-> (passed, aborted)"""
        res: msg.BarrierResponse = self._get(
            msg.CheckpointReadyRequest(
                node_id=self._node_id, step=step, group=group, world=world
            )
        )
        if not res:
            return False, False
        return res.passed, getattr(res, "aborted", False)

    def report_ckpt_skip(self, step: int, group: str) -> bool:
        """Tell peers this host is sitting this save out."""
        return self._report(
            msg.CheckpointReadyRequest(
                node_id=self._node_id, step=step, group=group,
                ready=False,
            )
        )

    def sync_checkpoint(self, step: int) -> bool:
        return self._report(
            msg.CheckpointSyncRequest(node_id=self._node_id, step=step)
        )

    # ------------------------------------------------------------ barriers

    def join_sync(self, sync_name: str) -> bool:
        return self._report(
            msg.SyncJoin(
                sync_name=sync_name,
                node_id=self._node_id,
                node_type=self._node_type,
            )
        )

    def sync_finished(self, sync_name: str) -> bool:
        return self._report(msg.SyncFinish(sync_name=sync_name))

    def barrier(self, sync_name: str, notify: bool = False) -> bool:
        res = self._get(
            msg.SyncBarrierRequest(sync_name=sync_name, notify=notify)
        )
        return res.success if res else False

    def report_job_end(self, success: bool, reason: str = "") -> bool:
        return self._report(
            msg.JobEnd(node_id=self._node_id, success=success, reason=reason)
        )

    # ---------------------------------------------------------- singleton

    @classmethod
    def singleton_instance(cls) -> "MasterClient | None":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = build_master_client()
        return cls._instance

    @classmethod
    def reset_singleton(cls, client: "MasterClient | None" = None):
        with cls._instance_lock:
            cls._instance = client


def build_master_client(
    master_addr: str | None = None, node_id: int | None = None
) -> MasterClient | None:
    """Build from env contract (reference master_client.py:408)."""
    addr = master_addr or os.environ.get(NodeEnv.DLROVER_MASTER_ADDR, "")
    if not addr:
        return None
    nid = (
        node_id
        if node_id is not None
        else int(os.environ.get(NodeEnv.NODE_RANK, "0"))
    )
    node_type = os.environ.get(NodeEnv.NODE_TYPE, NodeType.WORKER)
    return MasterClient(addr, nid, node_type)
