"""Brain client + master-side integrations.

Equivalent capability: reference dlrover/python/brain/client.py:63
(gRPC brain client) plus the master pieces that talk to it —
`BrainReporter` (stats/reporter.py:146 — periodic job metrics push) and
`BrainResoureOptimizer` (resource/brain_optimizer.py:64 — ResourcePlans
from the brain service).

The PyTorch port's copy of dlrover_tpu/brain/client.py; like the JAX
package's, it imports no torch.
"""

from __future__ import annotations

import threading
import time

from dlrover_tpu_torch.brain import messages as bmsg
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource
from dlrover_tpu_torch.common.retry import NonCriticalGuard, noncritical_rpc_policy
from dlrover_tpu_torch.common.rpc import RpcClient
from dlrover_tpu_torch.master.resource import ResourceOptimizer, ResourcePlan

logger = get_logger(__name__)


class BrainClient:
    """Brain RPC client — NON-CRITICAL by design: it runs under the
    short-budget retry policy and a :class:`NonCriticalGuard`, so a
    dead or flapping brain service degrades this client to a no-op
    (metrics dropped, no optimize plans) instead of stalling or
    crashing the job that merely *reports* to it."""

    def __init__(self, addr: str):
        self._rpc = RpcClient(addr, policy=noncritical_rpc_policy())
        self._guard = NonCriticalGuard(f"brain-client[{addr}]")

    @property
    def degraded(self) -> bool:
        return self._guard.disabled

    def persist_metrics(self, job_uuid: str, job_name: str,
                        metrics: dict) -> bool:
        return self._guard.run(
            lambda: self._rpc.report(
                "brain-client", 0,
                bmsg.PersistMetricsRequest(
                    job_uuid=job_uuid, job_name=job_name,
                    timestamp=time.time(), metrics=metrics,
                ),
            ),
            default=False,
        )

    def optimize(self, job_uuid: str, job_name: str, opt_type: str,
                 config: dict | None = None) -> dict | None:
        resp = self._guard.run(
            lambda: self._rpc.get(
                "brain-client", 0,
                bmsg.OptimizeRequest(
                    job_uuid=job_uuid, job_name=job_name,
                    opt_type=opt_type, config=config or {},
                ),
            )
        )
        if isinstance(resp, bmsg.OptimizeResponse) and resp.found:
            return resp.plan
        return None

    def get_job_metrics(self, job_uuid: str) -> list:
        resp = self._guard.run(
            lambda: self._rpc.get(
                "brain-client", 0,
                bmsg.GetJobMetricsRequest(job_uuid=job_uuid),
            )
        )
        if isinstance(resp, bmsg.JobMetricsResponse):
            return resp.records
        return []

    def close(self):
        self._rpc.close()


class BrainResourceOptimizer(ResourceOptimizer):
    """ResourceOptimizer delegating sizing decisions to the brain."""

    def __init__(self, client: BrainClient, job_uuid: str, job_name: str):
        self._client = client
        self._job_uuid = job_uuid
        self._job_name = job_name

    def _plan_from(self, plan_dict: dict | None) -> ResourcePlan:
        plan = ResourcePlan()
        if not plan_dict:
            return plan
        group = NodeGroupResource(
            int(plan_dict.get("worker_count", 0)),
            NodeResource(
                cpu=float(plan_dict.get("cpu", 0)),
                memory=int(plan_dict.get("memory_mb", 0)),
            ),
        )
        if group.count or group.node_resource.memory:
            plan.node_group_resources[NodeType.WORKER] = group
        return plan

    def generate_opt_plan(self, phase: str, config: dict) -> ResourcePlan:
        opt_type = "cold_create" if phase == "initial" else "worker_count"
        return self._plan_from(self._client.optimize(
            self._job_uuid, self._job_name, opt_type, config
        ))

    def generate_oom_recovery_plan(self, oom_nodes: list,
                                   phase: str) -> ResourcePlan:
        plan = ResourcePlan()
        for node in oom_nodes:
            got = self._client.optimize(
                self._job_uuid, self._job_name, "oom_memory",
                {"memory_mb": getattr(
                    node.config_resource, "memory", 0
                )},
            )
            if got and got.get("memory_mb"):
                plan.node_resources[node.name] = NodeResource(
                    memory=int(got["memory_mb"])
                )
        return plan


class BrainReporter:
    """Periodically pushes job runtime metrics to the brain (reference
    BrainReporter stats/reporter.py:146)."""

    def __init__(self, client: BrainClient, job_uuid: str, job_name: str,
                 job_manager=None, speed_monitor=None,
                 interval: float = 60.0):
        self._client = client
        self._job_uuid = job_uuid
        self._job_name = job_name
        self._job_manager = job_manager
        self._speed_monitor = speed_monitor
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None

    def _sample_to_metrics(self, sample) -> dict:
        # keys are present only when their source was configured: a
        # brain-side consumer must distinguish "metric unavailable"
        # from "measured zero"
        metrics: dict = {"status": "running"}
        if self._speed_monitor is not None:
            metrics["speed"] = sample.speed
            metrics["global_step"] = sample.global_step
        if self._job_manager is not None:
            metrics["worker_count"] = sample.worker_count
            if sample.max_used_memory_mb:
                metrics["used_memory_mb"] = sample.max_used_memory_mb
        runtime = {
            k: getattr(sample, k, None)
            for k in ("speed", "worker_cpu", "worker_memory",
                      "ps_cpu", "ps_memory")
        }
        if runtime.get("worker_cpu") or runtime.get("ps_cpu"):
            # per-node usage present: attach the JobRuntimeInfo-style
            # sample the windowed algorithms consume
            metrics["runtime"] = runtime
        return metrics

    def collect_metrics(self) -> dict:
        # single source of truth for the runtime reduction: the stats
        # sampler (master/stats.py) — no drift between the master's
        # local history and the brain-reported metrics
        from dlrover_tpu_torch.master.stats import JobMetricCollector

        sample = JobMetricCollector(
            self._job_manager, self._speed_monitor, reporters=[]
        ).collect_runtime_once()
        return self._sample_to_metrics(sample)

    def report_runtime(self, sample) -> bool:
        """Reporter hook: lets a JobMetricCollector fan its samples out
        to the brain (the intended composition)."""
        return self._client.persist_metrics(
            self._job_uuid, self._job_name,
            self._sample_to_metrics(sample),
        )

    def report_once(self) -> bool:
        return self._client.persist_metrics(
            self._job_uuid, self._job_name, self.collect_metrics()
        )

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="brain-reporter", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.is_set():
            try:
                self.report_once()
            except Exception:  # noqa: BLE001
                logger.exception("brain report failed")
            self._stopped.wait(self._interval)
