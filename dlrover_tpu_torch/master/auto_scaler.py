"""JobAutoScaler: periodic resource re-planning + scale execution.

Equivalent capability: reference dlrover/python/master/node/
job_auto_scaler.py:73 (`JobAutoScaler` ABC), :254
(`AllreduceTrainingAutoScaler` — periodic alive-count adjust) and :98
(`PSTrainingAutoScaler` — periodic optimize + OOM adjust).

TPU-first notes: allreduce-style (SPMD) training is THE mode on TPU; the
scaler keeps the worker group at the configured count by replacing dead
nodes, quantized to ``node_unit`` (a TPU slice's host count) so partially
usable slices are never requested.

The PyTorch port's copy of dlrover_tpu/master/auto_scaler.py.
"""

from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod

from dlrover_tpu_torch.common.constants import (
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.resource import (
    JobResourceOptimizer,
    ResourcePlan,
)

logger = get_logger(__name__)


class JobAutoScaler(ABC):
    """Watches job state and executes ResourcePlans through a Scaler."""

    def __init__(self, job_manager, scaler=None, interval: float = 30.0):
        self._job_manager = job_manager
        self._scaler = scaler
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self.started = False

    def start_auto_scaling(self):
        if self.started:
            return
        self.started = True
        self._thread = threading.Thread(
            target=self._periodic_adjust, name="auto-scaler", daemon=True
        )
        self._thread.start()

    def stop_auto_scaling(self):
        self._stopped.set()

    def _periodic_adjust(self):
        while not self._stopped.is_set():
            try:
                plan = self.plan()
                if plan is not None and not plan.empty():
                    self.execute_job_optimization_plan(plan)
            except Exception:  # noqa: BLE001
                logger.exception("auto-scale iteration failed")
            self._stopped.wait(self._interval)

    @abstractmethod
    def plan(self) -> ResourcePlan | None:
        ...

    def on_group_count_applied(self, count: int):
        """Hook: subclasses may adopt an executed count as the new target."""

    def execute_job_optimization_plan(self, plan: ResourcePlan):
        """Apply group-count changes and per-node resource overrides."""
        # Per-node overrides (OOM memory bumps): mutate config_resource in
        # place — a relaunched replacement aliases its parent's
        # config_resource (Node.get_relaunch_node_info), so the bump
        # reaches the next pod spec.
        for name, res in plan.node_resources.items():
            node = self._job_manager.get_node_by_name(name)
            if node is None:
                continue
            if res.memory:
                node.config_resource.memory = res.memory
            if res.cpu:
                node.config_resource.cpu = res.cpu
            logger.info(
                "applied resource override to %s: cpu=%s mem=%sMi",
                name, node.config_resource.cpu,
                node.config_resource.memory,
            )
        group = plan.node_group_resources.get(NodeType.WORKER)
        if group is None:
            return
        self.on_group_count_applied(group.count)
        nodes = self._job_manager.get_job_nodes(NodeType.WORKER)
        alive = {
            i: n for i, n in nodes.items()
            if n.status not in NodeStatus.end_states() and not n.is_released
        }
        delta = group.count - len(alive)
        if delta > 0:
            logger.info("scaling out %d worker(s) to reach %d",
                        delta, group.count)
            new_nodes = self._job_manager.create_new_workers(
                delta, group.node_resource
            )
            if self._scaler is not None and new_nodes:
                self._scaler.scale(
                    self._job_manager.get_job_nodes(NodeType.WORKER)
                )
        elif delta < 0:
            victims = sorted(alive)[delta:]
            logger.info("scaling in workers %s to reach %d",
                        victims, group.count)
            for node_id in victims:
                self._job_manager.release_node(NodeType.WORKER, node_id)


class AllreduceTrainingAutoScaler(JobAutoScaler):
    """Keeps the SPMD worker group at the configured size.

    Periodically counts alive workers; when below target (minus nodes that
    can still relaunch on their own) it requests replacements, quantized to
    ``node_unit`` (reference job_auto_scaler.py:254 `_get_alive_worker_num`
    periodic loop).
    """

    def __init__(self, job_manager, scaler=None, target_worker_num: int = 0,
                 node_unit: int = 1, interval: float = 30.0):
        super().__init__(job_manager, scaler, interval)
        self._target_worker_num = int(target_worker_num)
        self._node_unit = max(1, int(node_unit))
        # permanent failures already subtracted from the target (each node
        # shrinks it exactly once — no ratcheting)
        self._permanent_seen: set = set()

    def on_group_count_applied(self, count: int):
        # an executed plan (including an external / PS-optimizer one)
        # becomes the new steady-state target
        self._target_worker_num = count

    def plan(self) -> ResourcePlan | None:
        from dlrover_tpu_torch.common.node import (
            NodeGroupResource,
            NodeResource,
        )

        nodes = self._job_manager.get_job_nodes(NodeType.WORKER)
        if not self._target_worker_num:
            self._target_worker_num = len(nodes)
        alive = sum(
            1 for n in nodes.values()
            if n.status in (NodeStatus.RUNNING, NodeStatus.PENDING,
                            NodeStatus.INITIAL)
            and not n.is_released
        )
        # Nodes whose failure was unrecoverable (FATAL_ERROR / relaunches
        # exhausted) must NOT be resurrected as fresh nodes — that would be
        # an unbounded crash loop. Each newly-seen one permanently shrinks
        # the target by exactly one.
        for node_id, n in nodes.items():
            if node_id in self._permanent_seen:
                continue
            if self._job_manager.is_permanently_failed(n):
                self._permanent_seen.add(node_id)
                self._target_worker_num -= 1
                logger.warning(
                    "worker %s failed permanently; target now %d",
                    node_id, self._target_worker_num,
                )
        # never request a partial TPU slice: round DOWN to whole node_units
        achievable = (
            self._target_worker_num // self._node_unit
        ) * self._node_unit
        if achievable <= 0 or alive == achievable:
            return None
        plan = ResourcePlan()
        plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(
            achievable, NodeResource()
        )
        return plan


class PSTrainingAutoScaler(JobAutoScaler):
    """Optimizer-driven scaling + OOM memory recovery (reference
    job_auto_scaler.py:98). On TPU this serves host-side data/embedding
    workers (the PS analogue for sparse workloads)."""

    def __init__(self, job_manager, resource_optimizer: JobResourceOptimizer,
                 scaler=None, interval: float = 30.0):
        super().__init__(job_manager, scaler, interval)
        self._resource_optimizer = resource_optimizer
        # OOM events already turned into a memory bump (one bump per event)
        self._oom_handled: set = set()

    def plan(self) -> ResourcePlan | None:
        plan = self._resource_optimizer.get_plan()
        oom_nodes = self._find_oom_nodes()
        if oom_nodes:
            plan.merge(self._resource_optimizer.get_oom_plan(oom_nodes))
        return plan

    def _find_oom_nodes(self) -> list[Node]:
        out = []
        for nodes in self._job_manager.get_job_nodes().values():
            for node in nodes.values():
                key = (node.type, node.id)
                if node.exit_reason == NodeExitReason.OOM \
                        and key not in self._oom_handled:
                    self._oom_handled.add(key)
                    out.append(node)
        return out
