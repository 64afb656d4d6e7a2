"""Resource plans and optimizers: the master's sizing brain.

Equivalent capability: reference dlrover/python/master/resource/optimizer.py
(`ResourcePlan`/`ResourceOptimizer`), resource/job.py:196
(`PSJobResourceOptimizer` staged init/sample/stable phases :428-454) and
local_optimizer.py:66 (`PSLocalOptimizer` heuristics from runtime stats).

TPU-first notes: TPU slices are provisioned in fixed topologies, so the
worker-count plan quantizes to ``node_unit`` (hosts per slice) rather than
arbitrary counts; memory/CPU heuristics apply to the host side of each
worker.

The PyTorch port's copy of dlrover_tpu/master/resource.py.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource

logger = get_logger(__name__)


class OptimizePhase:
    """Staged optimization (reference resource/job.py:428-454)."""

    INITIAL = "initial"
    SAMPLE = "sample"
    STABLE = "stable"


@dataclass
class ResourcePlan:
    """A sizing decision: per-type group resources + per-node overrides."""

    node_group_resources: dict = field(default_factory=dict)
    node_resources: dict = field(default_factory=dict)

    def empty(self) -> bool:
        return not self.node_group_resources and not self.node_resources

    def merge(self, other: "ResourcePlan"):
        self.node_group_resources.update(other.node_group_resources)
        self.node_resources.update(other.node_resources)


class ResourceOptimizer(ABC):
    """Produces ResourcePlans for a phase from observed runtime stats."""

    @abstractmethod
    def generate_opt_plan(self, phase: str, config: dict) -> ResourcePlan:
        ...

    @abstractmethod
    def generate_oom_recovery_plan(
        self, oom_nodes: list, phase: str
    ) -> ResourcePlan:
        ...


class LocalHeuristicOptimizer(ResourceOptimizer):
    """Heuristic optimizer from master-local runtime stats — the analogue of
    the reference's PSLocalOptimizer (no external brain service needed).

    Heuristics:
    - sample phase: if per-worker throughput has not degraded vs the last
      sample, propose growing the worker group by ``node_unit`` up to
      ``max_nodes``.
    - stable phase: if the latest grow step *lowered* aggregate throughput,
      shrink back one unit.
    - OOM recovery: multiply the node's memory by ``oom_memory_factor``.
    """

    def __init__(
        self,
        speed_monitor=None,
        node_unit: int = 1,
        max_nodes: int = 0,
        oom_memory_factor: float = 2.0,
    ):
        self._speed_monitor = speed_monitor
        self._node_unit = max(1, int(node_unit))
        self._max_nodes = int(max_nodes)
        self._oom_memory_factor = float(oom_memory_factor)
        # (worker_count, aggregate_speed) history
        self._samples: list[tuple[int, float]] = []

    def record_sample(self, worker_count: int, speed: float):
        self._samples.append((int(worker_count), float(speed)))

    def generate_opt_plan(self, phase: str, config: dict) -> ResourcePlan:
        plan = ResourcePlan()
        if self._speed_monitor is not None:
            # live reading becomes the newest sample
            speed = self._speed_monitor.running_speed
            count = len(self._speed_monitor.running_workers) or 1
            prev = self._samples[-1] if self._samples else None
            self._samples.append((count, speed))
        else:
            if not self._samples:
                return plan
            count, speed = self._samples[-1]
            prev = self._samples[-2] if len(self._samples) >= 2 else None
        if count == 0 or phase == OptimizePhase.INITIAL:
            return plan
        if phase == OptimizePhase.SAMPLE:
            per_worker = speed / count
            prev_per_worker = prev[1] / prev[0] if prev and prev[0] else 0.0
            if per_worker >= 0.9 * prev_per_worker:
                target = count + self._node_unit
                if self._max_nodes and target > self._max_nodes:
                    return plan
                plan.node_group_resources[NodeType.WORKER] = (
                    NodeGroupResource(target, NodeResource())
                )
        elif phase == OptimizePhase.STABLE and prev is not None:
            if speed < 0.95 * prev[1] and count > prev[0]:
                target = max(prev[0], count - self._node_unit)
                plan.node_group_resources[NodeType.WORKER] = (
                    NodeGroupResource(target, NodeResource())
                )
        return plan

    def generate_oom_recovery_plan(
        self, oom_nodes: list, phase: str
    ) -> ResourcePlan:
        plan = ResourcePlan()
        for node in oom_nodes:
            mem = getattr(node.config_resource, "memory", 0) or 8192
            new_mem = int(mem * self._oom_memory_factor)
            plan.node_resources[node.name] = NodeResource(
                cpu=getattr(node.config_resource, "cpu", 0),
                memory=new_mem,
            )
            logger.info(
                "OOM recovery: node %s memory %d -> %d MiB",
                node.name, mem, new_mem,
            )
        return plan


class JobResourceOptimizer:
    """Drives phase transitions and applies plans to group resources —
    the per-job wrapper (reference PSJobResourceOptimizer /
    AllreduceJobResourceOptimizer resource/job.py:196,517)."""

    def __init__(self, optimizer: ResourceOptimizer,
                 sample_after_secs: float = 600.0,
                 stable_after_secs: float = 1800.0):
        self._optimizer = optimizer
        self._phase = OptimizePhase.INITIAL
        self._started_at = time.time()
        self._sample_after = sample_after_secs
        self._stable_after = stable_after_secs

    @property
    def phase(self) -> str:
        self._advance_phase()
        return self._phase

    def _advance_phase(self):
        age = time.time() - self._started_at
        if age >= self._stable_after:
            self._phase = OptimizePhase.STABLE
        elif age >= self._sample_after:
            self._phase = OptimizePhase.SAMPLE

    def get_plan(self, config: dict | None = None) -> ResourcePlan:
        return self._optimizer.generate_opt_plan(self.phase, config or {})

    def get_oom_plan(self, oom_nodes: list) -> ResourcePlan:
        return self._optimizer.generate_oom_recovery_plan(
            oom_nodes, self.phase
        )
