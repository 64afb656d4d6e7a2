"""Node model: resources, group resources and per-node bookkeeping.

Equivalent capability: reference dlrover/python/common/node.py
(NodeResource :37, NodeGroupResource :124, Node :149).

The PyTorch port's copy of dlrover_tpu/common/node.py.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from dlrover_tpu_torch.common.constants import (
    NodeExitReason,
    NodeStatus,
    PriorityClass,
)


@dataclass
class NodeResource:
    """Requested/used resource of one node.

    ``tpu_chips`` replaces the reference's gpu_num; ``gpu_type`` is kept
    as ``accelerator_type`` for parity with heterogeneous clusters.
    """

    cpu: float = 0.0
    memory: int = 0  # MiB
    tpu_chips: int = 0
    accelerator_type: str = ""
    priority: str = ""
    image: str = ""

    def to_resource_dict(self) -> dict:
        d = {"cpu": self.cpu, "memory": f"{self.memory}Mi"}
        if self.tpu_chips > 0:
            d["tpu"] = self.tpu_chips
        return d

    @classmethod
    def resource_str_to_node_resource(cls, resource_str: str) -> "NodeResource":
        """Parse ``cpu=4,memory=8192Mi,tpu=8`` style strings."""
        resource = cls()
        if not resource_str:
            return resource
        for kv in resource_str.strip().split(","):
            if not kv:
                continue
            k, _, v = kv.partition("=")
            k = k.strip().lower()
            v = v.strip()
            if k == "cpu":
                resource.cpu = float(v)
            elif k == "memory":
                resource.memory = int(v.lower().replace("mi", ""))
            elif k in ("tpu", "gpu"):
                resource.tpu_chips = int(v)
        return resource


@dataclass
class NodeGroupResource:
    """Resource of a node group (e.g. all workers)."""

    count: int = 0
    node_resource: NodeResource = field(default_factory=NodeResource)

    def update(self, count: int = 0, cpu: float = 0, memory: int = 0):
        if count > 0:
            self.count = count
        if cpu > 0:
            self.node_resource.cpu = cpu
        if memory > 0:
            self.node_resource.memory = memory

    @classmethod
    def new_empty(cls) -> "NodeGroupResource":
        return cls(0, NodeResource())


class Node:
    """One schedulable node (pod / VM / local process-group) of the job."""

    def __init__(
        self,
        node_type: str,
        node_id: int,
        config_resource: NodeResource | None = None,
        name: str | None = None,
        status: str = NodeStatus.INITIAL,
        rank_index: int | None = None,
        relaunch_count: int = 0,
        critical: bool = False,
        max_relaunch_count: int = 3,
        relaunchable: bool = True,
        service_addr: str | None = None,
        host_name: str | None = None,
        host_ip: str | None = None,
    ):
        self.type = node_type
        self.id = node_id
        self.name = name
        self.status = status
        self.rank_index = rank_index if rank_index is not None else node_id
        self.relaunch_count = relaunch_count
        self.critical = critical
        self.max_relaunch_count = max_relaunch_count
        self.relaunchable = relaunchable
        self.service_addr = service_addr
        self.host_name = host_name
        self.host_ip = host_ip

        self.config_resource = config_resource or NodeResource()
        self.used_resource = NodeResource()
        self.create_time: float | None = None
        self.start_time: float | None = None
        self.finish_time: float | None = None
        self.exit_reason: str | None = None
        self.is_released = False
        self.relaunch_policy = None
        self.start_hang_time: float = 0.0
        self.hang = False
        self.paral_config = None
        self.restart_training = False
        self.migrated = False
        self.unrecoverable_failure_msg = ""
        self.heartbeat_time: float = 0.0
        self.init_time: float = time.time()
        self.is_recovered_oom = False
        self.group = None

    def inc_relaunch_count(self):
        self.relaunch_count += 1

    def update_info(
        self,
        name=None,
        start_time=None,
        create_time=None,
        host_name=None,
        host_ip=None,
        restart_training=False,
        relaunch_count=0,
    ):
        if name is not None:
            self.name = name
        if start_time is not None:
            self.start_time = start_time
        if create_time is not None:
            self.create_time = create_time
        if host_name:
            self.host_name = host_name
        if host_ip:
            self.host_ip = host_ip
        self.relaunch_count = max(self.relaunch_count, relaunch_count)
        self.restart_training = restart_training

    def update_status(self, status: str | None = None):
        if status is not None:
            self.status = status

    def update_resource_usage(self, cpu: float, memory: int, tpu_stats=None):
        self.used_resource.cpu = round(cpu, 2)
        self.used_resource.memory = memory

    def update_service_address(self, service_addr: str):
        self.service_addr = service_addr

    def get_relaunch_node_info(self, new_id: int) -> "Node":
        new_node = Node(
            self.type,
            new_id,
            config_resource=self.config_resource,
            status=NodeStatus.INITIAL,
            rank_index=self.rank_index,
            relaunch_count=self.relaunch_count + 1,
            critical=self.critical,
            max_relaunch_count=self.max_relaunch_count,
            relaunchable=self.relaunchable,
        )
        return new_node

    def is_unrecoverable_failure(self) -> bool:
        if self.relaunch_count >= self.max_relaunch_count:
            self.unrecoverable_failure_msg = (
                f"exhausted {self.max_relaunch_count} relaunch attempts"
            )
            return True
        if self.exit_reason == NodeExitReason.FATAL_ERROR:
            self.unrecoverable_failure_msg = "fatal error in training"
            return True
        if (
            self.exit_reason == NodeExitReason.OOM
            and self.config_resource.memory >= NodeResourceLimit.MAX_MEMORY
        ):
            self.unrecoverable_failure_msg = (
                f"OOM at memory limit {NodeResourceLimit.MAX_MEMORY}Mi"
            )
            return True
        return False

    def set_exit_reason(self, reason: str):
        self.exit_reason = reason

    def update_priority(self, group_node_num: int):
        """high-priority fraction scheduling: ``0.5`` means the first half
        of ranks get high priority (reference node.py behavior)."""
        priority = self.config_resource.priority
        if priority in (PriorityClass.LOW, PriorityClass.HIGH, ""):
            return
        try:
            fraction = float(priority)
        except ValueError:
            return
        high_count = int(group_node_num * fraction)
        self.config_resource.priority = (
            PriorityClass.HIGH
            if self.rank_index < high_count
            else PriorityClass.LOW
        )

    def timeout(self, timeout_sec: float) -> bool:
        now = time.time()
        if (
            self.heartbeat_time > 0
            and now - self.heartbeat_time > timeout_sec
            and self.status == NodeStatus.RUNNING
        ):
            return True
        return False

    def __repr__(self):
        return (
            f"Node(type={self.type}, id={self.id}, rank={self.rank_index}, "
            f"status={self.status})"
        )

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d.pop("config_resource", None)
        d.pop("used_resource", None)
        return d


class NodeResourceLimit:
    MAX_CPU = 256
    MAX_MEMORY = 1024 * 1024  # MiB
    MIN_VALID_MEMORY = 1024
    MIN_VALID_CPU = 1
