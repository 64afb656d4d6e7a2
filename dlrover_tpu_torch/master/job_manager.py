"""Job managers: node lifecycle orchestration inside the master.

Equivalent capability: reference dlrover/python/master/node/
dist_job_manager.py (DistributedJobManager :88 — monitor loop :334,
heartbeat monitor :355, event processing :473, relaunch decision :561,
relaunch :605) and local_job_manager.py (LocalJobManager :31).

The PyTorch port's copy of dlrover_tpu/master/job_manager.py.
"""

from __future__ import annotations

import threading
import time

from dlrover_tpu_torch.common.constants import (
    JobConstant,
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.node import Node, NodeGroupResource, NodeResource

logger = get_logger(__name__)


class NodeEvent:
    def __init__(self, event_type: str, node: Node):
        self.event_type = event_type
        self.node = node


class JobManager:
    """Interface shared by local and distributed managers."""

    def __init__(self, job_args=None, speed_monitor=None):
        self._job_args = job_args
        self._speed_monitor = speed_monitor
        self._stopped = threading.Event()
        self._lock = threading.Lock()
        # Called with the dead Node so rendezvous managers drop it from
        # waiting and the task manager requeues its in-flight shards.
        self._node_exit_callbacks: list = []
        # node_type -> {node_id: Node}
        self._job_nodes: dict[str, dict[int, Node]] = {}
        self._relaunch_on_worker_failure = (
            getattr(job_args, "relaunch_on_worker_failure", 3)
            if job_args
            else 3
        )
        self._node_heartbeat_timeout = JobConstant.NODE_HEARTBEAT_TIMEOUT

    # -- queries -----------------------------------------------------------

    def get_job_nodes(self, node_type: str | None = None):
        with self._lock:
            if node_type is None:
                return {
                    t: dict(nodes) for t, nodes in self._job_nodes.items()
                }
            return dict(self._job_nodes.get(node_type, {}))

    def get_node(self, node_type: str, node_id: int) -> Node | None:
        with self._lock:
            return self._job_nodes.get(node_type, {}).get(node_id)

    def get_node_by_name(self, name: str) -> Node | None:
        with self._lock:
            for nodes in self._job_nodes.values():
                for node in nodes.values():
                    if node.name == name:
                        return node
        return None

    def is_permanently_failed(self, node: Node) -> bool:
        """True when a failed node must NOT come back in any form (the
        public face of the relaunch policy, for the auto-scaler)."""
        return node.status == NodeStatus.FAILED and \
            not self._should_relaunch(node)

    def _should_relaunch(self, node: Node) -> bool:
        """Reference _should_relaunch (dist_job_manager.py:561): relaunch
        unless the failure is unrecoverable, the node opted out, or the
        exit was a clean success."""
        if node.status == NodeStatus.SUCCEEDED:
            return False
        if not node.relaunchable:
            return False
        if node.exit_reason == NodeExitReason.FATAL_ERROR:
            return False
        if node.is_unrecoverable_failure():
            return False
        return True

    def all_workers_exited(self) -> bool:
        with self._lock:
            workers = list(self._job_nodes.get(NodeType.WORKER, {}).values())
            if not workers:
                return False
            return all(
                n.status in NodeStatus.end_states() or n.is_released
                for n in workers
            )

    def all_workers_failed(self) -> bool:
        with self._lock:
            workers = list(self._job_nodes.get(NodeType.WORKER, {}).values())
            if not workers:
                return False
            return all(n.status == NodeStatus.FAILED for n in workers)

    def all_running_node_hanged(self) -> bool:
        if self._speed_monitor is None:
            return False
        return self._speed_monitor.all_worker_hanged()

    # -- mutations from the servicer --------------------------------------

    def update_node_heartbeat(self, node_type, node_id, timestamp) -> str:
        """Returns an action for the agent: '' | 'restart' | 'stop'."""
        node = self.get_node(node_type, node_id)
        if node is None:
            node = self._add_node(node_type, node_id)
        node.heartbeat_time = timestamp
        if node.status in (NodeStatus.INITIAL, NodeStatus.PENDING):
            node.update_status(NodeStatus.RUNNING)
            if self._speed_monitor is not None:
                self._speed_monitor.add_running_worker(node_type, node_id)
        return ""

    def update_node_paral_config(self, node_type, node_id, paral_config):
        """Set the ParallelConfig served to a node (auto-tuning output)."""
        node = self.get_node(node_type, node_id)
        if node is None:
            node = self._add_node(node_type, node_id)
        node.paral_config = paral_config

    def update_all_paral_configs(self, paral_config):
        for nodes in self.get_job_nodes().values():
            for node in nodes.values():
                node.paral_config = paral_config

    def update_node_resource_usage(
        self, node_type, node_id, cpu, memory, tpu_stats=None
    ):
        node = self.get_node(node_type, node_id)
        if node is not None:
            node.update_resource_usage(cpu, memory, tpu_stats)

    def handle_node_failure(
        self, node_type, node_id, error_data: str, level: str, restart_count=0
    ):
        node = self.get_node(node_type, node_id)
        if node is None:
            return
        node.relaunch_count = max(node.relaunch_count, restart_count)
        logger.warning(
            "node %s-%s reported failure (level=%s): %s",
            node_type,
            node_id,
            level,
            error_data[:500],
        )

    def _add_node(self, node_type: str, node_id: int) -> Node:
        with self._lock:
            node = Node(
                node_type,
                node_id,
                max_relaunch_count=self._relaunch_on_worker_failure,
            )
            self._job_nodes.setdefault(node_type, {})[node_id] = node
            return node

    def add_node_exit_callback(self, callback):
        self._node_exit_callbacks.append(callback)

    def _run_node_exit_callbacks(self, node: Node):
        for cb in self._node_exit_callbacks:
            try:
                cb(node)
            except Exception:  # noqa: BLE001
                logger.exception("node exit callback failed")

    def start(self):
        ...

    def stop(self):
        self._stopped.set()


class LocalJobManager(JobManager):
    """Manages the nodes of a single-host job: only bookkeeping, no
    scheduling (reference local_job_manager.py:31)."""

    def __init__(self, job_args=None, speed_monitor=None):
        super().__init__(job_args, speed_monitor)

    def start(self):
        node = Node(NodeType.WORKER, 0, NodeResource())
        node.update_status(NodeStatus.RUNNING)
        with self._lock:
            self._job_nodes = {NodeType.WORKER: {0: node}}

    def handle_training_failure(
        self, node_type, node_id, restart_count=-1, error_data="", level=""
    ):
        self.handle_node_failure(
            node_type, node_id, error_data, level, restart_count
        )


class DistributedJobManager(JobManager):
    """Multi-node manager: watches platform node events, runs heartbeat
    timeout detection, decides/executes relaunches via a Scaler."""

    def __init__(
        self,
        job_args=None,
        speed_monitor=None,
        scaler=None,
        watcher=None,
    ):
        super().__init__(job_args, speed_monitor)
        self._scaler = scaler
        self._watcher = watcher
        self._next_node_id: dict[str, int] = {}
        self._threads: list[threading.Thread] = []
        group = getattr(job_args, "node_num", 1) if job_args else 1
        res = NodeGroupResource(group, NodeResource())
        self._group_resources = {NodeType.WORKER: res}

    def start(self):
        with self._lock:
            workers = {}
            count = self._group_resources[NodeType.WORKER].count
            for i in range(count):
                workers[i] = Node(
                    NodeType.WORKER,
                    i,
                    max_relaunch_count=self._relaunch_on_worker_failure,
                )
            self._job_nodes = {NodeType.WORKER: workers}
            self._next_node_id[NodeType.WORKER] = count
        if self._scaler is not None:
            self._scaler.scale(self.get_job_nodes(NodeType.WORKER))
        for target, name in (
            (self._monitor_nodes, "node-monitor"),
            (self._monitor_node_heartbeat, "heartbeat-monitor"),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    # -- monitor loops -----------------------------------------------------

    def _monitor_nodes(self):
        while not self._stopped.is_set():
            if self._watcher is None:
                time.sleep(5)
                continue
            try:
                for event in self._watcher.watch(timeout=30):
                    self._process_event(event)
            except Exception as e:  # noqa: BLE001
                logger.warning("node watcher error: %s", e)
                time.sleep(5)

    def _monitor_node_heartbeat(self):
        while not self._stopped.is_set():
            try:
                events = self._get_dead_node_events()
                for event in events:
                    self._process_event(event)
            except Exception:  # noqa: BLE001
                logger.exception("heartbeat monitor error")
            time.sleep(JobConstant.MONITOR_INTERVAL)

    def _get_dead_node_events(self) -> list[NodeEvent]:
        events = []
        for node in self.get_job_nodes(NodeType.WORKER).values():
            if node.timeout(self._node_heartbeat_timeout):
                logger.warning(
                    "node %s heartbeat timed out (last %.0fs ago)",
                    node.id,
                    time.time() - node.heartbeat_time,
                )
                node.set_exit_reason(NodeExitReason.HARDWARE_ERROR)
                events.append(NodeEvent(NodeEventType.DELETED, node))
        return events

    # -- event processing --------------------------------------------------

    def _process_event(self, event: NodeEvent):
        node = self.get_node(event.node.type, event.node.id)
        if node is None:
            with self._lock:
                self._job_nodes.setdefault(event.node.type, {})[
                    event.node.id
                ] = event.node
            node = event.node
        if event.event_type == NodeEventType.DELETED:
            self._handle_node_exit(node)
        elif event.event_type == NodeEventType.MODIFIED:
            node.update_status(event.node.status)
            if node.status == NodeStatus.FAILED:
                self._handle_node_exit(node)

    def _handle_node_exit(self, node: Node):
        if node.is_released:
            return
        node.is_released = True
        node.finish_time = time.time()
        if node.status not in NodeStatus.end_states():
            node.update_status(
                NodeStatus.FAILED
                if node.exit_reason
                else NodeStatus.DELETED
            )
        if self._speed_monitor is not None:
            self._speed_monitor.remove_running_worker(node.type, node.id)
            self._speed_monitor.reset_running_speed_monitor()
        self._run_node_exit_callbacks(node)
        if self._should_relaunch(node):
            self._relaunch_node(node)
        else:
            logger.warning(
                "node %s-%s will NOT be relaunched (%s)",
                node.type,
                node.id,
                node.unrecoverable_failure_msg or node.exit_reason,
            )

    def _relaunch_node(self, node: Node):
        with self._lock:
            new_id = self._next_node_id.get(node.type, 0)
            self._next_node_id[node.type] = new_id + 1
        new_node = node.get_relaunch_node_info(new_id)
        with self._lock:
            self._job_nodes.setdefault(node.type, {})[new_id] = new_node
        logger.info(
            "relaunch node %s-%s as id %s (attempt %s/%s)",
            node.type,
            node.id,
            new_id,
            new_node.relaunch_count,
            new_node.max_relaunch_count,
        )
        if self._scaler is not None:
            self._scaler.relaunch(node, new_node)

    def handle_training_failure(
        self, node_type, node_id, restart_count=-1, error_data="", level=""
    ):
        self.handle_node_failure(
            node_type, node_id, error_data, level, restart_count
        )

    # -- scaling API (used by JobAutoScaler) -------------------------------

    def create_new_workers(self, count: int, resource=None) -> list[Node]:
        """Add ``count`` fresh worker nodes (scale-out)."""
        new_nodes = []
        with self._lock:
            for _ in range(count):
                new_id = self._next_node_id.get(NodeType.WORKER, 0)
                self._next_node_id[NodeType.WORKER] = new_id + 1
                node = Node(
                    NodeType.WORKER,
                    new_id,
                    config_resource=resource,
                    max_relaunch_count=self._relaunch_on_worker_failure,
                )
                self._job_nodes.setdefault(NodeType.WORKER, {})[
                    new_id
                ] = node
                new_nodes.append(node)
        if new_nodes:
            logger.info(
                "scale-out: created worker node(s) %s",
                [n.id for n in new_nodes],
            )
        return new_nodes

    def release_node(self, node_type: str, node_id: int):
        """Mark a node released (scale-in); the scaler deletes its pod."""
        node = self.get_node(node_type, node_id)
        if node is None or node.is_released:
            return
        node.relaunchable = False
        node.is_released = True
        node.update_status(NodeStatus.DELETED)
        if self._speed_monitor is not None:
            self._speed_monitor.remove_running_worker(node_type, node_id)
        # same exit path as a watcher DELETED event: drop from rendezvous,
        # requeue its in-flight shards
        self._run_node_exit_callbacks(node)
        if self._scaler is not None and hasattr(self._scaler, "remove_node"):
            self._scaler.remove_node(node)
        logger.info("scale-in: released node %s-%s", node_type, node_id)

    def stop(self):
        super().stop()
        if self._scaler is not None:
            self._scaler.stop()
