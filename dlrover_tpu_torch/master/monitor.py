"""SpeedMonitor: global-step throughput tracking + straggler/hang signals.

Equivalent capability: reference dlrover/python/master/monitor/
speed_monitor.py:43.

The PyTorch port's copy of dlrover_tpu/master/monitor.py.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from dlrover_tpu_torch.common.context import Context

_ctx = Context.singleton_instance()


class SpeedMonitor:
    def __init__(self):
        self._lock = threading.Lock()
        # deque of (timestamp, global_step)
        self._global_step_records: deque = deque(
            maxlen=_ctx.train_speed_record_num
        )
        self._global_step = 0
        self._init_time = time.time()
        self._start_training_time: float = 0.0
        self._sample_count = 0
        # (node_type, node_id) currently expected to report steps
        self._running_workers: set = set()
        self._waiting_restart_workers: set = set()
        self._max_speed = 0.0
        # (node_type, node_id) -> (timestamp, step): per-NODE progress,
        # so the diagnosis layer can blame the specific stalled host
        # instead of only answering the job-level "is anyone moving"
        self._node_steps: dict = {}

    @property
    def running_workers(self):
        return self._running_workers

    @property
    def completed_global_step(self) -> int:
        return self._global_step

    @property
    def init_training_time(self) -> float:
        if self._start_training_time == 0:
            return 0
        return self._start_training_time - self._init_time

    def set_target_worker_num(self, num: int):
        self._target_worker_num = num

    def add_running_worker(self, node_type: str, node_id: int):
        with self._lock:
            self._running_workers.add((node_type, node_id))

    def remove_running_worker(self, node_type: str, node_id: int):
        with self._lock:
            self._running_workers.discard((node_type, node_id))

    def collect_global_step(
        self, step: int, timestamp: float | None = None, node=None,
    ):
        timestamp = timestamp or time.time()
        with self._lock:
            if self._start_training_time == 0:
                self._start_training_time = timestamp
            if node is not None:
                prev = self._node_steps.get(node)
                if prev is None or timestamp >= prev[0]:
                    self._node_steps[node] = (timestamp, step)
            if step >= self._global_step:
                self._global_step = step
                self._global_step_records.append((timestamp, step))
                self._sample_count += 1
        speed = self.running_speed
        if speed > self._max_speed:
            self._max_speed = speed

    def node_progress(self) -> dict:
        """(node_type, node_id) -> (last_report_time, last_step) for
        every node that ever reported a step."""
        with self._lock:
            return dict(self._node_steps)

    def stalled_nodes(self, window: float, now: float | None = None) -> list:
        """Nodes whose last step report is older than ``window`` while
        at least one other node kept progressing — the per-node
        complement of :meth:`all_worker_hanged`. ``now`` lets a caller
        evaluate every staleness check against one clock reading."""
        now = time.time() if now is None else now
        with self._lock:
            if len(self._node_steps) < 2:
                return []
            fresh = [
                t for t, _ in self._node_steps.values()
                if now - t <= window
            ]
            if not fresh:
                return []  # everyone stalled: job-level, not per-node
            return sorted(
                node for node, (t, _) in self._node_steps.items()
                if now - t > window
            )

    @property
    def running_speed(self) -> float:
        """Steps/sec over the recorded window."""
        with self._lock:
            if len(self._global_step_records) < 2:
                return 0.0
            t0, s0 = self._global_step_records[0]
            t1, s1 = self._global_step_records[-1]
            if t1 <= t0:
                return 0.0
            return (s1 - s0) / (t1 - t0)

    def worker_adjustment_finished(self) -> bool:
        return self._sample_count >= _ctx.sample_count_to_adjust_worker

    def all_worker_hanged(self) -> bool:
        """No step progress within the hang-detection window while workers
        are running (reference all_running_node_hanged analogue)."""
        with self._lock:
            if not self._running_workers:
                return False
            if not self._global_step_records:
                # The job may simply not use step reporting — absence of
                # records is not evidence of a hang.
                return False
            last_t, _ = self._global_step_records[-1]
            return time.time() - last_t > _ctx.hang_detection_time_window

    def reset_running_speed_monitor(self):
        with self._lock:
            self._global_step_records.clear()
            self._sample_count = 0
            # membership changed: stale per-node stamps from departed
            # workers must not read as hangs in the new round
            self._node_steps.clear()
