"""Job metrics collection + reporters.

Equivalent capability: reference dlrover/python/master/stats/ —
`JobMetricCollector` (job_collector.py:76) gathering dataset/runtime/
node metrics and handing them to a `LocalStatsReporter` (reporter.py:99,
in-master history) or `BrainReporter` (reporter.py:146, push to the
brain service — here dlrover_tpu_torch/brain/client.py).

The PyTorch port's copy of dlrover_tpu/master/stats.py.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


@dataclass
class RuntimeSample:
    timestamp: float = 0.0
    global_step: int = 0
    speed: float = 0.0
    worker_count: int = 0
    max_used_memory_mb: int = 0
    # per-node usage maps (node_id -> used), mirroring the reference
    # brain's JobRuntimeInfo — feed the windowed optimization
    # algorithms (brain/runtime_opt.py)
    worker_cpu: dict = field(default_factory=dict)
    worker_memory: dict = field(default_factory=dict)
    ps_cpu: dict = field(default_factory=dict)
    ps_memory: dict = field(default_factory=dict)


@dataclass
class JobMetrics:
    dataset_name: str = ""
    dataset_size: int = 0
    batch_size: int = 0
    runtime: list = field(default_factory=list)  # RuntimeSample history
    exit_reason: str = ""


class LocalStatsReporter:
    """In-master metrics history (reference LocalStatsReporter)."""

    MAX_SAMPLES = 2048

    def __init__(self):
        self._lock = threading.Lock()
        self.metrics = JobMetrics()

    def report_dataset(self, name: str, size: int, batch_size: int):
        with self._lock:
            self.metrics.dataset_name = name
            self.metrics.dataset_size = size
            self.metrics.batch_size = batch_size

    def report_runtime(self, sample: RuntimeSample):
        with self._lock:
            self.metrics.runtime.append(sample)
            if len(self.metrics.runtime) > self.MAX_SAMPLES:
                del self.metrics.runtime[: -self.MAX_SAMPLES]

    def report_exit(self, reason: str):
        with self._lock:
            self.metrics.exit_reason = reason

    def latest(self) -> RuntimeSample | None:
        with self._lock:
            return self.metrics.runtime[-1] if self.metrics.runtime \
                else None


class JobMetricCollector:
    """Collects master-side metrics on a cadence and fans them out to
    reporters (reference JobMetricCollector job_collector.py:76)."""

    def __init__(self, job_manager=None, speed_monitor=None,
                 reporters=None, interval: float = 30.0):
        self._job_manager = job_manager
        self._speed_monitor = speed_monitor
        # explicit [] means "no reporters" (one-shot sampling); only
        # None gets the default local history
        self.reporters = list(
            reporters if reporters is not None else [LocalStatsReporter()]
        )
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def local_reporter(self) -> LocalStatsReporter | None:
        for r in self.reporters:
            if isinstance(r, LocalStatsReporter):
                return r
        return None

    # --------------------------------------------------------- collection

    def collect_dataset_metric(self, params):
        for r in self.reporters:
            if hasattr(r, "report_dataset"):
                r.report_dataset(
                    getattr(params, "dataset_name", ""),
                    getattr(params, "dataset_size", 0),
                    getattr(params, "batch_size", 0),
                )

    def collect_runtime_once(self) -> RuntimeSample:
        from dlrover_tpu_torch.common.constants import NodeType

        sample = RuntimeSample(timestamp=time.time())
        if self._speed_monitor is not None:
            sample.speed = self._speed_monitor.running_speed
            sample.global_step = (
                self._speed_monitor.completed_global_step
            )
        if self._job_manager is not None:
            nodes = self._job_manager.get_job_nodes(NodeType.WORKER)
            alive = [n for n in nodes.values() if not n.is_released]
            sample.worker_count = len(alive)
            mems = [
                n.used_resource.memory for n in alive
                if n.used_resource.memory
            ]
            if mems:
                sample.max_used_memory_mb = int(max(mems))
            for n in alive:
                sample.worker_cpu[n.id] = n.used_resource.cpu
                sample.worker_memory[n.id] = n.used_resource.memory
            ps_nodes = self._job_manager.get_job_nodes(NodeType.PS)
            for n in ps_nodes.values():
                if n.is_released:
                    continue
                sample.ps_cpu[n.id] = n.used_resource.cpu
                sample.ps_memory[n.id] = n.used_resource.memory
        for r in self.reporters:
            if hasattr(r, "report_runtime"):
                r.report_runtime(sample)
        return sample

    def collect_job_exit(self, reason: str):
        for r in self.reporters:
            if hasattr(r, "report_exit"):
                r.report_exit(reason)

    # ---------------------------------------------------------- lifecycle

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="metric-collector", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.is_set():
            try:
                self.collect_runtime_once()
            except Exception:  # noqa: BLE001
                logger.exception("metric collection failed")
            self._stopped.wait(self._interval)
