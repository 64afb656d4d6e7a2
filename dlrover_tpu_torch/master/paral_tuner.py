"""Master-side parallel-config auto-tuning.

Equivalent capability: the producer half of the reference's auto-tuning
loop — the master generates `ParallelConfig` updates that the agent's
ParalConfigTuner (elastic_agent/config/paral_config_tuner.py:30)
delivers and the trainer hot-applies (ElasticDataLoader batch size,
optimizer lr). The reference computes these in the master/brain from
runtime stats; same here:

- memory-driven batch-size tuning: plenty of host headroom and stable
  throughput -> double the dataloader batch (up to ``max_batch_size``);
  an OOM event -> halve it;
- each change bumps the config version so stale files are ignored.

The PyTorch port's copy of dlrover_tpu/master/paral_tuner.py.
"""

from __future__ import annotations

import threading

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.constants import NodeExitReason, NodeType
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


class ParalConfigGenerator:
    def __init__(
        self,
        job_manager,
        speed_monitor=None,
        task_manager=None,
        initial_batch_size: int = 0,
        max_batch_size: int = 4096,
        memory_headroom: float = 0.5,
        interval: float = 60.0,
    ):
        self._job_manager = job_manager
        self._speed_monitor = speed_monitor
        self._task_manager = task_manager
        self._batch_size = int(initial_batch_size)
        self._max_batch_size = int(max_batch_size)
        self._headroom = memory_headroom
        self._interval = interval
        self._version = 0
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_speed = 0.0
        self._oom_seen: set = set()

    # ------------------------------------------------------------ policy

    def _observe(self) -> tuple[float, float, bool]:
        """(speed, max memory fraction used, new_oom)."""
        speed = (
            self._speed_monitor.running_speed
            if self._speed_monitor is not None else 0.0
        )
        frac = 0.0
        new_oom = False
        for node in self._job_manager.get_job_nodes(
            NodeType.WORKER
        ).values():
            limit = node.config_resource.memory or 0
            used = node.used_resource.memory or 0
            if limit > 0:
                frac = max(frac, used / limit)
            key = (node.type, node.id)
            if node.exit_reason == NodeExitReason.OOM and \
                    key not in self._oom_seen:
                self._oom_seen.add(key)
                new_oom = True
        return speed, frac, new_oom

    def tune_once(self) -> bool:
        """One observe->decide->publish cycle. True if a new config was
        pushed to the nodes."""
        if self._batch_size <= 0:
            # adopt the batch size workers registered with their dataset
            self._batch_size = self._registered_batch_size()
            if self._batch_size <= 0:
                return False
        speed, mem_frac, new_oom = self._observe()
        new_bs = self._batch_size
        if new_oom:
            new_bs = max(1, self._batch_size // 2)
            logger.warning(
                "OOM observed: halving dataloader batch to %d", new_bs
            )
        elif (
            mem_frac > 0
            and mem_frac < (1 - self._headroom)
            and speed >= self._last_speed * 0.95
            and self._batch_size * 2 <= self._max_batch_size
        ):
            new_bs = self._batch_size * 2
            logger.info(
                "memory %.0f%% used, throughput stable: raising "
                "dataloader batch to %d", mem_frac * 100, new_bs,
            )
        self._last_speed = max(self._last_speed, speed)
        if new_bs == self._batch_size:
            return False
        self._batch_size = new_bs
        self._version += 1
        self._job_manager.update_all_paral_configs(msg.ParallelConfig(
            dataloader=msg.DataLoaderConfig(
                batch_size=new_bs, version=self._version
            )
        ))
        return True

    def _registered_batch_size(self) -> int:
        if self._task_manager is None:
            return 0
        return self._task_manager.first_dataset_batch_size()

    def set_initial_batch_size(self, batch_size: int):
        if self._batch_size <= 0 and batch_size > 0:
            self._batch_size = int(batch_size)

    # ---------------------------------------------------------- lifecycle

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="paral-config-generator", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.is_set():
            try:
                self.tune_once()
            except Exception:  # noqa: BLE001
                logger.exception("paral-config generation failed")
            self._stopped.wait(self._interval)
