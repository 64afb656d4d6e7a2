"""TaskManager: per-dataset task dispatch + worker failure recovery.

Equivalent capability: reference dlrover/python/master/shard/
task_manager.py:37 (assign/recover shards, doing/done bookkeeping,
timeout -> reassign loop, speed-monitor hookup).

The PyTorch port's copy of dlrover_tpu/master/shard/task_manager.py.
"""

from __future__ import annotations

import threading
import time

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.monitor import SpeedMonitor
from dlrover_tpu_torch.master.shard.dataset_manager import (
    BatchDatasetManager,
    StreamingDatasetManager,
    Task,
)
from dlrover_tpu_torch.master.shard.dataset_splitter import new_dataset_splitter

logger = get_logger(__name__)


class TaskManager:
    def __init__(self, worker_restart_timeout: float = 0.0):
        self._lock = threading.Lock()
        self._datasets: dict[str, BatchDatasetManager] = {}
        # creation kwargs per dataset, so a restored master can rebuild
        # each manager before applying its shard-progress checkpoint
        self._dataset_params: dict[str, dict] = {}
        self._worker_restart_timeout = worker_restart_timeout
        self._speed_monitor = SpeedMonitor()
        self._task_timeout_callbacks: list = []
        self._stop = threading.Event()

    @property
    def speed_monitor(self) -> SpeedMonitor:
        return self._speed_monitor

    def new_dataset(
        self,
        batch_size: int,
        dataset_size: int,
        dataset_name: str,
        dataset_splitter=None,
        task_type: str = "training",
        num_epochs: int = 1,
        shuffle: bool = False,
        num_minibatches_per_shard: int = 2,
        storage_type: str = "",
        dataset_type: str = "table",
    ):
        with self._lock:
            if dataset_name in self._datasets:
                logger.info("dataset %s already registered", dataset_name)
                return
            if dataset_splitter is None:
                self._dataset_params[dataset_name] = {
                    "batch_size": batch_size,
                    "dataset_size": dataset_size,
                    "dataset_name": dataset_name,
                    "task_type": task_type,
                    "num_epochs": num_epochs,
                    "shuffle": shuffle,
                    "num_minibatches_per_shard": (
                        num_minibatches_per_shard
                    ),
                    "storage_type": storage_type,
                    "dataset_type": dataset_type,
                }
            if dataset_type == "streaming":
                self._datasets[dataset_name] = StreamingDatasetManager(
                    task_type,
                    batch_size,
                    shard_size=batch_size * num_minibatches_per_shard,
                    dataset_name=dataset_name,
                )
                logger.info(
                    "new streaming dataset %s: batch=%d", dataset_name,
                    batch_size,
                )
                return
            if dataset_splitter is None:
                shard_size = max(
                    batch_size * num_minibatches_per_shard, 1
                )
                dataset_splitter = new_dataset_splitter(
                    shuffle,
                    shard_size,
                    dataset_size,
                    num_epochs,
                    dataset_name,
                    storage_type,
                    dataset_type,
                )
            self._datasets[dataset_name] = BatchDatasetManager(
                task_type, batch_size, dataset_splitter
            )
            logger.info(
                "new dataset %s: size=%d batch=%d epochs=%d",
                dataset_name,
                dataset_size,
                batch_size,
                num_epochs,
            )

    def get_dataset(self, name: str) -> BatchDatasetManager | None:
        return self._datasets.get(name)

    def feed_streaming_dataset(self, dataset_name: str, count: int,
                               end: bool = False) -> bool:
        """Producer-side feed for streaming datasets. Holds the manager
        lock: feeds and get_task run on different RPC handler threads."""
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if not isinstance(ds, StreamingDatasetManager):
                return False
            ok = True
            if count:
                ok = ds.add_records(count)
            if end:
                ds.end_stream()
            return ok

    def first_dataset_batch_size(self) -> int:
        """Batch size workers registered (0 when no dataset yet) — the
        auto-tuner's starting point."""
        for ds in self._datasets.values():
            bs = getattr(ds, "_batch_size", 0)
            if bs:
                return int(bs)
        return 0

    def get_dataset_task(self, node_type, node_id, dataset_name) -> Task:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return Task.create_invalid_task()
            return ds.get_task(node_type, node_id)

    def report_dataset_task(self, dataset_name, task_id, success) -> bool:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return False
            ok, _ = ds.report_task_status(task_id, success)
            return ok

    def recover_tasks(self, node_type: str, node_id: int):
        with self._lock:
            for ds in self._datasets.values():
                ds.recover_tasks_of_node(node_type, node_id)

    def finished(self) -> bool:
        with self._lock:
            if not self._datasets:
                return False
            return all(ds.completed() for ds in self._datasets.values())

    def training_started(self) -> bool:
        return bool(self._datasets)

    def get_dataset_checkpoint(self, dataset_name: str) -> str:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            return ds.checkpoint() if ds else ""

    def restore_dataset_from_checkpoint(self, content: str) -> bool:
        import json

        try:
            dataset_name = json.loads(content).get("dataset_name", "")
            with self._lock:
                ds = self._datasets.get(dataset_name)
                if ds is None:
                    return False
                ds.restore_checkpoint(content)
                return True
        except Exception as e:  # noqa: BLE001
            logger.warning("restore dataset ckpt failed: %s", e)
            return False

    # -- failover durability (master state store) --------------------------

    def export_state(self) -> dict:
        """Per-dataset creation params + shard-progress checkpoint.
        Datasets registered with a caller-provided splitter (tests,
        embedded use) carry no params and are skipped — they cannot be
        rebuilt from persisted state."""
        with self._lock:
            out = {}
            for name, ds in self._datasets.items():
                params = self._dataset_params.get(name)
                if params is None:
                    logger.warning(
                        "dataset %s has a custom splitter; not "
                        "persisted for failover", name,
                    )
                    continue
                out[name] = {
                    "params": dict(params),
                    "state": ds.checkpoint(),
                }
            return out

    def restore_state(self, datasets: dict):
        for name, entry in datasets.items():
            self.new_dataset(**entry["params"])
            with self._lock:
                ds = self._datasets.get(name)
            if ds is not None and entry.get("state"):
                ds.restore_checkpoint(entry["state"])
                logger.info(
                    "restored dataset %s: todo=%d completed_step=%d",
                    name, len(ds.todo), ds.completed_step,
                )

    def replay_dispatch(
        self, dataset_name: str, task_id: int, start: int, end: int,
        indices, node_type: str = "", node_id: int = -1,
        allow_create: bool = False,
    ):
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is not None:
                ds.replay_dispatch(
                    task_id, start, end, indices, node_type, node_id,
                    allow_create=allow_create,
                )

    def replay_result(self, dataset_name: str, task_id: int,
                      success: bool):
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is not None:
                ds.replay_result(task_id, success)

    def replay_stream(self, dataset_name: str, reported: int,
                      ended: bool):
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if isinstance(ds, StreamingDatasetManager):
                ds.replay_stream(reported, ended)

    def start(self):
        t = threading.Thread(
            target=self._check_doing_task_loop,
            name="task-timeout-monitor",
            daemon=True,
        )
        t.start()

    def stop(self):
        self._stop.set()

    def _check_doing_task_loop(self):
        while not self._stop.is_set():
            with self._lock:
                for ds in self._datasets.values():
                    ds.reset_doing_tasks_timeout()
            time.sleep(30)
