"""Worker-side data-shard consumption client.

Equivalent capability: reference dlrover/python/elastic_agent/sharding/
client.py — ShardingClient (:29) fetch/report loop with shard checkpoint
get/restore (:199-226) and IndexShardingClient (:231, per-sample index
queue).

The PyTorch port's copy of dlrover_tpu/agent/sharding_client.py.
"""

from __future__ import annotations

import queue
import threading
import time

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import tracing
from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


class ShardingClient:
    """Fetches shard tasks from the master and reports completions."""

    def __init__(
        self,
        dataset_name: str,
        batch_size: int,
        num_epochs: int,
        dataset_size: int,
        shuffle: bool = False,
        task_type: str = "training",
        num_minibatches_per_shard: int = 2,
        storage_type: str = "",
        dataset_type: str = "table",
        master_client: MasterClient | None = None,
    ):
        self._client = master_client or MasterClient.singleton_instance()
        if self._client is None:
            raise RuntimeError(
                "no master client (DLROVER_MASTER_ADDR unset)"
            )
        self.dataset_name = dataset_name
        self._batch_size = batch_size
        self._lock = threading.Lock()
        self._current_task = None
        self._pending_tasks: list = []
        self._client.report_dataset_shard_params(
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

    def fetch_shard(self, wait_interval: float = 1.0):
        """Returns the next Shard or None when the dataset is finished.

        Streaming datasets return WAIT tasks while momentarily dry; the
        client blocks (polling) until data arrives or the stream ends.
        """
        # fetch span roots the shard's trace: the master-side dispatch
        # span nests under it, and report_batch_done joins the same
        # trace via the task_id label
        with tracing.span("shard.fetch", dataset=self.dataset_name):
            while True:
                task = self._client.get_task(self.dataset_name)
                if task is not None and task.task_type == TaskType.WAIT:
                    time.sleep(wait_interval)
                    continue
                break
        if task is None or task.task_id < 0:
            return None
        with self._lock:
            self._current_task = task
            self._pending_tasks.append(task)
        return task.shard

    def report_batch_done(self, task_ids=None):
        """Report completion of the oldest pending task(s)."""
        with self._lock:
            if task_ids is None:
                if not self._pending_tasks:
                    return
                tasks = [self._pending_tasks.pop(0)]
            else:
                tasks = [
                    t
                    for t in self._pending_tasks
                    if t.task_id in task_ids
                ]
                self._pending_tasks = [
                    t
                    for t in self._pending_tasks
                    if t.task_id not in task_ids
                ]
        for t in tasks:
            with tracing.span("shard.report", task_id=t.task_id):
                self._client.report_task_result(
                    self.dataset_name, t.task_id
                )

    def report_all_pending_done(self):
        """Ack every pending shard task (end-of-epoch drain)."""
        with self._lock:
            tasks, self._pending_tasks = self._pending_tasks, []
        for t in tasks:
            self._client.report_task_result(self.dataset_name, t.task_id)

    def report_task_failed(self, task_id: int, err: str):
        self._client.report_task_result(self.dataset_name, task_id, err)

    # ---- mid-epoch checkpoint (sampler state across restarts) ------------

    def get_shard_checkpoint(self) -> str:
        return self._client.get_shard_checkpoint(self.dataset_name)

    def restore_shard_from_checkpoint(self, content: str) -> bool:
        return self._client.report_shard_checkpoint(content)


class IndexShardingClient(ShardingClient):
    """Hands out per-sample indices instead of whole shards (reference
    IndexShardingClient :231)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._sample_queue: queue.Queue = queue.Queue()

    def fetch_sample_index(self):
        """Next global sample index, or None at end of data."""
        if self._sample_queue.empty():
            shard = self.fetch_shard()
            if shard is None:
                return None
            indices = shard.record_indices or range(shard.start, shard.end)
            for i in indices:
                self._sample_queue.put(i)
        return self._sample_queue.get()

    def fetch_batch_indices(self, batch_size: int):
        indices = []
        for _ in range(batch_size):
            idx = self.fetch_sample_index()
            if idx is None:
                break
            indices.append(idx)
        return indices or None
