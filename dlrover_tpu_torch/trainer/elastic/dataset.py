"""ElasticDataset: master-shard-driven dataset with mid-epoch resume.

Equivalent capability: reference atorch/atorch/data/elastic_dataset.py:19 —
a dataset whose sample order is dictated by the job master's shard service
(TaskManager) via the worker's :class:`IndexShardingClient`, giving elastic
re-sharding on scale events and exactly-once shard recovery on failure.

The PyTorch port's copy of dlrover_tpu/trainer/elastic/dataset.py.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from dlrover_tpu_torch.agent.sharding_client import IndexShardingClient


class ElasticDataset(ABC):
    """Subclass and implement :meth:`read_sample`.

    Iteration order comes from the master: each ``__getitem__`` call pulls
    the next global sample index from the sharding client's index queue.
    ``report_batch_done`` acknowledges consumed shards so the master can
    checkpoint dataset progress (and re-assign shards of failed workers).
    """

    def __init__(
        self,
        name: str,
        dataset_size: int,
        batch_size: int,
        epochs: int = 1,
        shuffle: bool = False,
        num_minibatches_per_shard: int = 2,
        client: IndexShardingClient | None = None,
    ):
        self._name = name
        self._dataset_size = int(dataset_size)
        self._client = client or IndexShardingClient(
            dataset_name=name,
            batch_size=batch_size,
            num_epochs=epochs,
            dataset_size=dataset_size,
            shuffle=shuffle,
            num_minibatches_per_shard=num_minibatches_per_shard,
        )

    def __len__(self):
        return self._dataset_size

    def __getitem__(self, _):
        index = self._client.fetch_sample_index()
        if index is None:
            # IndexError (not StopIteration, which PEP 479 would turn into a
            # RuntimeError inside generator-based loaders) signals end of the
            # master's shard stream.
            raise IndexError("end of master-served dataset")
        return self.read_sample(index)

    def report_batch_done(self, task_ids=None):
        """Ack the oldest pending shard task (call once per consumed
        batch), or the specific ``task_ids``."""
        self._client.report_batch_done(task_ids)

    def report_all_shards_done(self):
        """Ack every pending shard (end-of-epoch drain, so the master's
        task accounting reaches 'finished')."""
        self._client.report_all_pending_done()

    def get_shard_checkpoint(self) -> str:
        return self._client.get_shard_checkpoint()

    def restore_shard_from_checkpoint(self, content: str) -> bool:
        return self._client.restore_shard_from_checkpoint(content)

    @abstractmethod
    def read_sample(self, index: int):
        """Read one sample by global index (user-provided IO)."""
