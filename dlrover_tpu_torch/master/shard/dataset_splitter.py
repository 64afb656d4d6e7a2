"""Dataset splitters: produce shards of sample-index ranges.

Equivalent capability: reference dlrover/python/master/shard/
dataset_splitter.py (TableDatasetSplitter :144, TextDatasetSplitter :257).
A *shard* is a [start, end) range over the sample index space; workers
fetch shards as tasks and read only those records, so the master can
re-assign a failed worker's shard to a healthy one.

The PyTorch port's copy of dlrover_tpu/master/shard/dataset_splitter.py.
"""

from __future__ import annotations

import random
from abc import ABC, abstractmethod
from dataclasses import dataclass, field

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

_MAX_SHARD_COUNT = 50000


@dataclass
class Shard:
    name: str = ""
    start: int = 0
    end: int = 0
    record_indices: list = field(default_factory=list)


class DatasetSplitter(ABC):
    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int,
    ):
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = shard_size
        self.num_epochs = num_epochs
        self.epoch = 0

    @abstractmethod
    def create_shards(self):
        ...

    @abstractmethod
    def get_shards(self) -> list[Shard]:
        ...

    def epoch_finished(self) -> bool:
        return self.epoch >= self.num_epochs

    def get_epoch(self) -> int:
        return self.epoch


class TableDatasetSplitter(DatasetSplitter):
    """Split a table (row-indexed) dataset into contiguous ranges; with
    shuffle, the *order of shards* is shuffled per epoch (records inside a
    shard stay contiguous for IO efficiency)."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        max_shard_count: int = _MAX_SHARD_COUNT,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle
        self._max_shard_count = max_shard_count
        self._shards: list[Shard] = []

    def get_shards(self) -> list[Shard]:
        return self._shards

    def create_shards(self):
        logger.info(
            "Creating shards for dataset %s epoch %s",
            self.dataset_name,
            self.epoch,
        )
        shard_count = (
            self.dataset_size + self.shard_size - 1
        ) // self.shard_size
        if shard_count > self._max_shard_count:
            new_size = (
                self.dataset_size + self._max_shard_count - 1
            ) // self._max_shard_count
            logger.info(
                "shard_size %s -> %s to cap shard count",
                self.shard_size,
                new_size,
            )
            self.shard_size = new_size
        self._shards = self._create_shards_with_range(0, self.dataset_size)
        if self._shuffle:
            random.shuffle(self._shards)
        self.epoch += 1

    def _create_shards_with_range(self, start: int, end: int) -> list[Shard]:
        shards = []
        for s in range(start, end, self.shard_size):
            shards.append(
                Shard(
                    name=self.dataset_name,
                    start=s,
                    end=min(s + self.shard_size, end),
                )
            )
        return shards


class TextDatasetSplitter(DatasetSplitter):
    """Split a text/file dataset; with shuffle, *record indices* inside
    each shard are an explicit shuffled list (reference
    TextDatasetSplitter behavior — per-record random access)."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle
        self._shards: list[Shard] = []

    def get_shards(self) -> list[Shard]:
        return self._shards

    def create_shards(self):
        self._shards = self._create_shards_with_indices(
            0, self.dataset_size
        )
        self.epoch += 1

    def _create_shards_with_indices(self, start, end) -> list[Shard]:
        shards = []
        indices = list(range(start, end))
        if self._shuffle:
            random.shuffle(indices)
        for s in range(0, len(indices), self.shard_size):
            chunk = indices[s : s + self.shard_size]
            shards.append(
                Shard(
                    name=self.dataset_name,
                    start=s,
                    end=s + len(chunk),
                    record_indices=chunk,
                )
            )
        return shards


def new_dataset_splitter(
    shuffle: bool,
    shard_size: int,
    dataset_size: int,
    num_epochs: int,
    dataset_name: str,
    storage_type: str = "",
    dataset_type: str = "table",
) -> DatasetSplitter:
    if dataset_type == "text":
        return TextDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle
        )
    return TableDatasetSplitter(
        dataset_name, dataset_size, shard_size, num_epochs, shuffle
    )
