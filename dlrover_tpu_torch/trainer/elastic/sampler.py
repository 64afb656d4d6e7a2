"""ElasticSampler: a checkpointable, world-size-agnostic index sampler.

Equivalent capability: reference dlrover/trainer/torch/elastic/sampler.py:25
(`ElasticDistributedSampler`) — deterministic shuffling per epoch, round-robin
sharding over ranks, and a ``state_dict``/``load_state_dict`` pair that
resumes mid-epoch even when the world size changed between save and restore
(sampler.py:118-130 in the reference).

TPU-first notes: the sampler yields *global* sample indices; per-host batches
are formed by the dataloader and placed onto the device mesh with a
``NamedSharding`` over the "data" axis, so the sampler itself stays pure
host-side Python with no framework dependency.
"""

from __future__ import annotations

import numpy as np


class ElasticSampler:
    """Round-robin shards ``dataset_size`` indices over ``num_replicas``.

    Iteration yields the indices owned by ``rank``. ``completed_num`` counts
    *globally consumed* samples so a checkpoint taken at world size N can be
    restored at world size M: the first ``completed_num`` samples of the
    (deterministically shuffled) epoch permutation are skipped, and the
    remainder re-sharded over the new world.
    """

    def __init__(
        self,
        dataset_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if rank >= num_replicas or rank < 0:
            raise ValueError(
                f"rank {rank} out of range for {num_replicas} replicas"
            )
        self.dataset_size = int(dataset_size)
        self.num_replicas = int(num_replicas)
        self.rank = int(rank)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.drop_last = drop_last
        self.epoch = 0
        # Globally consumed samples within the current epoch (across ranks).
        self.completed_num = 0

    # ------------------------------------------------------------ epoch API

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)
        self.completed_num = 0

    def _epoch_permutation(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            return rng.permutation(self.dataset_size)
        return np.arange(self.dataset_size)

    def __iter__(self):
        perm = self._epoch_permutation()
        remaining = perm[self.completed_num:]
        if self.drop_last:
            usable = (len(remaining) // self.num_replicas) * self.num_replicas
            remaining = remaining[:usable]
        # Round-robin so that "first k global samples consumed" stays a
        # prefix property under any world size.
        for idx in remaining[self.rank:: self.num_replicas]:
            yield int(idx)

    def __len__(self):
        remaining = self.dataset_size - self.completed_num
        if self.drop_last:
            return remaining // self.num_replicas
        return (remaining + self.num_replicas - 1 - self.rank) // \
            self.num_replicas

    # ------------------------------------------------------------- reshape

    def reshape(self, num_replicas: int, rank: int):
        """Re-shard the REMAINDER of the epoch over a new world — the
        in-process membership-change path (no restart, no checkpoint
        round-trip).  ``completed_num`` counts globally consumed
        samples and consumption is a prefix of the epoch permutation,
        so handing the tail to a different (num_replicas, rank) serves
        every remaining sample exactly once and re-serves none."""
        if rank >= num_replicas or rank < 0:
            raise ValueError(
                f"rank {rank} out of range for {num_replicas} replicas"
            )
        self.num_replicas = int(num_replicas)
        self.rank = int(rank)

    # ---------------------------------------------------------- consumption

    def record_batch(self, global_batch_size: int):
        """Record that ``global_batch_size`` samples were consumed globally."""
        self.completed_num += int(global_batch_size)
        if self.completed_num >= self.dataset_size:
            # epoch exhausted; next epoch starts fresh
            self.completed_num = self.dataset_size

    # ---------------------------------------------------------- checkpoints

    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "completed_num": self.completed_num,
            "seed": self.seed,
            "shuffle": self.shuffle,
            "dataset_size": self.dataset_size,
        }

    def load_state_dict(self, state: dict):
        """Restore progress; tolerant of a changed world size.

        Mirrors reference sampler.py:118-130: ``completed_num`` is global, so
        only epoch/offset are restored — sharding uses the *current*
        num_replicas/rank.
        """
        self.epoch = int(state.get("epoch", 0))
        self.seed = int(state.get("seed", self.seed))
        self.shuffle = bool(state.get("shuffle", self.shuffle))
        saved_size = int(state.get("dataset_size", self.dataset_size))
        completed = int(state.get("completed_num", 0))
        if saved_size != self.dataset_size and saved_size > 0:
            # dataset changed length between runs: scale the offset
            completed = int(completed * self.dataset_size / saved_size)
        self.completed_num = min(completed, self.dataset_size)
