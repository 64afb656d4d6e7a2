"""ReplayBuffer: host-side experience store for RL training (the
port's copy of dlrover_tpu/rl/replay_buffer.py).

Equivalent capability: reference atorch/atorch/rl/replay_buffer/
replay_buffer.py:5 — keyed sample store with add/reset and dataset
creation for the training phase.
"""

from __future__ import annotations

import numpy as np


class ReplayBuffer:
    """Stores experience dicts; batches them for the PPO update phase."""

    def __init__(self, element_keys=None):
        self._keys = list(element_keys) if element_keys else None
        self._samples: list[dict] = []

    def __len__(self):
        return len(self._samples)

    def reset(self):
        self._samples.clear()

    def add_sample(self, sample: dict):
        if self._keys is None:
            self._keys = list(sample.keys())
        missing = set(self._keys) - set(sample.keys())
        if missing:
            raise ValueError(f"sample missing keys {missing}")
        self._samples.append(sample)

    def add_samples(self, samples):
        """Add a batch: a dict of [B, ...] arrays (split per-sample) or a
        list of per-sample dicts."""
        if isinstance(samples, dict):
            batch = len(next(iter(samples.values())))
            for i in range(batch):
                self.add_sample(
                    {k: np.asarray(v)[i] for k, v in samples.items()}
                )
        else:
            for s in samples:
                self.add_sample(s)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0):
        """Yield stacked {key: [batch_size, ...]} dicts (drops remainder)."""
        order = np.arange(len(self._samples))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            yield {
                k: np.stack([self._samples[i][k] for i in idx])
                for k in self._keys
            }
