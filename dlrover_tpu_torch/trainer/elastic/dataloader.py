"""ElasticDataLoader: batched host-side loader with hot-reconfig.

Equivalent capability: reference dlrover/trainer/torch/elastic/dataloader.py
— a dataloader whose batch size can be updated at runtime from the
``ParallelConfig`` JSON file written by the agent's paral-config tuner
(reference paral_config_tuner.py:30), plus the sampler-driven sharding above.

TPU-first notes: yields stacked numpy batches (host memory); device placement
is a separate concern handled by :class:`DevicePrefetcher` /
``jax.device_put`` with a NamedSharding, so the loader never touches jax.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np

from dlrover_tpu_torch.common.constants import ConfigPath
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.trainer.elastic.sampler import ElasticSampler

logger = get_logger(__name__)


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {
            k: _default_collate([s[k] for s in samples]) for k in first
        }
    if isinstance(first, (tuple, list)):
        return type(first)(
            _default_collate([s[i] for s in samples])
            for i in range(len(first))
        )
    return np.stack([np.asarray(s) for s in samples])


class ElasticDataLoader:
    """Iterates ``dataset[idx]`` for indices from an :class:`ElasticSampler`.

    ``config_file`` (default: ``$DLROVER_PARAL_CONFIG_PATH``) is re-read at
    each epoch boundary and on :meth:`maybe_update_config`; if the tuner raised
    or lowered ``dataloader.batch_size`` the new size takes effect on the
    next batch — the hot-update path of the reference's ElasticDataLoader.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: ElasticSampler | None = None,
        collate_fn=_default_collate,
        drop_last: bool = True,
        config_file: str | None = None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.init_batch_size = int(batch_size)
        self.sampler = sampler or ElasticSampler(len(dataset))
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        # "" explicitly disables hot-reconfig; only None falls back to env.
        self._config_file = config_file if config_file is not None else \
            os.getenv(ConfigPath.ENV_PARAL_CONFIG, ConfigPath.PARAL_CONFIG)
        self._config_version = -1
        self._lock = threading.Lock()

    # ------------------------------------------------------------ hot config

    def maybe_update_config(self):
        """Adopt a new batch size from the paral-config file, if newer."""
        path = self._config_file
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                config = json.load(f)
        except (OSError, ValueError):
            return
        dl = config.get("dataloader", {})
        version = dl.get("version", 0)
        new_bs = dl.get("batch_size", 0)
        with self._lock:
            if version > self._config_version and new_bs > 0:
                self._config_version = version
                if new_bs != self.batch_size:
                    logger.info(
                        "dataloader batch size %d -> %d (config v%d)",
                        self.batch_size, new_bs, version,
                    )
                    self.batch_size = int(new_bs)

    def update_batch_size(self, batch_size: int):
        with self._lock:
            self.batch_size = int(batch_size)

    def reshape(self, num_replicas: int, rank: int):
        """In-process membership change: re-shard the epoch remainder
        over the new world (see :meth:`ElasticSampler.reshape`).  The
        caller must re-enter ``iter(loader)`` — batches already yielded
        were recorded as consumed, so the fresh iterator continues
        exactly after them."""
        self.sampler.reshape(num_replicas, rank)

    # -------------------------------------------------------------- iterate

    def __iter__(self):
        self.maybe_update_config()
        buf = []
        replicas = self.sampler.num_replicas
        for idx in self.sampler:
            try:
                buf.append(self.dataset[idx])
            except IndexError:
                # master-served dataset exhausted mid-epoch
                break
            if len(buf) >= self.batch_size:
                # global consumption for mid-epoch checkpoint/resume: every
                # replica consumes one batch this step. Recorded *before*
                # the yield so a checkpoint taken while the caller holds
                # this batch counts it as consumed.
                self.sampler.record_batch(len(buf) * replicas)
                yield self.collate_fn(buf)
                buf = []
                self.maybe_update_config()
        if buf and not self.drop_last:
            self.sampler.record_batch(len(buf) * replicas)
            yield self.collate_fn(buf)

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # ---------------------------------------------------------- checkpoints

    def state_dict(self) -> dict:
        return {"sampler": self.sampler.state_dict(),
                "batch_size": self.batch_size}

    def load_state_dict(self, state: dict):
        self.sampler.load_state_dict(state.get("sampler", {}))
        bs = state.get("batch_size", 0)
        if bs:
            self.batch_size = int(bs)
