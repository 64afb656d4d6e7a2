"""Elastic data and training helpers (copies of
dlrover_tpu/trainer/elastic/: the checkpointable sampler, the batched
loader, the master-served dataset, the accumulating ElasticTrainer, the
device prefetcher and the shared-memory batch pipeline; the coworker
services and the PS failover client live in their own modules)."""

from dlrover_tpu_torch.trainer.elastic.dataloader import ElasticDataLoader
from dlrover_tpu_torch.trainer.elastic.dataset import ElasticDataset
from dlrover_tpu_torch.trainer.elastic.prefetch import DevicePrefetcher
from dlrover_tpu_torch.trainer.elastic.sampler import ElasticSampler
from dlrover_tpu_torch.trainer.elastic.shm_loader import (
    ShmBatchWriter,
    ShmDataLoader,
)
from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer

__all__ = [
    "ElasticSampler",
    "ElasticDataLoader",
    "ElasticDataset",
    "ElasticTrainer",
    "DevicePrefetcher",
    "ShmBatchWriter",
    "ShmDataLoader",
]
