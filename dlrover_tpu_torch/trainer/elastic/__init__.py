"""Elastic data: the checkpointable sampler, the batched loader and the
master-served dataset (copies of dlrover_tpu/trainer/elastic/sampler.py,
dataloader.py and dataset.py; the trainer, prefetch, shm loader and
coworker modules are ROADMAP Queue 1 item 8)."""

from dlrover_tpu_torch.trainer.elastic.dataloader import ElasticDataLoader
from dlrover_tpu_torch.trainer.elastic.dataset import ElasticDataset
from dlrover_tpu_torch.trainer.elastic.sampler import ElasticSampler

__all__ = ["ElasticSampler", "ElasticDataLoader", "ElasticDataset"]
