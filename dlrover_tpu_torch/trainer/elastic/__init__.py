"""Elastic data: the checkpointable sampler and the batched loader
(copies of dlrover_tpu/trainer/elastic/sampler.py and dataloader.py;
the dataset, prefetch, shm loader, coworker and reshape modules are
ROADMAP Queue 1 item 8)."""

from dlrover_tpu_torch.trainer.elastic.dataloader import ElasticDataLoader
from dlrover_tpu_torch.trainer.elastic.sampler import ElasticSampler

__all__ = ["ElasticSampler", "ElasticDataLoader"]
