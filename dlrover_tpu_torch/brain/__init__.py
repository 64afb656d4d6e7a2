from dlrover_tpu_torch.brain.datastore import MetricsStore
from dlrover_tpu_torch.brain.service import BrainService, create_brain_service
from dlrover_tpu_torch.brain.client import (
    BrainClient,
    BrainReporter,
    BrainResourceOptimizer,
)

__all__ = [
    "MetricsStore",
    "BrainService",
    "create_brain_service",
    "BrainClient",
    "BrainReporter",
    "BrainResourceOptimizer",
]
