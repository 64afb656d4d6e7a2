"""Strategy and auto_accelerate, which makes the train step."""

from dlrover_tpu_torch.parallel.accelerate import (  # noqa: F401
    AccelerateResult,
    TrainState,
    auto_accelerate,
)
from dlrover_tpu_torch.parallel.strategy import MeshConfig, Strategy  # noqa: F401
