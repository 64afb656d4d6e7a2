"""Flash Checkpoint for the PyTorch port: the engines that save the
training state to shared memory and restore it (``engine.py``), and the
``FlashCheckpointer`` API over them (``checkpointer.py``)."""

from dlrover_tpu_torch.trainer.flash_checkpoint.checkpointer import (  # noqa: F401
    FlashCheckpointer,
    StorageType,
)
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (  # noqa: F401
    CheckpointEngine,
    ReplicatedCheckpointEngine,
    ShardedCheckpointEngine,
)
