"""Flash Checkpoint for the PyTorch port: the engines that save the
training state to shared memory and restore it (``engine.py``). The
``FlashCheckpointer`` API of the JAX package reaches the master, and
comes with the control plane (ROADMAP Queue 1 item 6)."""

from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (  # noqa: F401
    CheckpointEngine,
    ReplicatedCheckpointEngine,
    ShardedCheckpointEngine,
)
