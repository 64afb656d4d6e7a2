"""Optimizers of the PyTorch port (counterparts of dlrover_tpu/optimizers)."""

from dlrover_tpu_torch.ops.fused_optim import FusedAdamW, fused_adamw  # noqa: F401
from dlrover_tpu_torch.optimizers.low_bit import Adam8bit, adam8bit  # noqa: F401

__all__ = ["Adam8bit", "FusedAdamW", "adam8bit", "fused_adamw"]
