"""Training helpers of the PyTorch port."""

from dlrover_tpu_torch.trainer.optim import build_optimizer  # noqa: F401
