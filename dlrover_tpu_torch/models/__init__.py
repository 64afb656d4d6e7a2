"""Models of the PyTorch port."""

from dlrover_tpu_torch.models.convert import params_from_jax  # noqa: F401
from dlrover_tpu_torch.models.llama import (  # noqa: F401
    PRESETS,
    LlamaConfig,
    llama_apply,
    llama_init,
    llama_loss_fn,
)
