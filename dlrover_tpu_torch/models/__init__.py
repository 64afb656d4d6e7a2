"""Models of the PyTorch port."""

from dlrover_tpu_torch.models.convert import (  # noqa: F401
    opt_state_from_jax,
    params_from_jax,
)
from dlrover_tpu_torch.models.llama import (  # noqa: F401
    PRESETS,
    LlamaConfig,
    llama_apply,
    llama_init,
    llama_loss_fn,
)
