"""Models of the PyTorch port."""

from dlrover_tpu_torch.models.convert import (  # noqa: F401
    opt_state_from_jax,
    params_from_jax,
    recsys_params_from_jax,
    tiered_state_from_jax,
)
from dlrover_tpu_torch.models.gpt2 import (  # noqa: F401
    GPT2_PRESETS,
    GPT2Config,
    gpt2_apply,
    gpt2_init,
    gpt2_logical_axes,
    gpt2_loss_fn,
)
from dlrover_tpu_torch.models.llama import (  # noqa: F401
    PRESETS,
    LlamaConfig,
    llama_apply,
    llama_init,
    llama_logical_axes,
    llama_loss_fn,
)
from dlrover_tpu_torch.models.recsys import (  # noqa: F401
    RecsysConfig,
    TieredBatchPreparer,
    make_tiered_embedding,
    recsys_init,
    recsys_logical_axes,
    recsys_loss_fn,
)
