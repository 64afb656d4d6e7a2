"""Optimizers of the PyTorch port (counterparts of dlrover_tpu/optimizers,
under its names)."""

from dlrover_tpu_torch.ops.fused_optim import FusedAdamW, fused_adamw  # noqa: F401
from dlrover_tpu_torch.optimizers.agd import AGD, agd  # noqa: F401
from dlrover_tpu_torch.optimizers.group_sparse import (  # noqa: F401
    GroupAdagrad,
    GroupAdam,
    group_adagrad,
    group_adam,
)
from dlrover_tpu_torch.optimizers.low_bit import Adam8bit, adam8bit  # noqa: F401
from dlrover_tpu_torch.optimizers.mup import (  # noqa: F401
    mup_adam,
    mup_lr_multipliers,
    mup_rescale_init,
    scale_by_mup,
)
from dlrover_tpu_torch.optimizers.offload import OffloadAdam  # noqa: F401
from dlrover_tpu_torch.optimizers.wsam import (  # noqa: F401
    make_wsam_grad_fn,
    make_wsam_step_fn,
    wsam_update,
)

__all__ = [
    "AGD", "Adam8bit", "FusedAdamW", "GroupAdagrad", "GroupAdam",
    "OffloadAdam", "adam8bit", "agd", "fused_adamw",
    "group_adagrad", "group_adam", "make_wsam_grad_fn", "make_wsam_step_fn",
    "mup_adam", "mup_lr_multipliers", "mup_rescale_init", "scale_by_mup",
    "wsam_update",
]
