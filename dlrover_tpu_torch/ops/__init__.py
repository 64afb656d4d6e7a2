"""Ops of the PyTorch port: hand-written Hopper kernels and plain torch."""

from dlrover_tpu_torch.ops.fused_optim import (  # noqa: F401
    FusedAdamW,
    flatten_meta,
    flatten_to_blocks,
    fused_adamw,
    tree_order,
    unflatten_from_blocks,
)
from dlrover_tpu_torch.ops.quantization import (  # noqa: F401
    dequantize_int8,
    dequantize_pos_log,
    quantize_int8,
    quantize_pos_log,
)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process, by kernel."""
    from dlrover_tpu_torch.ops import (
        attention,
        fused_optim,
        lowp,
        quantization,
    )

    return {kernel.__name__: kernel.launches
            for mod in (attention, quantization, fused_optim, lowp)
            for kernel in mod.KERNELS}
