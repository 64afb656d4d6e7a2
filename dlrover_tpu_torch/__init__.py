"""dlrover_tpu_torch — the PyTorch/CUDA port of dlrover_tpu for NVIDIA
Hopper GPUs.

A package of its own beside the JAX package: it imports torch, never jax,
and nothing of dlrover_tpu (it keeps its own copies of what it needs).
Attention runs on hand-written sm_90a kernels (ops/csrc); entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from dlrover_tpu_torch.device import cuda_available, resolve_device  # noqa: F401
