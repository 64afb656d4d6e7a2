"""dlrover_tpu_torch — the PyTorch/CUDA port of dlrover_tpu for NVIDIA
Hopper GPUs.

A package of its own beside the JAX package: it imports torch, never jax,
and nothing of dlrover_tpu (it keeps its own copies of what it needs).
Attention runs on hand-written sm_90a kernels (ops/csrc); entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.

Importing the package imports no torch: the control-plane processes (the
master, which never touches a tensor) start without it.
"""


def __getattr__(name):
    # cuda_available and resolve_device, from device.py when first asked
    if name in ("cuda_available", "resolve_device"):
        from dlrover_tpu_torch import device

        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
