"""Device resolution for the port's entry points.

The default device is ``cuda``. Without a GPU an entry point raises
unless the caller asked for the CPU explicitly (``device="cpu"``, as the
tests do): a run never drops to the CPU on its own.
"""

from __future__ import annotations

import torch

CUDA_SKIP_REASON = (
    "needs an NVIDIA GPU: torch.cuda.is_available() is False here (run "
    "the card tests with `python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py` "
    "on the GPU machine)"
)


def cuda_available() -> bool:
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; raises when CUDA was asked for and is
    missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not cuda_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
