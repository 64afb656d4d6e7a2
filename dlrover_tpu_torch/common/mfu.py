"""Model-FLOPs utilization accounting (a copy of dlrover_tpu/common/mfu.py
with the port's peak).

The FLOPs model is the standard dense-transformer estimate: 6 FLOPs per
parameter per token (fwd 2 + bwd 4) plus the causal-attention
``QK^T``/``AV`` term ``12 * n_layers * dim * tokens * seq / 2`` that the
parameter count does not capture.

Peak FLOP/s defaults to the NVIDIA H100 SXM dense bf16 tensor-core peak,
989 TFLOP/s (NVIDIA data sheet, at the 700 W power limit), and is
env-overridable (``DLROVER_TORCH_PEAK_FLOPS``) for other cards.
"""

from __future__ import annotations

import os

PEAK_FLOPS_ENV = "DLROVER_TORCH_PEAK_FLOPS"
# H100 SXM dense bf16 peak per card
DEFAULT_PEAK_FLOPS = 989e12


def peak_flops() -> float:
    """The env override when set (a malformed value raises), else the
    H100 SXM peak."""
    raw = os.environ.get(PEAK_FLOPS_ENV)
    if raw is None:
        return DEFAULT_PEAK_FLOPS
    try:
        return float(raw)
    except ValueError:
        raise ValueError(
            f"{PEAK_FLOPS_ENV}={raw!r} is not a number of FLOP/s") from None


def transformer_step_flops(
    params: int,
    tokens: int,
    n_layers: int = 0,
    dim: int = 0,
    seq: int = 0,
) -> float:
    """Model FLOPs of one train step over ``tokens`` tokens: dense
    ``6 * params * tokens`` plus the causal attention score/value term
    when the transformer shape is known (0s = dense-only estimate)."""
    flops = 6.0 * params * tokens
    if n_layers and dim and seq:
        flops += 12.0 * n_layers * dim * tokens * seq / 2
    return flops


def mfu(flops_per_step: float, step_seconds: float,
        peak: float | None = None) -> float:
    """Fraction of peak the step achieved; 0 when unmeasurable."""
    peak = peak_flops() if peak is None else peak
    if step_seconds <= 0 or peak <= 0:
        return 0.0
    return flops_per_step / step_seconds / peak
