"""Token-level softmax cross-entropy (dlrover_tpu/ops/cross_entropy.py
``softmax_cross_entropy``; plain torch there too: it is no Pallas
kernel in the JAX package)."""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits, labels, ignore_index: int = -100):
    """Token-level CE. logits [..., V] float, labels [...] int.

    Returns (per-token loss [...], valid mask [...]). Loss is 0 where
    ignored; caller averages by mask sum.
    """
    logits = logits.float()
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe_labels[..., None])[..., 0]
    loss = torch.where(valid, lse - picked, 0.0)
    return loss, valid
