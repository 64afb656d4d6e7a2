"""Weight bridge from the JAX package's Llama params to the port's.

``params_from_jax`` takes the pytree that ``dlrover_tpu.models.llama_init``
returns, with its leaves already turned into numpy arrays (for example
``jax.tree.map(np.asarray, params)``), so that this module needs neither
jax nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params_np: dict, device="cpu") -> dict:
    """Nested JAX Llama params (numpy leaves) -> the port's flat dict.

    Names map one to one, with nesting flattened by dots
    (``params["layers"]["wq"]`` -> ``"layers.wq"``). The stacked layer
    axis is KEPT: ``"layers.wq"`` stays [n_layers, dim, heads*head_dim],
    exactly as ``llama_init`` lays it out, and ``llama_apply`` unbinds it.
    Shapes and dtypes are unchanged, values are copied, so both packages
    compute the same function from the same numbers. ``device`` is where
    the tensors are placed (the CPU unless the caller asks otherwise)."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(f"{prefix}{key}.", child)
        else:
            out[prefix[:-1]] = torch.from_numpy(
                np.array(node, copy=True)).to(device)

    walk("", params_np)
    return out
