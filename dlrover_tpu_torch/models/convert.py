"""Bridge from the JAX package's params and optimizer states to the
port's.

``params_from_jax`` takes the pytree that ``dlrover_tpu.models.llama_init``
returns and ``opt_state_from_jax`` an optax state of the JAX package's
8-bit or fused Adam, each with its leaves already turned into numpy
arrays (for example ``jax.tree.map(np.asarray, tree)``), so that this
module needs neither jax nor the JAX package.
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
    compute the same function from the same numbers. Every ``attn_impl``
    ("flash", "bshd", "reference") uses these same leaves: the layouts
    differ only in how the projections' outputs are viewed. ``device`` is
    where the tensors are placed (the CPU unless the caller asks
    otherwise)."""
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


def _jax_leaves(tree, is_leaf):
    """The nodes of a nested dict/tuple for which ``is_leaf`` holds, in
    ``jax.tree_util`` order: dict keys sorted, sequences in order."""
    if is_leaf(tree):
        yield tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _jax_leaves(tree[key], is_leaf)
    elif isinstance(tree, (list, tuple)):
        for child in tree:
            yield from _jax_leaves(child, is_leaf)


def _named(name):
    return lambda node: type(node).__name__ == name


_STATE_KINDS = ("ScaleByAdam8bitState", "FusedAdamState",
                "FusedAdam8bitState")


def opt_state_from_jax(state_np, optimizer) -> dict:
    """A JAX optimizer state (numpy leaves) -> ``optimizer.state_dict()``
    holding the same moments, for ``optimizer.load_state_dict``.

    ``state_np`` is the state of ``optimizers.adam8bit`` (a chain that
    holds a ``ScaleByAdam8bitState``: a ``QuantizedMoment`` per leaf),
    or of ``fused_adamw(bits=32)`` / ``fused_adamw(bits=8)``
    (``FusedAdamState`` / ``FusedAdam8bitState``, flat). ``optimizer`` is
    the port's ``Adam8bit`` or ``FusedAdamW`` over the same params, given
    in the JAX leaf order (as ``auto_accelerate`` gives them). The flat
    arrays lose the TPU grid's tail rows; codes and scales are copied
    unchanged, onto the params' device."""
    found = [node for kind in _STATE_KINDS
             for node in _jax_leaves(state_np, _named(kind))]
    if len(found) != 1:
        raise ValueError(f"want one of {_STATE_KINDS} in the state, found "
                         f"{[type(n).__name__ for n in found]}")
    st = found[0]
    params = optimizer.param_groups[0]["params"]
    device = params[0].device

    def tensor(a, rows=None):
        a = np.asarray(a)
        if rows is not None:
            if a.shape[0] < rows:
                raise ValueError(f"state has {a.shape[0]} rows, the "
                                 f"optimizer {rows}")
            a = a[:rows]
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    out = optimizer.state_dict()
    state = {"count": int(np.asarray(st.count))}
    if type(st).__name__ == "ScaleByAdam8bitState":
        is_qm = _named("QuantizedMoment")
        mus = list(_jax_leaves(st.mu, is_qm))
        nus = list(_jax_leaves(st.nu, is_qm))
        if len(mus) != len(params):
            raise ValueError(f"state has {len(mus)} leaves, the optimizer "
                             f"{len(params)} params")
        for i, (mu, nu) in enumerate(zip(mus, nus)):
            state[i] = {"mu_q": tensor(mu.q), "mu_scale": tensor(mu.scales),
                        "nu_q": tensor(nu.q), "nu_scale": tensor(nu.scales)}
    else:
        rows = optimizer.meta.total_rows
        for key in st._fields:
            if key != "count":
                state[key] = tensor(getattr(st, key), rows)
    out["state"] = state
    return out
