"""Bridge from the JAX package's params and optimizer states to the
port's.

``params_from_jax`` takes the pytree that ``dlrover_tpu.models.llama_init``
or ``gpt2_init`` returns and ``opt_state_from_jax`` an optax state of the JAX package's
8-bit or fused Adam or AGD, each with its leaves already turned into numpy
arrays (for example ``jax.tree.map(np.asarray, tree)``), so that this
module needs neither jax nor the JAX package. On a DeviceMesh both give
DTensors: the params placed by their logical axes under the rule table,
the moments as their params are placed (the JAX package's
``compute_state_shardings``). ``recsys_params_from_jax`` and
``tiered_state_from_jax`` carry the recsys model's params and a
``TieredKvEmbedding``'s state (mapper, host tier) across.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params_np: dict, device="cpu", device_mesh=None,
                    logical_axes=None, rules=None) -> dict:
    """Nested JAX Llama or GPT-2 params (numpy leaves) -> the port's flat
    dict.

    Names map one to one, with nesting flattened by dots
    (``params["layers"]["wq"]`` -> ``"layers.wq"``; GPT-2's
    ``params["layers"]["w_qkv"]`` -> ``"layers.w_qkv"``). The stacked
    layer axis is KEPT: ``"layers.wq"`` stays [n_layers, dim,
    heads*head_dim], exactly as ``llama_init`` (``gpt2_init``) lays it
    out, and ``llama_apply`` (``gpt2_apply``) unbinds it.
    Shapes and dtypes are unchanged, values are copied, so both packages
    compute the same function from the same numbers. Every ``attn_impl``
    ("flash", "bshd", "reference") uses these same leaves: the layouts
    differ only in how the projections' outputs are viewed. ``device`` is
    where the tensors are placed (the CPU unless the caller asks
    otherwise). With a ``device_mesh`` each leaf becomes a DTensor there,
    placed by its ``logical_axes`` entry (``llama_logical_axes``) under
    ``rules`` (the default table when None; a leaf without axes is
    replicated): every rank passes the same arrays and keeps its
    shard."""
    out = {name: torch.from_numpy(np.array(leaf, copy=True)).to(device)
           for name, leaf in _by_name(params_np).items()}
    if device_mesh is None:
        return out
    from dlrover_tpu_torch.parallel.sharding import distribute_logical

    axes = logical_axes or {}
    return {name: distribute_logical(t, axes.get(name), device_mesh, rules)
            for name, t in out.items()}


def _by_name(tree) -> dict:
    """A nested dict's leaves by dotted name (``"layers.wq"``)."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(f"{prefix}{key}.", child)
        else:
            out[prefix[:-1]] = node

    walk("", tree)
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
                "FusedAdam8bitState", "ScaleByAgdState", "ScaleByAdamState")


def opt_state_from_jax(state_np, optimizer) -> dict:
    """A JAX optimizer state (numpy leaves) -> ``optimizer.state_dict()``
    holding the same moments, for ``optimizer.load_state_dict``.

    ``state_np`` is the state of ``optimizers.adam8bit`` (a chain that
    holds a ``ScaleByAdam8bitState``: a ``QuantizedMoment`` per leaf),
    of ``fused_adamw(bits=32)`` / ``fused_adamw(bits=8)``
    (``FusedAdamState`` / ``FusedAdam8bitState``, flat), or of ``agd``
    (a chain that holds a ``ScaleByAgdState``: moment trees and one
    count), or of ``optax.adam``/``adamw`` (a ``ScaleByAdamState``: mu,
    nu and one count). ``optimizer`` is the port's ``Adam8bit``,
    ``FusedAdamW`` or ``AGD``, or torch's ``Adam``/``AdamW``, over the
    same params; torch's take their moments by param name, as AGD does,
    each placed as its param is (a DTensor's moments are DTensors with
    its placements). The first two take them in the JAX leaf
    order (as ``auto_accelerate`` gives them); ``AGD``'s moments are
    matched by name, so its params must be named (``param_names`` in its
    groups, as ``auto_accelerate`` gives them). The flat arrays lose the
    TPU grid's tail rows; codes, scales and moments are copied unchanged,
    onto the params' device."""
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
    if type(st).__name__ == "ScaleByAdamState":
        out["state"] = _adam_state(st, optimizer)
        return out
    state = {"count": int(np.asarray(st.count))}
    if type(st).__name__ == "ScaleByAgdState":
        slots = {"mu": _by_name(st.mu), "nu": _by_name(st.nu)}
        if isinstance(st.max_nu, dict):
            slots["max_nu"] = _by_name(st.max_nu)
        names = [n for g in optimizer.param_groups
                 for n in g.get("param_names", ())]
        if len(names) != sum(len(g["params"])
                             for g in optimizer.param_groups):
            raise ValueError("AGD's moments are matched by param name: "
                             "build the optimizer over named params")
        for i, name in enumerate(names):
            state[i] = {slot: tensor(tree[name])
                        for slot, tree in slots.items()}
    elif type(st).__name__ == "ScaleByAdam8bitState":
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


def _adam_state(st, optimizer) -> dict:
    """torch Adam/AdamW per-param state from an optax ``ScaleByAdamState``,
    by param name; each moment on its param's device and placements."""
    names = [n for g in optimizer.param_groups
             for n in g.get("param_names", ())]
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if len(names) != len(params):
        raise ValueError("Adam's moments are matched by param name: build "
                         "the optimizer over named params")
    mu, nu = _by_name(st.mu), _by_name(st.nu)
    step = float(np.asarray(st.count))

    from torch.distributed.tensor import DTensor, distribute_tensor

    def like(a, p):
        t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
        if isinstance(p, DTensor):
            return distribute_tensor(t.to(p.device), p.device_mesh,
                                     p.placements, src_data_rank=None)
        return t.to(p.device)

    return {i: {"step": torch.tensor(step),
                "exp_avg": like(mu[name], p),
                "exp_avg_sq": like(nu[name], p)}
            for i, (name, p) in enumerate(zip(names, params))}


_RECSYS_LEAVES = ("table", "w1", "b1", "w2", "b2")


def recsys_params_from_jax(params_np: dict, device="cpu") -> dict:
    """``dlrover_tpu.models.recsys_init``'s params (numpy leaves) -> the
    port's: the same five leaves (the table and the two-layer tower),
    values and dtypes unchanged, on ``device``."""
    missing = [k for k in _RECSYS_LEAVES if k not in params_np]
    if missing:
        raise KeyError(f"not a recsys param tree: no {missing}")
    return params_from_jax({k: params_np[k] for k in _RECSYS_LEAVES},
                           device)


def _host_array(a) -> np.ndarray:
    """A host-tier array in the port's host form: ``bfloat16`` rows (an
    ml_dtypes type on the JAX side) as their int16 bit patterns."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16).copy()
    return a.copy()


def tiered_state_from_jax(state: dict) -> dict:
    """A JAX ``TieredKvEmbedding.state_dict()`` (numpy arrays) -> a state
    the port's ``TieredKvEmbedding.load_state_dict`` takes: the same
    mapper arrays, host ids, host rows and aux rows (the legacy
    ``host_store`` layout too), copied, with bfloat16 rows as bits."""
    out = {"mapper": {k: (np.asarray(v).copy()
                          if isinstance(v, np.ndarray) else v)
                      for k, v in state["mapper"].items()}}
    if "host_store" in state:
        out["host_store"] = {int(k): _host_array(v)
                             for k, v in state["host_store"].items()}
    else:
        out["host_ids"] = np.asarray(state["host_ids"], np.int64).copy()
        out["host_rows"] = _host_array(state["host_rows"])
    if state.get("host_aux") is not None:
        out["host_aux"] = [_host_array(a) for a in state["host_aux"]]
    return out
