"""Rematerialisation (activation checkpointing) for the port: the save
policies of the JAX package's ``jax.checkpoint`` sites, on
``torch.utils.checkpoint`` (non-reentrant, the only form that takes a
selective policy).

Two sites use them, as in the JAX package:

- the strategy's wrap around the whole loss (``Strategy.remat``,
  parallel/accelerate.py; dlrover_tpu/parallel/accelerate.py
  ``_remat_wrap``): ``"minimal"`` saves the weight matmuls
  (``dots_with_no_batch_dims_saveable``), ``"full"`` saves nothing,
  ``"offload"`` sends what ``"minimal"`` keeps to pinned host memory and
  brings it back in the backward;
- the model's checkpoint of each layer (``LlamaConfig.remat`` and
  ``remat_policy``, models/llama.py; the JAX layer scan's policy table):
  ``"dots_attn"`` saves the weight matmuls and the flash forward's
  (o, lse), ``"dots_no_batch"`` the weight matmuls, ``"dots"`` every
  matmul (batched ones too), ``"dots_attn_offload"`` sends the weight
  matmuls to pinned host memory and keeps (o, lse) on the device.

A weight matmul is ``aten.mm`` (a [B, S, D] @ [D, N] product reaches the
dispatcher as one); a batched one is ``aten.bmm``. The flash forward is
the dispatcher op of K1 or K9 (ops/attention.py), the counterpart of the
JAX package's "attn_out" name; the ring's K12 op is not named, as the
JAX ring's forward (a ``custom_vjp``) is invisible to its policies.

``Strategy.remat="none"`` means none: :func:`no_remat` is active around
the loss, and the model then checkpoints no layer whatever its config
says (the JAX package's ``no_remat_autocast``).
"""

from __future__ import annotations

import contextlib
import functools
from collections import defaultdict

import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

# registers the ops of K1 and K9 that the policies name
import dlrover_tpu_torch.ops.attention  # noqa: F401

aten = torch.ops.aten

SAVE, OFFLOAD = "save", "offload"  # what a policy does with an op's outputs

_DOTS_NO_BATCH = (aten.mm.default, aten.addmm.default)
_BATCHED_DOTS = (aten.bmm.default, aten.baddbmm.default)
_ATTN = (torch.ops.dlrover_tpu_torch.flash_fwd.default,
         torch.ops.dlrover_tpu_torch.flash_fwd_heads.default)


def _table(save=(), offload=()):
    return {**{op: SAVE for op in save}, **{op: OFFLOAD for op in offload}}


def strategy_policy(mode: str) -> dict:
    """{op: SAVE | OFFLOAD} of the strategy's wrap (``Strategy.remat``
    other than ``"none"``); every other op is recomputed."""
    if mode == "minimal":
        return _table(save=_DOTS_NO_BATCH)
    if mode == "offload":
        return _table(offload=_DOTS_NO_BATCH)
    if mode == "full":
        return {}
    raise ValueError(f"unknown remat mode {mode!r}: none | minimal | "
                     "offload | full")


def layer_policy(name: str) -> dict:
    """{op: SAVE | OFFLOAD} of the model's per-layer checkpoint
    (``LlamaConfig.remat_policy``)."""
    if name == "dots_attn":
        return _table(save=_DOTS_NO_BATCH + _ATTN)
    if name == "dots_attn_offload":
        return _table(save=_ATTN, offload=_DOTS_NO_BATCH)
    if name == "dots_no_batch":
        return _table(save=_DOTS_NO_BATCH)
    if name == "dots":
        return _table(save=_DOTS_NO_BATCH + _BATCHED_DOTS)
    raise ValueError(f"unknown remat_policy {name!r}: dots_attn | "
                     "dots_attn_offload | dots_no_batch | dots")


# ---------------------------------------------------------------------------
# offload: a selective checkpoint whose saves live in host memory
# ---------------------------------------------------------------------------


class _Offloaded:
    """A saved output parked in (pinned) host memory."""

    def __init__(self, t: torch.Tensor):
        self.device = t.device
        self.host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                pin_memory=t.is_cuda)
        self.host.copy_(t, non_blocking=True)

    def back(self) -> torch.Tensor:
        return self.host.to(self.device, non_blocking=True)


def _park(how, out):
    if how == OFFLOAD:
        return tree_map(lambda t: _Offloaded(t)
                        if isinstance(t, torch.Tensor) else t, out)
    return tree_map(lambda t: t.detach()
                    if isinstance(t, torch.Tensor) else t, out)


def _unpark(saved):
    return tree_map(lambda t: t.back() if isinstance(t, _Offloaded) else t,
                    saved)


class _SaveMode(TorchDispatchMode):
    """The checkpointed forward: runs every op and keeps the outputs the
    policy names, on the device (SAVE) or in host memory (OFFLOAD)."""

    def __init__(self, policy, store):
        super().__init__()
        self.policy, self.store = policy, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        how = self.policy.get(func)
        if how is not None:
            self.store[func].append(_park(how, out))
        return out


class _ReplayMode(TorchDispatchMode):
    """The recompute: the policy's ops hand back what the forward kept
    (in the order they ran), every other op runs again."""

    def __init__(self, policy, store):
        super().__init__()
        self.policy, self.store = policy, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.policy:
            return _unpark(self.store[func].pop(0))
        return func(*args, **(kwargs or {}))


def _contexts(policy: dict):
    """``context_fn`` of :func:`torch.utils.checkpoint.checkpoint`: the
    library's selective contexts where the policy only saves, the
    offloading pair above where it offloads."""
    if OFFLOAD in policy.values():
        store = defaultdict(list)
        return _SaveMode(policy, store), _ReplayMode(policy, store)
    saved = frozenset(policy)

    def choose(ctx, op, *args, **kwargs):
        return (torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
                if op in saved else
                torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)

    return torch.utils.checkpoint.create_selective_checkpoint_contexts(
        choose)


def checkpoint(fn, *args, policy: dict):
    """``fn(*args)`` under a non-reentrant checkpoint that keeps what
    ``policy`` names (from :func:`strategy_policy` or
    :func:`layer_policy`) and recomputes the rest in the backward."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=functools.partial(_contexts, policy))


# ---------------------------------------------------------------------------
# remat="none"
# ---------------------------------------------------------------------------


class _Flag:
    disabled = False


def remat_disabled() -> bool:
    """Whether the strategy asked for no rematerialisation: the model
    then checkpoints no layer."""
    return _Flag.disabled


@contextlib.contextmanager
def no_remat():
    """Suppress the model's per-layer checkpoints while active (the loss
    of a ``Strategy.remat="none"`` step)."""
    prev = _Flag.disabled
    _Flag.disabled = True
    try:
        yield
    finally:
        _Flag.disabled = prev
