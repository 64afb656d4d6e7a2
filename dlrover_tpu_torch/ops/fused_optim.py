"""One-pass fused AdamW step (port of dlrover_tpu/ops/fused_optim.py).

The optimizer state is flat: one ``[rows, BLOCK]`` array per moment,
each leaf starting at a row edge (the JAX package's layout, so a state
converts row for row and the 8-bit blockwise scales equal the per-leaf
ones). Grad-norm clipping, the Adam moments, bias correction, decoupled
weight decay, the parameter update and, for 8-bit state, the decode and
re-encode of both moments run in ONE kernel launch per step over every
leaf (K7 ``fused_adamw32``, K8 ``fused_adamw8``, sm_90a, ``csrc/optim.cu``).

Unlike the TPU step, which copies every grad and param into one flat
buffer and the update back out (a TPU pays per dispatch, not per byte),
the kernels read each grad and update each param in place through a
leaf table (param pointer, grad pointer, numel, first row), rebuilt each
step because autograd reallocates the grads. Elements past a leaf's
numel count as zeros. The TPU grid's tail padding (``TILE_ROWS``) is
dropped: ``total_rows`` is the sum of the leaves' rows.

Leaf order: the leaves are the optimizer's params in the order given.
``auto_accelerate`` gives them in :func:`tree_order`, the order in which
``jax.tree_util`` flattens the JAX package's nested param dict (sorted
keys), so that row ``r`` of the state and leaf index ``i`` of the
per-leaf rounding seeds mean the same in both packages.

Each wrapper launches its kernel for CUDA tensors and counts the launch
in its ``launches`` attribute; CPU tensors take the plain version
(``*_plain``), which computes on the flat layout with the kernels' op
order. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops.quantization import (
    BLOCK,
    LOG_FLOOR,
    _LOG_LEVELS,
    _INV_LOG_STEP,
    _LOG_LO,
    _LOG_STEP,
    _check_one_device,
    _n_rows,
    _symmetric_scale,
)

__all__ = [
    "FlatMeta",
    "FusedAdamW",
    "flatten_meta",
    "flatten_to_blocks",
    "fused_adamw",
    "tree_order",
    "unflatten_from_blocks",
]


# ---------------------------------------------------------------------------
# flat block layout
# ---------------------------------------------------------------------------


def tree_order(names) -> list:
    """Dotted param names (``"layers.wq"``) in the order ``jax.tree_util``
    flattens the nested dict they come from: keys sorted at each level."""
    return sorted(names, key=lambda name: name.split("."))


class FlatMeta(NamedTuple):
    shapes: tuple      # per-leaf shapes
    numels: tuple      # per-leaf element counts
    rows: tuple        # per-leaf row counts (leaf starts at a row edge)
    first_rows: tuple  # per-leaf first row
    total_rows: int    # sum of rows (no tail padding)


def flatten_meta(tensors: Sequence[torch.Tensor]) -> FlatMeta:
    shapes = tuple(tuple(t.shape) for t in tensors)
    numels = tuple(int(t.numel()) for t in tensors)
    rows = tuple(_n_rows(n) for n in numels)
    first = tuple(int(r) for r in np.cumsum((0,) + rows[:-1]))
    return FlatMeta(shapes, numels, rows, first, int(sum(rows)))


def flatten_to_blocks(tensors, meta: FlatMeta, device=None) -> torch.Tensor:
    """Leaves -> one f32 ``[total_rows, BLOCK]`` array, each leaf padded
    with zeros to its whole rows; a None leaf is all zeros."""
    if device is None:
        device = next(t.device for t in tensors if t is not None)
    out = torch.zeros((meta.total_rows, BLOCK), dtype=torch.float32,
                      device=device)
    flat = out.view(-1)
    for t, n, r0 in zip(tensors, meta.numels, meta.first_rows):
        if t is not None:
            flat[r0 * BLOCK:r0 * BLOCK + n] = t.detach().reshape(-1)
    return out


def unflatten_from_blocks(flat, meta: FlatMeta) -> list:
    """Inverse of :func:`flatten_to_blocks`: f32 views of the leaves."""
    vec = flat.reshape(-1)
    return [vec[r0 * BLOCK:r0 * BLOCK + n].view(shape)
            for shape, n, r0 in zip(meta.shapes, meta.numels,
                                    meta.first_rows)]


# ---------------------------------------------------------------------------
# step scalars
# ---------------------------------------------------------------------------


def _global_norm(grads) -> torch.Tensor:
    """optax.global_norm's order: per-leaf sums of squares in leaf
    order, summed, one sqrt. A None grad counts as zeros. Stays on the
    device (no host sync)."""
    sums = [torch.sum(torch.square(g.float())) for g in grads
            if g is not None]
    return torch.sqrt(sum(sums)) if sums else None


def _bias_correction(b: float, count: int) -> float:
    """``1 - b ** count`` in f32, as the JAX step computes it on the
    device (f32 pow, not Python's double)."""
    return float(np.float32(1) - np.float32(b) ** np.float32(count))


def _scalars(count: int, count_inc: int, lr, b1: float, b2: float,
             g_norm: Optional[torch.Tensor], device) -> torch.Tensor:
    """[-lr, bc1, bc2, g_norm] as a device f32[4]. A schedule ``lr`` is
    evaluated at the pre-increment ``count`` (optax.scale_by_schedule);
    the bias corrections use ``count_inc``. ``g_norm`` stays on the
    device, so building the scalars never waits for the backward."""
    lr_t = lr(count) if callable(lr) else lr
    head = torch.tensor([-float(lr_t), _bias_correction(b1, count_inc),
                         _bias_correction(b2, count_inc)],
                        dtype=torch.float32)
    device = torch.device(device)
    if device.type == "cuda":
        head = head.pin_memory().to(device, non_blocking=True)
    tail = (torch.zeros(1, dtype=torch.float32, device=device)
            if g_norm is None else g_norm.reshape(1).float())
    return torch.cat([head, tail])


def _clip(g, sc, clip_norm):
    """optax.clip_by_global_norm: where(norm < max, g, g / norm * max)."""
    if clip_norm is None:
        return g
    g_norm = sc[3]
    return torch.where(g_norm < clip_norm, g, (g / g_norm) * clip_norm)


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' on-card yardstick)
# ---------------------------------------------------------------------------


def fused_adamw32_plain(sc, params, grads, mu, nu, meta, *, b1, b2, eps,
                        weight_decay, clip_norm):
    """Plain version of K7 (``_fused_adam_kernel``'s op order). Updates
    ``params``, ``mu`` and ``nu`` (f32 [total_rows, BLOCK]) in place."""
    g = _clip(flatten_to_blocks(grads, meta, mu.device), sc, clip_norm)
    p = flatten_to_blocks(params, meta, mu.device)
    m = (1 - b1) * g + b1 * mu
    v = (1 - b2) * (g * g) + b2 * nu
    upd = (m / sc[1]) / (torch.sqrt(v / sc[2]) + eps)
    if weight_decay:
        upd = upd + weight_decay * p
    p = p + upd * sc[0]
    mu.copy_(m)
    nu.copy_(v)
    for dst, src in zip(params, unflatten_from_blocks(p, meta)):
        dst.copy_(src)


def _decode_log_analytic(nu_q, nu_scale):
    """The fused kernel's nu decode: exp(LOG_LO + (c - 1) * LOG_STEP),
    code 0 exact zero (the JAX table's analytic form)."""
    c = nu_q.float()
    code = torch.exp(_LOG_LO + (c - 1) * _LOG_STEP)
    return torch.where(nu_q == 0, 0.0, code) * nu_scale


def fused_adamw8_plain(sc, params, grads, mu_q, mu_scale, nu_q, nu_scale,
                       u, meta, *, b1, b2, eps, weight_decay, clip_norm):
    """Plain version of K8 (``_fused_adam8bit_kernel``'s op order).
    Updates ``params`` and the four state arrays in place."""
    dev = mu_q.device
    g = _clip(flatten_to_blocks(grads, meta, dev), sc, clip_norm)
    p = flatten_to_blocks(params, meta, dev)
    m = mu_q.float() * mu_scale
    v = _decode_log_analytic(nu_q, nu_scale)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    upd = (m / sc[1]) / (torch.sqrt(v / sc[2]) + eps)
    if weight_decay:
        upd = upd + weight_decay * p
    p = p + upd * sc[0]
    # mu: linear absmax int8, stochastic rounding floor(x + u)
    scale = _symmetric_scale(m.abs().amax(dim=-1, keepdim=True))
    mq = torch.clamp(torch.floor(m / scale + u), -127, 127)
    # nu: nearest log code (quantize_pos_log with the fused constants)
    vmax = v.amax(dim=-1, keepdim=True)
    vscale = torch.where(vmax == 0.0, 1.0, vmax)
    rel = v / vscale
    idx = torch.clamp(
        torch.round((torch.log(torch.clamp(rel, min=LOG_FLOOR)) - _LOG_LO)
                    * _INV_LOG_STEP) + 1,
        1, _LOG_LEVELS)
    mu_q.copy_(mq.to(torch.int8))
    mu_scale.copy_(scale)
    nu_q.copy_(torch.where(rel > 0.0, idx, 0.0).to(torch.uint8))
    nu_scale.copy_(vscale)
    for dst, src in zip(params, unflatten_from_blocks(p, meta)):
        dst.copy_(src)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_HYPER = [_F] * 6 + [_I, _F, _I]  # b1, 1-b1, b2, 1-b2, eps, wd, has_wd, clip, has_clip


def _is_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _check_arrays(name, *specs):
    """Raise unless each (tensor, dtype, shape) matches and is contiguous:
    the kernels index these arrays by the flat layout alone."""
    for t, dtype, shape in specs:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: got {t.dtype} {tuple(t.shape)}, want "
                             f"contiguous {dtype} {shape}")


def _leaf_table(params, grads, meta: FlatMeta, device) -> torch.Tensor:
    """int64 [n_leaves, 4] on the device: param pointer, grad pointer (0
    for a None grad), numel, first row. Copied from pinned host memory
    without a host sync. Checks that the leaves match ``meta``, which the
    kernels trust for their bounds."""
    if (len(params) != len(grads) or
            tuple(p.numel() for p in params) != meta.numels):
        raise ValueError("params and grads do not match the flat layout")
    for t in list(params) + [g for g in grads if g is not None]:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("fused AdamW kernels take contiguous float32 "
                            f"params and grads, got {t.dtype}")
    for p, g in zip(params, grads):
        if g is not None and g.shape != p.shape:
            raise ValueError(f"grad {tuple(g.shape)} for param "
                             f"{tuple(p.shape)}")
    rows = [[p.data_ptr(), 0 if g is None else g.data_ptr(), n, r0]
            for p, g, n, r0 in zip(params, grads, meta.numels,
                                   meta.first_rows)]
    table = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return table.to(device, non_blocking=True)


def _hyper(b1, b2, eps, weight_decay, clip_norm):
    return (b1, 1 - b1, b2, 1 - b2, eps, weight_decay or 0.0,
            int(bool(weight_decay)),
            0.0 if clip_norm is None else clip_norm,
            int(clip_norm is not None))


def fused_adamw32(sc, params, grads, mu, nu, meta, *, b1=0.9, b2=0.999,
                  eps=1e-8, weight_decay=0.0, clip_norm=None):
    """K7: one AdamW step with f32 moments over every leaf, in place."""
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              clip_norm=clip_norm)
    if _is_cpu(sc, mu, nu, *params, *grads):
        return fused_adamw32_plain(sc, params, grads, mu, nu, meta, **kw)
    _check_one_device("fused_adamw32", sc, mu, nu, *params, *grads)
    rows = (meta.total_rows, BLOCK)
    _check_arrays("fused_adamw32", (sc, torch.float32, (4,)),
                  (mu, torch.float32, rows), (nu, torch.float32, rows))
    table = _leaf_table(params, grads, meta, mu.device)
    _build.launch("fused_adamw32", "optim", [_P, _I, _L, _P, _P, _P] + _HYPER,
                  table.data_ptr(), len(params), meta.total_rows,
                  mu.data_ptr(), nu.data_ptr(), sc.data_ptr(),
                  *_hyper(b1, b2, eps, weight_decay, clip_norm))
    fused_adamw32.launches += 1


def fused_adamw8(sc, params, grads, mu_q, mu_scale, nu_q, nu_scale, u, meta,
                 *, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                 clip_norm=None):
    """K8: one AdamW step with 8-bit moments over every leaf, in place;
    ``u`` f32 [total_rows, BLOCK] is mu's stochastic-rounding field."""
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              clip_norm=clip_norm)
    state = (mu_q, mu_scale, nu_q, nu_scale, u)
    if _is_cpu(sc, *state, *params, *grads):
        return fused_adamw8_plain(sc, params, grads, *state, meta, **kw)
    _check_one_device("fused_adamw8", sc, *state, *params, *grads)
    rows, scales = (meta.total_rows, BLOCK), (meta.total_rows, 1)
    _check_arrays("fused_adamw8", (sc, torch.float32, (4,)),
                  (mu_q, torch.int8, rows), (nu_q, torch.uint8, rows),
                  (u, torch.float32, rows), (mu_scale, torch.float32, scales),
                  (nu_scale, torch.float32, scales))
    table = _leaf_table(params, grads, meta, mu_q.device)
    _build.launch("fused_adamw8", "optim",
                  [_P, _I, _L] + [_P] * 6 + _HYPER + [_F, _F, _F],
                  table.data_ptr(), len(params), meta.total_rows,
                  mu_q.data_ptr(), mu_scale.data_ptr(), nu_q.data_ptr(),
                  nu_scale.data_ptr(), u.data_ptr(), sc.data_ptr(),
                  *_hyper(b1, b2, eps, weight_decay, clip_norm),
                  _LOG_LO, _LOG_STEP, _INV_LOG_STEP)
    fused_adamw8.launches += 1


KERNELS = (fused_adamw32, fused_adamw8)
for _k in KERNELS:
    _k.launches = 0


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

Schedule = Callable[[int], float]


class FusedAdamW(torch.optim.Optimizer):
    """AdamW with grad-norm clipping as ONE kernel launch per step over
    every param (the ``fused_adamw`` GradientTransformation of the JAX
    package, applied in place).

    The update is JAX's: ``p += -lr * (adam + weight_decay * p)``, not
    torch AdamW's ``p *= 1 - lr * weight_decay``. A param without a grad
    counts as a zero grad: its moments still decay. ``bits=32`` keeps f32
    moments; ``bits=8`` keeps int8 linear mu and uint8 log-codebook nu
    with per-row scales. The 8-bit re-encode of mu rounds stochastically
    with a fresh uniform field each step: ``uniform(count, shape)`` when
    given (``count`` the post-increment step count), else ``torch.rand``
    from a generator seeded with ``(seed, count)``, so the state is a
    function of the count and the grads, as in JAX.

    State (``state_dict()["state"]``, string keys): ``count`` and the flat
    arrays ``mu``/``nu`` (bits 32) or ``mu_q``/``mu_scale``/``nu_q``/
    ``nu_scale`` (bits 8), ``[total_rows, BLOCK]`` / ``[total_rows, 1]``.
    """

    def __init__(self, params, lr: Union[float, Schedule] = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip_norm: Optional[float] = None,
                 bits: int = 32, seed: int = 0,
                 uniform: Optional[Callable] = None):
        if bits not in (32, 8):
            raise ValueError(f"bits must be 32 or 8, got {bits}")
        super().__init__(params, dict(lr=lr))
        if len(self.param_groups) != 1:
            raise ValueError("FusedAdamW takes one param group: its "
                             "hyperparameters hold for the whole tree")
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.bits, self.seed, self.uniform = bits, seed, uniform
        plist = self.param_groups[0]["params"]
        self.meta = flatten_meta(plist)
        dev, r = plist[0].device, self.meta.total_rows
        self.state["count"] = 0
        if bits == 32:
            self.state["mu"] = torch.zeros((r, BLOCK), device=dev)
            self.state["nu"] = torch.zeros((r, BLOCK), device=dev)
        else:
            self.state["mu_q"] = torch.zeros((r, BLOCK), dtype=torch.int8,
                                             device=dev)
            self.state["mu_scale"] = torch.ones((r, 1), device=dev)
            self.state["nu_q"] = torch.zeros((r, BLOCK), dtype=torch.uint8,
                                             device=dev)
            self.state["nu_scale"] = torch.ones((r, 1), device=dev)
        self._generator = None

    def _draw_uniform(self, count: int, device) -> torch.Tensor:
        shape = (self.meta.total_rows, BLOCK)
        if self.uniform is not None:
            return torch.as_tensor(self.uniform(count, shape),
                                   dtype=torch.float32).to(device)
        if self._generator is None:
            self._generator = torch.Generator(device=device)
        self._generator.manual_seed((self.seed << 32) + count)
        return torch.rand(shape, generator=self._generator, device=device)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = self.param_groups[0]["params"]
        grads = [p.grad for p in params]
        count = self.state["count"]
        count_inc = count + 1
        dev = params[0].device
        g_norm = _global_norm(grads) if self.clip_norm is not None else None
        sc = _scalars(count, count_inc, self.param_groups[0]["lr"], self.b1,
                      self.b2, g_norm, dev)
        kw = dict(b1=self.b1, b2=self.b2, eps=self.eps,
                  weight_decay=self.weight_decay, clip_norm=self.clip_norm)
        st = self.state
        if self.bits == 32:
            fused_adamw32(sc, params, grads, st["mu"], st["nu"], self.meta,
                          **kw)
        else:
            u = self._draw_uniform(count_inc, dev)
            fused_adamw8(sc, params, grads, st["mu_q"], st["mu_scale"],
                         st["nu_q"], st["nu_scale"], u, self.meta, **kw)
        st["count"] = count_inc
        return loss


def fused_adamw(
    learning_rate: Union[float, Schedule] = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = None,
    bits: int = 32,
    seed: int = 0,
) -> Callable[[Sequence[torch.Tensor]], FusedAdamW]:
    """``params -> FusedAdamW`` for ``auto_accelerate`` (as
    ``build_optimizer`` returns). ``learning_rate`` is a float or a
    schedule ``count -> lr`` evaluated at the pre-increment count."""
    if bits not in (32, 8):
        raise ValueError(f"bits must be 32 or 8, got {bits}")
    return lambda params: FusedAdamW(
        params, lr=learning_rate, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, clip_norm=clip_norm, bits=bits, seed=seed)
