"""Blockwise 8-bit quantization of optimizer state, and the int8
quantized matmul (port of dlrover_tpu/ops/quantization.py).

A tensor is read flat in blocks of ``BLOCK`` elements, one block a row of
a ``[rows, BLOCK]`` array, the last row zero-padded.

- :func:`quantize_int8` (K5) and :func:`dequantize_int8` (K6): linear
  absmax int8 per block, with stochastic rounding ``floor(x/scale + u)``
  for a uniform field ``u`` that the caller gives or that is drawn from
  an explicit ``torch.Generator``. Hand-written sm_90a kernels
  (``csrc/optim.cu``) for CUDA tensors; the plain versions
  (``*_plain``) for CPU tensors. No fallback from one to the other.
- :func:`quantize_pos_log` / :func:`dequantize_pos_log`: the log-spaced
  codebook for non-negative tensors (Adam's second moment). Plain jnp in
  the JAX package, plain torch here.

The int8 matmul (AQT-style, the low-precision compute path of
``compute_dtype="int8"``): :func:`int8_dot` and :func:`int8_einsum`
quantize both operands per channel (the amax over the contracted dims,
K16), multiply int8 x int8 -> int32 (``torch._int_mm`` on the card),
and dequantize in the epilogue (K17); their gradients are bf16 matmuls
against the dequantized int8 residuals (the straight-through rule). Each
is one dispatcher op (``torch.ops.dlrover_tpu_torch.int8_dot`` /
``int8_einsum``) returning the product and its residuals, so that a
remat policy can name it (parallel/remat.py). ops/lowp.py holds the
kernels and the GEMM call.

A division by a constant (``absmax / 127``, ``/ _LOG_STEP``) is a
multiplication by the constant's f32 reciprocal, because that is what
XLA compiles the JAX code to (its algebraic simplifier rewrites
``x / c``); the kernels do the same. Other divisions are IEEE ones.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops.lowp import (
    _symmetric_scale,
    dequantize_int32,
    int8_mm,
    per_channel_q,
    quantize_int8_channels,
)

BLOCK = 256  # quantization group size (elements)
LOG_FLOOR = 1e-12
_LOG_LEVELS = 255
# f32 log(LOG_FLOOR) and the log-space step between codes, as the JAX
# package computes them (equal in both of its forms, per leaf and fused)
_LOG_LO = float(np.log(np.float32(LOG_FLOOR)))
_LOG_STEP = float(np.float32(-_LOG_LO / (_LOG_LEVELS - 1)))
# f32 reciprocal of a constant divisor (see the module docstring)
_INV_LOG_STEP = float(np.float32(1) / np.float32(_LOG_STEP))


def _n_rows(numel: int) -> int:
    return -(-max(numel, 1) // BLOCK)


def _pad_to_blocks(flat):
    """Flat tensor -> ([rows, BLOCK] zero-padded, original length)."""
    n = flat.shape[0]
    pad = _n_rows(n) * BLOCK - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK), n


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' on-card yardstick)
# ---------------------------------------------------------------------------


def quantize_int8_plain(x, u, stochastic: bool = True):
    """Plain version of K5: (q int8 [rows, BLOCK], scales f32 [rows, 1])."""
    blocks, _n = _pad_to_blocks(x.reshape(-1).float())
    scale = _symmetric_scale(blocks.abs().amax(dim=-1, keepdim=True))
    scaled = blocks / scale
    rounded = torch.floor(scaled + u) if stochastic else torch.round(scaled)
    return torch.clamp(rounded, -127, 127).to(torch.int8), scale


def dequantize_int8_plain(q, scales, orig_shape):
    """Plain version of K6: f32 tensor of ``orig_shape``."""
    n = int(np.prod(orig_shape, dtype=np.int64))
    out = q.float() * scales
    return out.reshape(-1)[:n].reshape(orig_shape)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_L = ctypes.c_longlong


def quantize_int8(x, u=None, stochastic: bool = True, generator=None):
    """K5: blockwise absmax int8 quantization of ``x`` (read as f32).

    ``u`` is the rounding field, f32 [rows, BLOCK] in [0, 1), as the JAX
    kernel takes it; when it is None and ``stochastic``, it is drawn with
    ``torch.rand`` from ``generator``. Without ``stochastic`` rounding is
    to the nearest, half to even (``jnp.round``). Returns
    (q int8 [rows, BLOCK], scales f32 [rows, 1], orig_shape)."""
    shape = tuple(x.shape)
    rows = _n_rows(x.numel())
    if stochastic and u is None:
        u = torch.rand((rows, BLOCK), generator=generator, device=x.device)
    if not stochastic:
        u = None
    if u is not None and tuple(u.shape) != (rows, BLOCK):
        raise ValueError(f"quantize_int8: u {tuple(u.shape)}, want "
                         f"{(rows, BLOCK)}")
    if x.device.type == "cpu" and (u is None or u.device.type == "cpu"):
        q, scales = quantize_int8_plain(x, u, stochastic)
        return q, scales, shape
    _build.check_one_device("quantize_int8", x, u)
    if x.dtype != torch.float32 or (u is not None and u.dtype != torch.float32):
        raise TypeError("quantize_int8: the CUDA kernel takes float32")
    x = x.contiguous()
    u = None if u is None else u.contiguous()
    q = torch.empty((rows, BLOCK), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    _build.launch("quantize_int8", "optim", [_P, _L, _L, _P, _P, _P],
                  x.data_ptr(), x.numel(), rows,
                  None if u is None else u.data_ptr(), q.data_ptr(),
                  scales.data_ptr())
    quantize_int8.launches += 1
    return q, scales, shape


def dequantize_int8(q, scales, orig_shape, dtype=torch.float32):
    """K6: ``q * scales`` cut to ``orig_shape``, in ``dtype``."""
    orig_shape = tuple(orig_shape)
    if q.device.type == "cpu" and scales.device.type == "cpu":
        return dequantize_int8_plain(q, scales, orig_shape).to(dtype)
    _build.check_one_device("dequantize_int8", q, scales)
    rows = q.shape[0]
    if (q.dtype != torch.int8 or scales.dtype != torch.float32
            or tuple(q.shape) != (rows, BLOCK)
            or scales.numel() != rows):
        raise TypeError("dequantize_int8: the CUDA kernel takes int8 "
                        f"[rows, {BLOCK}] and f32 [rows, 1]")
    n = int(np.prod(orig_shape, dtype=np.int64))
    if n > rows * BLOCK:
        raise ValueError(f"dequantize_int8: {orig_shape} exceeds {rows} rows")
    q, scales = q.contiguous(), scales.contiguous()
    out = torch.empty(orig_shape, dtype=torch.float32, device=q.device)
    _build.launch("dequantize_int8", "optim", [_P, _P, _L, _L, _P],
                  q.data_ptr(), scales.data_ptr(), rows, n, out.data_ptr())
    dequantize_int8.launches += 1
    return out.to(dtype)


KERNELS = (quantize_int8, dequantize_int8)
for _k in KERNELS:
    _k.launches = 0


# ---------------------------------------------------------------------------
# log-codebook quantization (plain torch, as plain jnp in the JAX package)
# ---------------------------------------------------------------------------
#
# Non-negative tensors with a huge dynamic range (Adam's second moment)
# use a log-spaced codebook instead of linear absmax: linear absmax would
# zero small entries and the Adam denominator would collapse to eps.
# Index 0 is exact zero; indices 1..255 span [LOG_FLOOR, 1] * blockwise
# max geometrically.

_codebooks: dict = {}


def _log_codebook(device) -> torch.Tensor:
    """f32 [256]: 0, then geomspace(LOG_FLOOR, 1, 255) (computed in f64
    and rounded, as the JAX table). Cached per device, so that a step
    makes no host-to-device copy."""
    device = torch.device(device)
    code = _codebooks.get(device)
    if code is None:
        table = np.concatenate([[0.0], np.geomspace(LOG_FLOOR, 1.0,
                                                    _LOG_LEVELS)])
        code = torch.from_numpy(table.astype(np.float32)).to(device)
        _codebooks[device] = code
    return code


def quantize_pos_log(x):
    """Blockwise log-codebook quantization of a non-negative tensor.

    Returns (q uint8 [rows, BLOCK], scales f32 [rows, 1]): the nearest
    code in log space to ``x / max(block)``; only exact zeros map to 0."""
    blocks, _n = _pad_to_blocks(x.reshape(-1))
    absmax = blocks.amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0.0, 1.0, absmax)
    rel = blocks / scale
    log_rel = torch.log(torch.clamp(rel, min=LOG_FLOOR))
    idx = torch.clamp(
        torch.round((log_rel - _LOG_LO) * _INV_LOG_STEP) + 1,
        1, _LOG_LEVELS).to(torch.uint8)
    q = torch.where(rel > 0.0, idx, torch.zeros_like(idx))
    return q, scale.float()


def dequantize_pos_log(q, scales, orig_shape, dtype=torch.float32):
    """Codebook decode of :func:`quantize_pos_log`, cut to ``orig_shape``."""
    n = int(np.prod(orig_shape, dtype=np.int64))
    out = _log_codebook(q.device)[q.int()] * scales
    return out.reshape(-1)[:n].reshape(tuple(orig_shape)).to(dtype)


# ---------------------------------------------------------------------------
# int8 quantized matmul (AQT-style): the low-precision COMPUTE path
# ---------------------------------------------------------------------------
#
# Per-channel symmetric scales, int8 x int8 -> int32 accumulation,
# dequantize in the epilogue; gradients stay in the compute dtype,
# against the dequantized residuals. Every product runs as one 2-D GEMM:
# the left operand as [rows, contracted] (its per-row scales), the right
# one as [contracted, columns] (per-column scales), quantized by K16 with
# its codes transposed so that the contracted dim is contiguous in both.
#
# The residuals are the QUANTIZED operands and their scales, not the
# inputs: half the saved bytes, and the backward matmuls run against
# dequantize(q), the gradient of the function the forward computed.

_NS = "dlrover_tpu_torch"
_Q_OUT = "(Tensor, Tensor, Tensor, Tensor, Tensor)"


def _int8_gemm(a2d, b2d, out_dtype, product_first):
    """(out [M, N], qa [M, K], sa [M, 1], qbt [N, K], sb [1, N]) for the
    2-D product ``a2d @ b2d``."""
    qa, sa = quantize_int8_channels(a2d, "rows")
    qbt, sb = quantize_int8_channels(b2d, "cols")
    acc = int8_mm(qa, qbt)
    out = dequantize_int32(acc, sa, sb, out_dtype, product_first)
    return out, qa, sa, qbt, sb


def _dequantized(qa, sa, qbt, sb, dtype):
    """The residuals back in ``dtype``: ad [M, K] and bd transposed
    [N, K] (the JAX package's ``q.astype(dtype) * scale.astype(dtype)``)."""
    ad = qa.to(dtype) * sa.reshape(-1, 1).to(dtype)
    bdt = qbt.to(dtype) * sb.reshape(-1, 1).to(dtype)
    return ad, bdt


@torch.library.custom_op(f"{_NS}::int8_dot", mutates_args=(),
                         schema=f"(Tensor a, Tensor b) -> {_Q_OUT}")
def int8_dot_op(a, b):
    """``a [..., K] @ b [K, N]`` through int8 (the product and its
    residuals: qa [M, K], sa [M, 1], qb transposed [N, K], sb [1, N])."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    out, *res = _int8_gemm(a.reshape(-1, a.shape[-1]), b, out_dtype, False)
    return (out.view(*a.shape[:-1], b.shape[-1]), *res)


def _int8_dot_setup(ctx, inputs, output):
    a, b = inputs
    ctx.save_for_backward(*output[1:])
    ctx.shapes = (a.shape, a.dtype, b.dtype)


def _int8_dot_backward(ctx, g, *_res_grads):
    a_shape, a_dtype, b_dtype = ctx.shapes
    ad, bdt = _dequantized(*ctx.saved_tensors, g.dtype)
    g2 = g.reshape(-1, g.shape[-1])
    da = (g2 @ bdt).view(a_shape)
    db = ad.t() @ g2
    return da.to(a_dtype), db.to(b_dtype)


int8_dot_op.register_autograd(_int8_dot_backward,
                              setup_context=_int8_dot_setup)


def int8_dot(a, b):
    """``a @ b`` with int8 per-channel forward operands (int32
    accumulation): ``a`` [..., K] quantized per row, ``b`` [K, N] per
    column; straight-through gradients."""
    return int8_dot_op(a, b)[0]


# ---------------------------------------------------------------------------
# int8 quantized einsum: the einsum-form projection path
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _einsum_parts(spec: str, a_ndim: int, b_ndim: int):
    """Parse a two-operand einsum spec -> (a_sub, b_sub, out_sub,
    a_contract_dims, b_contract_dims). Validates that the spec is
    explicit and matmul-like (every input dim appears in the output or
    the other operand), as the JAX package does."""
    if "->" not in spec or "." in spec:
        raise ValueError(
            f"int8_einsum needs an explicit two-operand spec, got {spec!r}")
    lhs, out_sub = spec.split("->")
    a_sub, b_sub = lhs.split(",")
    if len(a_sub) != a_ndim or len(b_sub) != b_ndim:
        raise ValueError(f"spec {spec!r} does not match operand ranks "
                         f"({a_ndim}, {b_ndim})")
    a_c = tuple(i for i, ch in enumerate(a_sub) if ch not in out_sub)
    b_c = tuple(i for i, ch in enumerate(b_sub) if ch not in out_sub)
    for sub, other in ((a_sub, b_sub), (b_sub, a_sub)):
        for ch in sub:
            if ch not in out_sub and ch not in other:
                raise ValueError(
                    f"spec {spec!r}: dim {ch!r} is summed within one "
                    "operand - not a matmul-like einsum")
    return a_sub, b_sub, out_sub, a_c, b_c


def _scale_to_out(s, sub, out_sub):
    """Reshape a keepdims per-channel scale (shape of ``sub`` with
    contracted dims = 1) for broadcasting against the ``out_sub``-shaped
    einsum output (squeeze, transpose, reshape)."""
    keep = [(ch, d) for ch, d in zip(sub, s.shape) if ch in out_sub]
    s = s.reshape([d for _ch, d in keep])
    order = sorted(range(len(keep)), key=lambda i: out_sub.index(keep[i][0]))
    s = s.permute(order)
    dims = dict(keep)
    return s.reshape([dims.get(ch, 1) for ch in out_sub])


@functools.lru_cache(maxsize=None)
def _gemm_plan(spec: str, a_ndim: int, b_ndim: int):
    """The 2-D GEMM of a matmul-like spec: (a's permutation to
    [free..., contracted...], b's to [contracted..., free...], the
    output's permutation from [a free..., b free...] to ``out_sub``).
    A dim in both operands and the output (a batch dim) has no 2-D GEMM
    and raises."""
    a_sub, b_sub, out_sub, a_c, _b_c = _einsum_parts(spec, a_ndim, b_ndim)
    batch = [ch for ch in a_sub if ch in b_sub and ch in out_sub]
    if batch:
        raise NotImplementedError(
            f"int8_einsum {spec!r}: batch dims {batch} are not one 2-D GEMM "
            "(the models' specs have none)")
    a_free = [i for i, ch in enumerate(a_sub) if ch in out_sub]
    contracted = [a_sub[i] for i in a_c]
    b_free = [i for i, ch in enumerate(b_sub) if ch in out_sub]
    a_perm = a_free + list(a_c)
    b_perm = [b_sub.index(ch) for ch in contracted] + b_free
    mid = [a_sub[i] for i in a_free] + [b_sub[i] for i in b_free]
    out_perm = [mid.index(ch) for ch in out_sub]
    return a_perm, len(a_free), b_perm, len(contracted), out_perm


def _inverse(perm):
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return inv


@torch.library.custom_op(
    f"{_NS}::int8_einsum", mutates_args=(),
    schema=f"(str spec, Tensor a, Tensor b) -> {_Q_OUT}")
def int8_einsum_op(spec, a, b):
    """``einsum(spec, a, b)`` through int8 as one 2-D GEMM (the product,
    a view in ``spec``'s output order, and the residuals as
    :func:`int8_dot_op`'s)."""
    a_perm, n_af, b_perm, n_c, out_perm = _gemm_plan(spec, a.ndim, b.ndim)
    ap, bp = a.permute(a_perm), b.permute(b_perm)
    a_free, b_free = ap.shape[:n_af], bp.shape[n_c:]
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    out, *res = _int8_gemm(ap.reshape(math.prod(a_free), -1),
                           bp.reshape(-1, math.prod(b_free)), out_dtype, True)
    return (out.view(*a_free, *b_free).permute(out_perm), *res)


def _int8_einsum_setup(ctx, inputs, output):
    spec, a, b = inputs
    ctx.save_for_backward(*output[1:])
    ctx.meta = (spec, a.shape, b.shape, a.dtype, b.dtype)


def _int8_einsum_backward(ctx, g, *_res_grads):
    spec, a_shape, b_shape, a_dtype, b_dtype = ctx.meta
    a_perm, n_af, b_perm, n_c, out_perm = _gemm_plan(spec, len(a_shape),
                                                     len(b_shape))
    ad, bdt = _dequantized(*ctx.saved_tensors, g.dtype)
    M, N = ad.shape[0], bdt.shape[0]
    g2 = g.permute(_inverse(out_perm)).reshape(M, N)
    ap_shape = [a_shape[i] for i in a_perm]
    bp_shape = [b_shape[i] for i in b_perm]
    da = (g2 @ bdt).view(ap_shape).permute(_inverse(a_perm))
    db = (ad.t() @ g2).view(bp_shape).permute(_inverse(b_perm))
    return None, da.to(a_dtype), db.to(b_dtype)


int8_einsum_op.register_autograd(_int8_einsum_backward,
                                 setup_context=_int8_einsum_setup)


def int8_einsum(spec, a, b):
    """``torch.einsum(spec, a, b)`` with int8 per-channel forward
    operands (scales over each operand's contracted dims, int32
    accumulation) and straight-through gradients. The specs of the
    models (``bsd,dhk->bhsk``, ``bhsk,hkd->bsd``, ``bsd,dthk->tbhsk``)
    are one 2-D GEMM after a permute/reshape of each operand; the output
    is a view in the spec's order."""
    return int8_einsum_op(spec, a, b)[0]


def int8_einsum_reference(spec, a, b):
    """The JAX package's ``_int8_einsum_impl`` written out: per-channel
    codes over each operand's contracted dims (a tuple of axes), the
    exact integer einsum (float64), the scales' product broadcast by
    :func:`_scale_to_out`. The yardstick of :func:`int8_einsum`'s 2-D
    route."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    a_sub, b_sub, out_sub, a_c, b_c = _einsum_parts(spec, a.ndim, b.ndim)
    qa, sa = per_channel_q(a, a_c)
    qb, sb = per_channel_q(b, b_c)
    acc = torch.einsum(spec, qa.double(), qb.double()).to(torch.int32)
    scale = _scale_to_out(sa, a_sub, out_sub) * _scale_to_out(sb, b_sub,
                                                              out_sub)
    return (acc.float() * scale).to(out_dtype)
