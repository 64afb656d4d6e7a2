"""The quantize kernels and GEMM calls of low-precision compute (the
port's ops/fp8.py and the int8 matmul half of ops/quantization.py).

- :func:`quantize_fp8` (K15): a per-tensor scale ``max(amax, 1e-12) /
  fmax`` and ``x / scale`` cast to ``float8_e4m3fn`` or ``float8_e5m2``,
  the codes in ``x``'s layout, transposed, or both.
- :func:`quantize_int8_channels` (K16): symmetric int8 per channel, the
  amax over each row (an activation's contracted dim) or each column (a
  weight's), ``round`` half to even and a clamp to +-127; a column's
  codes come out transposed, the contracted dim contiguous.
- :func:`dequantize_int32` (K17): the int8 GEMM's epilogue, the int32
  products times the two per-channel scales.

Hand-written sm_90a kernels (``csrc/lowp.cu``) for CUDA tensors; the
plain versions (``*_plain``) for CPU tensors. No fallback from one to
the other: a CUDA tensor the kernel does not take raises. They replace no
TPU kernel: on the TPU, XLA fuses these chains into the dots.

The GEMMs themselves are PyTorch's calls, as the JAX package leaves its
dots to XLA: :func:`fp8_mm` is ``torch._scaled_mm`` (e4m3 x e4m3, e5m2 x
e4m3, e4m3 x e5m2 with f32 per-tensor scales), :func:`int8_mm` is
``torch._int_mm`` (int8 x int8 -> int32). On the CPU each is the plain
computation the JAX package writes: the dequantized operands multiplied
(fp8), the exact integer products (int8, through float64, exact below
2^53).

Numerics follow the JAX code as XLA compiles it under jit (its train
step): a division by a constant (``amax / 448``, ``amax / 127``) is a
product with the constant's f32 reciprocal; the division by a scale is an
IEEE one; the fp8 casts do not saturate (e4m3 overflows to NaN, e5m2 to
inf), as ml_dtypes' casts; ``torch``'s own e4m3 cast saturates, so the
plain version sends values past e4m3's rounding range to NaN first.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dlrover_tpu_torch.ops import _build

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
# e4m3fn: 464 (halfway between 448 and the NaN code) rounds to 448 (ties
# to even); anything larger in magnitude is NaN
_E4M3_NAN_ABOVE = 464.0
FP8_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
_FMAX = {"e4m3": E4M3_MAX, "e5m2": E5M2_MAX}
# f32 reciprocals of the constant divisors (see the module docstring)
_INV_FMAX = {fmt: float(np.float32(1) / np.float32(m))
             for fmt, m in _FMAX.items()}
_INV_127 = float(np.float32(1) / np.float32(127))
_AMAX_BLOCKS = 1024  # K15's partials (csrc/lowp.cu AMAX_BLOCKS)
# K16's columns mode (csrc/lowp.cu): strips, rows per amax block
_COL_STRIP, _MAX_STRIPS, _CHUNK_ROWS = 64, 4096, 256
_LAYOUTS = ("row", "col", "both")


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' on-card yardstick)
# ---------------------------------------------------------------------------


def fp8_scale_plain(x, fmt: str = "e4m3"):
    """The per-tensor scale: ``max(amax(|x|), 1e-12) / fmax``, f32 0-d."""
    amax = x.abs().amax().float()
    return torch.clamp_min(amax, 1e-12) * _INV_FMAX[fmt]


def quantize_fp8_plain(x, fmt: str = "e4m3", scale=None, layout="row"):
    """Plain version of K15: (q, qt, scale). ``q`` is ``x / scale`` cast
    to ``fmt`` in ``x``'s shape (``layout`` "row" or "both", else None);
    ``qt`` the codes of ``x`` viewed as [rows, last dim], transposed and
    contiguous (``layout`` "col" or "both", else None)."""
    if scale is None:
        scale = fp8_scale_plain(x, fmt)
    y = x.float() / scale
    if fmt == "e4m3":
        y = torch.where(y.abs() > _E4M3_NAN_ABOVE, float("nan"), y)
    q = y.to(FP8_DTYPES[fmt])
    qt = (q.reshape(-1, x.shape[-1]).t().contiguous()
          if layout in ("col", "both") else None)
    return (q if layout in ("row", "both") else None), qt, scale


def _symmetric_scale(absmax):
    """absmax -> int8 scale with the zero-channel guard."""
    return torch.where(absmax == 0.0, 1.0, absmax * _INV_127)


def per_channel_q(x, axis):
    """Symmetric int8 quantization along ``axis`` (the contracted dim or
    dims: an int or a tuple of ints). Returns (q int8, scale f32 with
    ``axis`` kept as size 1), the JAX package's ``_per_channel_q``."""
    xf = x.float()
    scale = _symmetric_scale(xf.abs().amax(dim=axis, keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8_channels_plain(x, channels: str = "rows"):
    """Plain version of K16 on a 2-D ``x`` [R, C]: ``"rows"`` gives (q
    [R, C], scale [R, 1]), ``"cols"`` (q transposed [C, R], scale [1,
    C])."""
    if channels == "rows":
        return per_channel_q(x, -1)
    q, scale = per_channel_q(x, 0)
    return q.t().contiguous(), scale


def dequantize_int32_plain(acc, sa, sb, dtype, product_first=False):
    """Plain version of K17: ``acc [M, N] * sa [M] * sb [N]`` in f32 (or
    ``acc * (sa * sb)``), cast to ``dtype``."""
    sa, sb = sa.reshape(-1, 1), sb.reshape(1, -1)
    if product_first:
        return (acc.float() * (sa * sb)).to(dtype)
    return (acc.float() * sa * sb).to(dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float


def _operand(name, x, dtypes=(torch.bfloat16, torch.float32)):
    """``x`` as a contiguous CUDA tensor of a dtype the kernel takes, and
    whether it is 16-byte aligned."""
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: the CUDA kernel takes "
                        f"{', '.join(map(str, dtypes))}, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty operand")
    x = x.contiguous()
    return x, x.data_ptr() % 16 == 0


def quantize_fp8(x, fmt: str = "e4m3", scale=None, layout: str = "row"):
    """K15: (q, qt, scale) as :func:`quantize_fp8_plain`. ``scale`` (an
    f32 tensor of one element on ``x``'s device) skips the amax launch;
    without it two launches run, the first writing the scale to a device
    tensor (no host sync)."""
    if fmt not in FP8_DTYPES:
        raise ValueError(f"unknown fp8 format {fmt!r}: e4m3 | e5m2")
    if layout not in _LAYOUTS:
        raise ValueError(f"layout {layout!r}: row | col | both")
    if x.device.type == "cpu" and (scale is None or
                                   scale.device.type == "cpu"):
        return quantize_fp8_plain(x, fmt, scale, layout)
    _build.check_one_device("quantize_fp8", x, scale)
    x, aligned = _operand("quantize_fp8", x)
    R = x.numel() // x.shape[-1]
    C = x.shape[-1]
    if scale is not None and (scale.dtype != torch.float32
                              or scale.numel() != 1):
        raise TypeError("quantize_fp8: scale must be one f32 element")
    dtype = FP8_DTYPES[fmt]
    q = (torch.empty(x.shape, dtype=dtype, device=x.device)
         if layout != "col" else None)
    qt = (torch.empty((C, R), dtype=dtype, device=x.device)
          if layout != "row" else None)
    out_scale, partial = None, None
    if scale is None:
        out_scale = torch.empty((), dtype=torch.float32, device=x.device)
        partial = torch.empty(_AMAX_BLOCKS, dtype=torch.float32,
                              device=x.device)
    vec_ok = int(aligned and C % 8 == 0 and R % 16 == 0)
    _build.launch(
        "quantize_fp8", "lowp", [_P, _I, _L, _L, _I, _F, _P, _P, _P, _P, _P,
                                 _I],
        x.data_ptr(), int(x.dtype == torch.bfloat16), R, C,
        int(fmt == "e5m2"), _INV_FMAX[fmt],
        None if scale is None else scale.contiguous().data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if out_scale is None else out_scale.data_ptr(),
        None if q is None else q.data_ptr(),
        None if qt is None else qt.data_ptr(), vec_ok)
    quantize_fp8.launches += 1
    return q, qt, (out_scale if scale is None else scale.reshape(()))


def quantize_int8_channels(x, channels: str = "rows"):
    """K16 on a 2-D ``x`` [R, C]: as :func:`quantize_int8_channels_plain`
    (``"rows"``: q [R, C] and scale [R, 1]; ``"cols"``: q transposed
    [C, R] and scale [1, C])."""
    if channels not in ("rows", "cols"):
        raise ValueError(f"channels {channels!r}: rows | cols")
    if x.dim() != 2:
        raise ValueError(f"quantize_int8_channels: a 2-D operand, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_channels_plain(x, channels)
    x, aligned = _operand("quantize_int8_channels", x)
    R, C = x.shape
    if channels == "rows":
        q = torch.empty((R, C), dtype=torch.int8, device=x.device)
        scale = torch.empty((R, 1), dtype=torch.float32, device=x.device)
        vec_ok = int(aligned and C % 8 == 0)
        partial = None
    else:
        if -(-C // _COL_STRIP) > _MAX_STRIPS:
            raise ValueError(f"quantize_int8_channels: {C} columns, the "
                             f"kernel takes {_COL_STRIP * _MAX_STRIPS}")
        q = torch.empty((C, R), dtype=torch.int8, device=x.device)
        scale = torch.empty((1, C), dtype=torch.float32, device=x.device)
        partial = torch.empty((-(-R // _CHUNK_ROWS), C), dtype=torch.float32,
                              device=x.device)
        vec_ok = int(aligned and C % 8 == 0)
    _build.launch("quantize_int8_channels", "lowp",
                  [_P, _I, _L, _L, _I, _P, _P, _P, _I],
                  x.data_ptr(), int(x.dtype == torch.bfloat16), R, C,
                  int(channels == "cols"), q.data_ptr(), scale.data_ptr(),
                  None if partial is None else partial.data_ptr(), vec_ok)
    quantize_int8_channels.launches += 1
    return q, scale


def dequantize_int32(acc, sa, sb, dtype, product_first=False):
    """K17: ``acc [M, N] * sa * sb`` (or ``acc * (sa * sb)``) in
    ``dtype`` (bf16 or f32 on the card), sa with M elements and sb with
    N."""
    if acc.device.type == "cpu" and sa.device.type == "cpu":
        return dequantize_int32_plain(acc, sa, sb, dtype, product_first)
    _build.check_one_device("dequantize_int32", acc, sa, sb)
    M, N = acc.shape
    if (acc.dtype != torch.int32 or sa.dtype != torch.float32
            or sb.dtype != torch.float32 or sa.numel() != M
            or sb.numel() != N):
        raise TypeError("dequantize_int32: the CUDA kernel takes int32 "
                        "[M, N] and f32 scales of M and N elements")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dequantize_int32: bf16 or f32 out, got {dtype}")
    acc, sa, sb = acc.contiguous(), sa.contiguous(), sb.contiguous()
    out = torch.empty((M, N), dtype=dtype, device=acc.device)
    vec_ok = int(N % 4 == 0 and acc.data_ptr() % 16 == 0)
    _build.launch("dequantize_int32", "lowp",
                  [_P, _L, _L, _P, _P, _I, _I, _P, _I],
                  acc.data_ptr(), M, N, sa.data_ptr(), sb.data_ptr(),
                  int(product_first), int(dtype == torch.bfloat16),
                  out.data_ptr(), vec_ok)
    dequantize_int32.launches += 1
    return out


KERNELS = (quantize_fp8, quantize_int8_channels, dequantize_int32)
for _k in KERNELS:
    _k.launches = 0


# ---------------------------------------------------------------------------
# the GEMMs (PyTorch's calls on the card, plain math on the CPU)
# ---------------------------------------------------------------------------


def dequantize_fp8(q, scale, dtype):
    """``q`` and its per-tensor scale back in ``dtype``: the JAX package's
    ``_dq`` (the product in ``dtype``)."""
    return q.float().to(dtype) * scale.to(dtype)


def _scaled_mm(x, y, sx, sy, out_dtype):
    """``torch._scaled_mm``, whose signature and return value changed
    between releases: keyword scales, and the product alone."""
    out = torch._scaled_mm(x, y, scale_a=sx.reshape(()).float(),
                           scale_b=sy.reshape(()).float(),
                           out_dtype=out_dtype)
    return out[0] if isinstance(out, tuple) else out


def fp8_mm(x, y, sx, sy, out_dtype):
    """``(x * sx) @ (y * sy)`` in ``out_dtype`` for fp8 ``x`` [M, K] and
    ``y`` [K, N] with per-tensor scales. On the card ``torch._scaled_mm``:
    ``x`` row-major, ``y`` column-major (``y.t()`` contiguous), every dim
    a multiple of 16, not both e5m2; anything else raises (no padding).
    On the CPU the JAX package's math: both operands dequantized to
    ``out_dtype``, then multiplied."""
    if x.device.type == "cpu":
        return dequantize_fp8(x, sx, out_dtype) @ dequantize_fp8(
            y, sy, out_dtype)
    (M, K), (K2, N) = x.shape, y.shape
    if K != K2:
        raise ValueError(f"fp8_mm: [{M}, {K}] @ [{K2}, {N}]")
    if M % 16 or K % 16 or N % 16:
        raise ValueError(f"fp8_mm: torch._scaled_mm wants every dim a "
                         f"multiple of 16, got M={M} K={K} N={N}")
    if not x.is_contiguous() or not y.t().is_contiguous():
        raise ValueError("fp8_mm: x row-major and y column-major")
    if x.dtype == y.dtype == torch.float8_e5m2:
        raise TypeError("fp8_mm: e5m2 x e5m2 has no tensor-core product")
    return _scaled_mm(x, y, sx, sy, out_dtype)


def int8_mm(qa, qbt):
    """int32 ``qa [M, K] @ qbt.t()`` for int8 ``qa`` and ``qbt`` [N, K]
    (the second operand column-major, the contracted dim contiguous in
    both). On the card ``torch._int_mm``: M above 16, K and N multiples
    of 8, else it raises (no padding). On the CPU the exact products
    through float64."""
    (M, K), (N, K2) = qa.shape, qbt.shape
    if K != K2:
        raise ValueError(f"int8_mm: [{M}, {K}] @ [{K2}, {N}]")
    if qa.device.type == "cpu":
        return (qa.double() @ qbt.double().t()).to(torch.int32)
    if M <= 16 or K % 8 or N % 8:
        raise ValueError(f"int8_mm: torch._int_mm wants M > 16 and K, N "
                         f"multiples of 8, got M={M} K={K} N={N}")
    return torch._int_mm(qa.contiguous(), qbt.contiguous().t())
