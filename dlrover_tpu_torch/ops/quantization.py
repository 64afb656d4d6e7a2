"""Blockwise 8-bit quantization of optimizer state (port of
dlrover_tpu/ops/quantization.py, the optimizer-state half).

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

The int8 matmul paths of the JAX module (``int8_dot``, ``int8_einsum``)
are not ported yet (ROADMAP Queue 1 item 12).

A division by a constant (``absmax / 127``, ``/ _LOG_STEP``) is a
multiplication by the constant's f32 reciprocal, because that is what
XLA compiles the JAX code to (its algebraic simplifier rewrites
``x / c``); the kernels do the same. Other divisions are IEEE ones.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dlrover_tpu_torch.ops import _build

BLOCK = 256  # quantization group size (elements)
LOG_FLOOR = 1e-12
_LOG_LEVELS = 255
# f32 log(LOG_FLOOR) and the log-space step between codes, as the JAX
# package computes them (equal in both of its forms, per leaf and fused)
_LOG_LO = float(np.log(np.float32(LOG_FLOOR)))
_LOG_STEP = float(np.float32(-_LOG_LO / (_LOG_LEVELS - 1)))
# f32 reciprocals of the constant divisors (see the module docstring)
_INV_127 = float(np.float32(1) / np.float32(127))
_INV_LOG_STEP = float(np.float32(1) / np.float32(_LOG_STEP))


def _n_rows(numel: int) -> int:
    return -(-max(numel, 1) // BLOCK)


def _symmetric_scale(absmax):
    """absmax -> int8 scale with the zero-block guard."""
    return torch.where(absmax == 0.0, 1.0, absmax * _INV_127)


def _pad_to_blocks(flat):
    """Flat tensor -> ([rows, BLOCK] zero-padded, original length)."""
    n = flat.shape[0]
    pad = _n_rows(n) * BLOCK - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK), n


def _check_one_device(name, *tensors):
    """Raise unless every tensor is on one device: the kernel path is
    taken when any of them is off the CPU, so a CPU tensor among them is
    a mixed-device call."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: mixed devices {sorted(map(str, devices))}")


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
    _check_one_device("quantize_int8", x, u)
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
    _check_one_device("dequantize_int8", q, scales)
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
