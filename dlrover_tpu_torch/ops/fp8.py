"""fp8 matmul path: e4m3 forward operands, e5m2 gradients, per-tensor
scaling (port of dlrover_tpu/ops/fp8.py), and the switches that route the
models' matmuls through fp8 or int8.

- :func:`quantize_e4m3` / :func:`quantize_e5m2`: a per-tensor scale
  ``max(amax, 1e-12) / fmax`` and ``x / scale`` cast to ``float8_e4m3fn``
  / ``float8_e5m2`` (K15, ops/lowp.py).
- :func:`fp8_dot`: ``a @ b`` with both operands in e4m3 (current
  scaling), on the card one ``torch._scaled_mm`` on the fp8 tensor cores;
  the backward quantizes the cotangent to e5m2 and runs ``da = g b^T``
  and ``db = a^T g`` against the e4m3 operands. The forward keeps the
  e4m3 copies and their scales as the backward's residuals (the JAX
  package keeps ``a`` and ``b`` and quantizes them again: the same
  numbers, since quantizing is deterministic, at half the bytes and with
  no second amax pass).
- :func:`Fp8History` / :func:`fp8_dot_delayed`: delayed scaling, the
  scales from an amax window (TransformerEngine's recipe).
- :func:`qdot` / :func:`qeinsum`: ``a @ b`` / ``einsum``, quantized while
  :func:`quant_autocast` is active (set by ``auto_accelerate`` for
  ``Strategy.compute_dtype`` "fp8" or "int8"), site by site
  (``Strategy.quant_sites``). Only a 2-D right operand quantizes in
  :func:`qdot`; :func:`qeinsum` quantizes under "int8" only; an untagged
  site always quantizes.

The switches are a module flag read when the model runs (the JAX package
reads its flag at trace time). A checkpointed region recomputes its
forward inside the backward, after the context has exited:
parallel/remat.py captures the mode with :func:`capture` at the forward
and restores it for the recompute with :func:`restored`.

``fp8_dot`` is a dispatcher op (``torch.ops.dlrover_tpu_torch.fp8_dot``)
returning the product and its residuals, so that a remat policy can name
it, as the JAX package's policies name "qdot_out" and "qdot_res".
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from dlrover_tpu_torch.ops.lowp import (
    E4M3_MAX,
    E5M2_MAX,
    fp8_mm,
    quantize_fp8,
)
from dlrover_tpu_torch.ops.quantization import int8_dot, int8_einsum

__all__ = ["E4M3_MAX", "E5M2_MAX", "Fp8History", "capture", "fp8_autocast",
           "fp8_dot", "fp8_dot_delayed", "fp8_enabled", "fp8_is_enabled",
           "parse_quant_sites", "qdot", "qeinsum", "quant_autocast",
           "quant_mode", "quant_site_enabled", "quant_sites",
           "quantize_e4m3", "quantize_e5m2", "restored"]

QUANT_MODES = ("fp8", "int8")


class _Flag:
    mode: str | None = None  # None | "fp8" | "int8"
    # which tagged call sites quantize: None = all ("attn_qkv",
    # "attn_out", "mlp" in the models)
    sites: frozenset | None = None


def quant_mode() -> str | None:
    """The active low-precision mode."""
    return _Flag.mode


def quant_sites() -> frozenset | None:
    """The active site filter (None = every site quantizes)."""
    return _Flag.sites


def quant_site_enabled(site: str | None) -> bool:
    """Whether a tagged call site quantizes under the active filter.
    Untagged sites (``site=None``) always quantize."""
    return _Flag.sites is None or site is None or site in _Flag.sites


def parse_quant_sites(spec: str | None):
    """``Strategy.quant_sites`` string -> site filter (None = all)."""
    if spec is None or spec == "all" or spec == "":
        return None
    return frozenset(s.strip() for s in spec.split(",") if s.strip())


def fp8_enabled() -> bool:
    """Whether ANY quantization mode is active (the JAX package's name).
    Do not gate the einsum-form flash path with it: int8 keeps that path,
    only fp8 leaves it (``quant_mode() != "fp8"``)."""
    return _Flag.mode is not None


fp8_is_enabled = fp8_enabled


@contextlib.contextmanager
def quant_autocast(mode: str = "fp8", sites=None):
    """``qdot`` (and under "int8" ``qeinsum``) quantize while this is
    active. ``sites``: an iterable of site labels or a
    ``Strategy.quant_sites`` string; None = every site."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {mode!r}")
    if isinstance(sites, str):
        sites = parse_quant_sites(sites)
    elif sites is not None:
        sites = frozenset(sites)
    with restored((mode, sites)):
        yield


@contextlib.contextmanager
def _quant_disabled():
    """Force-disable quantization inside an active autocast region."""
    with restored((None, _Flag.sites)):
        yield


def fp8_autocast(enabled: bool = True):
    """``enabled=False`` force-disables any active mode (callers use it to
    keep a numerically sensitive matmul in the compute dtype inside an
    autocast region)."""
    return quant_autocast("fp8") if enabled else _quant_disabled()


def capture() -> tuple:
    """The active (mode, sites), for :func:`restored`."""
    return _Flag.mode, _Flag.sites


@contextlib.contextmanager
def restored(state: tuple):
    """Make ``state`` (from :func:`capture`) the active one while active."""
    prev = capture()
    _Flag.mode, _Flag.sites = state
    try:
        yield
    finally:
        _Flag.mode, _Flag.sites = prev


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------


def quantize_e4m3(x, scale=None):
    """``x`` through e4m3 with a per-tensor scale: (q float8_e4m3fn in
    ``x``'s shape, scale f32 0-d)."""
    q, _qt, scale = quantize_fp8(x, "e4m3", scale)
    return q, scale


def quantize_e5m2(x, scale=None):
    """``x`` through e5m2 with a per-tensor scale: (q float8_e5m2, scale)."""
    q, _qt, scale = quantize_fp8(x, "e5m2", scale)
    return q, scale


# ---------------------------------------------------------------------------
# fp8_dot
# ---------------------------------------------------------------------------

_NS = "dlrover_tpu_torch"


@torch.library.custom_op(
    f"{_NS}::fp8_dot", mutates_args=(),
    schema="(Tensor a, Tensor b, Tensor? a_scale, Tensor? b_scale) -> "
           "(Tensor, Tensor, Tensor, Tensor, Tensor)")
def fp8_dot_op(a, b, a_scale, b_scale):
    """``a [..., K] @ b [K, N]`` with both operands in e4m3, per-tensor
    scales (given, or from each operand's amax). Returns the product in
    the operands' promoted dtype and the residuals: a's codes transposed
    [K, M], its scale, b's codes [K, N], its scale."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    K, N = a.shape[-1], b.shape[-1]
    qa, qat, sa = quantize_fp8(a.reshape(-1, K), "e4m3", a_scale, "both")
    qb, qbt, sb = quantize_fp8(b, "e4m3", b_scale, "both")
    out = fp8_mm(qa, qbt.t(), sa, sb, out_dtype)
    # a given scale comes back as (a view of) the input: an op's outputs
    # must not alias its inputs
    sa = sa.clone() if a_scale is not None else sa
    sb = sb.clone() if b_scale is not None else sb
    return out.view(*a.shape[:-1], N), qat, sa, qb, sb


def _fp8_setup(ctx, inputs, output):
    a, b, _a_scale, _b_scale = inputs
    ctx.save_for_backward(*output[1:])
    ctx.shapes = (a.shape, a.dtype, b.dtype)


def _fp8_backward(ctx, g, *_res_grads):
    """The cotangent in e5m2 against the e4m3 residuals: ``da = g b^T``,
    ``db = a^T g`` (a batched lhs flattened to rows)."""
    a_shape, a_dtype, b_dtype = ctx.shapes
    qat, sa, qb, sb = ctx.saved_tensors
    qg, qgt, sg = quantize_fp8(g.reshape(-1, g.shape[-1]), "e5m2", None,
                               "both")
    da = fp8_mm(qg, qb.t(), sg, sb, g.dtype).view(a_shape)
    db = fp8_mm(qat, qgt.t(), sa, sg, g.dtype)
    return da.to(a_dtype), db.to(b_dtype), None, None


fp8_dot_op.register_autograd(_fp8_backward, setup_context=_fp8_setup)


def fp8_dot(a, b):
    """``a @ b`` with both operands rounded through e4m3 (current
    per-tensor scaling) and the backward cotangent through e5m2."""
    return fp8_dot_op(a, b, None, None)[0]


def qeinsum(spec, a, b, site: str | None = None):
    """``torch.einsum(spec, a, b)``, int8-quantized while
    ``quant_autocast("int8")`` is active and ``site`` passes the filter
    (fp8 never reaches the models' einsum sites: their einsum-form flash
    path yields to the qdot branch under fp8)."""
    if _Flag.mode == "int8" and quant_site_enabled(site):
        return int8_einsum(spec, a, b)
    return torch.einsum(spec, a, b)


def qdot(a, b, site: str | None = None):
    """``a @ b``, quantized while :func:`quant_autocast` is active and
    ``site`` passes the filter. Only the linear-layer shape (a 2-D
    weight on the right, an lhs of 2 or more dims) quantizes; anything
    else is the plain product."""
    if (_Flag.mode is not None and quant_site_enabled(site)
            and b.dim() == 2 and a.dim() >= 2):
        if _Flag.mode == "int8":
            return int8_dot(a, b)
        return fp8_dot(a, b)
    return a @ b


# ---------------------------------------------------------------------------
# delayed scaling (TransformerEngine recipe)
# ---------------------------------------------------------------------------


class Fp8History(NamedTuple):
    """Per-tensor amax history ring; scale = max(history) / fmax (1 /
    fmax while the history is all zeros). Caller state, threaded through
    the step like optimizer state."""

    amax_history: torch.Tensor  # [window] f32
    fmax: float

    @classmethod
    def create(cls, window: int = 16, fmax: float = E4M3_MAX, device=None):
        return cls(torch.zeros(window, dtype=torch.float32, device=device),
                   fmax)

    def scale(self):
        # an IEEE division: fmax is a leaf of the JAX package's history
        # (a traced value, not a constant XLA rewrites)
        amax = self.amax_history.max()
        return torch.where(amax > 0, amax, 1.0) / self.fmax

    def update(self, x) -> "Fp8History":
        amax = x.detach().abs().amax().float().reshape(1)
        hist = torch.cat([amax.to(self.amax_history.device),
                          self.amax_history[:-1]])
        return self._replace(amax_history=hist)


def fp8_dot_delayed(a, b, a_hist: Fp8History, b_hist: Fp8History):
    """``a @ b`` with the operand scales taken from amax histories (no
    same-step amax reduction). Returns (out, new_a_hist, new_b_hist).
    The backward is :func:`fp8_dot`'s (the cotangent in e5m2 with its own
    scale, against the e4m3 residuals of the history scales)."""
    out = fp8_dot_op(a, b, a_hist.scale(), b_hist.scale())[0]
    return out, a_hist.update(a), b_hist.update(b)
