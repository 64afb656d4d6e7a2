"""Flash attention on hand-written Hopper kernels ([B, H, S, Dh] layout).

The JAX package runs attention as Pallas TPU kernels
(dlrover_tpu/ops/attention.py). Here the same function runs as four
CUDA kernels written for sm_90a (sources in ``csrc/``, built by
``_build``):

- ``flash_fwd`` (K1): o and lse, rope applied inside the kernel.
- ``flash_bwd_preprocess`` (K2): delta = rowsum(dO * O).
- ``flash_bwd_dq`` (K3): dq, q-major, un-roped in the kernel.
- ``flash_bwd_dkv`` (K4): dk and dv at kv-head width, kv-major, dk
  un-roped in the kernel.

Each wrapper launches its kernel for CUDA tensors and counts the launch
in its ``launches`` attribute; for CPU tensors it runs the kernel's
plain PyTorch version (``*_plain``), which holds the same math in f32.
There is no fallback from one to the other: a CUDA tensor the kernel
does not take (dtype, head_dim) raises.

:func:`flash_attention` ties them together in a ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIM = 128  # the head_dim the CUDA kernels are built for


# ---------------------------------------------------------------------------
# plain versions (f32 math; the CPU path and the kernels' on-card yardstick)
# ---------------------------------------------------------------------------


def _rope(x, cos, sin):
    """rope(x) = x * C + rotate_half(x) * S; x [B,H,S,D], tables [B,S,D]
    full width. Returns f32."""
    x = x.float()
    c, s = cos[:, None].float(), sin[:, None].float()
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rot * s


def _unrope(g, cos, sin):
    """Transpose of :func:`_rope` applied to a gradient g (f32)."""
    c, s = cos[:, None].float(), sin[:, None].float()
    gs = g * s
    half = g.shape[-1] // 2
    return g * c + torch.cat([gs[..., half:], -gs[..., :half]], dim=-1)


def _visible(q_len, kv_len, causal, device):
    """[q_len, kv_len] bool: end-aligned causal visibility (all True
    without causality), as in the JAX kernels' _block_mask."""
    if not causal:
        return torch.ones(q_len, kv_len, dtype=torch.bool, device=device)
    rows = torch.arange(q_len, device=device)[:, None]
    cols = torch.arange(kv_len, device=device)[None, :]
    return cols <= rows + (kv_len - q_len)


def _operands(q, k, v, rope_cos, rope_sin):
    """f32 q/k (roped when tables are given) and k/v repeated to q's
    head count."""
    group = q.shape[1] // k.shape[1]
    if rope_cos is not None:
        qf, kf = _rope(q, rope_cos, rope_sin), _rope(k, rope_cos, rope_sin)
    else:
        qf, kf = q.float(), k.float()
    vf = v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    return qf, kf, vf


def _probs(qf, kf, lse, causal, sm_scale):
    """P = exp(S * scale - lse) with invisible entries exactly 0."""
    mask = _visible(qf.shape[2], kf.shape[2], causal, qf.device)
    s = qf @ kf.transpose(-1, -2) * sm_scale
    return torch.where(mask, torch.exp(s - lse[..., None]), 0.0)


def flash_fwd_plain(q, k, v, rope_cos, rope_sin, causal, sm_scale):
    """Plain version of K1: (o in q.dtype, lse f32 [B, H, S]). A row that
    sees no key gets o = 0 and lse = -1e30, as in the kernel."""
    qf, kf, vf = _operands(q, k, v, rope_cos, rope_sin)
    mask = _visible(q.shape[2], k.shape[2], causal, q.device)
    s = (qf @ kf.transpose(-1, -2) * sm_scale).masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, 1.0, l)
    o = (p @ vf) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_bwd_preprocess_plain(do, o):
    """Plain version of K2: delta = rowsum(do * o), f32 [B, H, S]."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, rope_cos, rope_sin, causal,
                       sm_scale):
    """Plain version of K3: dq (q.dtype), un-roped."""
    qf, kf, vf = _operands(q, k, v, rope_cos, rope_sin)
    p = _probs(qf, kf, lse, causal, sm_scale)
    ds = p * (do.float() @ vf.transpose(-1, -2) - delta[..., None])
    dq = ds @ kf * sm_scale
    if rope_cos is not None:
        dq = _unrope(dq, rope_cos, rope_sin)
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, rope_cos, rope_sin, causal,
                        sm_scale):
    """Plain version of K4: (dk, dv) at kv-head width, dk un-roped."""
    qf, kf, vf = _operands(q, k, v, rope_cos, rope_sin)
    p = _probs(qf, kf, lse, causal, sm_scale)
    dof = do.float()
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    dv = p.transpose(-1, -2) @ dof
    dk = ds.transpose(-1, -2) @ qf * sm_scale
    B, KVH, S, D = k.shape
    group = q.shape[1] // KVH
    dk = dk.view(B, KVH, group, S, D).sum(dim=2)
    dv = dv.view(B, KVH, group, S, D).sum(dim=2)
    if rope_cos is not None:
        dk = _unrope(dk, rope_cos, rope_sin)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry -> (library, argtypes)
_ENTRIES = {
    "flash_fwd": ("flash_fwd", [_P] * 7 + [_I] * 5 + [_L] * 9 + [_I, _F, _P]),
    "flash_bwd_preprocess": ("flash_bwd",
                             [_P] * 3 + [_I] * 3 + [_L] * 6 + [_P]),
    "flash_bwd_dq": ("flash_bwd",
                     [_P] * 9 + [_I] * 5 + [ctypes.POINTER(_L), _I, _F, _P]),
    "flash_bwd_dkv": ("flash_bwd",
                      [_P] * 10 + [_I] * 5 + [ctypes.POINTER(_L), _I, _F, _P]),
}
_bound: dict = {}


def _launch(symbol: str, *args) -> None:
    """Call a C entry (building and binding its library at first use) and
    raise if it reports a CUDA error; the launch itself is asynchronous on
    the current stream."""
    fn = _bound.get(symbol)
    if fn is None:
        from dlrover_tpu_torch.ops import _build

        library, argtypes = _ENTRIES[symbol]
        fn = getattr(_build.load(library), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _bound[symbol] = fn
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err} at launch")


def _rows(t):
    """A [B, heads, S, D] bf16 CUDA operand the kernels can read through
    strides: rows contiguous, 16-byte aligned. Anything else is copied
    to a contiguous tensor first. Returns (tensor, (sb, sh, ss))."""
    aligned = (
        t.stride(3) == 1 and t.data_ptr() % 16 == 0
        and all(s % 8 == 0 for s in t.stride()[:3])
    )
    if not aligned:
        t = t.contiguous()
    return t, tuple(t.stride()[:3])


def _check(name, q, k, *others):
    """Raise for what the CUDA kernels do not take."""
    for t in (q, k) + others:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: mixed devices ({t.device})")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                            f"{t.dtype}")
    if q.shape[-1] != HEAD_DIM or k.shape[-1] != HEAD_DIM:
        raise NotImplementedError(
            f"{name}: the CUDA kernel is built for head_dim {HEAD_DIM}, got "
            f"{q.shape[-1]}")


def _table_ptrs(q, k, rope_cos, rope_sin):
    """Contiguous [B, S, D] rope tables and their pointers (None, None
    without rope). The kernels index the tables by position, so they
    must cover exactly q's batch and length, with q_len == kv_len."""
    if rope_cos is None:
        return (None, None), (None, None)
    want = (q.shape[0], q.shape[2], q.shape[3])
    if (q.shape[2] != k.shape[2] or tuple(rope_cos.shape) != want
            or tuple(rope_sin.shape) != want):
        raise ValueError(
            f"fused rope needs q_len == kv_len and [B, S, D] {want} "
            f"tables, got kv_len {k.shape[2]}, tables "
            f"{tuple(rope_cos.shape)} / {tuple(rope_sin.shape)}")
    tables = (rope_cos.contiguous(), rope_sin.contiguous())
    return tables, tuple(t.data_ptr() for t in tables)


def flash_fwd(q, k, v, rope_cos, rope_sin, causal, sm_scale):
    """K1: (o [B,H,S,D] q.dtype, lse f32 [B,H,S])."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, rope_cos, rope_sin, causal, sm_scale)
    _check("flash_fwd", q, k, v, rope_cos, rope_sin)
    (q, sq), (k, sk), (v, sv) = _rows(q), _rows(k), _rows(v)
    B, H, S, D = q.shape
    _tables, (pc, ps) = _table_ptrs(q, k, rope_cos, rope_sin)
    o = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), pc, ps,
            o.data_ptr(), lse.data_ptr(), B, H, k.shape[1], S, k.shape[2],
            *sq, *sk, *sv, int(causal), float(sm_scale))
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_preprocess(do, o):
    """K2: delta = rowsum(do * o), f32 [B, H, S]."""
    if do.device.type == "cpu":
        return flash_bwd_preprocess_plain(do, o)
    _check("flash_bwd_preprocess", do, o)
    if do.shape != o.shape:
        raise ValueError(f"flash_bwd_preprocess: do {tuple(do.shape)} and "
                         f"o {tuple(o.shape)} differ")
    (do, sd), (o, so) = _rows(do), _rows(o)
    B, H, S, _ = do.shape
    delta = torch.empty((B, H, S), dtype=torch.float32, device=do.device)
    _launch("flash_bwd_preprocess", do.data_ptr(), o.data_ptr(),
            delta.data_ptr(), B, H, S, *sd, *so)
    flash_bwd_preprocess.launches += 1
    return delta


def _launch_bwd(symbol, outs, q, k, v, do, lse, delta, rope_cos, rope_sin,
                causal, sm_scale):
    """Shared launch of K3/K4: both C entries take (q, k, v, do, lse,
    delta, cos, sin, *outs, B, H, KVH, q_len, kv_len, strides, causal,
    scale, stream)."""
    _check(symbol, q, k, v, do, rope_cos, rope_sin)
    (q, sq), (k, sk), (v, sv), (do, sd) = (
        _rows(q), _rows(k), _rows(v), _rows(do))
    lse, delta = lse.contiguous(), delta.contiguous()
    _tables, (pc, ps) = _table_ptrs(q, k, rope_cos, rope_sin)
    strides = (ctypes.c_longlong * 12)(*sq, *sk, *sv, *sd)
    B, H, q_len, _ = q.shape
    _launch(symbol, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), pc, ps,
            *(t.data_ptr() for t in outs), B, H, k.shape[1], q_len,
            k.shape[2], strides, int(causal), float(sm_scale))


def flash_bwd_dq(q, k, v, do, lse, delta, rope_cos, rope_sin, causal,
                 sm_scale):
    """K3: dq [B,H,S,D] in q.dtype, un-roped."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, rope_cos,
                                  rope_sin, causal, sm_scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_bwd_dq", (dq,), q, k, v, do, lse, delta, rope_cos,
                rope_sin, causal, sm_scale)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, rope_cos, rope_sin, causal,
                  sm_scale):
    """K4: (dk, dv) [B,KVH,S,D] in k.dtype/v.dtype, dk un-roped."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, rope_cos,
                                   rope_sin, causal, sm_scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("flash_bwd_dkv", (dk, dv), q, k, v, do, lse, delta,
                rope_cos, rope_sin, causal, sm_scale)
    flash_bwd_dkv.launches += 1
    return dk, dv


KERNELS = (flash_fwd, flash_bwd_preprocess, flash_bwd_dq, flash_bwd_dkv)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def launches() -> dict[str, int]:
    return {kernel.__name__: kernel.launches for kernel in KERNELS}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rope_cos, rope_sin, causal, sm_scale):
        o, lse = flash_fwd(q, k, v, rope_cos, rope_sin, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, rope_cos, rope_sin)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, rope_cos, rope_sin = ctx.saved_tensors
        delta = flash_bwd_preprocess(do, o)
        args = (q, k, v, do, lse, delta, rope_cos, rope_sin, ctx.causal,
                ctx.sm_scale)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: float | None = None, rope_cos=None,
                    rope_sin=None, window: int | None = None,
                    prefix_len: int | None = None):
    """Multi-head attention, O(S) memory ([B,H,S,Dh] layout).

    Args:
      q: [batch, heads, q_len, head_dim]
      k, v: [batch, kv_heads, kv_len, head_dim]; heads % kv_heads == 0.
      rope_cos/rope_sin: optional [batch, q_len, head_dim] FULL-WIDTH
        rotary tables. Rope is then applied to q and k inside the
        kernels (q/k passed raw; dq/dk come back un-roped).
        Self-attention only (q_len == kv_len).
      window/prefix_len: not in this port yet (ROADMAP Queue 1 item 3).
    Returns [batch, heads, q_len, head_dim] in q.dtype. Gradients flow to
    q, k and v; the rope tables are constants.
    """
    if window is not None or prefix_len is not None:
        raise NotImplementedError(
            "window/prefix_len attention is not ported yet "
            "(ROADMAP Queue 1 item 3, Queue 2 a)")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"q heads {q.shape[1]} not divisible by kv {k.shape[1]}")
    if rope_cos is not None:
        if q.shape[2] != k.shape[2]:
            raise ValueError(
                "fused rope requires self-attention (q_len == kv_len)")
        want = (q.shape[0], q.shape[2], q.shape[3])
        if tuple(rope_cos.shape) != want or tuple(rope_sin.shape) != want:
            raise ValueError(
                f"rope tables must be [B, S, head_dim] {want}, got "
                f"{tuple(rope_cos.shape)} / {tuple(rope_sin.shape)}")
        rope_cos, rope_sin = rope_cos.detach(), rope_sin.detach()
    for t in (k, v, rope_cos, rope_sin):
        if t is not None and t.device != q.device:
            raise ValueError(f"flash_attention: q on {q.device}, an operand "
                             f"on {t.device}")
    return _FlashAttention.apply(q, k, v, rope_cos, rope_sin, bool(causal),
                                 float(sm_scale))


def mha_reference(q, k, v, causal: bool = True,
                  sm_scale: float | None = None):
    """Plain attention (the ``attn_impl="reference"`` path)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = q.float() @ k.float().transpose(-1, -2) * sm_scale
    if causal:
        mask = _visible(q.shape[2], k.shape[2], True, q.device)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)
