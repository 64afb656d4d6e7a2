"""Flash attention on hand-written Hopper kernels.

The JAX package runs attention as Pallas TPU kernels
(dlrover_tpu/ops/attention.py). Here the same functions run as CUDA
kernels written for sm_90a (sources in ``csrc/``, built by ``_build``).
On the [B, H, S, Dh] layout (:func:`flash_attention`):

- ``flash_fwd`` (K1): o and lse; q roped inside the kernel, k by its
  pre-pass ``flash_fwd_rope_k``.
- ``flash_bwd_preprocess`` (K2): delta = rowsum(dO * O).
- ``flash_bwd_dq`` (K3): dq, q-major, un-roped in the kernel.
- ``flash_bwd_dkv`` (K4): dk and dv at kv-head width, kv-major, dk
  un-roped in the kernel.

K3 and K4 load q and k roped by the same pre-pass, run once per
backward for both.

On the model-native [B, S, H*Dh] layout (:func:`flash_attention_bshd`,
the JAX package's fused-heads family):

- ``flash_fwd_heads`` (K9): o [B, S, H*Dh] and lse, packing the q heads
  of one GQA group into the rows of each tile.
- ``flash_bwd_dq_heads`` (K10): dq [B, S, H*Dh], K3's loop on the
  [B, H, S, Dh] views.
- ``flash_bwd_dkv_heads`` (K11): dk and dv [B, S, KVH*Dh], K4's loop on
  the views.

Their backward takes delta from K2, over [B, H, S, Dh] views.

Every kernel above takes the JAX package's mask: causal (end-aligned),
with an optional sliding ``window`` and an always-visible ``prefix``;
visibility is ``(causal & in-window) | in-prefix``.

One block of ring attention (parallel/sequence.py's causal ring: a q
shard against one visiting kv shard, causal at global positions
``q_start + r >= k_start + c``), the counterparts of the JAX package's
``ring_fwd_block``, ``ring_dq_block`` and ``ring_dkv_block``:

- ``flash_ring_fwd`` (K12): the block's normalized o and its lse.
- ``flash_ring_dq`` (K13): the block's dq part, f32.
- ``flash_ring_dkv`` (K14): its dk and dv parts, f32, summed over each
  GQA group.

Each wrapper launches its kernel for CUDA tensors and counts the launch
in its ``launches`` attribute; for CPU tensors it runs the kernel's
plain PyTorch version (``*_plain``), which holds the same math in f32.
There is no fallback from one to the other: a CUDA tensor the kernel
does not take (dtype, head_dim, head grouping) raises.
"""

from __future__ import annotations

import ctypes

import torch

from dlrover_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIM = 128  # the head_dim the CUDA kernels are built for
TILE_ROWS = 64  # K9 packs a GQA group into its tiles: the group divides this


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


def _visible(q_len, kv_len, causal, device, window=None, prefix=None):
    """[q_len, kv_len] bool, as in the JAX kernels' _block_mask:
    ``(causal & in-window) | in-prefix`` with end-aligned causality (all
    True without causality). ``window``: key i-window+1..i visible from
    query i; ``prefix``: keys below it visible from every query."""
    if not causal:
        return torch.ones(q_len, kv_len, dtype=torch.bool, device=device)
    last = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    cols = torch.arange(kv_len, device=device)[None, :]
    vis = cols <= last
    if window is not None:
        vis &= cols > last - window
    if prefix is not None:
        vis |= cols < prefix
    return vis


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


def _ring_visible(q_len, kv_len, q_start, k_start, device):
    """[q_len, kv_len] bool of one ring block: causality at global
    positions, as the TPU ring's _dyn_mask, ``q_start + r >= k_start +
    c``."""
    rows = q_start + torch.arange(q_len, device=device)[:, None]
    cols = k_start + torch.arange(kv_len, device=device)[None, :]
    return rows >= cols


def _attend(qf, kf, vf, mask, sm_scale, dtype):
    """(o in ``dtype``, lse f32) of f32 operands under ``mask``. A row
    that sees no key gets o = 0 and lse = -1e30, as in the kernels."""
    s = (qf @ kf.transpose(-1, -2) * sm_scale).masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, 1.0, l)
    o = (p @ vf) / l
    return o.to(dtype), (m + torch.log(l)).squeeze(-1)


def _probs(qf, kf, lse, mask, sm_scale):
    """P = exp(S * scale - lse) with invisible entries exactly 0."""
    s = qf @ kf.transpose(-1, -2) * sm_scale
    return torch.where(mask, torch.exp(s - lse[..., None]), 0.0)


def _dq(qf, kf, vf, do, lse, delta, mask, sm_scale):
    """f32 dq of f32 operands from the saved lse and delta."""
    p = _probs(qf, kf, lse, mask, sm_scale)
    ds = p * (do.float() @ vf.transpose(-1, -2) - delta[..., None])
    return ds @ kf * sm_scale


def _dkv(qf, kf, vf, do, lse, delta, mask, sm_scale, kv_heads):
    """f32 (dk, dv) of f32 operands (k/v repeated to q's heads), summed
    over each group of q heads to ``kv_heads``."""
    p = _probs(qf, kf, lse, mask, sm_scale)
    dof = do.float()
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    dv = p.transpose(-1, -2) @ dof
    dk = ds.transpose(-1, -2) @ qf * sm_scale
    B, H, S, D = dk.shape
    group = H // kv_heads
    return (dk.view(B, kv_heads, group, S, D).sum(dim=2),
            dv.view(B, kv_heads, group, S, D).sum(dim=2))


def flash_fwd_plain(q, k, v, rope_cos, rope_sin, causal, sm_scale,
                    window=None, prefix=None):
    """Plain version of K1: (o in q.dtype, lse f32 [B, H, S])."""
    mask = _visible(q.shape[2], k.shape[2], causal, q.device, window, prefix)
    return _attend(*_operands(q, k, v, rope_cos, rope_sin), mask, sm_scale,
                   q.dtype)


def flash_bwd_preprocess_plain(do, o):
    """Plain version of K2: delta = rowsum(do * o), f32 [B, H, S]."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, rope_cos, rope_sin, causal,
                       sm_scale, window=None, prefix=None):
    """Plain version of K3: dq (q.dtype), un-roped."""
    mask = _visible(q.shape[2], k.shape[2], causal, q.device, window, prefix)
    dq = _dq(*_operands(q, k, v, rope_cos, rope_sin), do, lse, delta, mask,
             sm_scale)
    if rope_cos is not None:
        dq = _unrope(dq, rope_cos, rope_sin)
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, rope_cos, rope_sin, causal,
                        sm_scale, window=None, prefix=None):
    """Plain version of K4: (dk, dv) at kv-head width, dk un-roped."""
    mask = _visible(q.shape[2], k.shape[2], causal, q.device, window, prefix)
    dk, dv = _dkv(*_operands(q, k, v, rope_cos, rope_sin), do, lse, delta,
                  mask, sm_scale, k.shape[1])
    if rope_cos is not None:
        dk = _unrope(dk, rope_cos, rope_sin)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_ring_fwd_plain(q, k, v, q_start, k_start, sm_scale):
    """Plain version of K12: (o in q.dtype, normalized; lse f32
    [B, H, Sq]) of one ring block; rows that see nothing (a block wholly
    in their future) get o = 0 and lse = -1e30."""
    mask = _ring_visible(q.shape[2], k.shape[2], q_start, k_start, q.device)
    return _attend(*_operands(q, k, v, None, None), mask, sm_scale, q.dtype)


def flash_ring_dq_plain(q, k, v, do, lse, delta, q_start, k_start,
                        sm_scale):
    """Plain version of K13: the block's dq part, f32 [B, H, Sq, D],
    from the ring's global lse and delta."""
    mask = _ring_visible(q.shape[2], k.shape[2], q_start, k_start, q.device)
    return _dq(*_operands(q, k, v, None, None), do, lse, delta, mask,
               sm_scale)


def flash_ring_dkv_plain(q, k, v, do, lse, delta, q_start, k_start,
                         sm_scale):
    """Plain version of K14: the block's (dk, dv) parts, f32
    [B, KVH, Sk, D], summed over each GQA group."""
    mask = _ring_visible(q.shape[2], k.shape[2], q_start, k_start, q.device)
    return _dkv(*_operands(q, k, v, None, None), do, lse, delta, mask,
                sm_scale, k.shape[1])


def _split_heads(t, heads):
    """[B, S, heads * D] -> its [B, heads, S, D] view."""
    B, S, width = t.shape
    return t.reshape(B, S, heads, width // heads).transpose(1, 2)


def _merge_heads(t):
    """[B, heads, S, D] -> [B, S, heads * D]."""
    B, H, S, D = t.shape
    return t.transpose(1, 2).reshape(B, S, H * D)


def _heads_views(q, k, v, do, heads):
    """The [B, heads, S, D] views of [B, S, heads * D] operands (do may
    be None); k/v hold as many heads as their width allows."""
    kv_heads = k.shape[-1] // (q.shape[-1] // heads)
    views = (_split_heads(q, heads), _split_heads(k, kv_heads),
             _split_heads(v, kv_heads))
    return views + (() if do is None else (_split_heads(do, heads),))


def flash_fwd_heads_plain(q, k, v, heads, causal, sm_scale, window=None,
                          prefix=None):
    """Plain version of K9 on q [B, S, H*D], k/v [B, S, KVH*D]: (o
    [B, S, H*D] in q.dtype, lse f32 [B, H, S])."""
    o, lse = flash_fwd_plain(*_heads_views(q, k, v, None, heads), None, None,
                             causal, sm_scale, window, prefix)
    return _merge_heads(o), lse


def flash_bwd_dq_heads_plain(q, k, v, do, lse, delta, heads, causal,
                             sm_scale, window=None, prefix=None):
    """Plain version of K10: dq [B, S, H*D] in q.dtype."""
    return _merge_heads(flash_bwd_dq_plain(
        *_heads_views(q, k, v, do, heads), lse, delta, None, None, causal,
        sm_scale, window, prefix))


def flash_bwd_dkv_heads_plain(q, k, v, do, lse, delta, heads, causal,
                              sm_scale, window=None, prefix=None):
    """Plain version of K11: (dk, dv) [B, S, KVH*D]."""
    dk, dv = flash_bwd_dkv_plain(
        *_heads_views(q, k, v, do, heads), lse, delta, None, None, causal,
        sm_scale, window, prefix)
    return _merge_heads(dk), _merge_heads(dv)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_S = ctypes.POINTER(_L)
_MASK = [_I, _I, _I, _F]  # causal, window, prefix, scale
_RING = [_I, _I, _F]  # q_start, k_start, scale
# C entry -> (library, argtypes before the stream)
_ENTRIES = {
    "flash_fwd": ("flash_fwd", [_P] * 7 + [_I] * 5 + [_S] + _MASK),
    "flash_fwd_rope_k": ("flash_fwd", [_P] * 4 + [_I] * 3 + [_L] * 3),
    "flash_bwd_preprocess": ("flash_bwd", [_P] * 3 + [_I] * 3 + [_L] * 6),
    "flash_bwd_dq": ("flash_bwd", [_P] * 9 + [_I] * 5 + [_S] + _MASK),
    "flash_bwd_dkv": ("flash_bwd", [_P] * 10 + [_I] * 5 + [_S] + _MASK),
    "flash_fwd_heads": ("flash_heads", [_P] * 5 + [_I] * 5 + [_S] + _MASK),
    "flash_bwd_dq_heads": ("flash_heads", [_P] * 7 + [_I] * 5 + [_S] + _MASK),
    "flash_bwd_dkv_heads": ("flash_heads",
                            [_P] * 8 + [_I] * 5 + [_S] + _MASK),
    "flash_ring_fwd": ("flash_ring", [_P] * 5 + [_I] * 5 + [_S] + _RING),
    "flash_ring_dq": ("flash_ring", [_P] * 7 + [_I] * 5 + [_S] + _RING),
    "flash_ring_dkv": ("flash_ring", [_P] * 8 + [_I] * 5 + [_S] + _RING),
}


def _launch(symbol: str, *args) -> None:
    _build.launch(symbol, *_ENTRIES[symbol], *args)


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


def _strides(*operands):
    """The (batch, head, row) strides of (tensor, strides) pairs from
    :func:`_rows`, as the C array the entries take."""
    flat = [s for _, st in operands for s in st]
    return (_L * len(flat))(*flat)


def _mask_args(causal, window, prefix, sm_scale):
    """The C entries' trailing (causal, window, prefix, scale); 0 means
    no window / no prefix."""
    return (int(causal), 0 if window is None else int(window),
            0 if prefix is None else int(prefix), float(sm_scale))


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
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"{name}: q heads {q.shape[1]} not divisible by "
                         f"kv heads {k.shape[1]}")


def _check_packing(name, heads, kv_heads):
    """K9 puts a GQA group's q heads in the rows of one tile."""
    group = heads // kv_heads
    if TILE_ROWS % group != 0:
        raise NotImplementedError(
            f"{name}: the packed kernel needs heads / kv_heads to divide "
            f"{TILE_ROWS}, got {heads} / {kv_heads}")


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


def _ring_args(q_start, k_start, sm_scale):
    """The ring entries' trailing (q_start, k_start, scale)."""
    return int(q_start), int(k_start), float(sm_scale)


def _launch_attn(symbol, operands, inputs, tables, outs, tail):
    """Launch one attention kernel. Every C entry takes the [B, heads, S,
    D] operands q, k, v (and do) by pointer, read through their strides
    (views of the fused layout for K9-K11), then the f32 inputs (lse,
    delta), the rope tables (K1/K3/K4 only: ``tables`` is None for the
    other entries), the outputs, then B, H, KVH, q_len, kv_len, the
    operands' strides, the entry's trailing arguments ``tail`` (causal,
    window, prefix and scale from :func:`_mask_args`; q_start, k_start and
    scale for the ring entries) and the stream."""
    _check(symbol, *operands, *(tables or ()))
    ops = [_rows(t) for t in operands]
    q, k = ops[0][0], ops[1][0]
    inputs = [t.contiguous() for t in inputs]
    table_ptrs = ()
    if tables is not None:
        _tables, table_ptrs = _table_ptrs(q, k, *tables)
    B, H, q_len, _ = q.shape
    _launch(symbol, *(t.data_ptr() for t, _ in ops),
            *(t.data_ptr() for t in inputs), *table_ptrs,
            *(t.data_ptr() for t in outs), B, H, k.shape[1], q_len,
            k.shape[2], _strides(*ops), *tail)


def flash_fwd_rope_k(k, rope_cos, rope_sin):
    """K1's pre-pass: rope(k) as a contiguous [B, heads, S, D] bf16 CUDA
    tensor, rounded once from f32 (tables [B, S, D] full width). Counted
    as part of K1, which loads it in place of k, and of K3 and K4, which
    load it in place of q and k."""
    _check("flash_fwd_rope_k", k, k, rope_cos, rope_sin)
    k, st = _rows(k)
    (cos, sin), _ = _table_ptrs(k, k, rope_cos, rope_sin)
    out = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    B, KVH, S, _ = k.shape
    _launch("flash_fwd_rope_k", k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            out.data_ptr(), B, KVH, S, *st)
    return out


def flash_fwd(q, k, v, rope_cos, rope_sin, causal, sm_scale, window=None,
              prefix=None):
    """K1: (o [B,H,S,D] q.dtype, lse f32 [B,H,S]). With rope tables, k
    is roped first by the pre-pass :func:`flash_fwd_rope_k` and q inside
    the kernel."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, rope_cos, rope_sin, causal, sm_scale,
                               window, prefix)
    B, H, S, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if rope_cos is not None:
        k = flash_fwd_rope_k(k, rope_cos, rope_sin)
    _launch_attn("flash_fwd", (q, k, v), (), (rope_cos, rope_sin), (o, lse),
                 _mask_args(causal, window, prefix, sm_scale))
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


def flash_bwd_dq(q, k, v, do, lse, delta, rope_cos, rope_sin, causal,
                 sm_scale, window=None, prefix=None, roped=None):
    """K3: dq [B,H,S,D] in q.dtype, un-roped. With rope tables the kernel
    loads q and k roped: ``roped`` is the pair from
    :func:`flash_fwd_rope_k` on q and k, or, when None, they are roped
    here first; the tables un-rope dq in the kernel."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, rope_cos,
                                  rope_sin, causal, sm_scale, window, prefix)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if rope_cos is not None:
        q, k = roped or (flash_fwd_rope_k(q, rope_cos, rope_sin),
                         flash_fwd_rope_k(k, rope_cos, rope_sin))
    _launch_attn("flash_bwd_dq", (q, k, v, do), (lse, delta),
                 (rope_cos, rope_sin), (dq,),
                 _mask_args(causal, window, prefix, sm_scale))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, rope_cos, rope_sin, causal,
                  sm_scale, window=None, prefix=None, roped=None):
    """K4: (dk, dv) [B,KVH,S,D] in k.dtype/v.dtype, dk un-roped. Rope and
    ``roped`` as in :func:`flash_bwd_dq`."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, rope_cos,
                                   rope_sin, causal, sm_scale, window, prefix)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if rope_cos is not None:
        q, k = roped or (flash_fwd_rope_k(q, rope_cos, rope_sin),
                         flash_fwd_rope_k(k, rope_cos, rope_sin))
    _launch_attn("flash_bwd_dkv", (q, k, v, do), (lse, delta),
                 (rope_cos, rope_sin), (dk, dv),
                 _mask_args(causal, window, prefix, sm_scale))
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_fwd_heads(q, k, v, heads, causal, sm_scale, window=None,
                    prefix=None):
    """K9 on q [B,S,H*D], k/v [B,S,KVH*D]: (o [B,S,H*D] q.dtype, lse f32
    [B,H,S])."""
    if q.device.type == "cpu":
        return flash_fwd_heads_plain(q, k, v, heads, causal, sm_scale,
                                     window, prefix)
    views = _heads_views(q, k, v, None, heads)
    _check_packing("flash_fwd_heads", heads, views[1].shape[1])
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((q.shape[0], heads, q.shape[1]), dtype=torch.float32,
                      device=q.device)
    _launch_attn("flash_fwd_heads", views, (), None, (o, lse),
                 _mask_args(causal, window, prefix, sm_scale))
    flash_fwd_heads.launches += 1
    return o, lse


def flash_bwd_dq_heads(q, k, v, do, lse, delta, heads, causal, sm_scale,
                       window=None, prefix=None):
    """K10: dq [B,S,H*D] in q.dtype (K3's loop on the [B,H,S,D] views:
    one q head per tile, any GQA group)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_heads_plain(q, k, v, do, lse, delta, heads,
                                        causal, sm_scale, window, prefix)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_attn("flash_bwd_dq_heads", _heads_views(q, k, v, do, heads),
                 (lse, delta), None, (dq,),
                 _mask_args(causal, window, prefix, sm_scale))
    flash_bwd_dq_heads.launches += 1
    return dq


def flash_bwd_dkv_heads(q, k, v, do, lse, delta, heads, causal, sm_scale,
                        window=None, prefix=None):
    """K11: (dk, dv) [B,S,KVH*D] in k.dtype/v.dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_heads_plain(q, k, v, do, lse, delta, heads,
                                         causal, sm_scale, window, prefix)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_attn("flash_bwd_dkv_heads", _heads_views(q, k, v, do, heads),
                 (lse, delta), None, (dk, dv),
                 _mask_args(causal, window, prefix, sm_scale))
    flash_bwd_dkv_heads.launches += 1
    return dk, dv


def flash_ring_fwd(q, k, v, q_start, k_start, sm_scale):
    """K12: one ring block, q [B,H,Sq,D] against k/v [B,KVH,Sk,D] at
    global offsets ``q_start``/``k_start``: (o q.dtype normalized, lse
    f32 [B,H,Sq])."""
    if q.device.type == "cpu":
        return flash_ring_fwd_plain(q, k, v, q_start, k_start, sm_scale)
    B, H, Sq, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch_attn("flash_ring_fwd", (q, k, v), (), None, (o, lse),
                 _ring_args(q_start, k_start, sm_scale))
    flash_ring_fwd.launches += 1
    return o, lse


def flash_ring_dq(q, k, v, do, lse, delta, q_start, k_start, sm_scale):
    """K13: the block's dq part, f32 [B,H,Sq,D], from the ring's global
    lse and delta."""
    if q.device.type == "cpu":
        return flash_ring_dq_plain(q, k, v, do, lse, delta, q_start, k_start,
                                   sm_scale)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch_attn("flash_ring_dq", (q, k, v, do), (lse, delta), None, (dq,),
                 _ring_args(q_start, k_start, sm_scale))
    flash_ring_dq.launches += 1
    return dq


def flash_ring_dkv(q, k, v, do, lse, delta, q_start, k_start, sm_scale):
    """K14: the block's (dk, dv) parts, f32 [B,KVH,Sk,D], summed over
    each GQA group."""
    if q.device.type == "cpu":
        return flash_ring_dkv_plain(q, k, v, do, lse, delta, q_start,
                                    k_start, sm_scale)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    _launch_attn("flash_ring_dkv", (q, k, v, do), (lse, delta), None,
                 (dk, dv), _ring_args(q_start, k_start, sm_scale))
    flash_ring_dkv.launches += 1
    return dk, dv


KERNELS = (flash_fwd, flash_bwd_preprocess, flash_bwd_dq, flash_bwd_dkv,
           flash_fwd_heads, flash_bwd_dq_heads, flash_bwd_dkv_heads,
           flash_ring_fwd, flash_ring_dq, flash_ring_dkv)
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
    """K1-K4 on [B, H, S, D]."""

    @staticmethod
    def forward(ctx, q, k, v, rope_cos, rope_sin, causal, sm_scale, window,
                prefix):
        o, lse = flash_fwd(q, k, v, rope_cos, rope_sin, causal, sm_scale,
                           window, prefix)
        ctx.save_for_backward(q, k, v, o, lse, rope_cos, rope_sin)
        ctx.opts = (causal, sm_scale, window, prefix)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, rope_cos, rope_sin = ctx.saved_tensors
        delta = flash_bwd_preprocess(do, o)
        args = (q, k, v, do, lse, delta, rope_cos, rope_sin, *ctx.opts)
        roped = None
        if rope_cos is not None and q.device.type == "cuda":
            # K3 and K4 load q and k roped: one pre-pass each for both
            roped = (flash_fwd_rope_k(q, rope_cos, rope_sin),
                     flash_fwd_rope_k(k, rope_cos, rope_sin))
        dq = flash_bwd_dq(*args, roped=roped)
        dk, dv = flash_bwd_dkv(*args, roped=roped)
        return dq, dk, dv, None, None, None, None, None, None


class _FlashAttentionHeads(torch.autograd.Function):
    """K9-K11 (and K2 for delta) on [B, S, H*D]."""

    @staticmethod
    def forward(ctx, q, k, v, heads, causal, sm_scale, window, prefix):
        o, lse = flash_fwd_heads(q, k, v, heads, causal, sm_scale, window,
                                 prefix)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (heads, causal, sm_scale, window, prefix)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        heads = ctx.args[0]
        delta = flash_bwd_preprocess(_split_heads(do, heads),
                                     _split_heads(o, heads))
        args = (q, k, v, do, lse, delta, *ctx.args)
        dq = flash_bwd_dq_heads(*args)
        dk, dv = flash_bwd_dkv_heads(*args)
        return dq, dk, dv, None, None, None, None, None


def _check_mask_extras(causal, window, prefix_len):
    """The JAX package's rules for the mask extras."""
    if window is None and prefix_len is None:
        return
    if not causal:
        raise ValueError("window/prefix_len require causal=True")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if prefix_len is not None and int(prefix_len) < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")


def _int_or_none(x):
    return None if x is None else int(x)


def _same_device(name, q, *others):
    for t in others:
        if t is not None and t.device != q.device:
            raise ValueError(f"{name}: q on {q.device}, an operand on "
                             f"{t.device}")


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
      window: Mistral-style sliding window: query i sees keys
        i-window+1..i (end-aligned); the kernels skip the tiles below it.
      prefix_len: GLM-style prefix-LM: the first ``prefix_len`` keys are
        visible from every query. Both need causal=True and compose as
        ``(causal & in-window) | in-prefix``.
    Returns [batch, heads, q_len, head_dim] in q.dtype. Gradients flow to
    q, k and v; the rope tables are constants.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"q heads {q.shape[1]} not divisible by kv {k.shape[1]}")
    _check_mask_extras(causal, window, prefix_len)
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
    _same_device("flash_attention", q, k, v, rope_cos, rope_sin)
    return _FlashAttention.apply(q, k, v, rope_cos, rope_sin, bool(causal),
                                 float(sm_scale), _int_or_none(window),
                                 _int_or_none(prefix_len))


def flash_attention_bshd(q, k, v, causal: bool = True,
                         sm_scale: float | None = None, block_q: int = 512,
                         block_k: int = 512, bwd_block_q: int | None = None,
                         bwd_block_k: int | None = None, fused: bool = True,
                         window: int | None = None,
                         prefix_len: int | None = None):
    """Flash attention on the model-native [B, S, H, Dh] layout, with no
    transposes on either side of the fused kernels.

    - ``fused=True`` (default) with heads <= 128: the heads fold into
      the minor dimension ([B, S, H*Dh], a free view) and K9-K11 run
      there, each staging a k/v tile once for the q heads of its GQA
      group.
    - ``fused=False``, or heads > 128 (as in the JAX package): K1-K4 on
      the [B, H, S, Dh] strided views, without rope; only the output is
      laid back as [B, S, H, Dh].

    ``block_*`` are accepted and ignored: they are TPU VMEM tunings of
    the JAX kernels; the port's kernels fix their own tiles, and no block
    size changes the function computed. ``window``/``prefix_len`` as in
    :func:`flash_attention`. On the card, head_dim must be 128 (the JAX
    package's transposing fallback for other widths is not ported; the
    kernels raise).

    Args:
      q: [batch, q_len, heads, head_dim]
      k, v: [batch, kv_len, kv_heads, head_dim]; heads % kv_heads == 0.
    Returns [batch, q_len, heads, head_dim] in q.dtype.
    """
    B, S, H, hd = q.shape
    KVH, Skv = k.shape[2], k.shape[1]
    if H % KVH != 0:
        raise ValueError(f"q heads {H} not divisible by kv {KVH}")
    if H > 128:
        fused = False
    if sm_scale is None:
        sm_scale = hd ** -0.5
    _check_mask_extras(causal, window, prefix_len)
    _same_device("flash_attention_bshd", q, k, v)
    opts = (bool(causal), float(sm_scale), _int_or_none(window),
            _int_or_none(prefix_len))
    if not fused:
        o = _FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), None, None, *opts)
        return o.transpose(1, 2)
    o = _FlashAttentionHeads.apply(
        q.reshape(B, S, H * hd), k.reshape(B, Skv, KVH * hd),
        v.reshape(B, Skv, KVH * hd), H, *opts)
    return o.view(B, S, H, hd)


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
