"""The port's CUDA kernels against their plain PyTorch versions, on the
card (bf16). These need an NVIDIA GPU and nvcc: without CUDA they skip
with a reason (a CUDA kernel has no CPU mode). Run them on the GPU with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerance: errors relative to the largest reference value, 2e-2 for o
and 3e-2 for gradients: the kernels round roped q/k, P and dS to bf16
before the tensor-core products, which the f32 plain versions do not.
The attention kernels are checked per head layout (K1-K4 on [B, H, S, D],
K9-K11 on [B, S, H*D] through flash_attention_bshd), with GQA, ragged
lengths, a sliding window and a prefix; the ring-block kernels (K12-K14)
at the diagonal, wholly visible and wholly future offsets (exact zeros),
on contiguous shards and on shard views of a whole sequence, and through
ring_attention over 4 in-process ranks. Kernels that run another one's
loop are held to it bit for bit: K13's dq (rounded to bf16) to K3's on
the same mask, K10's dq and K11's dk/dv on [B, S, H*D] to K3's and K4's
on [B, H, S, D].

The optimizer kernels (K5-K8) do the plain versions' f32 operations in
the same order, without FMA contraction: K5/K6 codes, scales and values
are bit-equal; K7 is held within 1e-6 of the largest value (bit-equal
expected); K8's log codes come from expf/logf, whose last bit may differ
from torch's, so at most 1e-4 of codes may differ, by 1, and the params
within 1e-4 of the step's largest update.
"""

import pytest
import torch

from dlrover_tpu_torch.device import CUDA_SKIP_REASON, cuda_available
from dlrover_tpu_torch.ops import attention as att
from dlrover_tpu_torch.ops import fused_optim as fo
from dlrover_tpu_torch.ops import quantization as qz
from dlrover_tpu_torch.parallel import MeshConfig, build_mesh, ring_attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not cuda_available():
        pytest.skip(CUDA_SKIP_REASON)
    return torch.device("cuda")


def _rel(got, want):
    diff = (got.float() - want.float()).abs().max()
    return (diff / want.float().abs().max()).item()


@pytest.mark.parametrize("B,H,KVH,S,rope", [
    (1, 4, 4, 128, True),
    (2, 8, 2, 200, True),     # GQA, ragged
    (1, 4, 1, 77, False),     # MQA, ragged, no rope
    (1, 2, 2, 48, True),      # shorter than one 128-row tile
    (1, 4, 2, 1000, True),    # ragged against 128-row tiles
    (1, 2, 1, 1100, False),   # ragged, MQA, no rope
    (1, 2, 2, 256, True),     # 4 blocks: a grid smaller than one wave
])
def test_kernels_match_plain(cuda, B, H, KVH, S, rope):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(B, h, S, 128, generator=gen, device=cuda)
                   .to(torch.bfloat16) for h in (H, KVH, KVH, H))
    cos = sin = None
    if rope:
        ang = torch.randn(B, S, 64, generator=gen, device=cuda)
        cos = torch.cat([ang.cos()] * 2, -1).to(torch.bfloat16)
        sin = torch.cat([ang.sin()] * 2, -1).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = att.flash_attention(*leaves, rope_cos=cos, rope_sin=sin)
    out.backward(do)
    scale = 128 ** -0.5
    o_p, lse_p = att.flash_fwd_plain(q, k, v, cos, sin, True, scale)
    delta_p = att.flash_bwd_preprocess_plain(do, o_p)
    args = (q, k, v, do, lse_p, delta_p, cos, sin, True, scale)
    dk_p, dv_p = att.flash_bwd_dkv_plain(*args)
    assert _rel(out, o_p) < 2e-2
    assert _rel(leaves[0].grad, att.flash_bwd_dq_plain(*args)) < 3e-2
    assert _rel(leaves[1].grad, dk_p) < 3e-2
    assert _rel(leaves[2].grad, dv_p) < 3e-2


@pytest.mark.parametrize("B,H,KVH,S,window,prefix", [
    (1, 8, 2, 256, None, None),   # GQA, g = 4: 16 positions x 4 heads
    (2, 4, 4, 200, None, None),   # MHA, ragged
    (1, 8, 2, 300, 96, None),     # sliding window, ragged
    (1, 8, 1, 256, 64, 40),       # MQA, window + prefix
    (1, 2, 2, 48, None, None),    # shorter than one tile
    (1, 8, 8, 1100, None, None),  # g = 1, ragged against 128-row tiles
    (1, 8, 4, 1000, None, None),  # g = 2, ragged
    (1, 16, 1, 256, None, None),  # g = 16: 8 positions x 16 heads
    (1, 8, 1, 300, 200, None),    # g = 8, window not a tile multiple
    (1, 4, 2, 400, None, 200),    # prefix crossing a tile
    (1, 4, 1, 500, 160, 150),     # window and prefix, both mid-tile
])
def test_fused_heads_kernels_match_plain(cuda, B, H, KVH, S, window, prefix):
    """K9-K11 through flash_attention_bshd against the plain chain (K9's,
    K2's, K10's and K11's plain versions) on the same bf16 inputs."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn(B, S, h * 128, generator=gen, device=cuda)
                   .to(torch.bfloat16) for h in (H, KVH, KVH, H))
    before = att.launches()
    leaves = [t.view(B, S, -1, 128).clone().requires_grad_()
              for t in (q, k, v)]
    out = att.flash_attention_bshd(*leaves, window=window, prefix_len=prefix)
    out.backward(do.view(B, S, H, 128))
    torch.cuda.synchronize()
    after = att.launches()
    for name in ("flash_fwd_heads", "flash_bwd_dq_heads",
                 "flash_bwd_dkv_heads", "flash_bwd_preprocess"):
        assert after[name] == before[name] + 1
    scale = 128 ** -0.5
    o_p, lse_p = att.flash_fwd_heads_plain(q, k, v, H, True, scale, window,
                                           prefix)
    delta_p = att.flash_bwd_preprocess_plain(att._split_heads(do, H),
                                             att._split_heads(o_p, H))
    args = (q, k, v, do, lse_p, delta_p, H, True, scale, window, prefix)
    dk_p, dv_p = att.flash_bwd_dkv_heads_plain(*args)
    assert _rel(out.reshape(o_p.shape), o_p) < 2e-2
    assert _rel(leaves[0].grad.reshape(q.shape),
                att.flash_bwd_dq_heads_plain(*args)) < 3e-2
    assert _rel(leaves[1].grad.reshape(k.shape), dk_p) < 3e-2
    assert _rel(leaves[2].grad.reshape(v.shape), dv_p) < 3e-2


def test_masked_per_head_kernels_match_plain(cuda):
    """K1/K3/K4 with rope under a sliding window and a prefix."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    B, H, KVH, S = 1, 8, 2, 300
    q, k, v, do = (torch.randn(B, h, S, 128, generator=gen, device=cuda)
                   .to(torch.bfloat16) for h in (H, KVH, KVH, H))
    ang = torch.randn(B, S, 64, generator=gen, device=cuda)
    cos = torch.cat([ang.cos()] * 2, -1).to(torch.bfloat16)
    sin = torch.cat([ang.sin()] * 2, -1).to(torch.bfloat16)
    mask = (True, 128 ** -0.5, 96, 40)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = att.flash_attention(*leaves, rope_cos=cos, rope_sin=sin,
                              window=96, prefix_len=40)
    out.backward(do)
    o_p, lse_p = att.flash_fwd_plain(q, k, v, cos, sin, *mask)
    delta_p = att.flash_bwd_preprocess_plain(do, o_p)
    args = (q, k, v, do, lse_p, delta_p, cos, sin, *mask)
    dk_p, dv_p = att.flash_bwd_dkv_plain(*args)
    assert _rel(out, o_p) < 2e-2
    assert _rel(leaves[0].grad, att.flash_bwd_dq_plain(*args)) < 3e-2
    assert _rel(leaves[1].grad, dk_p) < 3e-2
    assert _rel(leaves[2].grad, dv_p) < 3e-2


@pytest.mark.parametrize("q_len,kv_len", [
    (200, 333),   # kv_len > q_len: end-aligned causality
    (333, 200),   # q_len > kv_len: rows 0..132 see no key
    (48, 300),
    (300, 48),
])
def test_forward_kernels_on_uneven_lengths(cuda, q_len, kv_len):
    """K1 (no rope) and K9 (g = 4) with kv_len != q_len against their
    plain versions; rows that see no key give o = 0 and lse = -1e30
    exactly."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, H, KVH = 2, 8, 2
    q = torch.randn(B, H, q_len, 128, generator=gen, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn(B, KVH, kv_len, 128, generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    scale = 128 ** -0.5
    blind = max(0, q_len - kv_len)  # rows with no visible key
    o_p, lse_p = att.flash_fwd_plain(q, k, v, None, None, True, scale)
    o9, lse9 = att.flash_fwd_heads(*(att._merge_heads(t) for t in (q, k, v)),
                                   H, True, scale)
    for o, lse in (att.flash_fwd(q, k, v, None, None, True, scale),
                   (att._split_heads(o9, H), lse9)):
        assert _rel(o, o_p) < 2e-2
        assert (lse - lse_p).abs().max().item() < 2e-2
        assert not o[:, :, :blind].any()
        assert torch.all(lse[:, :, :blind] == att.NEG_INF)


def test_per_head_kernels_on_transposed_views(cuda):
    """K1-K4 with rope on [B, S, H, D] tensors passed as their [B, H, S,
    D] transposes (head stride D, row stride H*D), read in place."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    B, H, KVH, S = 2, 8, 4, 300
    q, k, v, do = (torch.randn(B, S, h, 128, generator=gen, device=cuda)
                   .to(torch.bfloat16).transpose(1, 2)
                   for h in (H, KVH, KVH, H))
    ang = torch.randn(B, S, 64, generator=gen, device=cuda)
    cos = torch.cat([ang.cos()] * 2, -1).to(torch.bfloat16)
    sin = torch.cat([ang.sin()] * 2, -1).to(torch.bfloat16)
    assert q.stride() == (S * H * 128, 128, H * 128, 1)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = att.flash_attention(*leaves, rope_cos=cos, rope_sin=sin)
    out.backward(do)
    scale = 128 ** -0.5
    o_p, lse_p = att.flash_fwd_plain(q, k, v, cos, sin, True, scale)
    o, lse = att.flash_fwd(q, k, v, cos, sin, True, scale)
    assert (lse - lse_p).abs().max().item() < 2e-2
    delta_p = att.flash_bwd_preprocess_plain(do, o_p)
    args = (q, k, v, do, lse_p, delta_p, cos, sin, True, scale)
    dk_p, dv_p = att.flash_bwd_dkv_plain(*args)
    assert _rel(out, o_p) < 2e-2 and _rel(o, o_p) < 2e-2
    assert _rel(leaves[0].grad, att.flash_bwd_dq_plain(*args)) < 3e-2
    assert _rel(leaves[1].grad, dk_p) < 3e-2
    assert _rel(leaves[2].grad, dv_p) < 3e-2


def _backward_inputs(cuda, seed, B, H, KVH, q_len, kv_len, rope, mask,
                     transposed=False):
    """Seeded bf16 q/k/v/do (as [B, S, heads, D] transposes when
    ``transposed``), rope tables or None, and the arguments K3/K4 and
    their plain versions take, with lse and delta from the plain
    forward."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(heads, S):
        if transposed:
            return torch.randn(B, S, heads, 128, generator=gen, device=cuda
                               ).to(torch.bfloat16).transpose(1, 2)
        return torch.randn(B, heads, S, 128, generator=gen,
                           device=cuda).to(torch.bfloat16)

    q, k, v, do = (randn(H, q_len), randn(KVH, kv_len), randn(KVH, kv_len),
                   randn(H, q_len))
    cos = sin = None
    if rope:
        ang = torch.randn(B, q_len, 64, generator=gen, device=cuda)
        cos = torch.cat([ang.cos()] * 2, -1).to(torch.bfloat16)
        sin = torch.cat([ang.sin()] * 2, -1).to(torch.bfloat16)
    o_p, lse_p = att.flash_fwd_plain(q, k, v, cos, sin, *mask)
    delta_p = att.flash_bwd_preprocess_plain(do, o_p)
    return (q, k, v, do, lse_p, delta_p, cos, sin, *mask)


def _check_backward_kernels(args):
    """K3 and K4 against their plain versions on the same arguments;
    returns the kernels' (dq, dk, dv)."""
    before = att.launches()
    dq = att.flash_bwd_dq(*args)
    dk, dv = att.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    after = att.launches()
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 1
    dk_p, dv_p = att.flash_bwd_dkv_plain(*args)
    assert _rel(dq, att.flash_bwd_dq_plain(*args)) < 3e-2
    assert _rel(dk, dk_p) < 3e-2
    assert _rel(dv, dv_p) < 3e-2
    return dq, dk, dv


@pytest.mark.parametrize("B,H,KVH,S,window,prefix", [
    (1, 2, 2, 48, None, None),     # shorter than one 64-row tile
    (1, 4, 2, 1000, None, None),   # ragged against 64- and 128-row tiles
    (1, 2, 1, 1100, None, None),   # ragged, MQA
    (1, 2, 2, 256, None, None),    # group 1; 4 blocks: less than one wave
    (2, 4, 2, 384, None, None),    # group 2
    (1, 8, 2, 256, None, None),    # group 4
    (1, 8, 1, 320, None, None),    # group 8
    (1, 16, 1, 256, None, None),   # group 16
    (1, 8, 2, 700, 200, None),     # a window of 200
    (1, 4, 1, 500, 160, 150),      # window 160 and prefix 150, mid-tile
    (1, 4, 2, 400, None, 200),     # a prefix of 200, crossing tiles
])
def test_backward_kernels_match_plain(cuda, B, H, KVH, S, window, prefix):
    """K3 and K4 with rope, each called on its own from the plain
    forward's lse and delta, against their plain versions."""
    _check_backward_kernels(_backward_inputs(
        cuda, 8, B, H, KVH, S, S, True, (True, 128 ** -0.5, window, prefix)))


@pytest.mark.parametrize("q_len,kv_len,window", [
    (333, 200, None),  # q_len > kv_len: rows 0..132 see no key
    (300, 48, None),   # rows 0..251 see no key
    (200, 333, 64),    # kv_len > q_len: keys 0..69 are seen by no row
    (48, 300, 100),    # keys 0..152 are seen by no row
])
def test_backward_kernels_on_uneven_lengths(cuda, q_len, kv_len, window):
    """K3 and K4 (no rope, GQA g = 4) with kv_len != q_len against their
    plain versions; rows that see no key get dq = 0 and keys that no row
    sees get dk = dv = 0, exactly."""
    args = _backward_inputs(cuda, 9, 2, 8, 2, q_len, kv_len, False,
                            (True, 128 ** -0.5, window, None))
    dq, dk, dv = _check_backward_kernels(args)
    off = kv_len - q_len
    blind_rows = max(0, -off)
    blind_keys = 0 if window is None else max(0, off - window + 1)
    assert blind_rows or blind_keys
    assert not dq[:, :, :blind_rows].any()
    assert not dk[:, :, :blind_keys].any()
    assert not dv[:, :, :blind_keys].any()


@pytest.mark.parametrize("q_len,kv_len,rope", [
    (300, 300, True),
    (200, 333, False),  # kv_len > q_len: every row sees every key
    (333, 200, False),
])
def test_backward_kernels_without_causality(cuda, q_len, kv_len, rope):
    """K3 and K4 with causal=False (every tile live, the mask only at the
    ragged ends) against their plain versions."""
    _check_backward_kernels(_backward_inputs(
        cuda, 11, 1, 8, 2, q_len, kv_len, rope, (False, 128 ** -0.5, None,
                                                 None)))


def test_backward_kernels_on_transposed_views(cuda):
    """K3 and K4 with rope, each called on its own, on [B, S, H, D]
    tensors passed as their [B, H, S, D] transposes (head stride D, row
    stride H*D), with and without a window."""
    for window in (None, 100):
        args = _backward_inputs(cuda, 10, 2, 8, 4, 300, 300, True,
                                (True, 128 ** -0.5, window, None),
                                transposed=True)
        assert args[0].stride() == (300 * 8 * 128, 128, 8 * 128, 1)
        _check_backward_kernels(args)


@pytest.mark.parametrize("B,H,KVH,S", [
    (2, 8, 8, 512),    # the [seq4] run's block shape (at B2), diagonal
    (1, 8, 2, 1000),   # GQA g = 4, ragged against 64- and 128-row tiles
    (1, 4, 1, 77),     # MQA, shorter than one tile
])
def test_ring_dq_runs_the_dq_loop(cuda, B, H, KVH, S):
    """K13 on the diagonal block (q_start == k_start: causal with offset
    0) against K3 without rope on the same inputs (end-aligned causality
    at q_len == kv_len: the same mask). K13 runs K3's loop with an f32
    epilogue, so its dq rounded to bf16 is bit-equal to K3's."""
    scale = 128 ** -0.5
    args = _backward_inputs(cuda, 12, B, H, KVH, S, S, False,
                            (True, scale, None, None))
    q, k, v, do, lse, delta = args[:6]
    before = att.launches()
    dq3 = att.flash_bwd_dq(*args)
    dq13 = att.flash_ring_dq(q, k, v, do, lse, delta, S, S, scale)
    torch.cuda.synchronize()
    after = att.launches()
    for name in ("flash_bwd_dq", "flash_ring_dq"):
        assert after[name] == before[name] + 1
    assert dq3.dtype == torch.bfloat16 and dq13.dtype == torch.float32
    assert torch.equal(dq13.to(torch.bfloat16), dq3)


@pytest.mark.parametrize("B,H,KVH,S,window,prefix", [
    (2, 8, 8, 256, None, None),
    (1, 32, 8, 512, None, None),   # GQA g = 4: 4 x nq q tiles a block
    (1, 8, 2, 1024, 512, 128),     # window 512 and prefix 128
    (1, 8, 4, 1000, None, None),   # ragged against 64- and 128-row tiles
])
def test_dkv_heads_runs_the_dkv_loop(cuda, B, H, KVH, S, window, prefix):
    """K11 on [B, S, H*D] operands against K4 without rope on contiguous
    [B, H, S, D] copies of the same data. K11 runs K4's loop through
    strided tensor maps, so dk and dv are bit-equal."""
    mask = (True, 128 ** -0.5, window, prefix)
    q, k, v, do, lse, delta = _backward_inputs(cuda, 13, B, H, KVH, S, S,
                                               False, mask)[:6]
    before = att.launches()
    dk4, dv4 = att.flash_bwd_dkv(q, k, v, do, lse, delta, None, None, *mask)
    fused = [att._merge_heads(t) for t in (q, k, v, do)]
    dk11, dv11 = att.flash_bwd_dkv_heads(*fused, lse, delta, H, *mask)
    torch.cuda.synchronize()
    after = att.launches()
    for name in ("flash_bwd_dkv", "flash_bwd_dkv_heads"):
        assert after[name] == before[name] + 1
    assert dk11.shape == fused[1].shape and dv11.shape == fused[2].shape
    assert torch.equal(dk11, att._merge_heads(dk4))
    assert torch.equal(dv11, att._merge_heads(dv4))


@pytest.mark.parametrize("B,H,KVH,S,window,prefix", [
    (2, 8, 8, 256, None, None),
    (1, 32, 8, 512, None, None),   # GQA g = 4
    (1, 32, 4, 512, None, None),   # GQA g = 8
    (1, 8, 2, 1024, 512, 128),     # window 512 and prefix 128
    (1, 8, 4, 1000, None, None),   # ragged against 64- and 128-row tiles
    (1, 6, 2, 300, None, None),    # g = 3: K10 packs no heads, any group
])
def test_dq_heads_runs_the_dq_loop(cuda, B, H, KVH, S, window, prefix):
    """K10 on [B, S, H*D] operands against K3 without rope on contiguous
    [B, H, S, D] copies of the same data. K10 runs K3's loop through
    strided tensor maps, so dq is bit-equal."""
    mask = (True, 128 ** -0.5, window, prefix)
    q, k, v, do, lse, delta = _backward_inputs(cuda, 14, B, H, KVH, S, S,
                                               False, mask)[:6]
    before = att.launches()
    dq3 = att.flash_bwd_dq(q, k, v, do, lse, delta, None, None, *mask)
    fused = [att._merge_heads(t) for t in (q, k, v, do)]
    dq10 = att.flash_bwd_dq_heads(*fused, lse, delta, H, *mask)
    torch.cuda.synchronize()
    after = att.launches()
    for name in ("flash_bwd_dq", "flash_bwd_dq_heads"):
        assert after[name] == before[name] + 1
    assert dq10.shape == fused[0].shape
    assert torch.equal(dq10, att._merge_heads(dq3))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head_dim"):
        att.flash_fwd(q, q, q, None, None, True, 0.125)
    q32 = torch.zeros(1, 2, 16, 128, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        att.flash_fwd(q32, q32, q32, None, None, True, 0.125)
    q3 = torch.zeros(1, 16, 3 * 128, device=cuda, dtype=torch.bfloat16)
    kv3 = torch.zeros(1, 16, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="divide"):
        att.flash_fwd_heads(q3, kv3, kv3, 3, True, 0.125)
    with pytest.raises(NotImplementedError, match="head_dim"):
        att.flash_ring_fwd(q, q, q, 16, 0, 0.125)
    with pytest.raises(TypeError, match="bfloat16"):
        att.flash_ring_dq(q32, q32, q32, q32, q32[..., 0], q32[..., 0], 16,
                          0, 0.125)
    q4 = torch.zeros(1, 4, 16, 128, device=cuda, dtype=torch.bfloat16)
    rows = torch.zeros(1, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="divisible"):
        att.flash_ring_dkv(q4, q4[:, :3], q4[:, :3], q4, rows, rows, 16, 0,
                           0.125)


def _merge(o_a, lse_a, o_b, lse_b):
    """The ring's merge of two normalized blocks (f32)."""
    lse = torch.logaddexp(lse_a, lse_b)
    return (o_a.float() * (lse_a - lse).exp()[..., None]
            + o_b.float() * (lse_b - lse).exp()[..., None]), lse


@pytest.mark.parametrize("B,H,KVH,S", [
    (1, 4, 4, 128),
    (2, 8, 2, 200),    # GQA, ragged
    (1, 4, 1, 77),     # MQA, ragged
])
def test_ring_block_kernels_match_plain(cuda, B, H, KVH, S):
    """K12-K14 against their plain versions for the q shard of ring rank
    1 against the kv shards of ranks 1 (the diagonal), 0 (wholly
    visible) and 2 (wholly in the future: exact zeros, lse -1e30), with
    the lse and delta of the ring over the two visible blocks."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(B, h, S, 128, generator=gen, device=cuda)
                   .to(torch.bfloat16) for h in (H, KVH, KVH, H))
    scale = 128 ** -0.5
    starts = {"diagonal": S, "visible": 0, "future": 2 * S}
    before = att.launches()
    plain = {}
    for name, k_start in starts.items():
        o, lse = att.flash_ring_fwd(q, k, v, S, k_start, scale)
        o_p, lse_p = att.flash_ring_fwd_plain(q, k, v, S, k_start, scale)
        plain[name] = (o_p, lse_p)
        if name == "future":
            assert torch.all(o == 0) and torch.all(lse == att.NEG_INF)
            continue
        assert _rel(o, o_p) < 2e-2
        assert (lse - lse_p).abs().max().item() < 2e-2
    o_g, lse_g = _merge(*plain["diagonal"], *plain["visible"])
    delta = att.flash_bwd_preprocess_plain(do, o_g.to(torch.bfloat16))
    for name, k_start in starts.items():
        args = (q, k, v, do, lse_g, delta, S, k_start, scale)
        dq = att.flash_ring_dq(*args)
        dk, dv = att.flash_ring_dkv(*args)
        assert dq.dtype == dk.dtype == dv.dtype == torch.float32
        assert dk.shape == k.shape and dv.shape == v.shape
        if name == "future":
            assert not dq.any() and not dk.any() and not dv.any()
            continue
        dk_p, dv_p = att.flash_ring_dkv_plain(*args)
        assert _rel(dq, att.flash_ring_dq_plain(*args)) < 3e-2
        assert _rel(dk, dk_p) < 3e-2
        assert _rel(dv, dv_p) < 3e-2
    torch.cuda.synchronize()
    after = att.launches()
    for name in ("flash_ring_fwd", "flash_ring_dq", "flash_ring_dkv"):
        assert after[name] == before[name] + 3


@pytest.mark.parametrize("B,H,KVH,S,transposed", [
    (2, 8, 4, 500, True),    # ragged 500-row shards, q_start = 500
    (2, 8, 4, 500, False),   # the same cut from a [B, H, S, D] buffer
    (1, 8, 2, 256, True),    # GQA g = 4: two 128-row kv blocks a head
    (1, 2, 1, 77, True),     # ragged, shorter than one tile
    (2, 8, 2, 200, True),    # ragged against 128-row q and 64-row kv boxes
])
def test_ring_block_kernels_on_shard_views(cuda, B, H, KVH, S, transposed):
    """K12-K14 on shards of one sequence of 4 ring shards, as the [seq4]
    run hands them: views at a row offset of a [B, 4S, heads, D] buffer
    seen as [B, heads, 4S, D] (``transposed``) or of a [B, heads, 4S, D]
    one. The q shard of rank 1 (q_start = S) against the kv shards of
    ranks 1 (diagonal), 0 (visible) and 2 (future: exact zeros, lse
    -1e30). Shard 2 of every operand is scaled by 1000, so a tile that
    read past the end of shard 1 into it would show: K12's and K13's
    tensor maps read q (and K13's do) in 128-row boxes and k/v in 128-
    (K12) or 64-row (K13) boxes, K14's the other way round, each map
    bounded by the shard's length."""
    gen = torch.Generator(device=cuda).manual_seed(5)

    def whole(heads):
        if transposed:
            t = torch.randn(B, 4 * S, heads, 128, generator=gen,
                            device=cuda).to(torch.bfloat16).transpose(1, 2)
        else:
            t = torch.randn(B, heads, 4 * S, 128, generator=gen,
                            device=cuda).to(torch.bfloat16)
        t[:, :, 2 * S:3 * S] *= 1000
        return t

    q_all, k_all, v_all, do_all = whole(H), whole(KVH), whole(KVH), whole(H)

    def shard(t, rank):
        return t[:, :, rank * S:(rank + 1) * S]

    q, do = shard(q_all, 1), shard(do_all, 1)
    assert not q.is_contiguous() and q.data_ptr() != q_all.data_ptr()
    scale = 128 ** -0.5
    ranks = {"diagonal": 1, "visible": 0, "future": 2}
    plain = {}
    for name, c in ranks.items():
        k, v = shard(k_all, c), shard(v_all, c)
        o, lse = att.flash_ring_fwd(q, k, v, S, c * S, scale)
        if name == "future":
            assert torch.all(o == 0) and torch.all(lse == att.NEG_INF)
            continue
        o_p, lse_p = att.flash_ring_fwd_plain(q, k, v, S, c * S, scale)
        assert _rel(o, o_p) < 2e-2
        assert (lse - lse_p).abs().max().item() < 2e-2
        plain[name] = (o_p, lse_p)
    o_g, lse_g = _merge(*plain["diagonal"], *plain["visible"])
    delta = att.flash_bwd_preprocess_plain(do, o_g.to(torch.bfloat16))
    for name, c in ranks.items():
        args = (q, shard(k_all, c), shard(v_all, c), do, lse_g, delta, S,
                c * S, scale)
        dq = att.flash_ring_dq(*args)
        dk, dv = att.flash_ring_dkv(*args)
        if name == "future":
            assert not dq.any() and not dk.any() and not dv.any()
            continue
        dk_p, dv_p = att.flash_ring_dkv_plain(*args)
        assert _rel(dq, att.flash_ring_dq_plain(*args)) < 3e-2
        assert _rel(dk, dk_p) < 3e-2
        assert _rel(dv, dv_p) < 3e-2


def test_ring_attention_through_the_kernels(cuda):
    """ring_attention over 4 in-process ranks of 128 positions (GQA) on
    K12-K14 and K2, against autograd through mha_reference in f32."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    B, H, KVH, S = 2, 8, 2, 512
    q, k, v, do = (torch.randn(B, h, S, 128, generator=gen, device=cuda)
                   .to(torch.bfloat16) for h in (H, KVH, KVH, H))
    before = att.launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ring_attention(*leaves, mesh=build_mesh(MeshConfig(seq=4)))
    out.backward(do)
    torch.cuda.synchronize()
    after = att.launches()
    for name, want in (("flash_ring_fwd", 10), ("flash_ring_dq", 10),
                       ("flash_ring_dkv", 10), ("flash_bwd_preprocess", 4),
                       ("flash_fwd", 0), ("flash_bwd_dq", 0)):
        assert after[name] == before[name] + want, name
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    want = att.mha_reference(*ref, causal=True)
    want.backward(do.float())
    assert out.dtype == torch.bfloat16
    assert _rel(out, want) < 2e-2
    for got, r in zip(leaves, ref):
        assert _rel(got.grad, r.grad) < 3e-2


@pytest.mark.parametrize("shape", [(1000,), (3, 256), (7, 33, 5)])
def test_quantize_kernels_match_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=cuda)
    x.view(-1)[:256] = 0.0  # an all-zero row: scale 1
    rows = -(-x.numel() // qz.BLOCK)
    u = torch.rand((rows, qz.BLOCK), generator=gen, device=cuda)
    for stochastic in (True, False):
        q, s, orig = qz.quantize_int8(x, u=u, stochastic=stochastic)
        qp, sp = qz.quantize_int8_plain(x, u, stochastic)
        assert torch.equal(q, qp) and torch.equal(s, sp)
        assert s[0].item() == 1.0
        assert torch.equal(qz.dequantize_int8(q, s, orig),
                           qz.dequantize_int8_plain(q, s, orig))


def _opt_tree(cuda, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    shapes = [(7, 33), (1000,), (256,), (2, 300)]
    params = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
    grads = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
    grads[2] = None  # no grad: zeros, an all-zero row
    return params, grads, gen


@pytest.mark.parametrize("bits", [32, 8])
@pytest.mark.parametrize("clip,wd", [(None, 0.0), (0.5, 0.01)])
def test_fused_adamw_kernels_match_plain(cuda, bits, clip, wd):
    params, grads, gen = _opt_tree(cuda, 2)
    meta = fo.flatten_meta(params)
    r = meta.total_rows
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd, clip_norm=clip)
    if bits == 32:
        state = [torch.zeros((r, qz.BLOCK), device=cuda) for _ in range(2)]
    else:
        state = [torch.zeros((r, qz.BLOCK), dtype=torch.int8, device=cuda),
                 torch.ones((r, 1), device=cuda),
                 torch.zeros((r, qz.BLOCK), dtype=torch.uint8, device=cuda),
                 torch.ones((r, 1), device=cuda)]

    def step(kernel, count, ps, st, u):
        norm = fo._global_norm(grads) if clip is not None else None
        sc = fo._scalars(count, count + 1, 1e-2, 0.9, 0.999, norm, cuda)
        if bits == 32:
            fn = fo.fused_adamw32 if kernel else fo.fused_adamw32_plain
            fn(sc, ps, grads, *st, meta, **kw)
        else:
            fn = fo.fused_adamw8 if kernel else fo.fused_adamw8_plain
            fn(sc, ps, grads, *st, u, meta, **kw)

    def draw():
        return torch.rand((r, qz.BLOCK), generator=gen, device=cuda)

    for count in range(2):  # a non-trivial state first
        step(False, count, params, state, draw())
    u = draw()
    pk, sk = [p.clone() for p in params], [t.clone() for t in state]
    pp, sp = [p.clone() for p in params], [t.clone() for t in state]
    name = "fused_adamw32" if bits == 32 else "fused_adamw8"
    before = getattr(fo, name).launches
    step(True, 2, pk, sk, u)
    step(False, 2, pp, sp, u)
    torch.cuda.synchronize()
    assert getattr(fo, name).launches == before + 1
    if bits == 32:
        for got, want in zip(pk + sk, pp + sp):
            err = (got - want).abs().max() / want.abs().max()
            assert err.item() <= 1e-6
        return
    moved = max((a - b).abs().max().item() for a, b in zip(pp, params))
    for got, want in zip(pk, pp):
        assert (got - want).abs().max().item() <= 1e-4 * moved
    for got, want in ((sk[0], sp[0]), (sk[2], sp[2])):
        diff = (got.int() - want.int()).abs()
        assert diff.max().item() <= 1
        assert (diff != 0).float().mean().item() <= 1e-4
    for got, want in ((sk[1], sp[1]), (sk[3], sp[3])):
        assert ((got - want).abs() / want.abs()).max().item() <= 1e-6
