"""Parity of the port's flash attention (dlrover_tpu_torch.ops.attention)
with the JAX package's Pallas flash attention.

Both run on the CPU in float32 from the same numpy inputs: the JAX
kernels in Pallas interpret mode with 16-row blocks (as tests/test_ops.py
runs them), the port through its autograd Function, whose CPU path is the
kernels' plain versions. Tolerance: 1e-5 absolute on outputs and 1e-5
relative to the largest gradient; both sides compute in f32 and differ
only in summation order (observed ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops.attention import flash_attention as jax_flash
from dlrover_tpu_torch.ops import attention as port


def _rope_tables(B, S, D):
    half = D // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    ang = np.arange(S)[:, None] * freqs
    cos = np.concatenate([np.cos(ang)] * 2, -1)
    sin = np.concatenate([np.sin(ang)] * 2, -1)
    return (np.broadcast_to(cos, (B, S, D)).astype(np.float32).copy(),
            np.broadcast_to(sin, (B, S, D)).astype(np.float32).copy())


CASES = {
    # name: (B, H, KVH, S, D, rope, causal)
    "mha": (2, 4, 4, 32, 16, False, True),
    "mha-rope": (2, 4, 4, 32, 16, True, True),
    "gqa-rope": (2, 4, 2, 32, 16, True, True),
    "gqa-rope-ragged": (1, 4, 2, 40, 16, True, True),
    "gqa-noncausal": (1, 4, 2, 32, 16, False, False),
    # head_dim 64, the GPT-2 family's width (K1-K4's second build)
    "d64-mha": (2, 4, 4, 32, 64, False, True),
    "d64-mha-rope": (2, 4, 4, 32, 64, True, True),
    "d64-gqa-rope": (2, 4, 2, 32, 64, True, True),
    "d64-gqa-rope-ragged": (1, 4, 2, 40, 64, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_jax(case):
    B, H, KVH, S, D, rope, causal = CASES[case]
    rng = np.random.RandomState(0)
    q = rng.randn(B, H, S, D).astype(np.float32)
    k = rng.randn(B, KVH, S, D).astype(np.float32)
    v = rng.randn(B, KVH, S, D).astype(np.float32)
    do = rng.randn(B, H, S, D).astype(np.float32)
    cos, sin = _rope_tables(B, S, D) if rope else (None, None)

    def jax_out(q, k, v):
        return jax_flash(q, k, v, causal=causal, block_q=16, block_k=16,
                         rope_cos=cos, rope_sin=sin)

    j_o = np.asarray(jax_out(q, k, v))
    j_grads = jax.grad(
        lambda *a: jnp.sum(jax_out(*a) * do), argnums=(0, 1, 2))(q, k, v)

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    t_tables = ({} if not rope else
                {"rope_cos": torch.tensor(cos), "rope_sin": torch.tensor(sin)})
    t_o = port.flash_attention(tq, tk, tv, causal=causal, **t_tables)
    (t_o * torch.tensor(do)).sum().backward()

    np.testing.assert_allclose(t_o.detach().numpy(), j_o, atol=1e-5)
    for name, t, j in zip("qkv", (tq, tk, tv), j_grads):
        j = np.asarray(j)
        err = np.abs(t.grad.numpy() - j).max() / np.abs(j).max()
        assert err < 1e-5, f"d{name}: relative error {err}"


# head_dim 64 under the mask extras, GQA, with and without rope:
# (q_len, window, prefix_len, rope)
D64_MASK_CASES = [
    (64, 24, None, True),
    (64, None, 16, False),
    (72, 20, 9, True),
]


@pytest.mark.parametrize("q_len,window,prefix,rope", D64_MASK_CASES)
def test_head_dim_64_masks_match_jax(q_len, window, prefix, rope):
    """K1-K4's plain versions at head_dim 64 under a sliding window and
    a prefix-LM mask against JAX flash_attention with 16-row blocks,
    outputs and grads (f32, the tolerances above)."""
    rng = np.random.RandomState(6)
    B, H, KVH, D = 1, 4, 2, 64
    q = rng.randn(B, H, q_len, D).astype(np.float32)
    k = rng.randn(B, KVH, q_len, D).astype(np.float32)
    v = rng.randn(B, KVH, q_len, D).astype(np.float32)
    do = rng.randn(B, H, q_len, D).astype(np.float32)
    cos, sin = _rope_tables(B, q_len, D) if rope else (None, None)
    mask = {"window": window, "prefix_len": prefix}

    def jax_out(q, k, v):
        return jax_flash(q, k, v, causal=True, block_q=16, block_k=16,
                         rope_cos=cos, rope_sin=sin, **mask)

    j_o = np.asarray(jax_out(q, k, v))
    j_grads = jax.grad(
        lambda *a: jnp.sum(jax_out(*a) * do), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tables = ({} if not rope else
              {"rope_cos": torch.tensor(cos), "rope_sin": torch.tensor(sin)})
    t_o = port.flash_attention(tq, tk, tv, causal=True, **tables, **mask)
    (t_o * torch.tensor(do)).sum().backward()

    np.testing.assert_allclose(t_o.detach().numpy(), j_o, atol=1e-5)
    for name, t, j in zip("qkv", (tq, tk, tv), j_grads):
        j = np.asarray(j)
        err = np.abs(t.grad.numpy() - j).max() / np.abs(j).max()
        assert err < 1e-5, f"d{name}: relative error {err}"


def test_plain_kernels_compose_to_autograd_of_reference():
    """The four plain kernel versions chained by hand equal autograd
    through plain attention with rope applied outside (f32, 1e-5)."""
    B, H, KVH, S, D = 1, 4, 2, 24, 16
    rng = np.random.RandomState(1)
    q, k, v, do = (torch.tensor(rng.randn(B, h, S, D), dtype=torch.float32)
                   for h in (H, KVH, KVH, H))
    cos, sin = (torch.tensor(t) for t in _rope_tables(B, S, D))
    scale = D ** -0.5
    o, lse = port.flash_fwd_plain(q, k, v, cos, sin, True, scale)
    delta = port.flash_bwd_preprocess_plain(do, o)
    dq = port.flash_bwd_dq_plain(q, k, v, do, lse, delta, cos, sin, True,
                                 scale)
    dk, dv = port.flash_bwd_dkv_plain(q, k, v, do, lse, delta, cos, sin,
                                      True, scale)

    rq, rk, rv = (t.clone().requires_grad_() for t in (q, k, v))
    ref = port.mha_reference(port._rope(rq, cos, sin),
                             port._rope(rk, cos, sin), rv, causal=True)
    (ref * do).sum().backward()
    torch.testing.assert_close(o, ref.detach(), atol=1e-5, rtol=0)
    for got, want in ((dq, rq.grad), (dk, rk.grad), (dv, rv.grad)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_fully_masked_rows_give_zero_output():
    """q_len > kv_len with end-aligned causality leaves the first rows
    without a visible key: o = 0 and lse = -1e30, as in the TPU kernel."""
    rng = np.random.RandomState(2)
    q = torch.tensor(rng.randn(1, 2, 8, 16), dtype=torch.float32)
    k = torch.tensor(rng.randn(1, 2, 5, 16), dtype=torch.float32)
    v = torch.tensor(rng.randn(1, 2, 5, 16), dtype=torch.float32)
    o, lse = port.flash_fwd(q, k, v, None, None, True, 0.25)
    assert torch.all(o[:, :, :3] == 0)
    assert torch.all(lse[:, :, :3] == port.NEG_INF)
    j_o = jax_flash(q.numpy(), k.numpy(), v.numpy(), causal=True,
                    block_q=16, block_k=16, sm_scale=0.25)
    np.testing.assert_allclose(o.numpy(), np.asarray(j_o), atol=1e-5)


def test_cpu_path_counts_no_launch():
    port.reset_launches()
    q = torch.zeros(1, 2, 8, 16)
    out = port.flash_attention(q, q, q)
    assert out.shape == q.shape
    assert port.launches() == {
        "flash_fwd": 0, "flash_bwd_preprocess": 0, "flash_bwd_dq": 0,
        "flash_bwd_dkv": 0, "flash_fwd_heads": 0, "flash_bwd_dq_heads": 0,
        "flash_bwd_dkv_heads": 0, "flash_ring_fwd": 0, "flash_ring_dq": 0,
        "flash_ring_dkv": 0,
    }


@pytest.mark.parametrize("bad", ["heads", "rope_shape", "rope_cross",
                                 "window", "prefix"])
def test_flash_attention_argument_checks(bad):
    q = torch.zeros(1, 4, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    tables = torch.zeros(1, 8, 16)
    if bad == "heads":
        with pytest.raises(ValueError, match="divisible"):
            port.flash_attention(q, torch.zeros(1, 3, 8, 16),
                                 torch.zeros(1, 3, 8, 16))
    elif bad == "rope_shape":
        with pytest.raises(ValueError, match="rope tables"):
            port.flash_attention(q, kv, kv, rope_cos=tables[:, :4],
                                 rope_sin=tables[:, :4])
    elif bad == "rope_cross":
        with pytest.raises(ValueError, match="self-attention"):
            port.flash_attention(q, kv[:, :, :4], kv[:, :, :4],
                                 rope_cos=tables, rope_sin=tables)
    else:
        extra = {"window": 0} if bad == "window" else {"prefix_len": -1}
        with pytest.raises(ValueError, match=">= "):
            port.flash_attention(q, kv, kv, **extra)
        with pytest.raises(ValueError, match="causal=True"):
            port.flash_attention(q, kv, kv, causal=False, window=4)


# (q_len, kv_len, window, prefix_len), the shapes of the JAX package's own
# window/prefix gradient tests (tests/test_ops.py)
MASK_CASES = [
    (128, 128, 64, None),
    (100, 100, 48, None),
    (96, 200, 64, None),
    (128, 128, None, 32),
    (100, 100, 33, 17),
]


@pytest.mark.parametrize("q_len,kv_len,window,prefix", MASK_CASES)
def test_window_prefix_match_jax(q_len, kv_len, window, prefix):
    """K1/K3/K4's plain versions under a sliding window and a prefix-LM
    mask (GQA, no rope) against JAX flash_attention(window, prefix_len)
    with 32-row blocks, outputs and grads."""
    rng = np.random.RandomState(5)
    B, H, KVH, D = 1, 4, 2, 16
    q = rng.randn(B, H, q_len, D).astype(np.float32)
    k = rng.randn(B, KVH, kv_len, D).astype(np.float32)
    v = rng.randn(B, KVH, kv_len, D).astype(np.float32)
    do = rng.randn(B, H, q_len, D).astype(np.float32)
    mask = {"window": window, "prefix_len": prefix}

    def jax_out(q, k, v):
        return jax_flash(q, k, v, causal=True, block_q=32, block_k=32, **mask)

    j_o = np.asarray(jax_out(q, k, v))
    j_grads = jax.grad(
        lambda *a: jnp.sum(jax_out(*a) * do), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    t_o = port.flash_attention(tq, tk, tv, causal=True, **mask)
    (t_o * torch.tensor(do)).sum().backward()

    np.testing.assert_allclose(t_o.detach().numpy(), j_o, atol=1e-5)
    for name, t, j in zip("qkv", (tq, tk, tv), j_grads):
        j = np.asarray(j)
        err = np.abs(t.grad.numpy() - j).max() / np.abs(j).max()
        assert err < 1e-5, f"d{name}: relative error {err}"
