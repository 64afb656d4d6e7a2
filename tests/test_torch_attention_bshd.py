"""Parity of the port's fused-heads attention (``flash_attention_bshd``
and the plain versions of K9-K11 in dlrover_tpu_torch.ops.attention) with
the JAX package's, on the [B, S, H*Dh] layout.

Both run on the CPU in float32 from the same numpy inputs: the JAX
fused-heads Pallas kernels (``_fwd_fused`` / ``_bwd_fused``) and
``flash_attention_bshd`` in Pallas interpret mode with 16-row blocks, the
port's plain versions and autograd Functions. Tolerance: 1e-5 absolute on
outputs and lse, 1e-5 relative to the largest gradient, absolute where
that is below 1 (at window 1 the true dq and dk are 0, softmax over one
key, and both sides hold only rounding residue of ~1e-7); both sides
compute in f32 and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops.attention import _bwd_fused, _fwd_fused, _mask_extras
from dlrover_tpu.ops.attention import flash_attention_bshd as jax_bshd
from dlrover_tpu_torch.ops import attention as port

BLOCK = 16
CASES = {
    # name: (B, H, KVH, q_len, kv_len, causal, window, prefix)
    "mha": (2, 4, 4, 32, 32, True, None, None),
    "gqa-h4-kv2": (2, 4, 2, 32, 32, True, None, None),
    "gqa-h8-kv2": (1, 8, 2, 32, 32, True, None, None),
    "ragged-96-200": (1, 4, 2, 96, 200, True, None, None),
    "noncausal": (1, 4, 2, 40, 40, False, None, None),
    "window": (1, 4, 2, 48, 48, True, 20, None),
    "window-1": (1, 4, 2, 32, 32, True, 1, None),
    "prefix": (1, 4, 2, 48, 48, True, None, 9),
    "window-prefix": (1, 4, 2, 48, 48, True, 20, 9),
    "window-prefix-ragged": (1, 4, 2, 40, 72, True, 17, 5),
}
D = 16


def _inputs(case, seed=0):
    B, H, KVH, q_len, kv_len, causal, window, prefix = CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(B, q_len, H * D).astype(np.float32)
    k = rng.randn(B, kv_len, KVH * D).astype(np.float32)
    v = rng.randn(B, kv_len, KVH * D).astype(np.float32)
    do = rng.randn(B, q_len, H * D).astype(np.float32)
    return (q, k, v, do), (H, KVH, causal, window, prefix)


def _close_grads(got, want, names):
    for name, g, j in zip(names, got, want):
        j = np.asarray(j)
        err = np.abs(np.asarray(g) - j).max() / max(np.abs(j).max(), 1.0)
        assert err < 1e-5, f"{name}: relative error {err}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernels_match_jax_fused_kernels(case):
    """K9's plain version against ``_fwd_fused`` (o, lse) and K2 + K10 +
    K11's against ``_bwd_fused`` (dq, dk, dv) on the same tensors."""
    (q, k, v, do), (H, KVH, causal, window, prefix) = _inputs(case)
    scale = D ** -0.5
    with _mask_extras(window, prefix):
        j_o, j_lse = _fwd_fused(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), H, KVH, scale, causal,
                                BLOCK, BLOCK, True)
        j_grads = _bwd_fused(H, KVH, scale, causal, BLOCK, BLOCK, True,
                             (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              j_o, j_lse), jnp.asarray(do))
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = port.flash_fwd_heads_plain(tq, tk, tv, H, causal, scale, window,
                                        prefix)
    np.testing.assert_allclose(o.numpy(), np.asarray(j_o), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0],
                               atol=1e-5)
    delta = port.flash_bwd_preprocess_plain(port._split_heads(tdo, H),
                                            port._split_heads(o, H))
    args = (tq, tk, tv, tdo, lse, delta, H, causal, scale, window, prefix)
    dq = port.flash_bwd_dq_heads_plain(*args)
    dk, dv = port.flash_bwd_dkv_heads_plain(*args)
    assert dq.shape == tq.shape and dk.shape == tk.shape
    _close_grads((dq, dk, dv), j_grads, ("dq", "dk", "dv"))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_bshd_matches_jax(case, fused):
    """The public [B, S, H, Dh] function, outputs and grads, through the
    fused-heads route (K9-K11) and the per-head route (K1-K4)."""
    (q, k, v, do), (H, KVH, causal, window, prefix) = _inputs(case, seed=1)
    B, q_len, kv_len = q.shape[0], q.shape[1], k.shape[1]
    q, do = q.reshape(B, q_len, H, D), do.reshape(B, q_len, H, D)
    k, v = k.reshape(B, kv_len, KVH, D), v.reshape(B, kv_len, KVH, D)
    mask = {"causal": causal, "window": window, "prefix_len": prefix}

    def jax_out(q, k, v):
        return jax_bshd(q, k, v, block_q=BLOCK, block_k=BLOCK, fused=fused,
                        interpret=True, **mask)

    j_o = np.asarray(jax_out(q, k, v))
    j_grads = jax.grad(
        lambda *a: jnp.sum(jax_out(*a) * do), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    t_o = port.flash_attention_bshd(tq, tk, tv, block_q=BLOCK, block_k=BLOCK,
                                    fused=fused, **mask)
    assert t_o.shape == tq.shape
    (t_o * torch.tensor(do)).sum().backward()
    np.testing.assert_allclose(t_o.detach().numpy(), j_o, atol=1e-5)
    _close_grads((t.grad for t in (tq, tk, tv)), j_grads, ("dq", "dk", "dv"))


def test_cpu_path_counts_no_launch():
    port.reset_launches()
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    out = port.flash_attention_bshd(q, q, q)
    out.sum().backward()
    assert out.shape == q.shape
    counts = port.launches()
    assert {name: counts[name] for name in (
        "flash_fwd_heads", "flash_bwd_dq_heads", "flash_bwd_dkv_heads")} == {
        "flash_fwd_heads": 0, "flash_bwd_dq_heads": 0,
        "flash_bwd_dkv_heads": 0}
    assert sum(counts.values()) == 0


@pytest.mark.parametrize("bad", ["heads", "window", "prefix", "noncausal"])
def test_flash_attention_bshd_argument_checks(bad):
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    if bad == "heads":
        with pytest.raises(ValueError, match="divisible"):
            port.flash_attention_bshd(q, torch.zeros(1, 8, 3, 16),
                                      torch.zeros(1, 8, 3, 16))
    elif bad == "window":
        with pytest.raises(ValueError, match="window"):
            port.flash_attention_bshd(q, kv, kv, window=0)
    elif bad == "prefix":
        with pytest.raises(ValueError, match="prefix_len"):
            port.flash_attention_bshd(q, kv, kv, prefix_len=-1)
    else:
        with pytest.raises(ValueError, match="causal=True"):
            port.flash_attention_bshd(q, kv, kv, causal=False, prefix_len=2)
