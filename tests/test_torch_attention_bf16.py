"""Parity of the port's flash attention with the JAX package's in bfloat16.

tests/test_torch_attention.py holds the two packages together in f32.
Here both run the bf16 compute path the model trains with: q, k, v, the
output gradient and the rope tables are bf16 (the same numpy values,
rounded once to bf16 on each side), the JAX kernels in Pallas interpret
mode on the CPU, the port through its autograd Function, whose CPU path
is the kernels' plain versions. Forward output and the q/k/v gradients
come back in bf16 on both sides.

Tolerance: the largest absolute difference at most 2e-2 of each
output's largest absolute value. Both sides round their bf16 results
once (2^-9 relative), but the JAX kernels also round P and dS to bf16
before their products and rope q/k into bf16 tiles, where the port's
plain versions stay in f32; that is a few bf16 steps at the largest
values. A wrong mask, rope or group sum gives errors of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops.attention import flash_attention as jax_flash
from dlrover_tpu_torch.ops import attention as port

REL_TOL = 2e-2

CASES = {
    # name: (B, H, KVH, S, D, window, prefix)
    "causal": (1, 4, 2, 128, 128, None, None),
    "window": (1, 4, 2, 128, 128, 48, None),
    "window-prefix": (1, 4, 1, 96, 128, 40, 24),
    # head_dim 64, the GPT-2 family's width
    "d64-causal": (1, 4, 2, 128, 64, None, None),
    "d64-window-prefix": (1, 4, 1, 96, 64, 40, 24),
}


def _rope_tables(B, S, D):
    half = D // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    ang = np.arange(S)[:, None] * freqs
    cos = np.concatenate([np.cos(ang)] * 2, -1)
    sin = np.concatenate([np.sin(ang)] * 2, -1)
    return (np.broadcast_to(cos, (B, S, D)).astype(np.float32).copy(),
            np.broadcast_to(sin, (B, S, D)).astype(np.float32).copy())


def _bf16(x):
    """A numpy f32 array as (jax bf16, torch bf16) of the same values."""
    return jnp.asarray(x, dtype=jnp.bfloat16), torch.tensor(x).bfloat16()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_jax_in_bf16(case):
    B, H, KVH, S, D, window, prefix = CASES[case]
    rng = np.random.RandomState(7)
    data = [rng.randn(B, h, S, D).astype(np.float32)
            for h in (H, KVH, KVH, H)]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_bf16(x) for x in data)
    (jcos, tcos), (jsin, tsin) = (_bf16(t) for t in _rope_tables(B, S, D))

    def jax_out(q, k, v):
        return jax_flash(q, k, v, causal=True, block_q=32, block_k=32,
                         rope_cos=jcos, rope_sin=jsin, window=window,
                         prefix_len=prefix, interpret=True)

    j_o = jax_out(jq, jk, jv)
    j_grads = jax.grad(
        lambda *a: jnp.sum(jax_out(*a).astype(jnp.float32)
                           * jdo.astype(jnp.float32)),
        argnums=(0, 1, 2))(jq, jk, jv)

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    t_o = port.flash_attention(*leaves, rope_cos=tcos, rope_sin=tsin,
                               window=window, prefix_len=prefix)
    t_o.backward(tdo)

    assert j_o.dtype == jnp.bfloat16 and t_o.dtype == torch.bfloat16
    err = _rel(t_o.detach().float().numpy(), j_o.astype(jnp.float32))
    assert err <= REL_TOL, f"o: relative error {err}"
    for name, t, j in zip("qkv", leaves, j_grads):
        assert j.dtype == jnp.bfloat16 and t.grad.dtype == torch.bfloat16
        err = _rel(t.grad.float().numpy(), j.astype(jnp.float32))
        assert err <= REL_TOL, f"d{name}: relative error {err}"
