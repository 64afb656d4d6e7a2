"""Parity of the port's fused-heads attention with the JAX package's in
bfloat16, on the model-native [B, S, H, Dh] layout.

tests/test_torch_attention_bshd.py holds the two packages together in
f32 at head_dim 16. Here both run the bf16 compute path the bshd model
trains with, at the head_dim the port's kernels are built for (128): q,
k, v and the output gradient are bf16 (the same numpy values, rounded
once to bf16 on each side); ``flash_attention_bshd`` runs the JAX
fused-heads Pallas kernels in interpret mode on the CPU and the port's
autograd Function, whose CPU path is the plain versions of K9, K2, K10
and K11. Forward output and the q/k/v gradients come back in bf16 on
both sides.

Tolerance: the largest absolute difference at most 2e-2 of each
output's largest absolute value. Both sides round their bf16 results
once (2^-9 relative), but the JAX kernels also round P and dS to bf16
before their products, where the port's plain versions stay in f32;
that is a few bf16 steps at the largest values. A wrong mask, group sum
or head layout gives errors of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops.attention import flash_attention_bshd as jax_bshd
from dlrover_tpu_torch.ops import attention as port

REL_TOL = 2e-2
BLOCK = 32
D = 128

CASES = {
    # name: (B, H, KVH, S, window, prefix)
    "causal": (1, 2, 2, 96, None, None),
    "window": (1, 2, 2, 96, 40, None),
    "window-prefix": (1, 2, 1, 96, 40, 24),
    "gqa-g2": (2, 4, 2, 64, None, None),
    "gqa-g4": (1, 4, 1, 64, None, None),
    "ragged": (1, 4, 2, 72, None, None),
}


def _bf16(x):
    """A numpy f32 array as (jax bf16, torch bf16) of the same values."""
    return jnp.asarray(x, dtype=jnp.bfloat16), torch.tensor(x).bfloat16()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_bshd_matches_jax_in_bf16(case):
    B, H, KVH, S, window, prefix = CASES[case]
    rng = np.random.RandomState(11)
    data = [rng.randn(B, S, h, D).astype(np.float32)
            for h in (H, KVH, KVH, H)]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_bf16(x) for x in data)

    def jax_out(q, k, v):
        return jax_bshd(q, k, v, causal=True, block_q=BLOCK, block_k=BLOCK,
                        fused=True, window=window, prefix_len=prefix,
                        interpret=True)

    j_o = jax_out(jq, jk, jv)
    j_grads = jax.grad(
        lambda *a: jnp.sum(jax_out(*a).astype(jnp.float32)
                           * jdo.astype(jnp.float32)),
        argnums=(0, 1, 2))(jq, jk, jv)

    port.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    t_o = port.flash_attention_bshd(*leaves, fused=True, window=window,
                                    prefix_len=prefix)
    t_o.backward(tdo)
    # the CPU path runs the plain versions: no kernel is launched
    assert sum(port.launches().values()) == 0

    assert j_o.dtype == jnp.bfloat16 and t_o.dtype == torch.bfloat16
    assert t_o.shape == tq.shape
    err = _rel(t_o.detach().float().numpy(), j_o.astype(jnp.float32))
    assert err <= REL_TOL, f"o: relative error {err}"
    for name, t, j in zip("qkv", leaves, j_grads):
        assert j.dtype == jnp.bfloat16 and t.grad.dtype == torch.bfloat16
        err = _rel(t.grad.float().numpy(), j.astype(jnp.float32))
        assert err <= REL_TOL, f"d{name}: relative error {err}"
