"""Parity of the port's ring-block functions with the JAX package's in
bfloat16.

tests/test_torch_ring.py holds the two packages' ring blocks together in
f32 at head_dim 16. Here both run the bf16 compute path the [seq4] model
trains with, at head_dim 128: q, k, v and the output gradient are bf16
(the same numpy values, rounded once to bf16 on each side), lse and
delta f32. JAX runs ``ring_fwd_block``/``ring_dq_block``/
``ring_dkv_block`` in Pallas interpret mode with 16-row blocks, the port
its wrappers on the CPU, whose path is the kernels' plain versions. The
q shard of ring rank 1 meets the kv shards of ranks 1 (the diagonal), 0
(wholly visible) and 2 (wholly in its future); lse and delta are the
ring's over the two visible blocks, from the port's f32 plain versions.

Tolerance: the largest absolute difference at most 2e-2 of each output's
largest absolute value (o in bf16, lse, and the f32 dq, dk and dv), as
tests/test_torch_attention_bf16.py states it: the JAX kernels round P and
dS to bf16 before their products, where the port's plain versions stay
in f32. The future block is exactly zero on both sides (o, dq, dk, dv),
with lse -1e30.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import attention as jax_att
from dlrover_tpu_torch.ops import attention as port_att

REL_TOL = 2e-2
D = 128
# name: (B, H, KVH, shard length)
CASES = {"gqa": (1, 4, 1, 64), "ragged": (2, 2, 2, 40)}
# the q shard of rank 1 against the kv shard of rank 1, 0 and 2
RELATIONS = {"diagonal": 1, "visible": 0, "future": 2}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(B, H, KVH, S):
    """bf16 (jax, torch) pairs of q, k, v, do from one numpy draw, and the
    ring's f32 lse and delta of the q shard over its two visible blocks
    (the port's plain blocks in f32, merged as the ring merges them)."""
    rng = np.random.RandomState(11)
    data = [rng.randn(B, h, S, D).astype(np.float32)
            for h in (H, KVH, KVH, H)]
    pairs = [(jnp.asarray(x, dtype=jnp.bfloat16), torch.tensor(x).bfloat16())
             for x in data]
    q, k, v, do = (t.float() for _, t in pairs)
    scale = D ** -0.5
    blocks = [port_att.flash_ring_fwd_plain(q, k, v, S, c * S, scale)
              for c in (0, 1)]
    lse = torch.logaddexp(blocks[0][1], blocks[1][1])
    o = sum(o_c * (lse_c - lse).exp()[..., None] for o_c, lse_c in blocks)
    delta = port_att.flash_bwd_preprocess_plain(do, o)
    return pairs, lse.numpy(), delta.numpy()


@pytest.mark.parametrize("relation", sorted(RELATIONS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_blocks_match_jax_in_bf16(case, relation):
    B, H, KVH, S = CASES[case]
    pairs, lse, delta = _inputs(B, H, KVH, S)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = pairs
    q_start, k_start, scale = S, RELATIONS[relation] * S, D ** -0.5
    blocks = dict(block_q=16, block_k=16, interpret=True)

    j_o, j_lse = jax_att.ring_fwd_block(jq, jk, jv, q_start, k_start, scale,
                                        **blocks)
    wide = [np.broadcast_to(x[..., None], x.shape + (jax_att.STATS_W,))
            for x in (lse, delta)]
    j_dq = jax_att.ring_dq_block(jq, jk, jv, jdo, *wide, q_start, k_start,
                                 scale, **blocks)
    j_dk, j_dv = jax_att.ring_dkv_block(jq, jk, jv, jdo, *wide, q_start,
                                        k_start, scale, **blocks)

    t_o, t_lse = port_att.flash_ring_fwd(tq, tk, tv, q_start, k_start, scale)
    args = (tq, tk, tv, tdo, torch.tensor(lse), torch.tensor(delta),
            q_start, k_start, scale)
    t_dq = port_att.flash_ring_dq(*args)
    t_dk, t_dv = port_att.flash_ring_dkv(*args)

    assert j_o.dtype == jnp.bfloat16 and t_o.dtype == torch.bfloat16
    j_lse = np.asarray(j_lse)[..., 0]
    outs = {"o": (t_o.float(), j_o.astype(jnp.float32)),
            "lse": (t_lse, j_lse), "dq": (t_dq, j_dq), "dk": (t_dk, j_dk),
            "dv": (t_dv, j_dv)}
    for name, (got, want) in outs.items():
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape, name
        if relation == "future":
            fill = port_att.NEG_INF if name == "lse" else 0.0
            assert np.all(got == fill) and np.all(want == fill), name
            continue
        err = _rel(got, want)
        assert err <= REL_TOL, f"{name}: relative error {err}"
    for t in (t_dq, t_dk, t_dv):
        assert t.dtype == torch.float32
