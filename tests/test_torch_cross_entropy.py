"""Parity of the port's chunked ``fused_linear_cross_entropy`` (ops/
cross_entropy.py) and of ``llama_loss_fn`` at ``ce_chunks > 1`` with the
JAX package's, on the CPU in float32 from the same numpy inputs (seeded).

Tolerances: ``loss_sum`` within 1e-5 relative, ``valid_sum`` exactly,
the gradients of h, w and norm_scale within 1e-5 of each tensor's largest
value (observed below 5e-7: f32 sums in another order); the Llama loss
within 1e-5 absolute and its gradients within 1e-5 relative, against the
JAX loss and against the port's own ``ce_chunks=1`` loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
from dlrover_tpu.models.llama import llama_init as jax_init
from dlrover_tpu.models.llama import llama_loss_fn as jax_loss_fn
from dlrover_tpu.ops.cross_entropy import (
    fused_linear_cross_entropy as jax_flce,
)
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
from dlrover_tpu.parallel.mesh import build_mesh, set_mesh
from dlrover_tpu_torch.models import LlamaConfig, llama_loss_fn, params_from_jax
from dlrover_tpu_torch.ops import cross_entropy as tce
from dlrover_tpu_torch.ops.cross_entropy import fused_linear_cross_entropy
from dlrover_tpu_torch.parallel import Strategy, auto_accelerate
from dlrover_tpu_torch.trainer import build_optimizer

SMALL = dict(
    vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=96,
    max_seq_len=64, attn_impl="flash", remat=False, dtype="float32",
    attn_block_q=16, attn_block_k=16,
)
B, S, D, V = 2, 13, 16, 50  # S odd: 3 and 4 chunks need padding


@pytest.fixture(autouse=True)
def _restore_global_mesh(monkeypatch):
    from dlrover_tpu.parallel import mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(B, S, D).astype(np.float32)
    w = (rng.randn(D, V) * 0.3).astype(np.float32)
    ns = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    labels[0, 3] = labels[1, -1] = labels[1, 0] = -100
    return h, w, ns, labels


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(got.detach().numpy() - want))
                 / np.max(np.abs(want)))


@pytest.mark.parametrize("use_norm", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("n", [1, 3, 4])
def test_fused_linear_cross_entropy_matches_jax(n, use_norm):
    h, w, ns, labels = _inputs()
    argnums = (0, 1, 2) if use_norm else (0, 1)

    def j_loss(h, w, ns):
        return jax_flce(h, w, jnp.asarray(labels), n_chunks=n,
                        norm_scale=ns if use_norm else None)

    j_sum, j_valid = j_loss(h, w, ns)
    j_grads = jax.grad(lambda *a: j_loss(*a)[0], argnums=argnums)(h, w, ns)

    th, tw, tn = (torch.tensor(a, requires_grad=True) for a in (h, w, ns))
    t_sum, t_valid = fused_linear_cross_entropy(
        th, tw, torch.tensor(labels), n_chunks=n,
        norm_scale=tn if use_norm else None)
    t_sum.backward()
    assert abs(t_sum.item() - float(j_sum)) <= 1e-5 * abs(float(j_sum))
    assert int(t_valid) == int(j_valid) == B * S - 3
    got = (th.grad, tw.grad, tn.grad) if use_norm else (th.grad, tw.grad)
    for g, want in zip(got, j_grads):
        assert _rel(g, want) <= 1e-5
    if not use_norm:
        assert tn.grad is None


def test_chunks_are_the_padded_jax_chunks_without_their_padding():
    # S = 13 in 4 chunks: JAX pads to 16 and cuts 4 chunks of 4
    assert tce._chunks(13, 4) == [slice(0, 4), slice(4, 8), slice(8, 12),
                                  slice(12, 13)]
    # a chunk wholly of padding (S = 9 padded to 12) is no slice at all
    assert tce._chunks(9, 4) == [slice(0, 3), slice(3, 6), slice(6, 9)]
    assert tce._chunks(8, 1) == [slice(0, 8)]


def test_norm_fn_closure_is_not_ported():
    h, w, _ns, labels = _inputs()
    with pytest.raises(NotImplementedError, match="legacy closure hook"):
        fused_linear_cross_entropy(torch.tensor(h), torch.tensor(w),
                                   torch.tensor(labels),
                                   norm_fn=lambda x: x)


def _llama_pair(ce_chunks):
    jc = JaxConfig(**dict(SMALL, ce_chunks=ce_chunks))
    set_mesh(build_mesh(JaxMesh(data=1), devices=jax.devices()[:1]))
    j_params = jax_init(jc, jax.random.key(0))
    tokens = np.random.RandomState(1).randint(0, 64, (2, 18)).astype(
        np.int32)
    return jc, j_params, tokens


def _port_loss_and_grads(cfg, j_params, tokens):
    params = {k: v.requires_grad_() for k, v in params_from_jax(
        jax.tree.map(np.asarray, j_params)).items()}
    loss = llama_loss_fn(cfg)(params, {"tokens": torch.tensor(tokens)}, None)
    loss.backward()
    return loss, {k: p.grad for k, p in params.items()}


@pytest.mark.parametrize("ce_chunks", [2, 3])
def test_llama_loss_at_ce_chunks_matches_jax(ce_chunks):
    """17 labels: 2 chunks of 9 (one padding row), 3 of 6."""
    jc, j_params, tokens = _llama_pair(ce_chunks)
    j_loss, j_grads = jax.value_and_grad(jax_loss_fn(jc))(
        j_params, {"tokens": jnp.asarray(tokens)}, None)
    loss, grads = _port_loss_and_grads(
        LlamaConfig(**dict(SMALL, ce_chunks=ce_chunks)), j_params, tokens)
    assert abs(loss.item() - float(j_loss)) <= 1e-5
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    for name, g in grads.items():
        assert _rel(g, want[name].numpy()) <= 1e-5, name


def test_llama_loss_at_ce_chunks_matches_its_own_unchunked_loss():
    _jc, j_params, tokens = _llama_pair(2)
    one, g_one = _port_loss_and_grads(LlamaConfig(**SMALL), j_params,
                                      tokens)
    two, g_two = _port_loss_and_grads(
        LlamaConfig(**dict(SMALL, ce_chunks=2)), j_params, tokens)
    assert abs(two.item() - one.item()) <= 1e-5
    for name, g in g_one.items():
        assert _rel(g_two[name], g.numpy()) <= 1e-5, name


@pytest.mark.parametrize("remat", ["minimal", "full"])
def test_strategy_remat_runs_the_chunked_loss_once(monkeypatch, remat):
    """Under a strategy remat the chunked CE sits outside the checkpoint:
    its chunk loop runs once in the forward and once in its backward
    (not again in a recompute), and the losses equal remat "none"'s."""
    cfg = LlamaConfig(**dict(SMALL, ce_chunks=2))
    runs = []
    real = tce._chunks
    monkeypatch.setattr(tce, "_chunks",
                        lambda *a: runs.append(a) or real(*a))
    tokens = np.random.RandomState(2).randint(0, 64, (4, 17)).astype(
        np.int32)
    losses = {}
    for mode in ("none", remat):
        res = auto_accelerate(
            llama_loss_fn(cfg),
            lambda seed, device: params_from_jax(jax.tree.map(
                np.asarray, jax_init(JaxConfig(**dict(SMALL, ce_chunks=2)),
                                     jax.random.key(0))), device),
            build_optimizer("adamw", 1e-2), Strategy(
                compute_dtype="float32", remat=mode), device="cpu")
        state, out = res.state, []
        runs.clear()
        for _ in range(2):
            state, m = res.train_step(state, {"tokens": tokens}, None)
            out.append(m["loss"].item())
        assert len(runs) == 2 * 2, (mode, len(runs))
        losses[mode] = out
    np.testing.assert_allclose(losses[remat], losses["none"], atol=1e-6)


def test_ce_chunks_no_longer_raises():
    cfg = dataclasses.replace(LlamaConfig(**SMALL), ce_chunks=4)
    assert llama_loss_fn(cfg).remat_split is not None
