"""Parity of the port's Llama (dlrover_tpu_torch.models) with the JAX
package's, from the same weights: JAX ``llama_init`` params go through
``params_from_jax``. Both sides run in float32 on the CPU; the JAX flash
kernels (``attn_impl`` "flash", and the fused-heads kernels of "bshd")
run in Pallas interpret mode with 16-row blocks.

Tolerances: logits and loss 1e-5 absolute (observed ~5e-7: f32 with a
different summation order); gradients 1e-5 relative to each tensor's
largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models.llama import PRESETS as JAX_PRESETS
from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
from dlrover_tpu.models.llama import llama_apply as jax_apply
from dlrover_tpu.models.llama import llama_init as jax_init
from dlrover_tpu.models.llama import llama_loss_fn as jax_loss_fn
from dlrover_tpu.ops.cross_entropy import (
    softmax_cross_entropy as jax_softmax_ce,
)
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
from dlrover_tpu.parallel.mesh import build_mesh, set_mesh
from dlrover_tpu_torch.models import (
    PRESETS,
    LlamaConfig,
    llama_apply,
    llama_init,
    llama_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.ops.cross_entropy import softmax_cross_entropy

SMALL = dict(
    vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=96,
    max_seq_len=64, remat=False, dtype="float32", attn_block_q=16,
    attn_block_k=16,
)


@pytest.fixture(autouse=True)
def _restore_global_mesh(monkeypatch):
    """The JAX side sets its process-global mesh; put it back after each
    test so other test files in this process see what they expect."""
    from dlrover_tpu.parallel import mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)


def _pair(attn_impl):
    kw = dict(SMALL, attn_impl=attn_impl)
    set_mesh(build_mesh(JaxMesh(data=1), devices=jax.devices()[:1]))
    jc = JaxConfig(**kw)
    j_params = jax_init(jc, jax.random.key(0))
    p_np = jax.tree.map(np.asarray, j_params)
    return jc, LlamaConfig(**kw), j_params, p_np


def _tokens(seq_plus_one=33):
    return np.random.RandomState(1).randint(
        0, SMALL["vocab_size"], (2, seq_plus_one)).astype(np.int32)


@pytest.mark.parametrize("attn_impl", ["flash", "bshd", "reference"])
def test_llama_apply_logits_match_jax(attn_impl):
    jc, tc, j_params, p_np = _pair(attn_impl)
    tokens = _tokens()[:, :-1]
    j_logits = np.asarray(jax_apply(jc, j_params, jnp.asarray(tokens)))
    t_logits = llama_apply(tc, params_from_jax(p_np), torch.tensor(tokens))
    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.numpy(), j_logits, atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["flash", "bshd"])
def test_llama_loss_and_grads_match_jax(attn_impl):
    jc, tc, j_params, p_np = _pair(attn_impl)
    tokens = _tokens()
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jax_loss_fn(jc)(p, {"tokens": jnp.asarray(tokens)}, None)
    )(j_params)
    params = {k: v.requires_grad_() for k, v in params_from_jax(p_np).items()}
    loss = llama_loss_fn(tc)(params, {"tokens": torch.tensor(tokens)}, None)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) < 1e-5
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    assert set(want) == set(params)
    for name, g in want.items():
        err = (params[name].grad - g).abs().max() / g.abs().max()
        assert err < 1e-5, f"grad {name}: relative error {err}"


def test_params_from_jax_keeps_stacked_layers():
    jc, tc, _, p_np = _pair("flash")
    params = params_from_jax(p_np)
    assert params["layers.wq"].shape == (2, 64, 64)
    assert params["layers.wk"].shape == (2, 64, 32)
    ours = llama_init(tc, seed=0, device="cpu")
    assert {k: v.shape for k, v in ours.items()} == {
        k: v.shape for k, v in params.items()}
    assert all(v.dtype == torch.float32 for v in ours.values())


def test_llama_init_distributions():
    cfg = LlamaConfig(**dict(SMALL, dim=256, mlp_dim=512, n_heads=4,
                             n_kv_heads=4, vocab_size=512))
    p = llama_init(cfg, seed=3, device="cpu")
    assert torch.all(p["layers.attn_norm"] == 1)
    # N(0, 1/fan_in): std within 5% over 131k draws
    assert abs(p["layers.wq"].std().item() * 256 ** 0.5 - 1) < 0.05
    assert abs(p["layers.w_down"].std().item() * 512 ** 0.5 - 1) < 0.05
    assert abs(p["embed"].std().item() / 0.02 - 1) < 0.05
    again = llama_init(cfg, seed=3, device="cpu")
    assert torch.equal(p["lm_head"], again["lm_head"])


def test_presets_match_jax():
    assert set(PRESETS) == set(JAX_PRESETS)
    for name, cfg in PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            JAX_PRESETS[name])
        assert cfg.param_count() == JAX_PRESETS[name].param_count()


@pytest.mark.parametrize("field,value", [
    ("pipe_virtual_stages", 2), ("pipe_schedule", "1f1b"),
])
def test_unported_settings_raise(field, value):
    cfg = LlamaConfig(**dict(SMALL, **{field: value}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama_loss_fn(cfg)


def test_softmax_cross_entropy_matches_jax_with_ignore_index():
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 7, 11).astype(np.float32) * 3
    labels = rng.randint(0, 11, (3, 7)).astype(np.int32)
    labels[0, 2:] = -100
    labels[2, 0] = -100
    j_loss, j_valid = jax_softmax_ce(jnp.asarray(logits), jnp.asarray(labels))
    t_loss, t_valid = softmax_cross_entropy(torch.tensor(logits),
                                            torch.tensor(labels))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(j_loss), atol=1e-5)
    assert torch.all(t_loss[0, 2:] == 0)
