"""Parity of the port's GPT-2 (dlrover_tpu_torch.models.gpt2) with the
JAX package's, from the same weights: JAX ``gpt2_init`` params go through
``params_from_jax``. The model is cut to 2 layers and narrow widths but
keeps the family's head_dim 64 (dim 128, 2 heads), so the flash branch
runs K1-K4's head_dim 64 path (on the CPU, the kernels' plain versions).
The JAX flash kernels run in Pallas interpret mode with 16-row blocks, as
``tests/test_gpt2.py`` runs them.

Tolerances: in float32, logits and loss 1e-5 absolute, gradients 1e-5
relative to each tensor's largest entry (both sides compute in f32 and
differ only in summation order); three adamw steps through
``auto_accelerate``, each loss within 1e-5 relative. The bf16 default
path (``Strategy()``, bf16 compute over f32 masters, per-layer remat):
each step's loss within 2e-2 absolute, as tests/test_torch_bf16_default.py
holds the Llama model (both sides round to bf16 at the same places, in a
different order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models.gpt2 import GPT2_PRESETS as JAX_PRESETS
from dlrover_tpu.models.gpt2 import GPT2Config as JaxConfig
from dlrover_tpu.models.gpt2 import gpt2_apply as jax_apply
from dlrover_tpu.models.gpt2 import gpt2_init as jax_init
from dlrover_tpu.models.gpt2 import gpt2_logical_axes as jax_axes
from dlrover_tpu.models.gpt2 import gpt2_loss_fn as jax_loss_fn
from dlrover_tpu.parallel.accelerate import auto_accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
from dlrover_tpu.parallel.mesh import build_mesh as jax_build_mesh
from dlrover_tpu.parallel.mesh import set_mesh as jax_set_mesh
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu_torch.models import (
    GPT2_PRESETS,
    GPT2Config,
    gpt2_apply,
    gpt2_init,
    gpt2_logical_axes,
    gpt2_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.ops import attention as port_attention
from dlrover_tpu_torch.parallel import MeshConfig, Strategy, auto_accelerate
from dlrover_tpu_torch.parallel import build_mesh, set_mesh
from dlrover_tpu_torch.trainer import build_optimizer

SMALL = dict(
    vocab_size=64, dim=128, n_layers=2, n_heads=2, mlp_dim=256,
    max_seq_len=64, dtype="float32", attn_impl="flash", attn_block_q=16,
    attn_block_k=16,
)
LR = 1e-2


@pytest.fixture(autouse=True)
def _restore_global_mesh(monkeypatch):
    """The JAX side sets its process-global mesh; put it back after each
    test so other test files in this process see what they expect."""
    from dlrover_tpu.parallel import mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)


def _pair(**overrides):
    kw = dict(SMALL, **overrides)
    jax_set_mesh(jax_build_mesh(JaxMesh(data=1), devices=jax.devices()[:1]))
    jc = JaxConfig(**kw)
    p_np = jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))
    return jc, GPT2Config(**kw), p_np


def _tokens(seq_plus_one=33, batch=2):
    return np.random.RandomState(1).randint(
        0, SMALL["vocab_size"], (batch, seq_plus_one)).astype(np.int32)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def test_presets_and_param_count_match_jax():
    assert set(GPT2_PRESETS) == set(JAX_PRESETS)
    for name, jc in JAX_PRESETS.items():
        tc = GPT2_PRESETS[name]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
    big = GPT2_PRESETS["gpt2-1.5b"]
    assert (big.head_dim, big.n_layers, big.dim) == (64, 48, 1600)
    assert GPT2_PRESETS["gpt2-124m"].head_dim == 64


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_init_shapes_names_and_axes_match_jax(tie):
    jc, tc, p_np = _pair(tie_lm_head=tie)
    ours = gpt2_init(tc, seed=0, device="cpu")
    theirs = params_from_jax(p_np)
    assert set(ours) == set(theirs)
    for name, t in theirs.items():
        assert ours[name].shape == t.shape and ours[name].dtype == t.dtype
    # the same distributions: stds within 10% at these sizes
    for name in ("embed", "pos_embed", "layers.w_qkv", "layers.w_out"):
        assert abs(ours[name].std().item() / theirs[name].std().item()
                   - 1) < 0.1, name
    flat = params_from_jax(jax.tree.map(
        lambda a: np.zeros(0), jax_axes(jc),
        is_leaf=lambda x: isinstance(x, tuple)))
    assert set(gpt2_logical_axes(tc)) == set(flat)
    j_axes = jax_axes(jc)
    for name, axes in gpt2_logical_axes(tc).items():
        node = j_axes
        for part in name.split("."):
            node = node[part]
        assert axes == node, name


def test_params_from_jax_on_the_gpt2_tree():
    """The nested JAX GPT-2 tree flattens by dots, the layer axis kept,
    values and dtypes unchanged."""
    jc, tc, p_np = _pair(tie_lm_head=False)
    params = params_from_jax(p_np)
    assert params["layers.w_qkv"].shape == (2, 128, 384)
    assert params["lm_head"].shape == (128, 64)
    np.testing.assert_array_equal(params["layers.b_fc"].numpy(),
                                  p_np["layers"]["b_fc"])
    np.testing.assert_array_equal(params["pos_embed"].numpy(),
                                  p_np["pos_embed"])
    assert all(t.dtype == torch.float32 for t in params.values())


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("attn_impl", ["flash", "bshd", "reference"])
def test_gpt2_apply_logits_match_jax(attn_impl, tie):
    jc, tc, p_np = _pair(attn_impl=attn_impl, tie_lm_head=tie)
    tokens = _tokens()[:, :-1]
    j_logits = np.asarray(jax_apply(jc, jax.tree.map(jnp.asarray, p_np),
                                    jnp.asarray(tokens)))
    t_logits = gpt2_apply(tc, params_from_jax(p_np), torch.tensor(tokens))
    assert t_logits.dtype == torch.float32
    assert t_logits.shape == (2, 32, 64)
    np.testing.assert_allclose(t_logits.numpy(), j_logits, atol=1e-5)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_gpt2_loss_and_grads_match_jax(tie):
    jc, tc, p_np = _pair(tie_lm_head=tie)
    tokens = _tokens()
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jax_loss_fn(jc)(p, {"tokens": jnp.asarray(tokens)}, None))(
        jax.tree.map(jnp.asarray, p_np))
    params = {k: v.requires_grad_() for k, v in params_from_jax(p_np).items()}
    loss = gpt2_loss_fn(tc)(params, {"tokens": torch.tensor(tokens)}, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    j_flat = params_from_jax(jax.tree.map(np.asarray, j_grads))
    assert set(j_flat) == set(params)
    for name, g in j_flat.items():
        err = _rel(params[name].grad.numpy(), g.numpy())
        assert err < 1e-5, f"{name}: relative error {err}"


def test_remat_layers_give_the_same_grads():
    """``remat=True`` (each layer under the "dots_no_batch" checkpoint)
    computes the same loss and gradients as ``remat=False``."""
    _, tc, p_np = _pair()
    tokens = torch.tensor(_tokens())
    grads = []
    for remat in (False, True):
        params = {k: v.requires_grad_()
                  for k, v in params_from_jax(p_np).items()}
        cfg = dataclasses.replace(tc, remat=remat)
        gpt2_loss_fn(cfg)(params, {"tokens": tokens}, None).backward()
        grads.append({k: v.grad for k, v in params.items()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   atol=1e-6, rtol=1e-6)


def test_three_adamw_steps_through_auto_accelerate_match_jax():
    jc, tc, p_np = _pair(attn_impl="flash")
    rng = np.random.RandomState(2)
    batches = [rng.randint(0, 64, (4, 25)).astype(np.int32)
               for _ in range(3)]
    j_res = jax_accelerate(
        jax_loss_fn(jc), lambda r: jax_init(jc, r),
        optax.adamw(LR, weight_decay=0.0), jax_axes(jc),
        strategy=JaxStrategy(mesh=JaxMesh(data=1), compute_dtype="float32",
                             remat="none", donate=False),
        devices=jax.devices()[:1])
    j_state, j_losses = j_res.state, []
    for i, tokens in enumerate(batches):
        j_state, m = j_res.train_step(
            j_state, {"tokens": jnp.asarray(tokens)}, jax.random.key(i))
        j_losses.append(float(m["loss"]))

    t_res = auto_accelerate(
        gpt2_loss_fn(tc), lambda seed, device: params_from_jax(p_np, device),
        build_optimizer("adamw", LR, weight_decay=0.0),
        Strategy(compute_dtype="float32", remat="none"), device="cpu")
    t_state, t_losses = t_res.state, []
    for tokens in batches:
        t_state, m = t_res.train_step(t_state, {"tokens": tokens}, None)
        t_losses.append(m["loss"].item())
    assert t_state.step == 3
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=0)


def test_default_bf16_path_losses_match_jax():
    kw = dict(SMALL, dtype="bfloat16", remat=True, max_seq_len=128,
              attn_block_q=64, attn_block_k=64)
    jc, tc = JaxConfig(**kw), GPT2Config(**kw)
    assert Strategy().compute_dtype == "bfloat16"
    p_np = jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))
    tokens = np.random.RandomState(3).randint(0, 64, (4, 129)).astype(
        np.int32)
    j_res = jax_accelerate(
        jax_loss_fn(jc), lambda r: jax_init(jc, r),
        optax.adamw(LR, weight_decay=0.0), jax_axes(jc),
        strategy=JaxStrategy(mesh=JaxMesh(data=1)),
        devices=jax.devices()[:1])
    j_state, j_losses = j_res.state, []
    for i in range(3):
        j_state, m = j_res.train_step(
            j_state, {"tokens": jnp.asarray(tokens)}, jax.random.key(i))
        j_losses.append(float(m["loss"]))
    t_res = auto_accelerate(
        gpt2_loss_fn(tc), lambda seed, device: params_from_jax(p_np, device),
        build_optimizer("adamw", LR, weight_decay=0.0), Strategy(),
        device="cpu")
    t_state, t_losses = t_res.state, []
    for _ in range(3):
        t_state, m = t_res.train_step(t_state, {"tokens": tokens}, None)
        t_losses.append(m["loss"].item())
    assert all(np.isfinite(t_losses)) and t_losses[-1] < t_losses[0]
    np.testing.assert_allclose(t_losses, j_losses, atol=2e-2, rtol=0)


def test_seq_axis_logits_equal_the_reference():
    """Under a seq=2 mesh (the in-process ring over the ring-block
    kernels' plain versions on the CPU) the logits equal the reference
    branch's."""
    _, tc, p_np = _pair()
    params = params_from_jax(p_np)
    tokens = torch.tensor(_tokens()[:, :-1])
    with torch.no_grad():
        ref = gpt2_apply(dataclasses.replace(tc, attn_impl="reference"),
                         params, tokens)
        set_mesh(build_mesh(MeshConfig(seq=2)))
        try:
            out = gpt2_apply(tc, params, tokens)
        finally:
            set_mesh(None)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_max_seq_len_guard():
    _, tc, p_np = _pair()
    params = params_from_jax(p_np)
    too_long = torch.zeros(1, SMALL["max_seq_len"] + 1, dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        gpt2_apply(tc, params, too_long)
    out = gpt2_apply(tc, params, too_long[:, :-1])
    assert out.shape == (1, SMALL["max_seq_len"], 64)


def test_unported_settings_raise_naming_their_items():
    with pytest.raises(NotImplementedError, match="item 10"):
        gpt2_loss_fn(GPT2Config(**SMALL, pipe_schedule="1f1b"))
    with pytest.raises(NotImplementedError, match="item 10"):
        gpt2_init(GPT2Config(**dict(SMALL, attn_impl="ulysses")),
                  device="cpu")
    tc = GPT2Config(**SMALL)
    # item 12's compute dtypes are ported: the strategies build and run
    # (tests/test_torch_fp8.py holds them against the JAX package)
    for dtype in ("int8", "fp8"):
        res = auto_accelerate(gpt2_loss_fn(tc),
                              lambda s, d: gpt2_init(tc, s, d),
                              build_optimizer("sgd", 0.1),
                              Strategy(remat="none", compute_dtype=dtype),
                              device="cpu")
        assert f"dtype={dtype}" in res.strategy.describe()
    with pytest.raises(NotImplementedError, match="pipe"):
        build_mesh(MeshConfig(pipe=2))


def test_cpu_path_counts_no_launch():
    _, tc, p_np = _pair()
    port_attention.reset_launches()
    params = {k: v.requires_grad_() for k, v in params_from_jax(p_np).items()}
    gpt2_loss_fn(tc)(params, {"tokens": torch.tensor(_tokens())},
                     None).backward()
    assert sum(port_attention.launches().values()) == 0
