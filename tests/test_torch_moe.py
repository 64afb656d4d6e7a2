"""Parity of the port's MoE (dlrover_tpu_torch.parallel.moe and the MoE
Llama) with the JAX package's, on the CPU in float32 from the same numpy
inputs, and the port of tests/test_moe.py's invariants.

JAX side: ``top_k_gating``/``moe_ffn`` of dlrover_tpu/parallel/moe.py,
the Llama's ``llama_loss_fn``/``llama_apply`` (its flash kernels in
Pallas interpret mode with 16-row blocks, on a one-device mesh) and its
``auto_accelerate``. Port side: the same functions on CPU tensors (the
attention kernels' plain versions).

Tolerances: ``dispatch`` equal; ``combine`` within 1e-6 absolute, aux,
z and the dropped share within 1e-6 of max(1, |value|) (z is a mean of
squared log-sum-exps, ~8 here, where one f32 ulp is 1e-6); the FFN's
output and the gradients of x, the router and the experts within 1e-5
relative to each tensor's largest entry (the router's at top_k 1 within
3e-6 absolute, see the test); the Llama's loss within 1e-5 absolute,
its gradients within 1e-5 relative (tests/test_torch_llama.py's); two
AdamW steps as tests/test_torch_accelerate.py holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
from dlrover_tpu.models.llama import llama_apply as jax_apply
from dlrover_tpu.models.llama import llama_init as jax_init
from dlrover_tpu.models.llama import llama_logical_axes as jax_axes
from dlrover_tpu.models.llama import llama_loss_fn as jax_loss_fn
from dlrover_tpu.parallel import moe as jax_moe
from dlrover_tpu.parallel.accelerate import auto_accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
from dlrover_tpu.parallel.mesh import build_mesh as jax_build_mesh
from dlrover_tpu.parallel.mesh import set_mesh as jax_set_mesh
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.parallel.strategy import auto_strategy as jax_auto_strategy
from dlrover_tpu_torch.models import (
    LlamaConfig,
    llama_apply,
    llama_init,
    llama_logical_axes,
    llama_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.parallel import Strategy, auto_accelerate, auto_strategy
from dlrover_tpu_torch.parallel import moe as port_moe
from dlrover_tpu_torch.trainer import build_optimizer

SMALL = dict(
    vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=32,
    max_seq_len=64, remat=False, dtype="float32", attn_block_q=16,
    attn_block_k=16, n_experts=4, moe_top_k=2,
)
LR = 1e-2


@pytest.fixture(autouse=True)
def _restore_global_mesh(monkeypatch):
    """The JAX side sets its process-global mesh; put it back after each
    test so other test files in this process see what they expect."""
    from dlrover_tpu.parallel import mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _moe_inputs(g=2, t=16, d=8, e=4, m=16, seed=0):
    """x [G,T,D], the JAX ``moe_init`` params (numpy) and dy [G,T,D]."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, jax_moe.moe_init(
        jax.random.key(seed), e, d, m))
    return (rng.randn(g, t, d).astype(np.float32), params,
            rng.randn(g, t, d).astype(np.float32))


def _check_gating(logits, cf, k):
    e = logits.shape[-1]
    j_cfg = jax_moe.MoEConfig(n_experts=e, top_k=k, capacity_factor=cf)
    t_cfg = port_moe.MoEConfig(n_experts=e, top_k=k, capacity_factor=cf)
    assert t_cfg.capacity(logits.shape[1]) == j_cfg.capacity(logits.shape[1])
    j_d, j_c, j_m = jax_moe.top_k_gating(jnp.asarray(logits), j_cfg)
    t_d, t_c, t_m = port_moe.top_k_gating(torch.tensor(logits), t_cfg)
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
    np.testing.assert_allclose(t_c.numpy(), np.asarray(j_c), rtol=0,
                               atol=1e-6)
    assert set(t_m) == set(j_m)
    for name in j_m:
        want = float(j_m[name])
        assert abs(float(t_m[name]) - want) <= 1e-6 * max(1.0, abs(want)), \
            name


# ---------------------------------------------------------------------------
# gating and the FFN against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [0.25, 1.0, 8.0])
def test_top_k_gating_matches_jax(capacity_factor, top_k):
    logits = np.random.RandomState(3).randn(2, 64, 4).astype(np.float32) * 2
    _check_gating(logits, capacity_factor, top_k)


@pytest.mark.parametrize("top_k", [1, 2])
def test_tied_router_logits_route_as_jax(top_k):
    """Ties go to the lower expert index, as ``jax.lax.top_k`` breaks
    them: all-equal rows, rows with two equal maxima, and logits rounded
    to a coarse grid (many ties among the top k)."""
    rng = np.random.RandomState(4)
    logits = np.round(rng.randn(2, 32, 6) * 2) / 2
    logits[0, :8] = 0.0
    logits[1, :8, [1, 4]] = 5.0
    _check_gating(logits.astype(np.float32), 1.0, top_k)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [0.25, 1.0, 8.0])
def test_moe_ffn_and_grads_match_jax(capacity_factor, top_k):
    x, p_np, dy = _moe_inputs(t=32)
    j_cfg = jax_moe.MoEConfig(4, top_k, capacity_factor)
    t_cfg = port_moe.MoEConfig(4, top_k, capacity_factor)

    def j_loss(params, x):
        y, m = jax_moe.moe_ffn(x, params, j_cfg)
        return (jnp.sum(y * dy) + 0.01 * m["aux_loss"]
                + 1e-3 * m["z_loss"]), (y, m)

    (_, (j_y, j_m)), j_grads = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x))
    params = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    tx = torch.tensor(x, requires_grad=True)
    t_y, t_m = port_moe.moe_ffn(tx, params, t_cfg)
    (torch.sum(t_y * torch.tensor(dy)) + 0.01 * t_m["aux_loss"]
     + 1e-3 * t_m["z_loss"]).backward()
    assert _rel(t_y.detach(), j_y) < 1e-5
    for name in j_m:
        want = float(j_m[name])
        got = float(t_m[name].detach())
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), name
    assert _rel(tx.grad, j_grads[1]) < 1e-5
    for name, g in j_grads[0].items():
        if name == "router" and top_k == 1:
            # the renormalised gate v / v is 1: the router's gradient is
            # the aux and z terms alone (~8e-4), plus what f32 rounding
            # leaves of the gate's analytically zero gradient (JAX's sits
            # up to 7e-7 from a float64 evaluation)
            err = float(np.abs(params[name].grad.numpy() - g).max())
            assert err < 3e-6, err
        else:
            assert _rel(params[name].grad, g) < 1e-5, name


# ---------------------------------------------------------------------------
# tests/test_moe.py's invariants on the port
# ---------------------------------------------------------------------------


def _port_inputs(**kw):
    x, p_np, _ = _moe_inputs(**kw)
    return torch.tensor(x), {k: torch.tensor(v) for k, v in p_np.items()}


def test_gating_invariants():
    cfg = port_moe.MoEConfig(n_experts=4, top_k=2, capacity_factor=1.0)
    x, params = _port_inputs()
    dispatch, combine, metrics = port_moe.top_k_gating(
        x @ params["router"], cfg)
    g, t, e = 2, 16, 4
    assert dispatch.shape == (g, t, e, cfg.capacity(t))
    assert set(dispatch.unique().tolist()) <= {0.0, 1.0}
    # each (expert, capacity) slot holds at most one token per group
    assert (dispatch.sum(dim=1) <= 1.0 + 1e-6).all()
    # each token takes at most k routes
    assert (dispatch.sum(dim=(2, 3)) <= cfg.top_k + 1e-6).all()
    assert (combine >= 0).all()
    assert (combine.sum(dim=(2, 3)) <= 1.0 + 1e-5).all()
    assert (combine[dispatch == 0.0] == 0.0).all()
    assert all(torch.isfinite(v) for v in metrics.values())


def test_moe_matches_dense_reference_with_ample_capacity():
    """Every token through its top-k experts, no capacity: the port's
    FFN at capacity factor 8 drops nothing and equals it."""
    cfg = port_moe.MoEConfig(n_experts=4, top_k=2, capacity_factor=8.0)
    x, p = _port_inputs()
    out, metrics = port_moe.moe_ffn(x, p, cfg)
    probs = torch.softmax(x @ p["router"], dim=-1)
    vals, idx = probs.topk(2, dim=-1)
    vals = vals / vals.sum(-1, keepdim=True)
    h = torch.nn.functional.silu(torch.einsum("gtd,edm->gtem", x, p["w_gate"]))
    full = torch.einsum("gtem,emd->gted",
                        h * torch.einsum("gtd,edm->gtem", x, p["w_up"]),
                        p["w_down"])
    ref = (full.gather(2, idx[..., None].expand(-1, -1, -1, 8))
           * vals[..., None]).sum(2)
    assert float(metrics["dropped"]) == 0.0
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_capacity_drops_tokens():
    cfg = port_moe.MoEConfig(n_experts=4, top_k=2, capacity_factor=0.25)
    x, p = _port_inputs(t=64)
    out, metrics = port_moe.moe_ffn(x, p, cfg)
    assert float(metrics["dropped"]) > 0.0
    assert torch.isfinite(out).all()


def test_balanced_router_aux_loss_is_one():
    # uniform routing: aux = E * sum(1/E * 1/E) = 1
    cfg = port_moe.MoEConfig(n_experts=4, top_k=1)
    _, _, metrics = port_moe.top_k_gating(torch.zeros(1, 128, 4), cfg)
    assert abs(float(metrics["aux_loss"]) - 1.0) < 0.05


def test_moe_init_shapes_and_scale():
    p = port_moe.moe_init(0, 4, 64, 128)
    assert p["router"].shape == (64, 4)
    assert p["w_gate"].shape == p["w_up"].shape == (4, 64, 128)
    assert p["w_down"].shape == (4, 128, 64)
    assert abs(p["w_gate"].std().item() * 64 ** 0.5 - 1) < 0.05
    assert abs(p["w_down"].std().item() * 128 ** 0.5 - 1) < 0.05


def test_metrics_are_recorded_per_layer_call():
    cfg = LlamaConfig(**SMALL)
    params = llama_init(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, 64, (2, 16))
    with port_moe.record_metrics() as seen:
        _, aux = llama_apply(cfg, params, tokens, return_aux=True)
    assert len(seen) == cfg.n_layers
    want = sum(cfg.moe_aux_weight * m["aux_loss"]
               + cfg.moe_z_weight * m["z_loss"] for m in seen)
    assert torch.allclose(aux.detach(), want)
    assert not port_moe._recording


# ---------------------------------------------------------------------------
# the MoE Llama against the JAX package's
# ---------------------------------------------------------------------------


def _pair(attn_impl="reference", **changes):
    kw = dict(SMALL, attn_impl=attn_impl, **changes)
    jax_set_mesh(jax_build_mesh(JaxMesh(data=1), devices=jax.devices()[:1]))
    jc = JaxConfig(**kw)
    j_params = jax_init(jc, jax.random.key(0))
    return jc, LlamaConfig(**kw), j_params, jax.tree.map(np.asarray,
                                                         j_params)


def _tokens(batch=2, seq_plus_one=33, seed=1):
    return np.random.RandomState(seed).randint(
        0, SMALL["vocab_size"], (batch, seq_plus_one)).astype(np.int32)


def test_moe_params_init_and_axes_match_jax():
    jc, tc, _, p_np = _pair()
    ours = llama_init(tc, seed=0, device="cpu")
    theirs = params_from_jax(p_np)
    assert {k: v.shape for k, v in ours.items()} == {
        k: v.shape for k, v in theirs.items()}
    assert ours["layers.w_gate"].shape == (2, 4, 32, 32)
    assert ours["layers.router"].shape == (2, 32, 4)
    flat = {f"layers.{k}" if k in jax_axes(jc)["layers"] else k: v
            for k, v in {**jax_axes(jc), **jax_axes(jc)["layers"]}.items()
            if k != "layers"}
    assert llama_logical_axes(tc) == {k: tuple(v) for k, v in flat.items()}
    assert tc.param_count() == jc.param_count()


def test_moe_llama_apply_and_aux_match_jax():
    jc, tc, j_params, p_np = _pair()
    tokens = _tokens()[:, :-1]
    j_logits, j_aux = jax_apply(jc, j_params, jnp.asarray(tokens),
                                return_aux=True)
    t_logits, t_aux = llama_apply(tc, params_from_jax(p_np),
                                  torch.tensor(tokens), return_aux=True)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-5)
    assert abs(t_aux.item() - float(j_aux)) < 1e-6
    assert t_aux.item() > 0


@pytest.mark.parametrize("ce_chunks", [1, 2])
@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_moe_llama_loss_and_grads_match_jax(attn_impl, ce_chunks):
    """loss + aux (both CE paths) and every gradient, the router's
    included."""
    jc, tc, j_params, p_np = _pair(attn_impl, ce_chunks=ce_chunks)
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
    assert params["layers.router"].grad.abs().sum() > 0
    for name, g in want.items():
        assert _rel(params[name].grad, g) < 1e-5, f"grad {name}"


@pytest.mark.parametrize("policy", ["dots_attn", "dots_no_batch", "dots"])
def test_moe_aux_survives_layer_checkpoints(policy):
    """Under each per-layer remat policy the loss (aux included) and the
    gradients equal the unchecked run's."""
    _, tc, _, p_np = _pair("flash")
    tokens = torch.tensor(_tokens())

    def run(cfg):
        params = {k: v.requires_grad_()
                  for k, v in params_from_jax(p_np).items()}
        loss = llama_loss_fn(cfg)(params, {"tokens": tokens}, None)
        loss.backward()
        return loss.item(), {k: v.grad for k, v in params.items()}

    ref_loss, ref_grads = run(tc)
    loss, grads = run(dataclasses.replace(tc, remat=True,
                                          remat_policy=policy))
    assert loss == ref_loss
    for name, g in ref_grads.items():
        assert torch.equal(grads[name], g), name


def test_two_adamw_steps_match_jax():
    """The MoE Llama through both packages' ``auto_accelerate``, f32,
    remat none: losses and params after two AdamW steps."""
    jc, tc, _, p_np = _pair("flash")
    rng = np.random.RandomState(5)
    batches = [rng.randint(0, 64, (2, 33)).astype(np.int32)
               for _ in range(2)]
    j_res = jax_accelerate(
        jax_loss_fn(jc), lambda r: jax.tree.map(jnp.asarray, p_np),
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
        llama_loss_fn(tc), lambda seed, device: params_from_jax(p_np, device),
        build_optimizer("adamw", LR, weight_decay=0.0),
        Strategy(compute_dtype="float32", remat="none"), device="cpu")
    t_state, t_losses = t_res.state, []
    for tokens in batches:
        t_state, m = t_res.train_step(t_state, {"tokens": tokens}, None)
        t_losses.append(m["loss"].item())
    np.testing.assert_allclose(t_losses, j_losses, atol=1e-5)
    j_params = params_from_jax(jax.tree.map(np.asarray, j_state.params))
    diffs = torch.cat([(t_state.params[k].detach() - j_params[k]).abs()
                       .flatten() for k in j_params])
    assert diffs.median().item() < 1e-6
    assert diffs.quantile(0.99).item() < 2e-3 * LR
    assert diffs.max().item() < 0.25 * LR


@pytest.mark.parametrize("n_devices,n_experts", [
    (1, 8), (4, 8), (8, 8), (8, 4), (6, 4), (16, 8), (12, 8),
])
def test_auto_strategy_expert_axis_matches_jax(n_devices, n_experts):
    """The planner's MoE branch: expert = min(E, n / (tensor * seq)),
    stepped down until it divides, as the JAX package plans it."""
    kw = dict(n_devices=n_devices, param_count=10**9, moe=True,
              n_experts=n_experts, devices_per_host=8)
    ours, theirs = auto_strategy(**kw), jax_auto_strategy(**kw)
    assert dataclasses.asdict(ours.mesh) == dataclasses.asdict(theirs.mesh)
    assert ours.mesh.expert == theirs.mesh.expert


def test_moe_under_a_seq_process_group_raises(monkeypatch):
    """Routing is per sequence: over a seq process group's shards it
    raises naming item 10 (in process the whole sequence is here)."""
    from dlrover_tpu_torch.parallel import mesh as port_mesh

    ring = port_mesh.ProcessGroupRing.__new__(port_mesh.ProcessGroupRing)
    ring.size, ring.rank, ring.ranks = 2, 0, (0,)
    monkeypatch.setattr(port_mesh, "_global_mesh", port_mesh.Mesh(
        shape={"seq": 2}, ring=ring))
    cfg = LlamaConfig(**SMALL)
    with pytest.raises(NotImplementedError, match="item 10"):
        llama_apply(cfg, llama_init(cfg, 0, "cpu"),
                    torch.zeros(1, 8, dtype=torch.long))
