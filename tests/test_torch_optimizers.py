"""Parity of the port's optimizers of ROADMAP item 9 (dlrover_tpu_torch/
optimizers: agd, wsam, mup, group_sparse, offload) with the JAX
package's, on the CPU in float32: the same params and grads (numpy, from
a seed) go through both.

Tolerances (relative to each tensor's largest value unless said):
- AGD against optax: params and moments within 1e-6 after 5 steps (the
  foreach ops do JAX's f32 operations in its order; observed bit-equal);
- ``opt_state_from_jax`` continuing a JAX AGD run: the same 1e-6;
- WSAM: ``wsam_update`` within 1e-6; gradients and steps within 1e-5
  (the two backward passes round differently in f32 by ~1e-7, and the
  default gamma 0.9 weighs ``g_adv - g`` by alpha = 9; over Adam also
  because torch's Adam takes sqrt(nu)/sqrt(bc2) with double-precision
  scalars where optax takes sqrt(nu/bc2) in f32);
- ``build_optimizer("agd")`` through ``auto_accelerate``: three losses
  within 1e-5 relative of the JAX ``agd`` step's;
- muP: axes, multipliers and the rescaled init exactly; ``mup_adam``
  steps within 1e-5 (torch's Adam, as above), auto_accelerate losses
  within 1e-5 absolute;
- group Adam/Adagrad: per-row step counts exactly, params and moments
  within 1e-6;
- ``OffloadAdam`` against the JAX ``OffloadAdam``: params within 1e-6
  after 5 steps, its state_dict round trip exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
from dlrover_tpu.models.llama import llama_init as jax_init
from dlrover_tpu.models.llama import llama_logical_axes as jax_axes
from dlrover_tpu.models.llama import llama_loss_fn as jax_loss_fn
from dlrover_tpu.optimizers import OffloadAdam as JaxOffloadAdam
from dlrover_tpu.optimizers import agd as jax_agd
from dlrover_tpu.optimizers import group_adagrad as jax_group_adagrad
from dlrover_tpu.optimizers import group_adam as jax_group_adam
from dlrover_tpu.optimizers import make_wsam_grad_fn as jax_wsam_grad_fn
from dlrover_tpu.optimizers import make_wsam_step_fn as jax_wsam_step_fn
from dlrover_tpu.optimizers import mup_adam as jax_mup_adam
from dlrover_tpu.optimizers import mup_lr_multipliers as jax_mup_mults
from dlrover_tpu.optimizers import mup_rescale_init as jax_mup_rescale
from dlrover_tpu.optimizers import wsam_update as jax_wsam_update
from dlrover_tpu.parallel.accelerate import auto_accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu_torch.models import (
    LlamaConfig,
    llama_logical_axes,
    llama_loss_fn,
    opt_state_from_jax,
    params_from_jax,
)
from dlrover_tpu_torch.ops.fused_optim import tree_order
from dlrover_tpu_torch.optimizers import (
    AGD,
    GroupAdagrad,
    GroupAdam,
    OffloadAdam,
    group_adagrad,
    group_adam,
    make_wsam_grad_fn,
    make_wsam_step_fn,
    mup_adam,
    mup_lr_multipliers,
    mup_rescale_init,
    wsam_update,
)
from dlrover_tpu_torch.parallel import Strategy, auto_accelerate
from dlrover_tpu_torch.trainer import build_optimizer

SMALL = dict(
    vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=96,
    max_seq_len=64, attn_impl="flash", remat=False, dtype="float32",
    attn_block_q=16, attn_block_k=16,
)


@pytest.fixture(autouse=True)
def _restore_global_mesh(monkeypatch):
    """The JAX auto_accelerate sets its process-global mesh; put it back
    after each test."""
    from dlrover_tpu.parallel import mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)


def _tree(seed, scale=1.0):
    """A small nested param dict: a table, a matrix, a vector, a stack."""
    rng = np.random.RandomState(seed)

    def arr(*shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {"embed": arr(12, 5), "w": arr(5, 7), "b": arr(7),
            "layers": {"wq": arr(2, 5, 4)}}


def _named(tree, grad=False):
    """The tree as the port's named params, in the JAX leaf order."""
    flat = params_from_jax(tree)
    return [(n, flat[n].requires_grad_(grad)) for n in tree_order(flat)]


def _set_grads(named, grads_tree):
    flat = params_from_jax(grads_tree)
    for name, p in named:
        p.grad = flat[name]


def _run_jax(tx, params, grads):
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params, state


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= rtol, err


def _close_tree(named, tree, rtol):
    flat = params_from_jax(jax.tree.map(np.asarray, tree))
    for name, p in named:
        _close(p, flat[name].numpy(), rtol)


# ------------------------------------------------------------------ AGD


AGD_CASES = {
    "plain": {},
    "amsgrad": {"amsgrad": True},
    "clip": {"clip": 0.05},
    "weight_decay": {"weight_decay": 0.01},
    "all": {"amsgrad": True, "clip": 0.05, "weight_decay": 0.01,
            "delta": 1e-3},
}


@pytest.mark.parametrize("case", list(AGD_CASES))
def test_agd_matches_optax_agd(case):
    kw = AGD_CASES[case]
    params = _tree(0)
    grads = [_tree(10 + i) for i in range(5)]
    j_params, j_state = _run_jax(jax_agd(1e-2, **kw), params, grads)
    named = _named(params)
    opt = AGD(named, lr=1e-2, **kw)
    for g in grads:
        _set_grads(named, g)
        opt.step()
    _close_tree(named, j_params, 1e-6)
    st = j_state[0]
    assert opt.state["count"] == int(st.count) == 5
    for slot in ("mu", "nu") + (("max_nu",) if kw.get("amsgrad") else ()):
        want = params_from_jax(jax.tree.map(np.asarray, getattr(st, slot)))
        for name, p in named:
            _close(opt.state[p][slot], want[name].numpy(), 1e-6)
    # no max_nu slot unless amsgrad needs it, as in JAX
    assert all(("max_nu" in opt.state[p]) == bool(kw.get("amsgrad"))
               for _, p in named)


def test_agd_schedule_reads_the_pre_increment_count():
    sched = lambda count: 1e-2 * 0.5 ** count  # noqa: E731
    params = _tree(0)
    grads = [_tree(20 + i) for i in range(4)]
    j_params, _ = _run_jax(jax_agd(sched, weight_decay=0.01), params, grads)
    named = _named(params)
    opt = AGD(named, lr=sched, weight_decay=0.01)
    for g in grads:
        _set_grads(named, g)
        opt.step()
    _close_tree(named, j_params, 1e-6)


def test_opt_state_from_jax_continues_a_jax_agd_run():
    """3 JAX steps, the params and the AGD state carried into the port by
    name, then 2 more steps on each side."""
    params = _tree(1)
    grads = [_tree(30 + i) for i in range(5)]
    tx = jax_agd(1e-2, weight_decay=0.01, amsgrad=True)
    j_params, j_state = _run_jax(tx, params, grads[:3])
    np_state = jax.tree.map(np.asarray, j_state)
    named = _named(jax.tree.map(np.asarray, j_params))
    opt = AGD(named, lr=1e-2, weight_decay=0.01, amsgrad=True)
    opt.load_state_dict(opt_state_from_jax(np_state, opt))
    assert opt.state["count"] == 3
    for g in grads[3:]:
        upd, j_state = tx.update(g, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        _set_grads(named, g)
        opt.step()
    _close_tree(named, j_params, 1e-6)
    # positions are not names: without names the state has no home
    unnamed = AGD([p for _, p in named], lr=1e-2)
    with pytest.raises(ValueError, match="param name"):
        opt_state_from_jax(np_state, unnamed)


# ----------------------------------------------------------------- WSAM


def _jax_loss(params, batch, rng):
    x, y = batch
    hid = jnp.tanh(x @ params["w1"])
    return jnp.mean(jnp.square(hid @ params["w2"] - y))


def _torch_loss(params, batch, rng):
    x, y = (torch.as_tensor(a) for a in batch)
    hid = torch.tanh(x @ params["w1"])
    return torch.mean(torch.square(hid @ params["w2"] - y))


def _wsam_problem(seed=0):
    rng = np.random.RandomState(seed)
    params = {"w1": (rng.randn(6, 8) * 0.5).astype(np.float32),
              "w2": (rng.randn(8, 3) * 0.5).astype(np.float32)}
    batch = (rng.randn(16, 6).astype(np.float32),
             rng.randn(16, 3).astype(np.float32))
    return params, batch


def _torch_params(params):
    return {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}


@pytest.mark.parametrize("gamma", [0.0, 0.5, 0.9])
def test_wsam_update_matches_jax(gamma):
    g, ga = _tree(2), _tree(3)
    want = jax_wsam_update(g, ga, gamma)
    got = wsam_update(params_from_jax(g), params_from_jax(ga), gamma)
    for name, w in params_from_jax(
            jax.tree.map(np.asarray, want)).items():
        _close(got[name], w.numpy(), 1e-6)
    if gamma == 0.0:
        for name, w in params_from_jax(g).items():
            assert torch.equal(got[name], w)


@pytest.mark.parametrize("adaptive", [False, True])
def test_wsam_grad_fn_matches_jax_and_restores_the_weights(adaptive):
    params, batch = _wsam_problem()
    (j_loss, j_grads) = jax_wsam_grad_fn(
        _jax_loss, rho=0.1, gamma=0.9, adaptive=adaptive)(params, batch,
                                                          None)
    tp = _torch_params(params)
    before = {k: v.detach().clone() for k, v in tp.items()}
    t_loss, t_grads = make_wsam_grad_fn(
        _torch_loss, rho=0.1, gamma=0.9, adaptive=adaptive)(tp, batch, None)
    assert abs(t_loss.item() - float(j_loss)) <= 1e-6 * abs(float(j_loss))
    for k in params:
        _close(t_grads[k], j_grads[k], 1e-5)
        assert torch.equal(tp[k].detach(), before[k])  # bit for bit


@pytest.mark.parametrize("decouple", [True, False],
                         ids=["decoupled", "coupled"])
@pytest.mark.parametrize("base", ["sgd", "adam"])
def test_wsam_step_matches_jax(decouple, base):
    params, batch = _wsam_problem(1)
    lr = 0.05
    j_tx = optax.sgd(lr) if base == "sgd" else optax.adam(lr)
    j_step = jax_wsam_step_fn(_jax_loss, j_tx, lr, rho=0.05, gamma=0.9,
                              decouple=decouple)
    tp = _torch_params(params)
    opt = (torch.optim.SGD(tp.values(), lr=lr) if base == "sgd"
           else torch.optim.Adam(tp.values(), lr=lr))
    t_step = make_wsam_step_fn(_torch_loss, opt, lr, rho=0.05, gamma=0.9,
                               decouple=decouple)
    jp, js = params, j_tx.init(params)
    for _ in range(4):
        jp, js, j_out = j_step(jp, js, batch, None)
        t_out = t_step(tp, batch, None)
        assert abs(t_out.item() - float(j_out)) <= 1e-5 * float(j_out)
    for k in params:
        _close(tp[k], jp[k], 1e-5)
        assert tp[k].grad is None


def test_wsam_step_with_a_schedule_needs_the_step():
    params, batch = _wsam_problem(2)
    sched = lambda step: 0.1 / (1 + step)  # noqa: E731
    j_step = jax_wsam_step_fn(_jax_loss, optax.sgd(sched), sched)
    tp = _torch_params(params)
    opt = torch.optim.SGD(tp.values(), lr=0.1)
    t_step = make_wsam_step_fn(_torch_loss, opt, sched)
    with pytest.raises(ValueError, match="schedule"):
        t_step(tp, batch, None)
    jp, js = params, optax.sgd(sched).init(params)
    for i in range(3):
        jp, js, _ = j_step(jp, js, batch, None, step=i)
        # the base optimizer follows the same schedule
        opt.param_groups[0]["lr"] = sched(i)
        t_step(tp, batch, None, step=i)
    for k in params:
        _close(tp[k], jp[k], 1e-5)


def test_wsam_rejects_gamma_one():
    with pytest.raises(ValueError, match="gamma"):
        wsam_update({}, {}, 1.0)
    with pytest.raises(ValueError, match="gamma"):
        make_wsam_step_fn(_torch_loss, None, 0.1, gamma=1.0)


# ------------------------------------------------------------------ muP


def _flat_axes(tree):
    return {".".join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, tuple))[0]}


def test_llama_logical_axes_and_mup_rules_match_jax():
    jc, tc = JaxConfig(**SMALL), LlamaConfig(**SMALL)
    axes = llama_logical_axes(tc)
    assert axes == _flat_axes(jax_axes(jc))
    want = _flat_axes(jax_mup_mults(jax_axes(jc), 4.0))
    assert mup_lr_multipliers(axes, 4.0) == want
    # hidden and readout weights at 1/4, the embedding and norms at 1
    assert want["layers.wq"] == want["lm_head"] == 0.25
    assert want["embed"] == want["final_norm"] == 1.0
    j_params = jax_init(jc, jax.random.key(0))
    j_scaled = jax_mup_rescale(j_params, jax_axes(jc), 4.0)
    got = mup_rescale_init(params_from_jax(
        jax.tree.map(np.asarray, j_params)), axes, 4.0)
    for name, w in params_from_jax(
            jax.tree.map(np.asarray, j_scaled)).items():
        assert torch.equal(got[name], w), name


def test_mup_adam_matches_jax():
    jc, tc = JaxConfig(**SMALL), LlamaConfig(**SMALL)
    j_params = jax.tree.map(np.asarray, jax_init(jc, jax.random.key(1)))
    rng = np.random.RandomState(4)
    grads = [jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32),
                          j_params) for _ in range(3)]
    j_out, _ = _run_jax(jax_mup_adam(1e-2, jax_axes(jc), 4.0), j_params,
                        grads)
    named = _named(j_params)
    opt = mup_adam(1e-2, llama_logical_axes(tc), 4.0)(named)
    assert sorted(g["lr"] for g in opt.param_groups) == [0.0025, 0.01]
    for g in grads:
        _set_grads(named, g)
        opt.step()
    _close_tree(named, j_out, 1e-5)
    with pytest.raises(ValueError, match="names"):
        mup_adam(1e-2, llama_logical_axes(tc), 4.0)([p for _, p in named])


def test_mup_adam_through_auto_accelerate_matches_jax():
    """The params reach the factory by name (auto_accelerate gives named
    params): two steps of both packages' train steps."""
    jc, tc = JaxConfig(**SMALL), LlamaConfig(**SMALL)
    p_np = jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))
    rng = np.random.RandomState(5)
    batches = [rng.randint(0, 64, (4, 17)).astype(np.int32)
               for _ in range(2)]
    j_res = jax_accelerate(
        jax_loss_fn(jc), lambda r: jax_init(jc, r),
        jax_mup_adam(1e-2, jax_axes(jc), 4.0), jax_axes(jc),
        strategy=JaxStrategy(mesh=JaxMesh(data=1), compute_dtype="float32",
                             remat="none", donate=False),
        devices=jax.devices()[:1])
    t_res = auto_accelerate(
        llama_loss_fn(tc), lambda seed, device: params_from_jax(p_np, device),
        mup_adam(1e-2, llama_logical_axes(tc), 4.0),
        Strategy(compute_dtype="float32", remat="none"), device="cpu")
    j_state, t_state, j_losses, t_losses = j_res.state, t_res.state, [], []
    for i, tokens in enumerate(batches):
        j_state, m = j_res.train_step(
            j_state, {"tokens": jnp.asarray(tokens)}, jax.random.key(i))
        j_losses.append(float(m["loss"]))
        t_state, m = t_res.train_step(t_state, {"tokens": tokens}, None)
        t_losses.append(m["loss"].item())
    np.testing.assert_allclose(t_losses, j_losses, atol=1e-5)
    names = {n for g in t_state.optimizer.param_groups
             for n in g["param_names"]}
    assert names == set(t_state.params)


# -------------------------------------------------------- group sparse


def _sparse_grads(seed, n):
    """Grads of a lookup: per step only some rows of the table and of the
    stack are nonzero; rows 0 and 11 are never touched."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = _tree(seed + i)
        rows = rng.rand(12) < 0.5
        rows[[0, 11]] = False
        g["embed"] = g["embed"] * rows[:, None]
        g["layers"]["wq"][i % 2] = 0.0
        g["b"][rng.rand(7) < 0.3] = 0.0
        out.append(g)
    return out


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_group_adam_matches_jax_with_untouched_rows(wd):
    params = _tree(7)
    grads = _sparse_grads(40, 5)
    j_params, j_state = _run_jax(jax_group_adam(1e-2, weight_decay=wd),
                                 params, grads)
    named = _named(params)
    opt = group_adam(1e-2, weight_decay=wd)(named)
    for g in grads:
        _set_grads(named, g)
        opt.step()
    _close_tree(named, j_params, 1e-6)
    st = j_state[0]
    steps = params_from_jax(jax.tree.map(np.asarray, st.steps))
    for name, p in named:
        got = opt.state[p]["steps"]
        assert got.dtype == torch.int32
        assert torch.equal(got, steps[name]), name
        for slot in ("mu", "nu"):
            want = params_from_jax(jax.tree.map(np.asarray,
                                                getattr(st, slot)))[name]
            _close(opt.state[p][slot], want.numpy(), 1e-6)
    table = dict(named)["embed"]
    assert opt.state[table]["steps"][[0, 11]].eq(0).all()
    np.testing.assert_array_equal(table.detach().numpy()[[0, 11]],
                                  params["embed"][[0, 11]])
    # the per-row counts stay int32 through a state_dict round trip
    again = GroupAdam([p for _, p in named], lr=1e-2)
    again.load_state_dict(opt.state_dict())
    for _, p in named:
        assert torch.equal(again.state[p]["steps"], opt.state[p]["steps"])


def test_group_adagrad_matches_jax_with_untouched_rows():
    params = _tree(8)
    grads = _sparse_grads(50, 4)
    j_params, j_state = _run_jax(jax_group_adagrad(5e-2), params, grads)
    named = _named(params)
    opt = group_adagrad(5e-2)(named)
    assert isinstance(opt, GroupAdagrad)
    for g in grads:
        _set_grads(named, g)
        opt.step()
    _close_tree(named, j_params, 1e-6)
    accum = params_from_jax(jax.tree.map(np.asarray, j_state[0].accum))
    for name, p in named:
        _close(opt.state[p]["accum"], accum[name].numpy(), 1e-6)
    table = dict(named)["embed"]
    assert opt.state[table]["accum"][[0, 11]].eq(0.1).all()


# ------------------------------------------------------------- offload


def test_offload_adam_matches_jax_offload_adam():
    params = _tree(9)
    grads = [_tree(60 + i) for i in range(5)]
    j_opt = JaxOffloadAdam(1e-2, weight_decay=0.01)
    j_params, j_state = jax.tree.map(jnp.asarray, params), None
    j_state = j_opt.init(j_params)
    for g in grads:
        j_params, j_state = j_opt.step(j_params, g, j_state)
    named = _named(params)
    opt = OffloadAdam(named, lr=1e-2, weight_decay=0.01)
    for g in grads:
        _set_grads(named, g)
        opt.step()
    _close_tree(named, j_params, 1e-6)
    assert opt.state["count"] == j_state.count == 5
    # JAX's host buffers are in its leaf order, as the named params
    for (_, p), mu, nu in zip(named, j_state.mu, j_state.nu):
        _close(opt.state[p]["mu"], mu, 1e-6)
        _close(opt.state[p]["nu"], nu, 1e-6)
        assert opt.state[p]["mu"].device.type == "cpu"
    assert set(opt.last_legs) == {"d2h_wait_s", "host_math_s"}


def test_offload_adam_state_dict_round_trip():
    """As the JAX ``state_dict``/``load_state_dict`` (tests/
    test_optimizers.py): the count and the moments come back, and a
    state_dict is a snapshot, not the live buffers."""
    named = _named(_tree(10))
    opt = OffloadAdam(named, lr=1e-2)
    _set_grads(named, _tree(70))
    opt.step()
    sd = opt.state_dict()
    mu0 = {n: opt.state[p]["mu"].clone() for n, p in named}
    _set_grads(named, _tree(71))
    opt.step()
    assert opt.state["count"] == 2
    live = {n: opt.state[p]["mu"] for n, p in named}
    opt.load_state_dict(sd)
    assert opt.state["count"] == 1
    for n, p in named:
        assert torch.equal(opt.state[p]["mu"], mu0[n])
        # restored into the same host buffers
        assert opt.state[p]["mu"] is live[n]


# -------------------------------------------------- the Trainer factory


def test_build_optimizer_agd_steps_as_jax_agd():
    """``build_optimizer("agd")`` through auto_accelerate, against the JAX
    package's ``agd`` through its own: two train steps' losses."""
    jc, tc = JaxConfig(**SMALL), LlamaConfig(**SMALL)
    # auto_accelerate's own init: seed 0 on both sides
    p_np = jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))
    # one repeated batch: a falling loss shows the step learns
    batches = [np.random.RandomState(6).randint(0, 64, (4, 17)).astype(
        np.int32)] * 3
    j_res = jax_accelerate(
        jax_loss_fn(jc), lambda r: jax_init(jc, r),
        jax_agd(1e-2, weight_decay=0.01), jax_axes(jc),
        strategy=JaxStrategy(mesh=JaxMesh(data=1), compute_dtype="float32",
                             remat="none", donate=False),
        devices=jax.devices()[:1])
    t_res = auto_accelerate(
        llama_loss_fn(tc), lambda seed, device: params_from_jax(p_np, device),
        build_optimizer("agd", 1e-2, 0.01),
        Strategy(compute_dtype="float32", remat="none"), device="cpu")
    assert isinstance(t_res.state.optimizer, AGD)
    j_state, t_state, j_losses, t_losses = j_res.state, t_res.state, [], []
    for i, tokens in enumerate(batches):
        j_state, m = j_res.train_step(
            j_state, {"tokens": jnp.asarray(tokens)}, jax.random.key(i))
        j_losses.append(float(m["loss"]))
        t_state, m = t_res.train_step(t_state, {"tokens": tokens}, None)
        t_losses.append(m["loss"].item())
    # relative: where successive moments barely differ, AGD's SGD-like
    # branch divides by delta = 1e-5, which magnifies the f32 rounding of
    # the two packages' gradients (observed 4.7e-6 at the third step)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=0)
    assert t_losses[-1] < t_losses[0]
