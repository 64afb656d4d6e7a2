"""Parity of the port's optimizers (ops/fused_optim.py, optimizers/
low_bit.py) with the JAX package's on the CPU. The JAX side runs its
Pallas kernels in interpret mode under ``jax.jit``, as its own tests do;
the port runs the plain versions of K5-K8, which the CUDA kernels are
held to on the card.

Both sides start from the same params and optimizer state (the port's
converted by ``params_from_jax`` / ``opt_state_from_jax``), take the
same grads (numpy, from a seed) and the same stochastic-rounding fields
(``jax.random.uniform`` where the JAX package draws them, handed to the
port through the optimizers' ``uniform`` hook).

Tolerances:
- ``fused_adamw(bits=32)``: params and moments within 1e-6 relative to
  their largest value after every step. Not bit-equal: XLA's CPU
  backend contracts ``(1 - b1) * g + b1 * mu`` into a fused multiply-add
  (LLVM's fp-contract), which the port, like its CUDA kernel, does not;
  after three steps about 4-6% of the params differ in their last bit.
- 8-bit Adam, fused and per leaf: the params' difference relative to
  how far the params moved, median at most 1e-6 and largest at most 0.1.
  The log code of nu is the nearest in log space, and the two libraries'
  log/exp can differ by an ulp across a rounding edge; one flipped code
  moves that entry's update by about 5%.
- ``auto_accelerate``: losses of two steps within 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
from dlrover_tpu.models.llama import llama_init as jax_init
from dlrover_tpu.models.llama import llama_logical_axes
from dlrover_tpu.models.llama import llama_loss_fn as jax_loss_fn
from dlrover_tpu.ops import fused_optim as jfo
from dlrover_tpu.optimizers import adam8bit as jax_adam8bit
from dlrover_tpu.parallel.accelerate import auto_accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu_torch.models import (
    LlamaConfig,
    llama_init,
    llama_loss_fn,
    opt_state_from_jax,
    params_from_jax,
)
from dlrover_tpu_torch.ops import fused_optim as tfo
from dlrover_tpu_torch.optimizers import Adam8bit, FusedAdamW, adam8bit
from dlrover_tpu_torch.optimizers import low_bit as tlb
from dlrover_tpu_torch.parallel import Strategy, auto_accelerate


SMALL = dict(
    vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=96,
    max_seq_len=64, attn_impl="flash", remat=False, dtype="float32",
    attn_block_q=16, attn_block_k=16,
)


def _tree(seed, scale=1.0):
    """A nested param dict with Llama's naming, ragged leaf sizes and a
    stacked layer axis (JAX flattens it in sorted key order)."""
    rng = np.random.RandomState(seed)

    def arr(*shape):
        return jnp.asarray(rng.randn(*shape).astype(np.float32) * scale)

    return {
        "lm_head": arr(33, 10),
        "embed": arr(10, 33),
        "layers": {"wq": arr(2, 33, 40), "attn_norm": arr(2, 33),
                   "w_down": arr(2, 50, 33)},
        "final_norm": arr(300),
    }


def _grads_like(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)), tree)


def _port_params(tree):
    """The JAX tree as port tensors in the JAX leaf order."""
    flat = params_from_jax(jax.tree.map(np.asarray, tree))
    return [flat[name].requires_grad_() for name in tfo.tree_order(flat)]


def _set_grads(params, grads_tree):
    flat = params_from_jax(jax.tree.map(np.asarray, grads_tree))
    for p, name in zip(params, tfo.tree_order(flat)):
        p.grad = flat[name]


def _flat(params):
    return np.concatenate([p.detach().numpy().ravel() for p in params])


def _jax_flat(tree):
    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(tree)])


def _run_jax(tx, params, grads, state=None):
    state = tx.init(params) if state is None else state
    update = jax.jit(tx.update)
    for g in grads:
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params, state


def _paths(tree):
    return [".".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_leaf_order_and_rows_match_jax():
    """The port's Llama dict is in init order; ``tree_order`` gives JAX's
    flattening order, in which auto_accelerate hands the optimizer its
    params."""
    jax_names = _paths(jax_init(JaxConfig(**SMALL), jax.random.key(0)))
    port_names = list(llama_init(LlamaConfig(**SMALL), 0, "cpu"))
    assert port_names != jax_names
    assert tfo.tree_order(port_names) == jax_names
    res = auto_accelerate(
        llama_loss_fn(LlamaConfig(**SMALL)),
        lambda seed, device: llama_init(LlamaConfig(**SMALL), seed, device),
        lambda params: torch.optim.SGD(params, lr=0.1),
        Strategy(remat="none"), device="cpu")
    order = {id(p): n for n, p in res.state.params.items()}
    given = res.state.optimizer.param_groups[0]["params"]
    assert [order[id(p)] for p in given] == jax_names

    tree = _tree(0)
    paths = _paths(tree)
    assert tfo.tree_order(reversed(paths)) == paths
    jmeta = jfo.flatten_meta(tree)
    tmeta = tfo.flatten_meta(_port_params(tree))
    assert tmeta.rows == jmeta.rows
    assert tmeta.shapes == tuple(jmeta.shapes)
    assert tmeta.total_rows == sum(jmeta.rows) <= jmeta.total_rows
    assert tmeta.first_rows == tuple(np.cumsum((0,) + jmeta.rows[:-1]))
    # the flat layout round-trips, zero-padded between leaves
    params = _port_params(tree)
    blocks = tfo.flatten_to_blocks(params, tmeta)
    jblocks = np.asarray(jfo.flatten_to_blocks(tree, jmeta))
    np.testing.assert_array_equal(blocks.numpy(),
                                  jblocks[:tmeta.total_rows])
    for got, want in zip(tfo.unflatten_from_blocks(blocks, tmeta), params):
        assert torch.equal(got, want.detach())


@pytest.mark.parametrize("clip,wd,schedule", [
    (None, 0.0, False), (1.0, 0.0, False), (0.5, 0.01, True),
], ids=["plain", "clip", "clip-wd-schedule"])
def test_fused_adamw32_matches_jax(clip, wd, schedule):
    """Three steps; the port's state starts from the converted JAX state
    after one step, so the moments are non-zero."""
    tree = _tree(1)
    grads = [_grads_like(tree, 10 + i) for i in range(4)]
    if schedule:
        jlr = lambda c: jnp.where(c < 2, 1e-2, 5e-3)  # noqa: E731
        tlr = lambda c: 1e-2 if c < 2 else 5e-3  # noqa: E731
    else:
        jlr = tlr = 1e-2
    tx = jfo.fused_adamw(jlr, weight_decay=wd, clip_norm=clip)
    p1, s1 = _run_jax(tx, tree, grads[:1])
    params = _port_params(p1)
    opt = FusedAdamW(params, lr=tlr, weight_decay=wd, clip_norm=clip)
    opt.load_state_dict(opt_state_from_jax(jax.tree.map(np.asarray, s1),
                                           opt))
    jp, js = p1, s1
    for g in grads[1:]:
        jp, js = _run_jax(tx, jp, [g], js)
        _set_grads(params, g)
        opt.step()
        for got, want in ((_flat(params), _jax_flat(jp)),
                          (opt.state["mu"].numpy(),
                           np.asarray(js.mu)[:opt.meta.total_rows]),
                          (opt.state["nu"].numpy(),
                           np.asarray(js.nu)[:opt.meta.total_rows])):
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-6
    assert opt.state["count"] == int(js.count) == 4


def _fused_u(tree):
    """JAX's fused 8-bit rounding field (fused_optim.py:366-369), cut to
    the port's rows (JAX pads to the TPU grid's tile)."""
    padded = jfo.flatten_meta(tree).total_rows

    def uniform(count, shape):
        u = jax.random.uniform(jax.random.fold_in(jax.random.key(0), count),
                               (padded, jfo.BLOCK), jnp.float32)
        return np.array(u)[:shape[0]]

    return uniform


def _per_leaf_u(count, index, shape):
    """JAX's per-leaf seed (low_bit.py:104-105, quantization.py:74)."""
    return np.array(jax.random.uniform(jax.random.key(count * 7919 + index),
                                       shape))


def _assert_tracks(jp, params, p0):
    a, b = _flat(params), _jax_flat(jp)
    moved = max(float(np.abs(b - _jax_flat(p0)).max()), 1e-12)
    diff = np.abs(a - b) / moved
    assert np.median(diff) <= 1e-6
    assert diff.max() <= 0.1


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_leaf"])
def test_8bit_adam_matches_jax(fused):
    """Two JAX steps make a non-zero 8-bit state; it is converted and both
    packages take three more steps with clipping and weight decay."""
    tree = _tree(2, scale=0.1)
    grads = [_grads_like(tree, 20 + i) for i in range(5)]
    kw = dict(weight_decay=0.01, clip_norm=2.0)
    tx = (jfo.fused_adamw(1e-2, bits=8, **kw) if fused
          else jax_adam8bit(1e-2, **kw))
    p2, s2 = _run_jax(tx, tree, grads[:2])
    params = _port_params(p2)
    if fused:
        opt = FusedAdamW(params, lr=1e-2, bits=8, uniform=_fused_u(tree),
                         **kw)
    else:
        opt = Adam8bit(params, lr=1e-2, uniform=_per_leaf_u, **kw)
    opt.load_state_dict(opt_state_from_jax(jax.tree.map(np.asarray, s2),
                                           opt))
    assert opt.state["count"] == 2
    jp = p2
    for g in grads[2:]:
        jp, s2 = _run_jax(tx, jp, [g], s2)
        _set_grads(params, g)
        opt.step()
    _assert_tracks(jp, params, p2)
    assert opt.state["count"] == 5


def test_8bit_state_round_trips_through_state_dict():
    """Save after two steps, load into a fresh optimizer over copies of
    the params, take two more steps on both: identical, since the
    rounding fields are a function of the step count."""
    tree = _tree(3, scale=0.1)
    grads = [_grads_like(tree, 30 + i) for i in range(4)]
    for make in (lambda ps: FusedAdamW(ps, lr=1e-2, bits=8),
                 lambda ps: Adam8bit(ps, lr=1e-2)):
        params = _port_params(tree)
        opt = make(params)
        for g in grads[:2]:
            _set_grads(params, g)
            opt.step()
        copies = [p.detach().clone().requires_grad_() for p in params]
        restored = make(copies)
        restored.load_state_dict(copy.deepcopy(opt.state_dict()))
        for g in grads[2:]:
            for ps, o in ((params, opt), (copies, restored)):
                _set_grads(ps, g)
                o.step()
        for a, b in zip(params, copies):
            assert torch.equal(a, b)


def test_a_param_without_grad_still_decays_its_moments():
    params = _port_params(_tree(4))
    opt = FusedAdamW(params, lr=1e-2)
    _set_grads(params, _grads_like(_tree(4), 40))
    opt.step()
    mu1 = opt.state["mu"].clone()
    params[0].grad = None
    before = params[0].detach().clone()
    opt.step()
    rows = slice(0, opt.meta.rows[0])
    np.testing.assert_array_equal(opt.state["mu"][rows].numpy(),
                                  (np.float32(0.9) * mu1[rows]).numpy())
    assert not torch.equal(params[0].detach(), before)  # momentum moves it


@pytest.mark.parametrize("bits", [32, 8])
def test_fused_step_is_one_launch_whatever_the_leaf_count(monkeypatch, bits):
    """THE fused-step gate: one kernel call per step for 2 or 20 leaves
    (the per-leaf 8-bit path calls K5 and K6 once per leaf)."""
    name = "fused_adamw32" if bits == 32 else "fused_adamw8"
    calls = []
    real = getattr(tfo, name)
    monkeypatch.setattr(tfo, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.RandomState(5)
    for n_leaves in (2, 20):
        params = [torch.tensor(rng.randn(40).astype(np.float32),
                               requires_grad=True) for _ in range(n_leaves)]
        opt = FusedAdamW(params, lr=1e-3, bits=bits)
        for p in params:
            p.grad = torch.ones_like(p)
        calls.clear()
        opt.step()
        opt.step()
        assert len(calls) == 2
    counted = {"quantize_int8": 0, "dequantize_int8": 0}
    for fn in counted:
        real_fn = getattr(tlb, fn)
        monkeypatch.setattr(
            tlb, fn, lambda *a, _fn=fn, _real=real_fn, **k:
            counted.__setitem__(_fn, counted[_fn] + 1) or _real(*a, **k))
    Adam8bit(params, lr=1e-3).step()
    assert counted == {"quantize_int8": 20, "dequantize_int8": 20}


@pytest.mark.parametrize("kind", ["adam8bit", "adam8bit_fused", "fused32"])
def test_two_auto_accelerate_steps_match_jax(kind):
    jc, tc = JaxConfig(**SMALL), LlamaConfig(**SMALL)
    p_np = jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, 64, (4, 25)).astype(np.int32)
               for _ in range(2)]
    lr, fused = 1e-2, kind != "adam8bit"
    if kind == "fused32":
        jtx, factory = jfo.fused_adamw(lr), tfo.fused_adamw(lr)
    else:
        jtx = jax_adam8bit(lr, fused=fused)
        factory = adam8bit(lr, fused=fused)

    j_res = jax_accelerate(
        jax_loss_fn(jc), lambda r: jax_init(jc, r), jtx,
        llama_logical_axes(jc),
        strategy=JaxStrategy(mesh=JaxMesh(data=1), compute_dtype="float32",
                             remat="none", donate=False,
                             fused_optim=fused),
        devices=jax.devices()[:1])
    j_state, j_losses = j_res.state, []
    for i, tokens in enumerate(batches):
        j_state, m = j_res.train_step(
            j_state, {"tokens": jnp.asarray(tokens)}, jax.random.key(i))
        j_losses.append(float(m["loss"]))

    t_res = auto_accelerate(
        llama_loss_fn(tc), lambda seed, device: params_from_jax(p_np, device),
        factory, Strategy(compute_dtype="float32", remat="none",
                          fused_optim=fused), device="cpu")
    t_state, t_losses = t_res.state, []
    for tokens in batches:
        t_state, m = t_res.train_step(t_state, {"tokens": tokens}, None)
        t_losses.append(m["loss"].item())
    np.testing.assert_allclose(t_losses, j_losses, atol=1e-5)
    assert t_losses[1] < t_losses[0]
    expected = FusedAdamW if fused else Adam8bit
    assert isinstance(t_state.optimizer, expected)
