"""Remat in the port, held against remat "none" and against the JAX
package, on one CPU device in float32.

- ``auto_strategy`` and ``_remat_for`` plan the same ``Strategy`` as the
  JAX package's (its JSON, string for string) over n_devices {1, 4, 8} x
  the ``PRESETS`` param counts x hbm_gb {16, 80} x seq_len {2048, 65536}.
- For each strategy remat ("minimal", "full", "offload") x each
  per-layer policy (and no per-layer remat), on the flash, bshd and
  reference routes and under a seq=4 ring, the loss and every gradient
  of one ``auto_accelerate`` step equal remat "none"'s BIT FOR BIT
  (recomputation reruns the same ops on the same inputs).
- The forward attention runs as often as the JAX package's remat reruns
  it: once per layer without remat, once more per layer for the
  strategy's recompute, and once more again where the per-layer policy
  does not save the attention's (o, lse).
- The losses of two steps are within 1e-5 of the JAX package's under the
  same ``Strategy`` and per-layer policy.
- Under "none" with ``config.remat=True`` no checkpoint runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.utils.checkpoint

from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
from dlrover_tpu.models.llama import PRESETS as JAX_PRESETS
from dlrover_tpu.models.llama import llama_init as jax_init
from dlrover_tpu.models.llama import llama_logical_axes
from dlrover_tpu.models.llama import llama_loss_fn as jax_loss_fn
from dlrover_tpu.parallel.accelerate import auto_accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.parallel.strategy import _remat_for as jax_remat_for
from dlrover_tpu.parallel.strategy import auto_strategy as jax_auto_strategy
from dlrover_tpu_torch.models import (
    PRESETS,
    LlamaConfig,
    llama_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.ops import attention as port_attention
from dlrover_tpu_torch.parallel import (
    MeshConfig,
    Strategy,
    auto_accelerate,
    auto_strategy,
    set_mesh,
)
from dlrover_tpu_torch.parallel.strategy import _remat_for

SMALL = dict(
    vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=96,
    max_seq_len=64, attn_impl="flash", dtype="float32", attn_block_q=16,
    attn_block_k=16,
)
MODES = ("minimal", "full", "offload")
POLICIES = ("dots_attn", "dots_attn_offload", "dots_no_batch", "dots", None)
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small shapes gain nothing from many intra-op threads; two keep this
    file from crowding the timing-sensitive tests that run beside it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _restore_meshes(monkeypatch):
    """Put both packages' process-global meshes back after each test."""
    from dlrover_tpu.parallel import mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)
    yield
    set_mesh(None)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq_len", [2048, 65536])
@pytest.mark.parametrize("hbm_gb", [16.0, 80.0])
@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_auto_strategy_plans_as_jax(n_devices, hbm_gb, seq_len):
    assert set(PRESETS) == set(JAX_PRESETS)
    for name in PRESETS:
        count = PRESETS[name].param_count()
        assert count == JAX_PRESETS[name].param_count()
        ours = auto_strategy(n_devices, count, seq_len=seq_len,
                             hbm_gb=hbm_gb)
        theirs = jax_auto_strategy(n_devices, count, seq_len=seq_len,
                                   hbm_gb=hbm_gb)
        assert ours.to_json() == theirs.to_json(), name
        per_device = count * 4.0 / n_devices
        assert _remat_for(per_device, hbm_gb * 2**30) == jax_remat_for(
            per_device, hbm_gb * 2**30)


def test_nano_350m_plans_no_remat_on_one_card():
    """The slice's plan: nano-350m on one 80 GB card keeps every
    activation, as on the JAX package's 16 GB default."""
    count = PRESETS["nano-350m"].param_count()
    for hbm_gb in (16.0, 80.0):
        plan = auto_strategy(1, count, hbm_gb=hbm_gb)
        assert plan.remat == "none"
        assert plan.mesh == MeshConfig(data=1, fsdp=1)


# ---------------------------------------------------------------------------
# remat against remat "none"
# ---------------------------------------------------------------------------


class _Recorder(torch.optim.Optimizer):
    """Keeps a copy of every gradient its step sees; updates nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = []

    def step(self, closure=None):
        self.grads.append([p.grad.detach().clone()
                           for g in self.param_groups for p in g["params"]])


def _tokens():
    return np.random.RandomState(1).randint(0, 64, (4, 33)).astype(np.int32)


def _port_params():
    jc = JaxConfig(**dict(SMALL, remat=False))
    return jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))


PARAMS = _port_params()


def _port_step(config, strategy):
    """(loss, grads) of one auto_accelerate step of the port."""
    res = auto_accelerate(
        llama_loss_fn(config), lambda s, d: params_from_jax(PARAMS, d),
        _Recorder, strategy, device="cpu")
    _, metrics = res.train_step(res.state, {"tokens": _tokens()}, None)
    return metrics["loss"], res.state.optimizer.grads[0]


def _config(attn_impl, policy):
    return LlamaConfig(**dict(SMALL, attn_impl=attn_impl,
                              remat=policy is not None,
                              remat_policy=policy or "dots_attn"))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("attn_impl", ["flash", "bshd", "reference"])
def test_remat_grads_equal_none_bit_for_bit(attn_impl, mode, policy):
    base_loss, base_grads = _port_step(
        _config(attn_impl, None),
        Strategy(compute_dtype="float32", remat="none"))
    loss, grads = _port_step(_config(attn_impl, policy),
                             Strategy(compute_dtype="float32", remat=mode))
    assert torch.equal(loss, base_loss)
    assert len(grads) == len(base_grads)
    for g, b in zip(grads, base_grads):
        assert torch.equal(g, b)


@pytest.mark.parametrize("mode", ["none"] + list(MODES))
def test_remat_under_the_seq_ring_equals_none(mode):
    """A recompute reruns the ring's forward (4 ranks in this process):
    the same loss and gradients as without remat."""
    mesh = MeshConfig(seq=4)
    base_loss, base_grads = _port_step(
        _config("flash", None),
        Strategy(mesh=mesh, compute_dtype="float32", remat="none"))
    loss, grads = _port_step(
        _config("flash", "dots_attn"),
        Strategy(mesh=mesh, compute_dtype="float32", remat=mode))
    assert torch.equal(loss, base_loss)
    for g, b in zip(grads, base_grads):
        assert torch.equal(g, b)


def _forward_runs(policy, mode):
    """K1 runs per layer and step that the JAX package's remat implies."""
    if mode == "none":
        return 1
    saves_attn = policy in ("dots_attn", "dots_attn_offload")
    return 2 + (policy is not None and not saves_attn)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", ["none"] + list(MODES))
def test_flash_forward_runs_as_jax_remat_implies(monkeypatch, mode, policy):
    calls = {"fwd": 0, "dq": 0, "dkv": 0}

    def counting(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    for key, name in (("fwd", "flash_fwd_plain"), ("dq", "flash_bwd_dq_plain"),
                      ("dkv", "flash_bwd_dkv_plain")):
        monkeypatch.setattr(port_attention, name,
                            counting(key, getattr(port_attention, name)))
    _port_step(_config("flash", policy),
               Strategy(compute_dtype="float32", remat=mode))
    layers = SMALL["n_layers"]
    assert calls == {"fwd": layers * _forward_runs(policy, mode),
                     "dq": layers, "dkv": layers}


@pytest.mark.parametrize("mode", ["none"] + list(MODES))
def test_checkpoint_calls(monkeypatch, mode):
    """remat="none" means none: with config.remat=True the model
    checkpoints no layer. The other modes wrap the loss once and each
    layer twice: in the forward and in the strategy's recompute, which
    runs the model again."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*args, **kwargs):
        calls.append(kwargs.get("use_reentrant"))
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    _port_step(_config("flash", "dots_attn"),
               Strategy(compute_dtype="float32", remat=mode))
    want = 0 if mode == "none" else 1 + 2 * SMALL["n_layers"]
    assert calls == [False] * want


def test_unknown_remat_names_raise():
    with pytest.raises(ValueError, match="remat mode"):
        _port_step(_config("flash", None),
                   Strategy(compute_dtype="float32", remat="some"))
    with pytest.raises(ValueError, match="remat_policy"):
        llama_loss_fn(_config("flash", "dots_all"))
    # without per-layer remat the policy is not read, as in the JAX model
    llama_loss_fn(LlamaConfig(**dict(SMALL, remat=False,
                                     remat_policy="dots_all")))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,policy", [
    ("none", "dots_attn"), ("minimal", "dots_attn"), ("full", "dots_attn"),
    ("offload", "dots_attn"), ("minimal", "dots_attn_offload"),
    ("minimal", "dots_no_batch"), ("full", "dots"),
])
def test_remat_losses_match_jax(mode, policy):
    kw = dict(SMALL, remat=True, remat_policy=policy)
    jc = JaxConfig(**kw)
    batches = [np.random.RandomState(s).randint(0, 64, (4, 25)).astype(
        np.int32) for s in (1, 2)]
    j_res = jax_accelerate(
        jax_loss_fn(jc), lambda r: jax_init(jc, r),
        optax.adamw(LR, weight_decay=0.0), llama_logical_axes(jc),
        strategy=JaxStrategy(mesh=JaxMesh(data=1), compute_dtype="float32",
                             remat=mode, donate=False),
        devices=jax.devices()[:1])
    p_np = jax.tree.map(np.asarray, j_res.state.params)
    j_state, j_losses = j_res.state, []
    for i, tokens in enumerate(batches):
        j_state, m = j_res.train_step(j_state, {"tokens": jnp.asarray(tokens)},
                                      jax.random.key(i))
        j_losses.append(float(m["loss"]))

    from dlrover_tpu_torch.trainer import build_optimizer

    t_res = auto_accelerate(
        llama_loss_fn(LlamaConfig(**kw)),
        lambda s, d: params_from_jax(p_np, d),
        build_optimizer("adamw", LR, weight_decay=0.0),
        Strategy(compute_dtype="float32", remat=mode), device="cpu")
    t_state, t_losses = t_res.state, []
    for tokens in batches:
        t_state, m = t_res.train_step(t_state, {"tokens": tokens}, None)
        t_losses.append(m["loss"].item())
    np.testing.assert_allclose(t_losses, j_losses, atol=1e-5)
    assert t_losses[1] < t_losses[0]


def test_eval_without_grad_runs_no_checkpoint(monkeypatch):
    """Under no_grad there is nothing to keep: the model checkpoints no
    layer whatever its config says."""
    from dlrover_tpu_torch.models import llama_apply

    calls = []
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1))
    tokens = torch.tensor(_tokens()[:, :-1])
    with torch.no_grad():
        out = llama_apply(_config("flash", "dots_attn"),
                          params_from_jax(PARAMS), tokens)
    assert calls == [] and torch.isfinite(out).all()
