"""Parity of the port's ``auto_accelerate`` train step with the JAX
package's on one CPU device: the same Llama weights (through
``params_from_jax``), the same token batches, adamw (optax.adamw vs
torch.optim.AdamW, weight_decay passed explicitly), compute in float32.

Tolerances: losses 1e-5 absolute (the second loss is taken after the
first update, so it checks the update too). Parameters after the steps:
median difference below 1e-6, 99th percentile below 0.2% of one
learning-rate step, every difference below 25% of one. Adam divides by
sqrt(nu) + eps, so for the few entries whose gradient is within a few
orders of eps (1e-8) a 1e-7 relative difference in the gradient moves
the update by a visible fraction of lr: over two steps at lr 1e-2 the
observed median is 2e-7, the 99th percentile 6.5e-6 and the largest
7.7e-4 (with grad_accum=2, whose microbatch sums also reorder).
"""

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
from dlrover_tpu.parallel.accelerate import auto_accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu_torch.models import LlamaConfig, llama_loss_fn, params_from_jax
from dlrover_tpu_torch.optimizers import Adam8bit, FusedAdamW, fused_adamw
from dlrover_tpu_torch.parallel import MeshConfig, Strategy, auto_accelerate
from dlrover_tpu_torch.trainer import build_optimizer

SMALL = dict(
    vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=96,
    max_seq_len=64, attn_impl="flash", remat=False, dtype="float32",
    attn_block_q=16, attn_block_k=16,
)
LR = 1e-2


@pytest.fixture(autouse=True)
def _restore_global_mesh(monkeypatch):
    """The JAX side sets its process-global mesh; put it back after each
    test so other test files in this process see what they expect."""
    from dlrover_tpu.parallel import mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)


def _run_both(grad_accum):
    jc, tc = JaxConfig(**SMALL), LlamaConfig(**SMALL)
    p_np = jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, 64, (4, 25)).astype(np.int32)
               for _ in range(2)]

    j_res = jax_accelerate(
        jax_loss_fn(jc), lambda r: jax_init(jc, r),
        optax.adamw(LR, weight_decay=0.0), llama_logical_axes(jc),
        strategy=JaxStrategy(mesh=JaxMesh(data=1), compute_dtype="float32",
                             remat="none", grad_accum=grad_accum,
                             donate=False),
        devices=jax.devices()[:1])
    j_state, j_losses = j_res.state, []
    for i, tokens in enumerate(batches):
        j_state, m = j_res.train_step(
            j_state, {"tokens": jnp.asarray(tokens)}, jax.random.key(i))
        j_losses.append(float(m["loss"]))

    t_res = auto_accelerate(
        llama_loss_fn(tc), lambda seed, device: params_from_jax(p_np, device),
        build_optimizer("adamw", LR, weight_decay=0.0),
        Strategy(compute_dtype="float32", remat="none",
                 grad_accum=grad_accum),
        device="cpu")
    t_state, t_losses = t_res.state, []
    for tokens in batches:
        t_state, m = t_res.train_step(t_state, {"tokens": tokens}, None)
        t_losses.append(m["loss"].item())
    assert t_state.step == 2
    return (j_losses, params_from_jax(jax.tree.map(np.asarray,
                                                   j_state.params)),
            t_losses, t_state.params)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_two_adamw_steps_match_jax(grad_accum):
    j_losses, j_params, t_losses, t_params = _run_both(grad_accum)
    np.testing.assert_allclose(t_losses, j_losses, atol=1e-5)
    assert t_losses[1] < t_losses[0]
    assert set(t_params) == set(j_params)
    diffs = torch.cat([(t_params[k].detach() - j_params[k]).abs().flatten()
                       for k in j_params])
    assert diffs.median().item() < 1e-6
    assert diffs.quantile(0.99).item() < 2e-3 * LR
    assert diffs.max().item() < 0.25 * LR


def test_strategy_json_round_trip_and_jax_plans_load():
    s = Strategy(compute_dtype="float32", remat="none", grad_accum=4)
    assert Strategy.from_json(s.to_json()) == s
    jax_plan = JaxStrategy(mesh=JaxMesh(data=1), remat="none").to_json()
    loaded = Strategy.from_json(jax_plan)
    assert loaded.mesh == MeshConfig(data=1)
    assert loaded.remat == "none"
    assert "dp-only" in loaded.describe()


@pytest.mark.parametrize("strategy", [
    Strategy(mesh=MeshConfig(data=2), remat="none"),
    Strategy(mesh=MeshConfig(fsdp=4), remat="none"),
    Strategy(remat="minimal"),
    Strategy(remat="none", compute_dtype="int8"),
    Strategy(remat="none", donate=False),
    Strategy(remat="none", quant_sites="mlp"),
    Strategy(remat="none", rules=(("batch", "data"),)),
], ids=["data2", "fsdp4", "remat", "int8", "donate", "quant_sites",
        "rules"])
def test_unported_strategies_raise(strategy):
    tc = LlamaConfig(**SMALL)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        auto_accelerate(llama_loss_fn(tc), lambda s, d: {},
                        build_optimizer("sgd", 0.1), strategy, device="cpu")


def test_fused_optim_lever_is_accepted_and_recorded():
    """As in the JAX package, ``fused_optim`` is a recorded lever that the
    optimizer factory acts on; the step is unchanged."""
    tc = LlamaConfig(**SMALL)
    strategy = Strategy(remat="none", fused_optim=True)
    res = auto_accelerate(
        llama_loss_fn(tc), lambda s, d: {"w": torch.zeros(300)},
        fused_adamw(1e-3, bits=8), strategy, device="cpu")
    assert res.strategy.fused_optim
    assert "fused_optim" in res.strategy.describe()
    assert isinstance(res.state.optimizer, FusedAdamW)
    assert Strategy.from_json(strategy.to_json()).fused_optim


def test_build_optimizer():
    p = [torch.zeros(3, requires_grad=True)]
    adamw = build_optimizer("adamw", 1e-3)(p)
    assert isinstance(adamw, torch.optim.AdamW)
    assert adamw.param_groups[0]["weight_decay"] == 0.0
    assert isinstance(build_optimizer("sgd", 0.1)(p), torch.optim.SGD)
    a8 = build_optimizer("adam8bit", 1e-3, weight_decay=0.1)(p)
    assert isinstance(a8, Adam8bit) and a8.weight_decay == 0.1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer("agd")
    with pytest.raises(ValueError):
        build_optimizer("lion")
