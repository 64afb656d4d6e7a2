"""The port's ``expert`` mesh axis over 4 gloo processes on the CPU, held
against the JAX package's ``auto_accelerate`` on 4 of its virtual CPU
devices with the same meshes: a MoE Llama (the ``tiny`` preset with 4
experts, top-2, ``attn_impl="flash"``, whose plain path runs on the CPU;
f32 compute, remat none) trained 2 AdamW steps under ``expert=4``,
``data=2, expert=2`` and ``fsdp=2, expert=2``, and under ``data=2,
expert=2`` with the chunked CE; ``params_from_jax`` and
``opt_state_from_jax`` placing the MoE leaves and their Adam moments on
the ``data=2, expert=2`` mesh; and MoE under a ``tensor`` axis, which
raises.

On the expert axis the rows are replicated and each rank holds its E/n
experts' stacks (``Shard(1)``), runs only them and sums the partial
outputs over the axis (parallel/shard_ops.py); the aux loss's
first-choice share is averaged over the batch ranks, so each rank's aux
term averages to the global batch's, as GSPMD computes it.

Each process is spawned and imports this module, so its top level
imports the port only (and the port-only helpers of
tests/test_torch_mesh_gloo.py). The processes meet through a FileStore
in a temporary directory and are killed after ``GLOO_DEADLINE_S``.

Tolerances: tests/test_torch_mesh_gloo.py's: losses 1e-5 absolute;
params after the steps by its Adam statistic (median below 1e-6, 99th
percentile below 0.2% of one learning-rate step, every difference below
25% of one); leaves from JAX equal.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_mesh_gloo import (
    LR,
    ScaleByAdamState,
    _assert_adam_params,
    _expected_placements,
    _port_train,
    _rows,
)
from torch.distributed.tensor import Shard

from dlrover_tpu_torch.models import (
    PRESETS,
    llama_logical_axes,
    llama_loss_fn,
    opt_state_from_jax,
    params_from_jax,
)
from dlrover_tpu_torch.parallel import MeshConfig, Strategy, auto_accelerate
from dlrover_tpu_torch.parallel.mesh import build_mesh
from dlrover_tpu_torch.trainer import build_optimizer

N = 4
STEPS = 2
GLOO_DEADLINE_S = 150
MESHES = {
    "expert4": dict(data=1, expert=4),
    "data2-expert2": dict(data=2, expert=2),
    "fsdp2-expert2": dict(data=1, fsdp=2, expert=2),
}
MOE = dataclasses.replace(PRESETS["tiny"], attn_impl="flash",
                          attn_block_q=16, attn_block_k=16, n_experts=4,
                          moe_top_k=2, mlp_dim=64)
CHUNKED = dataclasses.replace(MOE, ce_chunks=2)


def _inputs():
    """The seeded inputs: JAX-made MoE params, the token batches, and optax's
    Adam state after one update (the params as the gradient)."""
    import jax
    import optax

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_init as jax_init

    params = jax.tree.map(np.asarray, jax_init(
        JaxConfig(**dataclasses.asdict(MOE)), jax.random.key(0)))
    tx = optax.adamw(LR, weight_decay=0.0)
    _, state = tx.update(params, tx.init(params), params)
    (adam,) = [s for s in jax.tree.leaves(
        state, is_leaf=lambda n: type(n).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState"]
    rng = np.random.RandomState(0)
    return {
        "params": params,
        # one batch repeated: the loss must fall
        "tokens": [rng.randint(0, MOE.vocab_size, (8, 33)).astype(np.int32)
                   ] * STEPS,
        "adam_state": ScaleByAdamState(*(jax.tree.map(np.asarray, x)
                                         for x in adam)),
    }


# ------------------------------------------------------------ port side


def _from_jax(inputs):
    """On data=2, expert=2: the MoE leaves placed by ``params_from_jax``,
    and optax's Adam state loaded into a DeviceMesh step's AdamW."""
    config = MeshConfig(**MESHES["data2-expert2"])
    dm = build_mesh(config).device_mesh
    axes = llama_logical_axes(MOE)
    placed = params_from_jax(inputs["params"], "cpu", dm, axes)
    res = auto_accelerate(
        llama_loss_fn(MOE), lambda s, d: params_from_jax(inputs["params"], d),
        build_optimizer("adamw", LR, weight_decay=0.0),
        Strategy(mesh=config, compute_dtype="float32", remat="none"),
        device="cpu", param_logical_axes=axes)
    opt = res.state.optimizer
    opt.load_state_dict(opt_state_from_jax(inputs["adam_state"], opt))
    return (
        {k: (tuple(v.placements), v.full_tensor(), v.to_local().shape)
         for k, v in placed.items()},
        {k: (tuple(opt.state[p]["exp_avg"].placements),
             opt.state[p]["exp_avg"].full_tensor(),
             opt.state[p]["exp_avg_sq"].full_tensor())
         for k, p in res.state.params.items()})


def _tensor_axis_raises(inputs):
    """MoE under data=1, expert=2, tensor=2: the message, or None."""
    try:
        _port_train(llama_loss_fn(MOE), inputs["params"],
                    llama_logical_axes(MOE),
                    MeshConfig(data=1, expert=2, tensor=2),
                    [{"tokens": inputs["tokens"][0]}])
    except NotImplementedError as e:
        return str(e)
    return None


def _gloo_worker(rank, store, out_dir, inputs):
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(N)})
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=N)
    try:
        got = {}
        batches = [{"tokens": t} for t in inputs["tokens"]]
        for name, kw in MESHES.items():
            got[name] = _port_train(
                llama_loss_fn(MOE), inputs["params"],
                llama_logical_axes(MOE), MeshConfig(**kw), batches)
        got["chunked"] = _port_train(
            llama_loss_fn(CHUNKED), inputs["params"],
            llama_logical_axes(CHUNKED),
            MeshConfig(**MESHES["data2-expert2"]), batches)
        got["from_jax"], got["adam_from_jax"] = _from_jax(inputs)
        got["tensor"] = _tensor_axis_raises(inputs)
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Spawn the 4 ranks once; (inputs, each rank's results)."""
    tmp = tmp_path_factory.mktemp("moe_gloo")
    inputs = _inputs()
    mp = torch.multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_gloo_worker,
                        args=(r, tmp / "store", str(tmp), inputs))
             for r in range(N)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + GLOO_DEADLINE_S
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [p.pid for p in procs if p.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    assert not hung, (f"gloo ranks {hung} still running after "
                      f"{GLOO_DEADLINE_S} s; killed")
    assert [p.exitcode for p in procs] == [0] * N
    return inputs, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                    for r in range(N)]


# ------------------------------------------------------------- JAX side


@pytest.fixture(autouse=True)
def _restore_global_mesh(monkeypatch):
    from dlrover_tpu.parallel import mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)


def _jax_moe(inputs, mesh_kw, config=MOE):
    """Two optax.adamw steps of the MoE Llama on 4 virtual devices:
    (losses, params)."""
    import jax
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_logical_axes as jax_axes
    from dlrover_tpu.models.llama import llama_loss_fn as jax_loss
    from dlrover_tpu.parallel.accelerate import auto_accelerate as jax_acc
    from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
    from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy

    jc = JaxConfig(**dataclasses.asdict(config))
    res = jax_acc(
        jax_loss(jc), lambda r: jax.tree.map(jnp.asarray, inputs["params"]),
        optax.adamw(LR, weight_decay=0.0), jax_axes(jc),
        strategy=JaxStrategy(mesh=JaxMesh(**mesh_kw),
                             compute_dtype="float32", remat="none",
                             donate=False),
        devices=jax.devices()[:N])
    state, losses = res.state, []
    for i, tokens in enumerate(inputs["tokens"]):
        state, m = res.train_step(state, {"tokens": jnp.asarray(tokens)},
                                  jax.random.key(i))
        losses.append(float(m["loss"]))
    return losses, params_from_jax(jax.tree.map(np.asarray, state.params))


# ------------------------------------------------------------ assertions


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_moe_llama_on_the_expert_axis_matches_jax_mesh(gloo_run, mesh_name):
    """Losses and params after 2 AdamW steps against JAX's 4-device mesh;
    the expert stacks ``Shard(1)`` over ``expert``, their moments too."""
    inputs, saved = gloo_run
    ref_losses, ref_params = _jax_moe(inputs, MESHES[mesh_name])
    dims = list(saved[0][mesh_name]["dims"])
    assert "expert" in dims
    want = _expected_placements(llama_logical_axes(MOE), dims)
    for name in ("layers.w_gate", "layers.w_up", "layers.w_down"):
        assert want[name][dims.index("expert")] == Shard(1)
    for got in saved:
        got = got[mesh_name]
        np.testing.assert_allclose(got["losses"], ref_losses, atol=1e-5)
        assert got["losses"][-1] < got["losses"][0]
        _assert_adam_params(got["params"], ref_params)
        assert got["placements"] == want
        assert got["moments"] == got["placements"]


def test_chunked_ce_with_moe_on_the_expert_axis_matches_jax(gloo_run):
    inputs, saved = gloo_run
    ref_losses, ref_params = _jax_moe(inputs, MESHES["data2-expert2"],
                                      CHUNKED)
    for got in saved:
        np.testing.assert_allclose(got["chunked"]["losses"], ref_losses,
                                   atol=1e-5)
        _assert_adam_params(got["chunked"]["params"], ref_params)


def test_params_and_adam_state_from_jax_on_the_expert_axis(gloo_run):
    """``params_from_jax`` places the router and the expert stacks by
    their logical axes (each rank keeping its 2 of 4 experts), and
    optax's Adam moments load into the DeviceMesh step's AdamW with
    their params' placements."""
    inputs, saved = gloo_run
    ref = params_from_jax(inputs["params"])
    mu = params_from_jax(inputs["adam_state"].mu)
    nu = params_from_jax(inputs["adam_state"].nu)
    want = saved[0]["data2-expert2"]["placements"]
    for got in saved:
        for name, (placements, full, local) in got["from_jax"].items():
            assert placements == want[name]
            assert torch.equal(full, ref[name])
        assert got["from_jax"]["layers.w_gate"][2] == (2, 2, 64, 64)
        for name, (placements, m, v) in got["adam_from_jax"].items():
            assert placements == want[name]
            assert torch.equal(m, mu[name]) and torch.equal(v, nu[name])


def test_moe_under_a_tensor_axis_raises(gloo_run):
    _, saved = gloo_run
    for got in saved:
        assert got["tensor"] is not None
        assert "ROADMAP Queue 1 item 10" in got["tensor"]


def test_rows_are_replicated_over_the_expert_axis(monkeypatch):
    """The expert ranks of one replica read the same rows (the batch maps
    to data and fsdp only)."""
    config = MeshConfig(**MESHES["data2-expert2"])
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: N)
    seen = {}
    for rank in range(N):
        monkeypatch.setattr(dist, "get_rank", lambda group=None, r=rank: r)
        seen[rank] = _rows(np.arange(8), config).tolist()
    assert seen[0] == seen[1] == [0, 1, 2, 3]
    assert seen[2] == seen[3] == [4, 5, 6, 7]
