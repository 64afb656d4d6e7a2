"""The port's ring collectives (ops/collectives.py) and collective-compute
overlap (parallel/overlap.py) over 4 gloo processes on the CPU, held
against torch's library collectives, against each other and against the
JAX package's overlapped train step on 4 of its virtual CPU devices.

One spawn runs every case (the JAX package's tests/test_hot_loop.py
``TestRingCollectives`` and ``TestOverlappedScan``):

- ``ring_all_gather`` along dims 0 and 1 against
  ``all_gather_into_tensor`` and the unsharded array (exact);
  ``ring_reduce_scatter`` against ``reduce_scatter_tensor`` and the sum
  of every rank's tile (1e-6 relative: the ring adds in its own order);
  the gradient of ``sum(sin(x @ ring_all_gather(w)))`` by each rank's
  shard of ``w`` (the ring reduce-scatter) against the unsharded
  gradient's rows (1e-6); a dim the group's size does not divide
  raising ``ValueError``;
- two SGD steps of the ``tiny`` Llama and of a 2-layer GPT-2 on
  ``fsdp=4`` under ``overlap_collectives`` "off", "xla" and "manual",
  remat "none" and "minimal" (with the models' per-layer checkpoints,
  whose recompute gathers again), f32: against each other and against
  JAX's ``auto_accelerate`` under the same mode;
- at ``fsdp=1`` (``data=4``) ``layer_gather_fn`` is None under every
  mode, and so it is without a mesh.

Tolerances: "xla" is bit-equal to "off" (the same library collectives,
issued earlier); "manual" gathers exactly, but its backward sums the
reduce-scatter in the ring's order, not gloo's: its losses within 1e-6
of "off"'s and its params within 1e-6 (one SGD step of 1e-2 moves a
param by about 1e-4). Against JAX: losses within 1e-5, params within
1e-5, as tests/test_torch_mesh_gloo.py's toy MLP. The processes meet
through a FileStore and are killed after ``GLOO_DEADLINE_S``; this
module's top level imports the port only.
"""

import dataclasses
import faulthandler
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dlrover_tpu_torch.models import (
    PRESETS,
    GPT2Config,
    gpt2_logical_axes,
    gpt2_loss_fn,
    llama_logical_axes,
    llama_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.ops import collectives
from dlrover_tpu_torch.ops.collectives import (
    ring_all_gather,
    ring_reduce_scatter,
)
from dlrover_tpu_torch.parallel import MeshConfig, Strategy, auto_accelerate
from dlrover_tpu_torch.parallel import accelerate as accelerate_lib
from dlrover_tpu_torch.parallel.mesh import batch_place, build_mesh
from dlrover_tpu_torch.parallel.overlap import (
    OVERLAP_MODES,
    layer_gather_fn,
    overlap_autocast,
)
from dlrover_tpu_torch.parallel.shard_ops import ShardContext
from dlrover_tpu_torch.trainer import build_optimizer

N = 4
LR = 1e-2
STEPS = 2
GLOO_DEADLINE_S = 300
FSDP4 = dict(data=1, fsdp=N)
REMATS = ("none", "minimal")
TINY = dataclasses.replace(PRESETS["tiny"], attn_impl="flash",
                           attn_block_q=16, attn_block_k=16)
GPT2_SMALL = dict(
    vocab_size=64, dim=128, n_layers=2, n_heads=2, mlp_dim=256,
    max_seq_len=64, dtype="float32", attn_impl="flash", attn_block_q=16,
    attn_block_k=16,
)
MODELS = ("llama", "gpt2")


def _config(model, remat):
    """The model's config; under remat "minimal" its layers checkpointed
    too."""
    cfg = TINY if model == "llama" else GPT2Config(**GPT2_SMALL)
    return dataclasses.replace(cfg, remat=remat != "none")


# ---------------------------------------------------------------- inputs


def _inputs():
    import jax

    from dlrover_tpu.models.gpt2 import GPT2Config as JaxGPT2
    from dlrover_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_init as jax_init

    rng = np.random.RandomState(0)
    return {
        "llama": jax.tree.map(np.asarray, jax_init(
            JaxConfig(**dataclasses.asdict(TINY)), jax.random.key(0))),
        "gpt2": jax.tree.map(np.asarray, jax_gpt2_init(
            JaxGPT2(**GPT2_SMALL), jax.random.key(0))),
        "llama_tokens": rng.randint(0, TINY.vocab_size, (8, 17))
        .astype(np.int32),
        "gpt2_tokens": rng.randint(0, 64, (8, 17)).astype(np.int32),
        "gather": rng.randn(8, 12).astype(np.float32),
        "scatter": rng.randn(N, 8, 6).astype(np.float32),
        "w": rng.randn(8, 6).astype(np.float32),
        "x": rng.randn(8, 8).astype(np.float32),
    }


# ------------------------------------------------------------ port side


def _rings(inputs, group):
    """This rank's ring results and their library counterparts."""
    rank = dist.get_rank(group)
    out = {}
    full = torch.tensor(inputs["gather"])
    for dim in (0, 1):
        shard = full.chunk(N, dim=dim)[rank].contiguous()
        lib = [torch.empty_like(shard) for _ in range(N)]
        dist.all_gather(lib, shard, group=group)
        out["gather", dim] = (ring_all_gather(shard, group, dim),
                              torch.cat(lib, dim=dim))
    mine = torch.tensor(inputs["scatter"][rank])
    lib = torch.empty(8 // N, 6)
    dist.reduce_scatter_tensor(lib, mine.clone(), group=group)
    out["scatter"] = (ring_reduce_scatter(mine, group, 0), lib)
    w = torch.tensor(inputs["w"]).chunk(N)[rank].clone().requires_grad_()
    x = torch.tensor(inputs["x"]).chunk(N)[rank]
    torch.sin(x @ ring_all_gather(w, group, 0)).sum().backward()
    out["grad"] = w.grad
    try:
        ring_reduce_scatter(torch.ones(7, 4), group, 0)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _port_train(model, mode, remat, inputs):
    """Two SGD steps on fsdp=4: (losses, whole params, ring calls)."""
    cfg = _config(model, remat)
    loss_fn, axes = ((llama_loss_fn(cfg), llama_logical_axes(cfg))
                     if model == "llama"
                     else (gpt2_loss_fn(cfg), gpt2_logical_axes(cfg)))
    config = MeshConfig(**FSDP4)
    res = auto_accelerate(
        loss_fn, lambda seed, device: params_from_jax(inputs[model], device),
        build_optimizer("sgd", LR),
        Strategy(mesh=config, compute_dtype="float32", remat=remat,
                 overlap_collectives=mode),
        device="cpu", param_logical_axes=axes)
    index, count = batch_place(config)
    tokens = np.split(inputs[f"{model}_tokens"], count)[index]
    calls = dict(collectives.ring_calls)
    state, losses = res.state, []
    for _ in range(STEPS):
        state, m = res.train_step(state, {"tokens": tokens}, None)
        losses.append(m["loss"].item())
    return {"losses": losses,
            "params": {k: v.full_tensor().detach().clone()
                       for k, v in state.params.items()},
            "ring_calls": {k: collectives.ring_calls[k] - calls[k]
                           for k in calls}}


def _no_ops():
    """``layer_gather_fn`` under each mode at fsdp=1 and without a mesh."""
    ctx = ShardContext(accelerate_lib.build_mesh(
        MeshConfig(data=N)).device_mesh)
    out = {}
    for mode in OVERLAP_MODES:
        with overlap_autocast(mode):
            out[mode] = (layer_gather_fn(ctx, {}),
                         layer_gather_fn(None, {}))
    return out


def _reuse_meshes() -> None:
    """In a worker: one mesh (a DeviceMesh and its gloo groups) per mesh
    config, reused by every case, instead of new process groups for each
    of the many ``auto_accelerate`` calls."""
    made = {}

    def build(config=None):
        config = config or MeshConfig()
        if config not in made:
            made[config] = build_mesh(config)
        return made[config]

    accelerate_lib.build_mesh = build


def _gloo_worker(rank, store, out_dir, inputs):
    # a crash (SIGSEGV) prints this rank's stack to its stderr
    faulthandler.enable()
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(N)})
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=N)
    _reuse_meshes()
    try:
        group = accelerate_lib.build_mesh(
            MeshConfig(**FSDP4)).device_mesh.get_group("fsdp")
        got = {"rings": _rings(inputs, group), "no_ops": _no_ops()}
        for model in MODELS:
            for remat in REMATS:
                for mode in OVERLAP_MODES:
                    got[model, mode, remat] = _port_train(model, mode, remat,
                                                          inputs)
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Spawn the 4 ranks once; (inputs, each rank's results)."""
    tmp = tmp_path_factory.mktemp("overlap_gloo")
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
    """The JAX side sets its process-global mesh; put it back after each
    test so other test files in this process see what they expect."""
    from dlrover_tpu.parallel import mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)


def _jax_train(model, mode, remat, inputs):
    """Two optax.sgd steps on 4 virtual devices: (losses, params)."""
    import jax
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.models.gpt2 import GPT2Config as JaxGPT2
    from dlrover_tpu.models.gpt2 import gpt2_logical_axes as jax_gpt2_axes
    from dlrover_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss
    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_logical_axes as jax_axes
    from dlrover_tpu.models.llama import llama_loss_fn as jax_loss
    from dlrover_tpu.parallel.accelerate import auto_accelerate as jax_acc
    from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
    from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy

    cfg = dataclasses.asdict(_config(model, remat))
    if model == "llama":
        jc = JaxConfig(**cfg)
        loss_fn, axes = jax_loss(jc), jax_axes(jc)
    else:
        jc = JaxGPT2(**cfg)
        loss_fn, axes = jax_gpt2_loss(jc), jax_gpt2_axes(jc)
    res = jax_acc(
        loss_fn, lambda r: jax.tree.map(jnp.asarray, inputs[model]),
        optax.sgd(LR), axes,
        strategy=JaxStrategy(mesh=JaxMesh(**FSDP4), compute_dtype="float32",
                             remat=remat, donate=False,
                             overlap_collectives=mode),
        devices=jax.devices()[:N])
    state, losses = res.state, []
    batch = {"tokens": jnp.asarray(inputs[f"{model}_tokens"])}
    for i in range(STEPS):
        state, m = res.train_step(state, batch, jax.random.key(i))
        losses.append(float(m["loss"]))
    return losses, params_from_jax(jax.tree.map(np.asarray, state.params))


# ------------------------------------------------------------ assertions


@pytest.mark.parametrize("dim", [0, 1])
def test_ring_all_gather_matches_all_gather(gloo_run, dim):
    inputs, saved = gloo_run
    for got in saved:
        ring, lib = got["rings"]["gather", dim]
        assert torch.equal(ring, lib)
        assert torch.equal(ring, torch.tensor(inputs["gather"]))


def test_ring_reduce_scatter_matches_reduce_scatter(gloo_run):
    inputs, saved = gloo_run
    total = inputs["scatter"].sum(axis=0)
    for rank, got in enumerate(saved):
        ring, lib = got["rings"]["scatter"]
        np.testing.assert_allclose(ring.numpy(), lib.numpy(), rtol=1e-6)
        np.testing.assert_allclose(ring.numpy(),
                                   np.split(total, N)[rank], rtol=1e-6)


def test_ring_gather_gradient_matches_unsharded(gloo_run):
    """The gradient through the ring gather (its backward the ring
    reduce-scatter) equals the unsharded gradient's rows."""
    inputs, saved = gloo_run
    w = torch.tensor(inputs["w"]).requires_grad_()
    torch.sin(torch.tensor(inputs["x"]) @ w).sum().backward()
    for rank, got in enumerate(saved):
        np.testing.assert_allclose(got["rings"]["grad"].numpy(),
                                   w.grad.chunk(N)[rank].numpy(), atol=1e-6)


def test_reduce_scatter_rejects_indivisible(gloo_run):
    _, saved = gloo_run
    for got in saved:
        assert "not divisible" in got["rings"]["indivisible"]


CASES = [(m, mode, r) for m in MODELS for r in REMATS
         for mode in OVERLAP_MODES]


@pytest.mark.parametrize("model,mode,remat", CASES,
                         ids=[f"{m}-{mode}-{r}" for m, mode, r in CASES])
def test_overlap_trains_as_jax_does(gloo_run, model, mode, remat):
    inputs, saved = gloo_run
    ref_losses, ref_params = _jax_train(model, mode, remat, inputs)
    for got in saved:
        got = got[model, mode, remat]
        np.testing.assert_allclose(got["losses"], ref_losses, atol=1e-5)
        assert got["losses"][-1] < got["losses"][0]
        for k, v in ref_params.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=1e-5)


ON = [(m, mode, r) for m in MODELS for r in REMATS for mode in ("xla",
                                                                "manual")]


@pytest.mark.parametrize("model,mode,remat", ON,
                         ids=[f"{m}-{mode}-{r}" for m, mode, r in ON])
def test_overlap_trains_as_off_does(gloo_run, model, mode, remat):
    """"xla" bit-equal to "off"; "manual" within 1e-6 (the ring's sums),
    and only "manual" runs the rings, forward and backward."""
    _, saved = gloo_run
    for got in saved:
        off, on = got[model, "off", remat], got[model, mode, remat]
        assert off["ring_calls"] == {"all_gather": 0, "reduce_scatter": 0}
        if mode == "xla":
            assert on["losses"] == off["losses"]
            for k, v in off["params"].items():
                assert torch.equal(on["params"][k], v), k
            assert on["ring_calls"] == off["ring_calls"]
            continue
        np.testing.assert_allclose(on["losses"], off["losses"], rtol=0,
                                   atol=1e-6)
        for k, v in off["params"].items():
            np.testing.assert_allclose(on["params"][k], v, rtol=0, atol=1e-6)
        calls = on["ring_calls"]
        assert calls["all_gather"] > 0
        assert calls["reduce_scatter"] > 0


def test_overlap_is_a_no_op_without_fsdp(gloo_run):
    _, saved = gloo_run
    for got in saved:
        assert all(v == (None, None) for v in got["no_ops"].values())


def test_overlap_mode_validated():
    with pytest.raises(ValueError, match="overlap mode"):
        with overlap_autocast("bogus"):
            pass
    with pytest.raises(ValueError, match="overlap_collectives"):
        auto_accelerate(lambda p, b, r: None, lambda s, d: {},
                        build_optimizer("sgd", LR),
                        Strategy(overlap_collectives="bogus"), device="cpu")


def test_overlap_carries_the_rule_table():
    from dlrover_tpu_torch.parallel.overlap import overlap_mode, overlap_rules

    rules = (("embed", "fsdp"),)
    with overlap_autocast("manual", rules=rules):
        assert (overlap_mode(), overlap_rules()) == ("manual", rules)
    assert (overlap_mode(), overlap_rules()) == ("off", None)


def test_no_mesh_no_overlap():
    """Plain params have no ``ShardContext``, and the overlap is off for
    them under every mode."""
    ctx = ShardContext.of({"w": torch.zeros(2)})
    assert ctx is None
    for mode in OVERLAP_MODES:
        with overlap_autocast(mode):
            assert layer_gather_fn(ctx, {}) is None
