"""The port's data, fsdp and tensor mesh axes over 4 gloo processes on
the CPU, held against the JAX package's ``auto_accelerate`` on 4 of its
virtual CPU devices with the same meshes.

One spawn runs every case: for each mesh (``MeshConfig()`` = data 4,
``fsdp=4``, ``fsdp=2, tensor=2``, ``data=2, tensor=2``) three adamw steps
of the toy MLP of tests/test_parallel.py (a plain loss function on
DTensors) and of the ``tiny`` Llama preset (``attn_impl="flash"``, whose
plain path runs on the CPU; f32 compute, remat none), then three steps
of a 2-layer GPT-2 under ``fsdp=4``, the Llama's other paths on a
mesh (bshd and reference attention, layer checkpoints, two
microbatches, the chunked CE) against its flash run there, two
microbatches with labels ignored unevenly across rows against JAX's
mesh, ``vocab_parallel_cross_entropy`` over a ``tensor=4`` mesh, and each
mesh's batch placement. The assertions are parametrised over the
cases, so each counts.

Each process is spawned and imports this module, so its top level
imports the port only; the JAX package is imported where a reference is
made, in the test's own process. The processes meet through a FileStore
in a temporary directory (no TCP port: the suite runs under xdist), and
are killed after ``GLOO_DEADLINE_S``.

Tolerances: losses 1e-5 absolute (tests/test_torch_accelerate.py's); the
vocab-parallel loss and its gradient 1e-6. Parameters after the steps,
as ``full_tensor()``: every difference within 1e-5 for the toy MLP; for
the Llama and GPT-2 the statistic of tests/test_torch_accelerate.py
(median below 1e-6, 99th percentile below 0.2% of one learning-rate
step, every difference below 25% of one): Adam divides by sqrt(nu) +
eps, so a gradient within a few orders of eps turns a 1e-7 relative
difference of the summation order into a visible fraction of lr.
"""

import collections
import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from dlrover_tpu_torch.models import (
    GPT2Config,
    PRESETS,
    gpt2_logical_axes,
    gpt2_loss_fn,
    llama_logical_axes,
    llama_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.ops.cross_entropy import vocab_parallel_cross_entropy
from dlrover_tpu_torch.parallel import MeshConfig, Strategy, auto_accelerate
from dlrover_tpu_torch.parallel.mesh import batch_place, build_mesh
from dlrover_tpu_torch.parallel.shard_ops import ShardContext
from dlrover_tpu_torch.trainer import build_optimizer
from dlrover_tpu_torch.trainer.elastic import ElasticSampler

N = 4
LR = 1e-2
STEPS = 3
GLOO_DEADLINE_S = 150
MESHES = {
    "data4": dict(),
    "fsdp4": dict(data=1, fsdp=4),
    "fsdp2-tensor2": dict(data=1, fsdp=2, tensor=2),
    "data2-tensor2": dict(data=2, tensor=2),
}
TINY = dataclasses.replace(PRESETS["tiny"], attn_impl="flash",
                           attn_block_q=16, attn_block_k=16)
GPT2_SMALL = dict(
    vocab_size=64, dim=128, n_layers=2, n_heads=2, mlp_dim=256,
    max_seq_len=64, dtype="float32", attn_impl="flash", attn_block_q=16,
    attn_block_k=16,
)
TOY_AXES = {"w1": ("embed", "mlp"), "w2": ("mlp", "embed")}


class ScaleByAdamState(collections.namedtuple(
        "ScaleByAdamState", ["count", "mu", "nu"])):
    """optax's Adam state with numpy leaves, under optax's class name (what
    ``opt_state_from_jax`` looks for), so the spawned ranks unpickle it
    without importing optax."""


# ---------------------------------------------------------------- inputs


def _inputs():
    """The seeded inputs of every case, as numpy: JAX-made params, the
    toy's (x, y) batch, the token batches, and the CE's logits."""
    import jax

    from dlrover_tpu.models.gpt2 import GPT2Config as JaxGPT2
    from dlrover_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_init as jax_init

    rng = np.random.RandomState(0)
    k1, k2 = jax.random.split(jax.random.key(0))
    inputs = {
        "toy_params": {
            "w1": np.asarray(jax.random.normal(k1, (16, 32)) * 0.02),
            "w2": np.asarray(jax.random.normal(k2, (32, 16)) * 0.02)},
        "toy_batch": {"x": rng.randn(16, 16).astype(np.float32),
                      "y": rng.randn(16, 16).astype(np.float32)},
        "llama_params": jax.tree.map(np.asarray, jax_init(
            JaxConfig(**dataclasses.asdict(TINY)), jax.random.key(0))),
        "llama_tokens": [rng.randint(0, TINY.vocab_size, (8, 33))
                         .astype(np.int32) for _ in range(STEPS)],
        "gpt2_params": jax.tree.map(np.asarray, jax_gpt2_init(
            JaxGPT2(**GPT2_SMALL), jax.random.key(0))),
        "gpt2_tokens": [rng.randint(0, 64, (8, 33)).astype(np.int32)
                        for _ in range(STEPS)],
        "adam_state": _adam_state(jax.tree.map(np.asarray, jax_init(
            JaxConfig(**dataclasses.asdict(TINY)), jax.random.key(0)))),
        "ce_logits": rng.randn(2, 8, 64).astype(np.float32) * 3,
        "ce_labels": np.where(rng.rand(2, 8) < 0.2, -100,
                              rng.randint(0, 64, (2, 8))).astype(np.int32),
    }
    inputs["accum_labels"] = [_uneven_labels(t)
                              for t in inputs["llama_tokens"]]
    return inputs


# the accum case's labels: the first IGNORED[r] of row r's 32 ignored,
# so that JAX's microbatches (rows 0-3 and 4-7 of the global batch) hold
# 64 and 120 valid labels, and each rank's two halves of its rows (rows
# 0, 1, 4, 5 and 2, 3, 6, 7 on fsdp=2) 80 and 104
IGNORED = (24, 24, 16, 0, 0, 0, 8, 0)


def _uneven_labels(tokens):
    labels = tokens[:, 1:].copy()
    for row, n in enumerate(IGNORED):
        labels[row, :n] = -100
    return labels


def _adam_state(params_np):
    """optax.adamw's state after one update with the params as the
    gradient, as a :class:`ScaleByAdamState` of numpy leaves."""
    import jax
    import optax

    tx = optax.adamw(LR, weight_decay=0.0)
    _, state = tx.update(params_np, tx.init(params_np), params_np)
    (adam,) = [s for s in jax.tree.leaves(
        state, is_leaf=lambda n: type(n).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState"]
    return ScaleByAdamState(*(jax.tree.map(np.asarray, x) for x in adam))


def _rows(x, config):
    """This rank's rows of a global batch leaf."""
    index, count = batch_place(config)
    return np.split(np.asarray(x), count)[index]


# ------------------------------------------------------------ port side


def _toy_loss(params, batch, rng):
    x, y = batch["x"], batch["y"]
    h = torch.relu(x @ params["w1"].to(x.dtype))
    pred = h @ params["w2"].to(x.dtype)
    return torch.mean((pred - y) ** 2)


def _port_train(loss_fn, p_np, axes, config, batches, **strategy):
    """Three adamw steps: (losses, full params, placements, moments'
    placements). ``strategy`` overrides the Strategy's fields."""
    res = auto_accelerate(
        loss_fn, lambda seed, device: params_from_jax(p_np, device),
        build_optimizer("adamw", LR, weight_decay=0.0),
        Strategy(**{"mesh": config, "compute_dtype": "float32",
                    "remat": "none", **strategy}),
        device="cpu", param_logical_axes=axes)
    state, losses = res.state, []
    for batch in batches:
        local = {k: _rows(v, config) for k, v in batch.items()}
        state, m = res.train_step(state, local, None)
        losses.append(m["loss"].item())
    opt = state.optimizer
    return {
        "losses": losses,
        "params": {k: v.full_tensor().detach() for k, v in
                   state.params.items()},
        "placements": {k: tuple(v.placements)
                       for k, v in state.params.items()},
        "moments": {k: tuple(opt.state[v]["exp_avg"].placements)
                    for k, v in state.params.items()},
        "dims": res.mesh.device_mesh.mesh_dim_names,
    }


def _port_vocab_ce(logits, labels):
    """Each rank's (per-token loss, valid, grad of the loss sum by its
    logits shard) over a tensor=4 mesh."""
    ctx = ShardContext(build_mesh(MeshConfig(data=1, tensor=N)).device_mesh)
    width = logits.shape[-1] // N
    start = ctx.tensor_rank * width
    shard = torch.tensor(logits[..., start:start + width], requires_grad=True)
    loss, valid = vocab_parallel_cross_entropy(
        shard, torch.tensor(labels).long(), ctx, start)
    loss.sum().backward()
    return loss.detach(), valid, shard.grad, ctx.tensor_rank


# other paths of the model on a mesh, each against the flash, remat
# "none", grad_accum=1, ce_chunks=1 run on the same mesh: (mesh, config
# changes, strategy changes)
VARIANTS = {
    "bshd": ("fsdp2-tensor2", dict(attn_impl="bshd"), {}),
    "reference": ("data2-tensor2", dict(attn_impl="reference"), {}),
    "remat": ("fsdp2-tensor2", dict(remat=True), dict(remat="minimal")),
    "accum2": ("fsdp2-tensor2", {}, dict(grad_accum=2)),
    "ce_chunks2": ("fsdp4", dict(ce_chunks=2), {}),
}


def _variants(inputs):
    out = {}
    for name, (mesh, changes, strategy) in VARIANTS.items():
        cfg = dataclasses.replace(TINY, **changes)
        out[name] = _port_train(
            llama_loss_fn(cfg), inputs["llama_params"],
            llama_logical_axes(cfg), MeshConfig(**MESHES[mesh]),
            [{"tokens": t} for t in inputs["llama_tokens"]],
            **strategy)["losses"]
    return out


def _accum_batches(inputs, shifted):
    """The accum case's batches: the tokens with the uneven labels; the
    port's loss takes the inputs already cut (``shifted``), JAX's the
    whole tokens."""
    return [{"tokens": t[:, :-1] if shifted else t, "labels": labels}
            for t, labels in zip(inputs["llama_tokens"],
                                 inputs["accum_labels"])]


def _sampler_rows(config):
    """(this rank's mesh coordinate, the first rows its sampler reads)."""
    index, count = batch_place(config)
    dm = build_mesh(config).device_mesh
    rows = list(ElasticSampler(64, num_replicas=count, rank=index))[:8]
    return dict(zip(dm.mesh_dim_names, dm.get_coordinate())), rows


def _from_jax_cases(inputs):
    """On (fsdp=2, tensor=2): ``params_from_jax`` onto the mesh, optax's
    Adam state through ``opt_state_from_jax`` into the AdamW of a
    DeviceMesh step, and ``shard_logical`` of a replicated DTensor."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from dlrover_tpu_torch.models import opt_state_from_jax
    from dlrover_tpu_torch.parallel import shard_logical

    config = MeshConfig(**MESHES["fsdp2-tensor2"])
    dm = build_mesh(config).device_mesh
    axes = llama_logical_axes(TINY)
    placed = params_from_jax(inputs["llama_params"], "cpu", dm, axes)
    from_jax = {k: (tuple(v.placements), v.full_tensor())
                for k, v in placed.items()}
    res = auto_accelerate(
        llama_loss_fn(TINY),
        lambda s, d: params_from_jax(inputs["llama_params"], d),
        build_optimizer("adamw", LR, weight_decay=0.0),
        Strategy(mesh=config, compute_dtype="float32", remat="none"),
        device="cpu", param_logical_axes=axes)
    opt = res.state.optimizer
    opt.load_state_dict(opt_state_from_jax(inputs["adam_state"], opt))
    adam = {k: (tuple(opt.state[p]["exp_avg"].placements),
                tuple(p.placements),
                opt.state[p]["exp_avg"].full_tensor(),
                opt.state[p]["exp_avg_sq"].full_tensor(),
                float(opt.state[p]["step"]))
            for k, p in res.state.params.items()}
    full = torch.arange(64.).reshape(8, 8)
    rep = distribute_tensor(full, dm, [Replicate()] * 3)
    moved = shard_logical(rep, ("embed", "mlp"))
    plain = shard_logical(full, ("embed", "mlp"))
    logical = (tuple(moved.placements),
               torch.equal(moved.full_tensor(), full), plain is full,
               shard_logical(moved, ("embed", "mlp")) is moved)
    return from_jax, adam, logical


def _gloo_worker(rank, store, out_dir, inputs):
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(N)})
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=N)
    try:
        got = {}
        for name, kw in MESHES.items():
            config = MeshConfig(**kw)
            got["toy", name] = _port_train(
                _toy_loss, inputs["toy_params"], TOY_AXES, config,
                [inputs["toy_batch"]] * STEPS)
            got["llama", name] = _port_train(
                llama_loss_fn(TINY), inputs["llama_params"],
                llama_logical_axes(TINY), config,
                [{"tokens": t} for t in inputs["llama_tokens"]])
            got["rows", name] = _sampler_rows(config)
        got["variants"] = _variants(inputs)
        got["accum", "fsdp2-tensor2"] = _port_train(
            llama_loss_fn(TINY), inputs["llama_params"],
            llama_logical_axes(TINY), MeshConfig(**MESHES["fsdp2-tensor2"]),
            _accum_batches(inputs, shifted=True), grad_accum=2)
        gcfg = GPT2Config(**GPT2_SMALL)
        got["gpt2", "fsdp4"] = _port_train(
            gpt2_loss_fn(gcfg), inputs["gpt2_params"],
            gpt2_logical_axes(gcfg), MeshConfig(**MESHES["fsdp4"]),
            [{"tokens": t} for t in inputs["gpt2_tokens"]])
        got["vocab_ce"] = _port_vocab_ce(inputs["ce_logits"],
                                         inputs["ce_labels"])
        got["from_jax"], got["adam_from_jax"], got["shard_logical"] = (
            _from_jax_cases(inputs))
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Spawn the 4 ranks once; (inputs, each rank's results)."""
    tmp = tmp_path_factory.mktemp("mesh_gloo")
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


def _jax_train(loss_fn, p_np, axes, mesh_kw, batches, grad_accum=1):
    """Three optax.adamw steps on 4 virtual devices: (losses, params)."""
    import jax
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.parallel.accelerate import auto_accelerate as jax_acc
    from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
    from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy

    res = jax_acc(
        loss_fn, lambda r: jax.tree.map(jnp.asarray, p_np),
        optax.adamw(LR, weight_decay=0.0), axes,
        strategy=JaxStrategy(mesh=JaxMesh(**mesh_kw),
                             compute_dtype="float32", remat="none",
                             donate=False, grad_accum=grad_accum),
        devices=jax.devices()[:N])
    state, losses = res.state, []
    for i, batch in enumerate(batches):
        state, m = res.train_step(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(i))
        losses.append(float(m["loss"]))
    return losses, params_from_jax(jax.tree.map(np.asarray, state.params))


def _jax_toy(inputs, mesh_kw):
    import jax
    import jax.numpy as jnp

    def loss_fn(params, batch, rng):
        x, y = batch["x"], batch["y"]
        h = jax.nn.relu(x @ params["w1"].astype(x.dtype))
        pred = h @ params["w2"].astype(x.dtype)
        return jnp.mean((pred - y) ** 2)

    return _jax_train(loss_fn, inputs["toy_params"], TOY_AXES, mesh_kw,
                      [inputs["toy_batch"]] * STEPS)


def _jax_llama(inputs, mesh_kw):
    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_logical_axes as jax_axes
    from dlrover_tpu.models.llama import llama_loss_fn as jax_loss

    jc = JaxConfig(**dataclasses.asdict(TINY))
    return _jax_train(jax_loss(jc), inputs["llama_params"], jax_axes(jc),
                      mesh_kw, [{"tokens": t}
                                for t in inputs["llama_tokens"]])


def _jax_llama_accum(inputs, mesh_kw):
    """Two microbatches a step under JAX's auto_accelerate, the loss the
    mean over the given labels (the tiny preset has no MoE term)."""
    import jax.numpy as jnp

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_apply as jax_apply
    from dlrover_tpu.models.llama import llama_logical_axes as jax_axes
    from dlrover_tpu.ops.cross_entropy import softmax_cross_entropy

    jc = JaxConfig(**dataclasses.asdict(TINY))

    def loss_fn(params, batch, rng):
        logits = jax_apply(jc, params, batch["tokens"][:, :-1])
        loss, valid = softmax_cross_entropy(logits, batch["labels"])
        return loss.sum() / jnp.maximum(valid.sum(), 1)

    return _jax_train(loss_fn, inputs["llama_params"], jax_axes(jc),
                      mesh_kw, _accum_batches(inputs, shifted=False),
                      grad_accum=2)


def _jax_gpt2(inputs, mesh_kw):
    from dlrover_tpu.models.gpt2 import GPT2Config as JaxGPT2
    from dlrover_tpu.models.gpt2 import gpt2_logical_axes as jax_axes
    from dlrover_tpu.models.gpt2 import gpt2_loss_fn as jax_loss

    jc = JaxGPT2(**GPT2_SMALL)
    return _jax_train(jax_loss(jc), inputs["gpt2_params"], jax_axes(jc),
                      mesh_kw, [{"tokens": t}
                                for t in inputs["gpt2_tokens"]])


def _assert_adam_params(params, ref):
    diffs = torch.cat([(params[k] - ref[k]).abs().flatten() for k in ref])
    assert diffs.median().item() < 1e-6
    assert diffs.quantile(0.99).item() < 2e-3 * LR
    assert diffs.max().item() < 0.25 * LR


def _expected_placements(axes, dims):
    """The placements JAX's spec of each param names on mesh dims
    ``dims``."""
    from dlrover_tpu.parallel.sharding import logical_to_mesh_axes

    out = {}
    for name, logical in axes.items():
        spec = logical_to_mesh_axes(logical)
        placements = [Replicate()] * len(dims)
        for dim, entry in enumerate(spec):
            for axis in (entry,) if isinstance(entry, str) else entry or ():
                if axis in dims:
                    placements[dims.index(axis)] = Shard(dim)
        out[name] = tuple(placements)
    return out


# ------------------------------------------------------------ assertions


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_toy_mlp_matches_jax_mesh(gloo_run, mesh_name):
    inputs, saved = gloo_run
    ref_losses, ref_params = _jax_toy(inputs, MESHES[mesh_name])
    for got in saved:
        got = got["toy", mesh_name]
        np.testing.assert_allclose(got["losses"], ref_losses, atol=1e-5)
        assert got["losses"][-1] < got["losses"][0]
        for k in ref_params:
            np.testing.assert_allclose(got["params"][k], ref_params[k],
                                       rtol=0, atol=1e-5)
        assert got["placements"] == _expected_placements(
            TOY_AXES, list(got["dims"]))
        assert got["moments"] == got["placements"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tiny_llama_matches_jax_mesh(gloo_run, mesh_name):
    inputs, saved = gloo_run
    ref_losses, ref_params = _jax_llama(inputs, MESHES[mesh_name])
    want = _expected_placements(llama_logical_axes(TINY),
                                list(saved[0]["llama", mesh_name]["dims"]))
    for got in saved:
        got = got["llama", mesh_name]
        np.testing.assert_allclose(got["losses"], ref_losses, atol=1e-5)
        assert got["losses"][-1] < got["losses"][0]
        _assert_adam_params(got["params"], ref_params)
        assert got["placements"] == want
        assert got["moments"] == got["placements"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_paths_on_a_mesh_match_flash(gloo_run, variant):
    """The bshd and reference attention, the layer checkpoints under
    remat "minimal" (the gathers re-run in the backward), two
    microbatches (each rank's rows cut in two: the same mean, every
    label valid) and the chunked CE, each on a mesh, against the flash
    run on the same mesh within 1e-5."""
    _, saved = gloo_run
    mesh = VARIANTS[variant][0]
    for got in saved:
        np.testing.assert_allclose(got["variants"][variant],
                                   got["llama", mesh]["losses"], atol=1e-5)


def test_grad_accum_on_a_mesh_matches_jax(gloo_run):
    """Two microbatches a step on (fsdp=2, tensor=2), with labels ignored
    unevenly across rows: microbatch i is each rank's share of the global
    batch's i-th half, as JAX's, so the losses (each microbatch's mean
    over its own valid labels) and the params agree with JAX's 4-device
    mesh; cut from each rank's own rows, the halves hold other counts of
    valid labels and the losses differ."""
    inputs, saved = gloo_run
    ref_losses, ref_params = _jax_llama_accum(inputs,
                                              MESHES["fsdp2-tensor2"])
    for got in saved:
        got = got["accum", "fsdp2-tensor2"]
        np.testing.assert_allclose(got["losses"], ref_losses, atol=1e-5)
        assert got["losses"][-1] < got["losses"][0]
        _assert_adam_params(got["params"], ref_params)


def test_gpt2_fsdp4_matches_jax(gloo_run):
    inputs, saved = gloo_run
    ref_losses, ref_params = _jax_gpt2(inputs, MESHES["fsdp4"])
    for got in saved:
        got = got["gpt2", "fsdp4"]
        np.testing.assert_allclose(got["losses"], ref_losses, atol=1e-5)
        _assert_adam_params(got["params"], ref_params)


def test_vocab_parallel_cross_entropy_matches_jax(gloo_run):
    """Each tensor rank's loss against the JAX package's
    ``vocab_parallel_cross_entropy`` in a shard_map over 4 devices, and
    its logits shard's gradient against the gradient of the plain CE."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from dlrover_tpu.ops.cross_entropy import softmax_cross_entropy
    from dlrover_tpu.ops.cross_entropy import (
        vocab_parallel_cross_entropy as jax_vpce,
    )
    from dlrover_tpu.parallel import get_shard_map

    inputs, saved = gloo_run
    logits, labels = inputs["ce_logits"], inputs["ce_labels"]
    mesh = Mesh(np.array(jax.devices()[:N]), ("tensor",))
    fn = get_shard_map()(
        lambda lg, lb: jax_vpce(lg, lb, "tensor")[0], mesh=mesh,
        in_specs=(P(None, None, "tensor"), P()), out_specs=P(),
        check_vma=False)
    with mesh:
        ref_loss = np.asarray(jax.jit(fn)(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    ref_grad = np.asarray(jax.grad(
        lambda lg: softmax_cross_entropy(lg, jnp.asarray(labels))[0].sum()
    )(jnp.asarray(logits)))
    width = logits.shape[-1] // N
    for got in saved:
        loss, valid, grad, t = got["vocab_ce"]
        np.testing.assert_allclose(loss.numpy(), ref_loss, rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(valid.numpy(), labels != -100)
        np.testing.assert_allclose(
            grad.numpy(), ref_grad[..., t * width:(t + 1) * width],
            rtol=0, atol=1e-6)


def test_params_from_jax_places_dtensors(gloo_run):
    inputs, saved = gloo_run
    want = saved[0]["llama", "fsdp2-tensor2"]["placements"]
    ref = params_from_jax(inputs["llama_params"])
    for got in saved:
        for k, (placements, full) in got["from_jax"].items():
            assert placements == want[k]
            assert torch.equal(full, ref[k])


def test_opt_state_from_jax_places_adam_moments_as_params(gloo_run):
    """optax's Adam state (mu, nu, count) loads into the AdamW of a
    DeviceMesh step by param name: each moment a DTensor with its param's
    placements holding JAX's values, the step its count."""
    inputs, saved = gloo_run
    st = inputs["adam_state"]
    mu, nu = params_from_jax(st.mu), params_from_jax(st.nu)
    for got in saved:
        assert set(got["adam_from_jax"]) == set(mu)
        for k, (m_pl, p_pl, m, v, step) in got["adam_from_jax"].items():
            assert m_pl == p_pl
            assert torch.equal(m, mu[k]) and torch.equal(v, nu[k])
            assert step == float(st.count)


def test_shard_logical_redistributes_dtensors_only(gloo_run):
    _, saved = gloo_run
    for got in saved:
        placements, equal, plain_passes, matched_passes = got[
            "shard_logical"]
        assert placements == (Replicate(), Shard(0), Shard(1))
        assert equal and plain_passes and matched_passes


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tensor_ranks_of_a_replica_read_the_same_rows(gloo_run, mesh_name):
    """The sampler's replica is the rank's (data, fsdp) place: the ranks
    that differ only along ``tensor`` read the same rows, and the
    replicas read disjoint rows."""
    _, saved = gloo_run
    by_replica = {}
    for got in saved:
        coord, rows = got["rows", mesh_name]
        by_replica.setdefault((coord["data"], coord["fsdp"]), []).append(
            rows)
    kw = MESHES[mesh_name]
    assert len(by_replica) == kw.get("data", N // kw.get("tensor", 1)
                                     // kw.get("fsdp", 1)) * kw.get(
                                         "fsdp", 1)
    seen = set()
    for rows in by_replica.values():
        assert all(r == rows[0] for r in rows)
        assert not seen & set(rows[0])
        seen |= set(rows[0])
