"""The port's ``seq`` axis beside data, fsdp and tensor on a DeviceMesh,
held against the JAX package's meshes of the same shape on its virtual
CPU devices.

Three spawns, one for each world size:

- 4 gloo ranks: for ``data=2, seq=2``, ``fsdp=2, seq=2`` and ``seq=2,
  tensor=2``, the mesh's layout (seq inside data/fsdp, outside tensor;
  the ring's rank is the seq coordinate; a replica's seq ranks read the
  same rows), three adamw steps of the tiny Llama on the ring and under
  Ulysses, and of a 2-layer GPT-2 on the ring (under ``tensor`` GPT-2
  raises, ROADMAP Queue 1 item 7), each against JAX's
  ``auto_accelerate`` on 4 devices with the same ``MeshConfig``; then,
  on ``data=2, seq=2``, labels ignored unevenly across the seq shards;
  on ``fsdp=2, seq=2``, ``overlap_collectives="xla"`` against "off"
  and a sharded Flash Checkpoint round trip of the trained params
  (each piece, replicated over seq, saved once); on ``seq=2,
  tensor=2``, Ulysses with one local kv head a rank raising JAX's
  ``ValueError``; and a Bayesian strategy search (``search_algo="bo"``)
  over the 4 ranks returning one ``Strategy`` on every rank;
- 8 gloo ranks, ``data=2, seq=4``: the JAX package's
  ``test_llama_forward_with_seq_axis`` and
  ``test_sequence_sharded_attention_wrapper``
  (tests/test_sequence_parallel.py) on each rank's rows and sequence
  shard, and the twin of examples/long_context_ring.py for 3 steps
  against the JAX example's losses;
- 2 gloo ranks: the seq axis held whole in each process beside a
  DeviceMesh (``data=2, seq=4``) against JAX's steps, and a process
  that would hold 2 of 4 seq ranks raising. The test's own process runs
  one rank of ``MeshConfig(data=1, fsdp=-1, seq=4)``, bit-equal to
  ``MeshConfig(seq=4)`` without a group.

Each process is spawned and imports this module, so its top level
imports the port only; the JAX package is imported where a reference is
made, in the test's own process. The processes meet through a FileStore
in a temporary directory (no TCP port: the suite runs under xdist), and
are killed after their deadline.

The JAX references that train on several devices run in a process of
their own (:func:`_refs_main`), tried up to ``REF_ATTEMPTS`` times: on a
loaded host XLA's CPU runtime deadlocks the ring's collectives of JAX's
data x seq meshes (one seq group's devices at the next ring hop's
``collective-permute`` while the other group waits at its all-reduce),
and its rendezvous timeout then aborts the whole process. On 8 devices
(data=2, seq=4) it did so in 3 of 9 loaded runs and in every attempt of
a whole ``-n 6`` run of the suite, so the 8-rank and 2-rank cases are
held against JAX's unsharded steps instead (on one device; the ring is
exact and the data split keeps the mean, so JAX's meshes give these
numbers within float rounding), and the example twin against JAX's
example on one device. A failed attempt costs at most
``--xla_cpu_collective_call_terminate_timeout_seconds``; the port's
numbers are never retried.

Tolerances: tests/test_torch_mesh_gloo.py's (losses 1e-5 absolute;
params by the Adam statistic there); the forward 2e-4 and the attention
2e-5, the JAX tests' own; the example's losses within its printed
rounding (6e-5).
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_mesh_gloo import (
    GPT2_SMALL,
    LR,
    TINY,
    TOY_AXES,
    _assert_adam_params,
    _expected_placements,
    _port_train,
    _rows,
    _toy_loss,
)

from dlrover_tpu_torch.models import (
    GPT2Config,
    LlamaConfig,
    gpt2_logical_axes,
    gpt2_loss_fn,
    llama_apply,
    llama_logical_axes,
    llama_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.parallel import (
    DryRunner,
    MeshConfig,
    Strategy,
    auto_accelerate,
    axis_index,
    batch_place,
    build_mesh,
    search_strategy,
    sequence_sharded_attention,
    set_mesh,
)
from dlrover_tpu_torch.parallel.accelerate import empty_params, global_value
from dlrover_tpu_torch.parallel.mesh import MeshError
from dlrover_tpu_torch.trainer import build_optimizer

STEPS = 3
MESHES = {
    "data2-seq2": dict(data=2, seq=2),
    "fsdp2-seq2": dict(data=1, fsdp=2, seq=2),
    "seq2-tensor2": dict(data=1, seq=2, tensor=2),
}
# Ulysses splits each rank's heads over seq: 4 kv heads leave 2 a tensor
# rank, which seq=2 divides
ULYSSES = dataclasses.replace(TINY, attn_impl="ulysses", n_kv_heads=4)
# the JAX tests' config (tests/test_sequence_parallel.py)
FWD = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
           mlp_dim=64, max_seq_len=32, dtype="float32",
           attn_impl="reference")
IN_PROCESS = dict(data=2, seq=4)
# row r's first IGNORED[r] labels are ignored: of each row's 32 labels
# seq rank 0 holds the first 16, so its share of the valid labels is
# far below seq rank 1's
IGNORED = (24, 16, 30, 0, 8, 20, 0, 12)
DEADLINE_S = {2: 90, 4: 180, 8: 120}


# ---------------------------------------------------------------- inputs


def _jax_params(config: dict, seed: int = 0):
    import jax

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_init as jax_init

    return jax.tree.map(np.asarray, jax_init(JaxConfig(**config),
                                             jax.random.key(seed)))


def _labels(tokens):
    labels = tokens[:, 1:].copy()
    for row, n in enumerate(IGNORED):
        labels[row, :n] = -100
    return labels


def _inputs():
    """The seeded inputs of every case, as numpy."""
    import jax

    from dlrover_tpu.models.gpt2 import GPT2Config as JaxGPT2
    from dlrover_tpu.models.gpt2 import gpt2_init as jax_gpt2_init

    rng = np.random.RandomState(0)
    k1, k2 = jax.random.split(jax.random.key(0))
    # one batch repeated: random tokens hold nothing to learn across
    # batches, so only a repeated batch makes a falling loss show that
    # the step learns
    tokens = [rng.randint(0, TINY.vocab_size, (8, 33)).astype(np.int32)
              ] * STEPS
    return {
        "llama": _jax_params(dataclasses.asdict(TINY)),
        "ulysses": _jax_params(dataclasses.asdict(ULYSSES)),
        "gpt2": jax.tree.map(np.asarray, jax_gpt2_init(
            JaxGPT2(**GPT2_SMALL), jax.random.key(0))),
        "tokens": tokens,
        "gpt2_tokens": [rng.randint(0, 64, (8, 33)).astype(np.int32)
                        ] * STEPS,
        "labels": [_labels(t) for t in tokens],
        "toy_params": {
            "w1": np.asarray(jax.random.normal(k1, (16, 32)) * 0.02),
            "w2": np.asarray(jax.random.normal(k2, (32, 16)) * 0.02)},
        "toy_batch": {"x": rng.randn(16, 16).astype(np.float32),
                      "y": rng.randn(16, 16).astype(np.float32)},
        "fwd_params": _jax_params(FWD),
        "fwd_tokens": rng.randint(0, 64, (2, 32)).astype(np.int32),
        "qkv": [rng.randn(4, 4, 32, 16).astype(np.float32)
                for _ in range(3)],
        "ring_params": _jax_params(_ring_example_config()),
    }


def _ring_example_config() -> dict:
    """examples/long_context_ring.py's LlamaConfig."""
    return dict(vocab_size=512, dim=64, n_layers=2, n_heads=4,
                n_kv_heads=2, mlp_dim=128, max_seq_len=512,
                attn_impl="flash", remat=False, dtype="float32")


def _token_batches(inputs, key="tokens"):
    return [{"tokens": t} for t in inputs[key]]


def _label_batches(inputs, shifted):
    """The uneven case's batches: the port's loss takes the inputs
    already cut (``shifted``), JAX's the whole tokens."""
    return [{"tokens": t[:, :-1] if shifted else t, "labels": labels}
            for t, labels in zip(inputs["tokens"], inputs["labels"])]


# ---------------------------------------------------------------- spawns


def _spawn(tmp, world, worker, inputs):
    """Run ``worker(rank, world, store, tmp, inputs)`` on ``world`` gloo
    ranks; each rank's saved results."""
    mp = torch.multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_entry,
                        args=(worker, r, world, str(tmp / "store"),
                              str(tmp), inputs))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + DEADLINE_S[world]
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [p.pid for p in procs if p.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    errors = [(tmp / f"rank{r}.err").read_text() for r in range(world)
              if (tmp / f"rank{r}.err").exists()]
    assert not hung, (f"gloo ranks {hung} still running after "
                      f"{DEADLINE_S[world]} s; killed: {errors}")
    assert [p.exitcode for p in procs] == [0] * world, errors
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _entry(worker, rank, world, store, tmp, inputs):
    import traceback

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world)})
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        got = worker(rank, tmp, inputs)
        torch.save(got, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        set_mesh(None)
        dist.destroy_process_group()


# ------------------------------------------------------ 4 ranks: workers


def _layout(config):
    """The mesh's dims, the ring's place and this rank's rows."""
    mesh = build_mesh(config)
    set_mesh(mesh)
    dm = mesh.device_mesh
    coord = dict(zip(dm.mesh_dim_names, dm.get_coordinate()))
    return {"dims": dm.mesh_dim_names, "coord": coord,
            "ring": (mesh.ring.kind, mesh.ring.size, mesh.ring.rank,
                     mesh.ring.ranks),
            "axis_index": axis_index("seq"), "place": batch_place(config)}


def _raised(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _ckpt_case(tmp, rank, inputs):
    """Train on fsdp=2, seq=2, save the params to shm through the sharded
    engine, restore them into empty masters on the same mesh: the saved
    pieces' paths and the restored values against the trained ones."""
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.common.ipc import (
        SOCKET_DIR_ENV,
        PersistentSharedMemory,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        ShardedCheckpointEngine,
    )

    job = f"seqmesh{os.getppid()}"
    os.environ.update({"ELASTIC_JOB_NAME": job, "NODE_RANK": "0",
                       SOCKET_DIR_ENV: os.path.join(tmp, "socks"),
                       "DLROVER_PARAL_CONFIG_PATH": ""})
    config = MeshConfig(**MESHES["fsdp2-seq2"])
    axes = llama_logical_axes(TINY)
    res = auto_accelerate(
        llama_loss_fn(TINY),
        lambda s, d: params_from_jax(inputs["llama"], d),
        build_optimizer("adamw", LR, weight_decay=0.0),
        Strategy(mesh=config, compute_dtype="float32", remat="none"),
        device="cpu", param_logical_axes=axes)
    state = res.state
    for batch in _token_batches(inputs):
        state, _ = res.train_step(
            state, {k: _rows(v, config) for k, v in batch.items()}, None)
    engine = ShardedCheckpointEngine(os.path.join(tmp, "ckpt"),
                                     local_rank=rank)
    try:
        params = {k: v.detach() for k, v in state.params.items()}
        assert engine.save_to_memory(STEPS, {"params": params})
        meta, _ = engine._shm_handler.read()
        paths = sorted(leaf.path for leaf in meta.leaves)
        dist.barrier()
        target = {"params": empty_params(params, "cpu", res.mesh, axes)}
        restored, step = engine.load(target=target)
        dist.barrier()
        return {"paths": paths, "step": step,
                "equal": {k: torch.equal(v.to_local(),
                                         params[k].to_local())
                          and v.placements == params[k].placements
                          for k, v in restored["params"].items()}}
    finally:
        engine.close()
        AsyncCheckpointSaver.reset()
        try:
            seg = PersistentSharedMemory(name=f"dlrtpu_torch_ckpt_{job}_"
                                         f"{rank}")
            seg.close()
            seg.unlink()
        except FileNotFoundError:
            pass


def _one_rank_infeasible(rank, inputs):
    """Two dry-runs of the toy model on fsdp=4: in the first, rank 1's
    build runs out of memory after the others' builds succeeded; the
    second fits everywhere. What each rank records."""
    builds = []
    config = MeshConfig(fsdp=4)

    def build(strategy):
        res = auto_accelerate(
            _toy_loss, lambda s, d: params_from_jax(inputs["toy_params"], d),
            build_optimizer("adamw", LR, weight_decay=0.0), strategy,
            device="cpu", param_logical_axes=TOY_AXES)
        builds.append(strategy)
        if rank == 1 and len(builds) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (rank 1)")
        batch = {k: _rows(v, config) for k, v in inputs["toy_batch"].items()}
        return res.train_step, res.state, batch, None

    runner = DryRunner(build)
    strategy = Strategy(mesh=config, compute_dtype="float32", remat="none")
    return [(r.ok, r.error, r.step_s, r.compile_s, r.loss)
            for r in (runner.profile(strategy), runner.profile(strategy))]


def _worker4(rank, tmp, inputs):
    got = {}
    gcfg = GPT2Config(**GPT2_SMALL)
    for name, kw in MESHES.items():
        config = MeshConfig(**kw)
        got["layout", name] = _layout(config)
        got["ring", name] = _port_train(
            llama_loss_fn(TINY), inputs["llama"], llama_logical_axes(TINY),
            config, _token_batches(inputs))
        got["ulysses", name] = _port_train(
            llama_loss_fn(ULYSSES), inputs["ulysses"],
            llama_logical_axes(ULYSSES), config, _token_batches(inputs))

        def gpt2(config=config):
            return _port_train(
                gpt2_loss_fn(gcfg), inputs["gpt2"], gpt2_logical_axes(gcfg),
                config, _token_batches(inputs, "gpt2_tokens"))

        got["gpt2", name] = (_raised(gpt2) if "tensor" in kw else gpt2())
    got["labels"] = _port_train(
        llama_loss_fn(TINY), inputs["llama"], llama_logical_axes(TINY),
        MeshConfig(**MESHES["data2-seq2"]),
        _label_batches(inputs, shifted=True))
    got["overlap"] = _port_train(
        llama_loss_fn(TINY), inputs["llama"], llama_logical_axes(TINY),
        MeshConfig(**MESHES["fsdp2-seq2"]), _token_batches(inputs),
        overlap_collectives="xla")
    ul_kv2 = dataclasses.replace(TINY, attn_impl="ulysses")
    got["ulysses_heads"] = _raised(lambda: _port_train(
        llama_loss_fn(ul_kv2), inputs["llama"], llama_logical_axes(ul_kv2),
        MeshConfig(**MESHES["seq2-tensor2"]), _token_batches(inputs)))
    got["ckpt"] = _ckpt_case(tmp, rank, inputs)
    got["search"] = search_strategy(
        _toy_loss,
        lambda s, d: params_from_jax(inputs["toy_params"], d),
        build_optimizer("adamw", LR, weight_decay=0.0), TOY_AXES,
        lambda: inputs["toy_batch"], device="cpu", hbm_gb=16.0,
        search_algo="bo", max_dryruns=3, max_candidates=6).to_json()
    got["one_rank_infeasible"] = _one_rank_infeasible(rank, inputs)
    return got


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    inputs = _inputs()
    return inputs, _spawn(tmp_path_factory.mktemp("seq_mesh4"), 4, _worker4,
                          inputs)


# ------------------------------------------------------------- JAX side


def _jax_train(loss_fn, p_np, axes, mesh_kw, batches, n=4):
    """Three optax.adamw steps on ``n`` virtual devices: (losses,
    params)."""
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
                             donate=False),
        devices=jax.devices()[:n])
    state, losses = res.state, []
    for i, batch in enumerate(batches):
        state, m = res.train_step(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(i))
        losses.append(float(m["loss"]))
    return losses, params_from_jax(jax.tree.map(np.asarray, state.params))


def _jax_llama(params, config, mesh_kw, batches, loss_fn=None, n=4):
    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_logical_axes as jax_axes
    from dlrover_tpu.models.llama import llama_loss_fn as jax_loss

    jc = JaxConfig(**dataclasses.asdict(config))
    return _jax_train(loss_fn or jax_loss(jc), params, jax_axes(jc),
                      mesh_kw, batches, n)


def _jax_labels_loss(config):
    """The mean over the given labels (the tiny preset has no MoE
    term)."""
    import jax.numpy as jnp

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_apply as jax_apply
    from dlrover_tpu.ops.cross_entropy import softmax_cross_entropy

    jc = JaxConfig(**dataclasses.asdict(config))

    def loss_fn(params, batch, rng):
        logits = jax_apply(jc, params, batch["tokens"][:, :-1])
        loss, valid = softmax_cross_entropy(logits, batch["labels"])
        return loss.sum() / jnp.maximum(valid.sum(), 1)

    return loss_fn


def _assert_matches(got, ref, axes):
    ref_losses, ref_params = ref
    np.testing.assert_allclose(got["losses"], ref_losses, atol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
    _assert_adam_params(got["params"], ref_params)
    assert got["placements"] == _expected_placements(axes, list(got["dims"]))
    assert got["moments"] == got["placements"]


# ----------------------------------------------------- 4 ranks: asserts


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_seq_is_a_mesh_dim_in_jax_order(run4, mesh_name):
    """seq sits inside data/fsdp and outside tensor; the ring's rank and
    ``axis_index("seq")`` are the seq coordinate, not the global rank;
    a replica's seq ranks read the same rows, the replicas disjoint
    ones."""
    _, saved = run4
    kw = MESHES[mesh_name]
    want = tuple(a for a in ("data", "fsdp", "seq", "tensor")
                 if a in ("data", "fsdp") or kw.get(a, 1) > 1)
    places = {}
    for rank, got in enumerate(saved):
        lay = got["layout", mesh_name]
        assert lay["dims"] == want
        coord = lay["coord"]["seq"]
        assert lay["ring"] == ("process-group", 2, coord, (coord,))
        assert lay["axis_index"] == coord
        replica = (lay["coord"]["data"], lay["coord"]["fsdp"])
        places.setdefault(replica, set()).add(lay["place"])
    assert all(len(p) == 1 for p in places.values())
    assert len({next(iter(p)) for p in places.values()}) == len(places)
    # seq=2 at the global ranks' coordinates 0, 1, 0, 1 or 0, 0, 1, 1
    coords = [got["layout", mesh_name]["coord"]["seq"] for got in saved]
    assert coords != list(range(4)) and sorted(coords) == [0, 0, 1, 1]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_llama_ring_matches_jax_mesh(run4, jax_refs, mesh_name):
    _, saved = run4
    ref = jax_refs["ring", mesh_name]
    for got in saved:
        _assert_matches(got["ring", mesh_name], ref, llama_logical_axes(TINY))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_llama_ulysses_matches_jax_mesh(run4, jax_refs, mesh_name):
    _, saved = run4
    ref = jax_refs["ulysses", mesh_name]
    for got in saved:
        _assert_matches(got["ulysses", mesh_name], ref,
                        llama_logical_axes(ULYSSES))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_gpt2_ring_matches_jax_mesh(run4, jax_refs, mesh_name):
    """GPT-2 on the ring beside data and fsdp; under tensor it raises
    naming item 7 (w_qkv's fused columns need a q/k/v-aware split)."""
    _, saved = run4
    if "tensor" in MESHES[mesh_name]:
        for got in saved:
            assert "ROADMAP Queue 1 item 7" in got["gpt2", mesh_name]
        return
    ref = jax_refs["gpt2", mesh_name]
    for got in saved:
        _assert_matches(got["gpt2", mesh_name], ref,
                        gpt2_logical_axes(GPT2Config(**GPT2_SMALL)))


def test_uneven_labels_across_seq_shards_match_jax(run4, jax_refs):
    """Ignored labels pile up in seq rank 0's half of each row: the
    loss is the mean over the global batch's valid labels (each rank's
    term divides by the count over data and seq), as JAX's."""
    _, saved = run4
    ref = jax_refs["labels"]
    for got in saved:
        _assert_matches(got["labels"], ref, llama_logical_axes(TINY))


def test_overlap_on_fsdp_seq_matches_off(run4):
    """The fsdp gathers one layer ahead ("xla") under a seq dim: the
    same losses and params as "off" on the same mesh."""
    _, saved = run4
    for got in saved:
        off, xla = got["ring", "fsdp2-seq2"], got["overlap"]
        np.testing.assert_allclose(xla["losses"], off["losses"], rtol=0,
                                   atol=1e-6)
        for k, v in off["params"].items():
            np.testing.assert_allclose(xla["params"][k], v, rtol=0,
                                       atol=1e-6)


def test_ulysses_needs_local_heads_divisible_by_seq(run4):
    """Under tensor=2 the 2 kv heads leave one a rank, which seq=2 does
    not divide: JAX's ValueError."""
    _, saved = run4
    for got in saved:
        assert got["ulysses_heads"].startswith("MeshError: ulysses needs "
                                               "heads divisible")
    assert issubclass(MeshError, ValueError)


def test_sharded_checkpoint_round_trip_on_fsdp_seq(run4):
    """Each param (sharded over fsdp, replicated over seq) is saved by
    the seq coordinate 0 of each fsdp shard only, and restores
    bit-equal onto the same mesh."""
    _, saved = run4
    paths = [p for got in saved for p in got["ckpt"]["paths"]]
    names = {f"params.{k}" for k in llama_logical_axes(TINY)}
    assert {p: paths.count(p) for p in set(paths)} == {n: 2 for n in names}
    for got in saved:
        assert got["ckpt"]["step"] == STEPS
        assert all(got["ckpt"]["equal"].values())


def test_bo_search_agrees_on_every_rank(run4):
    """Each rank measures its own step times; they are MAX-reduced before
    the Gaussian process sees them, so every rank picks the same
    Strategy."""
    _, saved = run4
    picks = {got["search"] for got in saved}
    assert len(picks) == 1
    strategy = Strategy.from_json(picks.pop())
    m = strategy.mesh
    assert m.data * m.fsdp * m.tensor * m.seq * m.pipe * m.expert == 4


def test_a_build_infeasible_on_one_rank_fails_on_every_rank(run4):
    """Rank 1's build runs out of memory, the others' succeed: the build's
    outcome is agreed before any step, so no rank runs a step, every
    rank records the same failure, and the next dry-run runs on all of
    them."""
    _, saved = run4
    failed, ok = zip(*(got["one_rank_infeasible"] for got in saved))
    assert [f[0] for f in failed] == [False] * 4
    assert failed[1][1].startswith("OutOfMemoryError")
    assert all(f[1] == "failed on another rank of the process group"
               for i, f in enumerate(failed) if i != 1)
    assert all(f[2:] == (0.0, 0.0, None) for f in failed)
    assert all(r[0] and r[2] > 0 and np.isfinite(r[4]) for r in ok)
    assert len({r[2:4] for r in ok}) == 1


# -------------------------------------------------------------- 8 ranks


def _worker8(rank, tmp, inputs):
    import dlrover_tpu_torch.examples.long_context_ring as ring_example
    import dlrover_tpu_torch.models as models

    config = MeshConfig(data=2, seq=4)
    mesh = build_mesh(config)
    set_mesh(mesh)
    index, count = batch_place(config)
    c = axis_index("seq")
    # the forward with plain params on this rank's row and shard
    tokens = np.split(inputs["fwd_tokens"], count)[index]
    shard = np.split(tokens, 4, axis=1)[c]
    logits = llama_apply(LlamaConfig(**FWD),
                         params_from_jax(inputs["fwd_params"]),
                         torch.tensor(shard).long())
    # the attention wrapper on this rank's rows and sequence shard
    q, k, v = (torch.tensor(np.split(np.split(x, count)[index], 4,
                                     axis=2)[c]) for x in inputs["qkv"])
    attn = sequence_sharded_attention(q, k, v, mesh=mesh, impl="ring")
    set_mesh(None)
    # the example imports llama_init when it runs: start it from JAX's
    # params
    llama_init = models.llama_init
    models.llama_init = (
        lambda cfg, seed, dev: params_from_jax(inputs["ring_params"], dev))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            losses = ring_example.main(["--steps", "3"], device="cpu")
    finally:
        models.llama_init = llama_init
    return {"place": (index, count, c), "logits": logits.detach(),
            "attn": attn, "losses": losses,
            "lines": out.getvalue().splitlines()}


@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    inputs = _inputs()
    return inputs, _spawn(tmp_path_factory.mktemp("seq_mesh8"), 8, _worker8,
                          inputs)


def _cut(full, place, seq_dim):
    index, count, c = place
    return np.split(np.split(np.asarray(full), count)[index], 4,
                    axis=seq_dim)[c]


def test_llama_forward_with_seq_axis(run8):
    """JAX's test of the same name: Llama logits under data=2, seq=4
    equal the single-device logits (2e-4)."""
    import jax

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_apply as jax_apply

    inputs, saved = run8
    ref = np.asarray(jax_apply(JaxConfig(**FWD), jax.tree.map(
        np.asarray, inputs["fwd_params"]), inputs["fwd_tokens"]))
    for got in saved:
        np.testing.assert_allclose(got["logits"].numpy(),
                                   _cut(ref, got["place"], 1), rtol=2e-4,
                                   atol=2e-4)


def test_sequence_sharded_attention_wrapper(run8):
    """JAX's test of the same name: the ring under data=2, seq=4 equals
    causal attention over the whole sequence (2e-5)."""
    from dlrover_tpu.ops.attention import mha_reference

    inputs, saved = run8
    ref = np.asarray(mha_reference(*inputs["qkv"], causal=True))
    for got in saved:
        np.testing.assert_allclose(got["attn"].numpy(),
                                   _cut(ref, got["place"], 2), rtol=2e-5,
                                   atol=2e-5)


def _example_mesh_line(n: int) -> str:
    """The mesh line both examples print on ``n`` devices or ranks."""
    shards = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    return (f"mesh: data={n // shards} x seq={shards}, sequence 512 "
            f"sharded {512 // shards}/device (ring attention)")


def test_long_context_ring_twin_matches_the_jax_example(run8, jax_refs):
    """The twin on 8 ranks (data=2, seq=4) prints the example's lines,
    its losses those JAX's example prints (on one device; see the
    module's docstring) within the printed rounding, every rank the
    same."""
    _, saved = run8
    want = jax_refs["example"]
    assert want[0] == _example_mesh_line(1)
    jax_losses = [float(line.split("loss=")[1]) for line in want
                  if line.startswith("step ")]
    assert len(jax_losses) == 3 and len(want) == 5
    for got in saved:
        assert got["lines"][0] == _example_mesh_line(8)
        assert [line.split("=")[0] for line in got["lines"][1:]] == \
            [line.split("=")[0] for line in want[1:]]
        assert got["lines"][-1] == want[-1]
        np.testing.assert_allclose(got["losses"], jax_losses, rtol=0,
                                   atol=6e-5)
        assert got["losses"] == saved[0]["losses"]


# ------------------------------------------- the seq axis in the process


def _worker2(rank, tmp, inputs):
    config = MeshConfig(**IN_PROCESS)
    mesh = build_mesh(config)
    got = {"dims": mesh.device_mesh.mesh_dim_names,
           "ring": (mesh.ring.kind, mesh.ring.ranks),
           "place": batch_place(config),
           "raises": _raised(lambda: build_mesh(MeshConfig(data=1, seq=4)))}
    got["train"] = _port_train(
        llama_loss_fn(TINY), inputs["llama"], llama_logical_axes(TINY),
        config, _token_batches(inputs))
    return got


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    inputs = _inputs()
    return inputs, _spawn(tmp_path_factory.mktemp("seq_mesh2"), 2, _worker2,
                          inputs)


def test_seq_in_process_beside_a_two_rank_mesh_matches_jax(run2,
                                                           jax_refs):
    """data=2 over 2 processes, each holding the 4 seq ranks of its
    replica: the DeviceMesh has no seq dim and the ring is in-process;
    the steps equal JAX's (unsharded; see the module's docstring). A
    process that would hold 2 of 4 seq ranks raises."""
    _, saved = run2
    ref = jax_refs["in_process"]
    places = set()
    for got in saved:
        assert got["dims"] == ("data", "fsdp")
        assert got["ring"] == ("in-process", (0, 1, 2, 3))
        places.add(got["place"])
        assert "2 of the 4 seq ranks" in got["raises"]
        _assert_matches(got["train"], ref, llama_logical_axes(TINY))
    assert places == {(0, 2), (1, 2)}


# the reference process's XLA: tests/conftest.py's device count and
# level, and 60 s for a late device at a collective (the default is 40)
REF_FLAGS = ("--xla_force_host_platform_device_count={n} "
             "--xla_backend_optimization_level=0 "
             "--xla_cpu_collective_call_terminate_timeout_seconds=60")
REF_ATTEMPTS = 3
# what the reference process reads of the inputs
REF_INPUTS = ("llama", "ulysses", "gpt2", "tokens", "gpt2_tokens", "labels")


def _refs_main(inputs_path, out_path):
    """The 4-device reference process: JAX's three steps on each mesh
    (ring, Ulysses, GPT-2 off tensor, the uneven labels), and its
    unsharded steps on one device."""
    from dlrover_tpu.models.gpt2 import GPT2Config as JaxGPT2
    from dlrover_tpu.models.gpt2 import gpt2_logical_axes as jax_gpt2_axes
    from dlrover_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss

    inputs = torch.load(inputs_path, weights_only=False)
    refs = {}
    jc = JaxGPT2(**GPT2_SMALL)
    for name, kw in MESHES.items():
        refs["ring", name] = _jax_llama(inputs["llama"], TINY, kw,
                                        _token_batches(inputs))
        refs["ulysses", name] = _jax_llama(inputs["ulysses"], ULYSSES, kw,
                                           _token_batches(inputs))
        if "tensor" not in kw:
            refs["gpt2", name] = _jax_train(
                jax_gpt2_loss(jc), inputs["gpt2"], jax_gpt2_axes(jc), kw,
                _token_batches(inputs, "gpt2_tokens"))
    refs["labels"] = _jax_llama(inputs["llama"], TINY, MESHES["data2-seq2"],
                                _label_batches(inputs, shifted=False),
                                loss_fn=_jax_labels_loss(TINY))
    refs["in_process"] = _jax_llama(inputs["llama"], TINY, {},
                                    _token_batches(inputs), n=1)
    torch.save(refs, out_path)


def _example_main(inputs_path, out_path):
    """The 1-device reference process: the lines JAX's
    examples/long_context_ring.py prints for 3 steps."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).parent.parent / "examples"
            / "long_context_ring.py")
    spec = importlib.util.spec_from_file_location("jax_ring_example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    sys.argv = ["long_context_ring.py", "--steps", "3"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        example.main()
    torch.save(out.getvalue().splitlines(), out_path)


def _reference(tmp, main: str, devices: int, inputs=None):
    """What ``main`` (a function of this module) saves, run in a process
    of its own on ``devices`` virtual devices, up to REF_ATTEMPTS
    times."""
    torch.save(inputs, tmp / "in.pt")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=REF_FLAGS.format(n=devices),
               PYTHONPATH=os.pathsep.join([here, os.path.dirname(here)]))
    errors = []
    for _ in range(REF_ATTEMPTS):
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import sys; from test_torch_seq_mesh_gloo import {main}; "
             f"{main}(sys.argv[1], sys.argv[2])",
             str(tmp / "in.pt"), str(tmp / "out.pt")],
            env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode == 0:
            return torch.load(tmp / "out.pt", weights_only=False)
        errors.append(proc.stderr[-2000:])
    pytest.fail(f"the JAX reference process failed {REF_ATTEMPTS} times: "
                f"{errors}")


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    inputs = _inputs()
    refs = _reference(tmp_path_factory.mktemp("jax_refs"), "_refs_main", 4,
                      {k: inputs[k] for k in REF_INPUTS})
    refs["example"] = _reference(tmp_path_factory.mktemp("jax_example"),
                                 "_example_main", 1)
    return refs


def _train_here(inputs, config):
    res = auto_accelerate(
        llama_loss_fn(TINY), lambda s, d: params_from_jax(inputs["llama"], d),
        build_optimizer("adamw", LR, weight_decay=0.0),
        Strategy(mesh=config, compute_dtype="float32", remat="none"),
        device="cpu", param_logical_axes=llama_logical_axes(TINY))
    state, losses = res.state, []
    for batch in _token_batches(inputs):
        state, m = res.train_step(state, batch, None)
        losses.append(m["loss"].item())
    set_mesh(None)
    return res, losses, {k: global_value(v).detach()
                         for k, v in state.params.items()}


def test_one_rank_mesh_with_seq_in_process_is_bit_equal(tmp_path):
    """One gloo rank, ``MeshConfig(data=1, fsdp=-1, seq=4)``: the 4 seq
    ranks in this process beside a one-rank DeviceMesh (DTensor params),
    bit-equal to ``MeshConfig(seq=4)`` with no process group."""
    inputs = {"llama": _jax_params(dataclasses.asdict(TINY)),
              "tokens": [np.random.RandomState(0).randint(
                  0, TINY.vocab_size, (8, 33)).astype(np.int32)] * STEPS}
    _, ref_losses, ref_params = _train_here(inputs, MeshConfig(seq=4))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        res, losses, params = _train_here(
            inputs, MeshConfig(data=1, fsdp=-1, seq=4))
        assert res.mesh.device_mesh.mesh_dim_names == ("data", "fsdp")
        assert res.mesh.ring.kind == "in-process"
        assert type(res.state.params["embed"]).__name__ == "DTensor"
    finally:
        dist.destroy_process_group()
    assert losses == ref_losses
    for k, v in ref_params.items():
        assert torch.equal(params[k], v), k

