"""Flash Checkpoint of DeviceMesh state in the port: 4 gloo processes on
the CPU, one host, each with its own local rank's shm segment and its
own saver (no agent). The counterparts of tests/test_flash_checkpoint.py's
sharded cases (save and restore on one mesh, restore onto another mesh,
a shard-wise restore, shard dedup), and a Trainer that trains three
steps on ``(fsdp=2, tensor=2)`` with a save and resumes on ``(fsdp=4)``.

One spawn runs every case; the assertions are parametrised over them,
so each counts. The state is a tree of DTensors placed by logical axes
(``w`` over fsdp and tensor, ``v`` over fsdp and replicated over tensor,
``b`` replicated, ``big`` 64x32 for the staging bound, ``h`` a bf16
``w``, whose bytes a restore onto another mesh must reinterpret, not
convert), a plain tensor and a host array. The processes meet through a
FileStore in a temporary directory, each with the job's segments
unlinked at its end, and are killed after ``GLOO_DEADLINE_S``. The module imports no jax: the
spawned processes import it.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common.ipc import (
    SOCKET_DIR_ENV,
    PersistentSharedMemory,
)
from dlrover_tpu_torch.models import (
    PRESETS,
    llama_init,
    llama_logical_axes,
    llama_loss_fn,
)
from dlrover_tpu_torch.parallel import MeshConfig, Strategy, build_mesh
from dlrover_tpu_torch.parallel.mesh import batch_place
from dlrover_tpu_torch.parallel.sharding import distribute_logical
from dlrover_tpu_torch.trainer import Trainer, TrainingArgs
from dlrover_tpu_torch.trainer.elastic import (
    ElasticDataLoader,
    ElasticSampler,
)
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    ShardedCheckpointEngine,
)

N = 4
GLOO_DEADLINE_S = 120
FSDP4 = MeshConfig(data=1, fsdp=4)
FSDP2_TENSOR2 = MeshConfig(data=1, fsdp=2, tensor=2)
AXES = {"w": ("embed", "mlp"), "v": ("embed", None), "b": (None,),
        "big": ("embed", "mlp"), "h": ("embed", "mlp")}
TINY = dataclasses.replace(PRESETS["tiny"], attn_impl="flash")
GLOBAL_BATCH = 8


def _globals():
    return {"w": torch.arange(128.).reshape(16, 8),
            "v": torch.arange(128.).reshape(16, 8) * -1,
            "b": torch.arange(8.) + 0.5,
            "big": torch.arange(2048.).reshape(64, 32),
            "h": ((torch.arange(128.) - 60.5) / 8).reshape(16, 8).to(
                torch.bfloat16)}


def _state(config, zeros=False):
    """The tree on ``config``'s mesh (zeros: a restore target)."""
    dm = build_mesh(config).device_mesh
    g = _globals()
    tree = {"params": {k: distribute_logical(
        torch.zeros_like(t) if zeros else t, AXES[k], dm)
        for k, t in g.items()}}
    tree["count"] = torch.tensor(0 if zeros else 7, dtype=torch.int64)
    tree["host"] = np.zeros(3, np.int32) if zeros else np.arange(3,
                                                                 dtype=np.int32)
    return tree


def _full(tree):
    return {"params": {k: v.full_tensor() for k, v in
                       tree["params"].items()},
            "count": tree["count"].clone(), "host": np.array(tree["host"])}


def _engine_cases(ckpt_dir):
    """Save and restore the tree on and across meshes; what each rank
    saw."""
    got = {}
    engine = ShardedCheckpointEngine(ckpt_dir, local_rank=dist.get_rank())
    # dedup: each rank's own segment after a save on (fsdp=2, tensor=2)
    assert engine.save_to_memory(10, _state(FSDP2_TENSOR2))
    meta, _ = engine._shm_handler.read()
    got["dedup"] = sorted(leaf.path for leaf in meta.leaves)
    dist.barrier()

    # saved on fsdp=4, restored onto (fsdp=2, tensor=2) from storage
    assert engine.save_to_storage(20, _state(FSDP4))
    assert engine.wait_for_persist(20, timeout=60)
    engine._shm_handler.mark_empty()
    dist.barrier()
    target = _state(FSDP2_TENSOR2, zeros=True)
    restored, step = engine.load(target=target)
    shard_bytes = max(t.to_local().numel() * t.element_size()
                      for t in target["params"].values())
    got["cross_storage"] = (step, _full(restored),
                            engine.last_restore_stats["max_staging_bytes"],
                            shard_bytes,
                            {k: v.placements == target["params"][k].placements
                             for k, v in restored["params"].items()})
    dist.barrier()

    # saved on (fsdp=2, tensor=2), restored onto fsdp=4 from the four
    # local ranks' segments
    assert engine.save_to_memory(30, _state(FSDP2_TENSOR2))
    dist.barrier()
    restored, step = engine.load(target=_state(FSDP4, zeros=True))
    got["cross_shm"] = (step, _full(restored))
    dist.barrier()

    # the same mesh, from storage
    assert engine.save_to_storage(40, _state(FSDP2_TENSOR2))
    assert engine.wait_for_persist(40, timeout=60)
    engine._shm_handler.mark_empty()
    dist.barrier()
    restored, step = engine.load(target=_state(FSDP2_TENSOR2, zeros=True))
    got["same_storage"] = (step, _full(restored))
    dist.barrier()
    engine.close()
    return got


def _dataset(n=64):
    rng = np.random.RandomState(3)
    rows = rng.randint(0, TINY.vocab_size, (n, 17)).astype(np.int32)

    class DS:
        def __len__(self):
            return n

        def __getitem__(self, idx):
            return rows[idx]

    return DS()


def _trainer(config, out_dir, max_steps, ckpt):
    """The tiny Llama's Trainer on ``config``'s mesh; each replica along
    the batch axes reads GLOBAL_BATCH / replicas rows a step, and its
    rows of the dataset's first GLOBAL_BATCH for ``evaluate``."""
    index, count = batch_place(config)
    ds = _dataset()
    first = np.stack([ds[i] for i in range(GLOBAL_BATCH)])
    loader = ElasticDataLoader(
        _dataset(), batch_size=GLOBAL_BATCH // count,
        sampler=ElasticSampler(64, num_replicas=count, rank=index),
        collate_fn=lambda rows: {"tokens": np.stack(rows)})
    trainer = Trainer(
        llama_loss_fn(TINY), lambda s, d: llama_init(TINY, s, d),
        llama_logical_axes(TINY),
        TrainingArgs(output_dir=out_dir, max_steps=max_steps,
                     learning_rate=1e-2, flash_checkpoint=ckpt,
                     save_steps=3 if ckpt else 0, log_steps=0,
                     strategy=Strategy(mesh=config, compute_dtype="float32",
                                       remat="none")),
        train_data=loader,
        eval_data=[{"tokens": np.split(first, count)[index]}],
        device="cpu")
    losses = {}
    inner = trainer._accel.train_step

    def step(state, batch, rng):
        state, metrics = inner(state, batch, rng)
        losses[state.step] = metrics["loss"].item()
        return state, metrics

    trainer._accel.train_step = step
    return trainer, losses


def _trainer_cases(out_dir):
    ref, ref_losses = _trainer(FSDP4, os.path.join(out_dir, "ref"), 6,
                               ckpt=False)
    ref.train()
    ref_eval = ref.evaluate()
    first, first_losses = _trainer(FSDP2_TENSOR2,
                                   os.path.join(out_dir, "run"), 3,
                                   ckpt=True)
    first.train()
    first.close()
    dist.barrier()
    second, second_losses = _trainer(FSDP4, os.path.join(out_dir, "run"), 6,
                                     ckpt=True)
    second.train()
    second_eval = second.evaluate()
    second.close()
    return {"ref": ref_losses, "first": first_losses,
            "second": second_losses,
            "batch_size": second.train_data.batch_size,
            "eval": (ref_eval, second_eval)}


def _worker(rank, store, tmp, job):
    os.environ.update({
        "RANK": str(rank), "WORLD_SIZE": str(N), "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(N), "NODE_RANK": "0",
        "ELASTIC_JOB_NAME": job, SOCKET_DIR_ENV: os.path.join(tmp, "socks"),
        # no paral-config hot reload: a test earlier in the same pytest
        # process (the JAX tuner's) may have pointed this variable at a
        # file with another batch size
        "DLROVER_PARAL_CONFIG_PATH": "",
    })
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=N)
    try:
        got = _engine_cases(os.path.join(tmp, "ckpt"))
        dist.barrier()
        AsyncCheckpointSaver.reset()
        got["trainer"] = _trainer_cases(os.path.join(tmp, "trainer"))
        torch.save(got, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        AsyncCheckpointSaver.reset()
        for name in (f"dlrtpu_torch_ckpt_{job}_{rank}",
                     f"dlrtpu_torch_timer_{job}"):
            try:
                seg = PersistentSharedMemory(name=name)
            except FileNotFoundError:
                continue
            seg.close()
            seg.unlink()
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_sharded")
    job = f"shardtest{os.getpid()}"
    mp = torch.multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_worker,
                        args=(r, str(tmp / "store"), str(tmp), job))
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
    return tmp, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(N)]


def _assert_tree_equal(got, want):
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert torch.equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["host"], want["host"])


def _want():
    g = _globals()
    return {"params": g, "count": torch.tensor(7),
            "host": np.arange(3, dtype=np.int32)}


def test_shard_dedup(sharded_run):
    """On (fsdp=2, tensor=2): ``w``, ``h`` and ``big`` once per rank
    (sharded on both axes), ``v`` once per fsdp shard (replicated over
    tensor), ``b``, the plain tensor and the host array once."""
    _, saved = sharded_run
    paths = [p for got in saved for p in got["dedup"]]
    counts = {name: paths.count(name) for name in set(paths)}
    assert counts == {"params.w": 4, "params.big": 4, "params.h": 4,
                      "params.v": 2,
                      "params.b": 1, "count": 1, "host": 1}
    # the replicated leaves are written by local rank 0
    assert {"params.b", "count", "host"} <= set(saved[0]["dedup"])


@pytest.mark.parametrize("case", ["cross_storage", "cross_shm",
                                  "same_storage"])
def test_restore_equals_the_saved_state(sharded_run, case):
    """Saved on fsdp=4, restored onto (fsdp=2, tensor=2) from storage;
    saved on (fsdp=2, tensor=2), restored onto fsdp=4 from the local
    ranks' segments; and on the same mesh from storage."""
    _, saved = sharded_run
    want_step = {"cross_storage": 20, "cross_shm": 30,
                 "same_storage": 40}[case]
    for got in saved:
        step, tree = got[case][:2]
        assert step == want_step
        _assert_tree_equal(tree, _want())


def test_cross_mesh_restore_is_shard_wise(sharded_run):
    """Each rank's largest host staging buffer is at most its largest
    target shard (a quarter of ``big``), never a global array, and the
    restored leaves keep the target's placements."""
    _, saved = sharded_run
    for got in saved:
        _, _, staging, shard_bytes, placed = got["cross_storage"]
        assert 0 < staging <= shard_bytes < 2048 * 4
        assert all(placed.values())


def test_single_process_reads_the_sharded_checkpoint(sharded_run,
                                                     monkeypatch):
    """The persisted pieces of step 40 tile every global array: one
    process's targetless load assembles them."""
    tmp, _ = sharded_run
    monkeypatch.setenv(SOCKET_DIR_ENV, str(tmp / "main-socks"))
    AsyncCheckpointSaver.reset()
    engine = ShardedCheckpointEngine(str(tmp / "ckpt"), standalone=True)
    try:
        out = engine.load_from_storage()
    finally:
        engine.close()
        AsyncCheckpointSaver.reset()
    assert out["step"] == 40
    want = _want()
    for k, v in want["params"].items():
        assert torch.equal(out["state"][f"params.{k}"], v)
    assert torch.equal(out["state"]["count"], want["count"])


def test_trainer_resumes_on_another_mesh(sharded_run):
    """Three steps on (fsdp=2, tensor=2) with a save at step 3, then a
    Trainer on fsdp=4 restores step 3 (params, moments, sampler) and its
    steps 4-6 take the losses of an uninterrupted fsdp=4 run within
    1e-5."""
    _, saved = sharded_run
    for rank, got in enumerate(saved):
        t = got["trainer"]
        # the loader's per-replica batch, rescaled to the new replicas
        assert t["batch_size"] == GLOBAL_BATCH // 4, (
            f"rank {rank}: batch {t['batch_size']}")
        assert sorted(t["first"]) == [1, 2, 3], (
            f"rank {rank}: first run's steps {sorted(t['first'])}")
        assert sorted(t["second"]) == [4, 5, 6], (
            f"rank {rank}: resumed run's steps {sorted(t['second'])}")
        ref = t["ref"]
        np.testing.assert_allclose(
            [t["first"][s] for s in (1, 2, 3)], [ref[s] for s in (1, 2, 3)],
            atol=1e-5, err_msg=f"rank {rank}: steps 1-3 against the "
            f"uninterrupted run {ref}")
        np.testing.assert_allclose(
            [t["second"][s] for s in (4, 5, 6)], [ref[s] for s in (4, 5, 6)],
            atol=1e-5, err_msg=f"rank {rank}: resumed steps 4-6 against "
            f"the uninterrupted run {ref}")
        # evaluate after step 6: the global loss over every rank's rows,
        # the same on every rank and for the resumed run
        np.testing.assert_allclose(
            t["eval"][1], t["eval"][0], atol=1e-5,
            err_msg=f"rank {rank}: evaluate (uninterrupted, resumed)")
        np.testing.assert_allclose(
            t["eval"][0], saved[0]["trainer"]["eval"][0], rtol=0, atol=0,
            err_msg=f"rank {rank}: uninterrupted evaluate against rank 0's")
