"""Parity of the port's recsys family with the JAX package's, on the CPU
in float32: the JAX ``Trainer`` and the port's, each with its own
``TieredBatchPreparer`` over its own ``TieredKvEmbedding`` and with
``group_adam``, from the same weights (``recsys_params_from_jax``) over
the same raw-id batches (dim 8, device capacity 64, 4 fields, a 512-id
vocabulary: the table spills every step). Losses within 1e-6, the
slots, the tier and the trained table equal; the eval path serves
batches with ``count=False``; a restart restores the tier with the
table and GroupAdam's int32 row counts; a table on a DeviceMesh raises.
"""

import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dlrover_tpu.models import RecsysConfig as JaxConfig
from dlrover_tpu.models import TieredBatchPreparer as JaxPreparer
from dlrover_tpu.models import make_tiered_embedding as jax_tier
from dlrover_tpu.models import recsys_init as jax_init
from dlrover_tpu.models import recsys_logical_axes as jax_axes
from dlrover_tpu.models import recsys_loss_fn as jax_loss_fn
from dlrover_tpu.optimizers import group_adam as jax_group_adam
from dlrover_tpu.trainer.trainer import Trainer as JaxTrainer
from dlrover_tpu.trainer.trainer import TrainingArgs as JaxArgs
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.models import (
    RecsysConfig,
    TieredBatchPreparer,
    make_tiered_embedding,
    recsys_init,
    recsys_logical_axes,
    recsys_loss_fn,
    recsys_params_from_jax,
)
from dlrover_tpu_torch.optimizers import group_adam
from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

CFG = dict(dim=8, device_capacity=64, fields=4, hidden=16)
VOCAB, BATCH, STEPS, LR = 512, 16, 8, 1e-2


@pytest.fixture(autouse=True)
def _isolate(isolated_ckpt_env, tmp_path, monkeypatch):
    """Both Trainers' shm and socket isolation, no paral-config file."""
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.common.ipc import (
        SOCKET_DIR_ENV,
        PersistentSharedMemory,
    )

    monkeypatch.setenv("DLROVER_PARAL_CONFIG_PATH", "")
    monkeypatch.setenv(SOCKET_DIR_ENV, str(tmp_path / "port-socks"))
    monkeypatch.setenv("DLROVER_RUNTIME_METRICS_PATH",
                       str(tmp_path / "metrics.json"))
    monkeypatch.delenv(NodeEnv.RESHAPE_DIR, raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    AsyncCheckpointSaver.reset()
    yield
    torch.set_num_threads(prev)
    AsyncCheckpointSaver.reset()
    for name in (f"dlrtpu_torch_ckpt_{isolated_ckpt_env}_0",
                 f"dlrtpu_torch_timer_{isolated_ckpt_env}"):
        try:
            seg = PersistentSharedMemory(name=name)
        except FileNotFoundError:
            continue
        seg.close()
        seg.unlink()


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"ids": rs.randint(0, VOCAB, size=(BATCH, 4)).astype(np.int64),
             "labels": rs.randint(0, 2, size=BATCH).astype(np.float32)}
            for _ in range(n)]


def _record(trainer, slots=None):
    """Wrap the train step to keep each step's loss (and slots)."""
    losses, step = [], trainer._accel.train_step

    def recording(state, batch, rng):
        if slots is not None:
            slots.append(np.asarray(batch["slots"]).copy())
        state, metrics = step(state, batch, rng)
        losses.append(float(metrics["loss"]))
        return state, metrics

    trainer._accel.train_step = recording
    return losses


def _jax_run(tmp_path, batches, eval_data=None):
    cfg = JaxConfig(**CFG)
    kv = jax_tier(cfg)
    trainer = JaxTrainer(
        jax_loss_fn(cfg), lambda rng: jax_init(cfg, rng, kv), jax_axes(cfg),
        JaxArgs(output_dir=str(tmp_path / "jax"), max_steps=len(batches),
                log_steps=0, compute_dtype="float32",
                flash_checkpoint=False),
        batches, eval_data=eval_data, optimizer=jax_group_adam(LR),
        prestep=JaxPreparer(kv))
    params = jax.tree.map(np.asarray, trainer.state.params)
    slots = []
    losses = _record(trainer, slots)
    trainer.train()
    return trainer, kv, params, losses, slots


def _port_trainer(tmp_path, params, batches, kv, eval_data=None,
                  flash=False, name="port"):
    cfg = RecsysConfig(**CFG)
    return Trainer(
        recsys_loss_fn(cfg),
        lambda seed, device: recsys_params_from_jax(params, device),
        recsys_logical_axes(cfg),
        TrainingArgs(output_dir=str(tmp_path / name),
                     max_steps=len(batches), log_steps=0,
                     compute_dtype="float32", flash_checkpoint=flash),
        batches, eval_data=eval_data, optimizer=group_adam(LR),
        prestep=TieredBatchPreparer(kv), device="cpu")


def test_trainer_matches_jax(tmp_path):
    batches = _batches(STEPS)
    j_tr, j_kv, params, j_losses, j_slots = _jax_run(tmp_path, batches)
    kv = make_tiered_embedding(RecsysConfig(**CFG))
    tr = _port_trainer(tmp_path, params, batches, kv)
    table = tr.state.params["table"]
    t_slots = []
    t_losses = _record(tr, t_slots)
    tr.train()
    assert len(t_losses) == len(j_losses) == STEPS
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-6)
    for a, b in zip(t_slots, j_slots):
        np.testing.assert_array_equal(a, b)
    # the preparer wrote the table the optimizer holds, in place
    assert tr.state.params["table"] is table
    assert kv.counters == j_kv.counters and kv.counters["demoted_rows"] > 0
    assert kv.host_ids == j_kv.host_ids > 0
    t_ids, t_vecs, t_fr = kv.export(table.detach())
    j_ids, j_vecs, j_fr = j_kv.export(np.asarray(j_tr.state.params["table"]))
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_fr, j_fr)
    np.testing.assert_allclose(t_vecs, j_vecs, rtol=0, atol=1e-6)
    st = tr.state.optimizer.state[table]
    assert st["steps"].dtype == torch.int32
    j_state = [leaf for leaf in jax.tree.leaves(
        j_tr.state.opt_state, is_leaf=lambda x: hasattr(x, "steps"))
        if hasattr(leaf, "steps")][0]
    np.testing.assert_array_equal(st["steps"].numpy(),
                                  np.asarray(j_state.steps["table"]))
    np.testing.assert_allclose(st["mu"].numpy(),
                               np.asarray(j_state.mu["table"]), atol=1e-6)


def test_eval_serves_without_counting(tmp_path):
    batches, evals = _batches(4), _batches(2, seed=1)
    j_tr, j_kv, params, _, _ = _jax_run(tmp_path, batches, eval_data=evals)
    kv = make_tiered_embedding(RecsysConfig(**CFG))
    tr = _port_trainer(tmp_path, params, batches, kv, eval_data=evals)
    tr.train()
    probe = np.arange(VOCAB)
    before = kv.mapper.frequencies(probe).copy()
    loss, j_loss = tr.evaluate(), j_tr.evaluate()
    assert np.isfinite(loss)
    assert abs(loss - j_loss) <= 1e-6
    np.testing.assert_array_equal(kv.mapper.frequencies(probe), before)
    np.testing.assert_array_equal(kv.mapper.frequencies(probe),
                                  j_kv.mapper.frequencies(probe))


def test_restart_restores_tier_state(tmp_path):
    """A restart restores the mapper and host rows with the table leaf
    (the prestep sidecar) and GroupAdam's counts as int32; the resumed
    run continues as an uninterrupted one; a sidecar of another step
    refuses to load."""
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver

    cfg = RecsysConfig(**CFG)
    batches = _batches(8)
    params = {k: v.numpy() for k, v in recsys_init(
        cfg, torch.Generator().manual_seed(0), device="cpu").items()}
    ref_kv = make_tiered_embedding(cfg)
    ref = _port_trainer(tmp_path, params, batches, ref_kv, name="ref")
    ref_losses = _record(ref)
    ref.train()
    ref.close()

    first = batches[:6]
    kv1 = make_tiered_embedding(cfg)
    t1 = _port_trainer(tmp_path, params, first, kv1, flash=True)
    t1.train()
    ids1, vecs1, fr1 = kv1.export(t1.state.params["table"].detach())
    assert kv1.host_ids > 0
    t1.close()
    AsyncCheckpointSaver.reset()

    kv2 = make_tiered_embedding(cfg)
    t2 = _port_trainer(tmp_path, params, batches, kv2, flash=True)
    assert t2.maybe_resume() == 6
    assert kv2.host_ids == kv1.host_ids
    ids2, vecs2, fr2 = kv2.export(t2.state.params["table"].detach())
    np.testing.assert_array_equal(ids2, ids1)
    np.testing.assert_array_equal(vecs2, vecs1)
    np.testing.assert_array_equal(fr2, fr1)
    table = t2.state.params["table"]
    assert t2.state.optimizer.state[table]["steps"].dtype == torch.int32
    # steps 7 and 8 (the batches after the restored position) as the
    # uninterrupted run took them
    t2.train_data = batches[6:]
    losses = _record(t2)
    t2.train()
    np.testing.assert_allclose(losses, ref_losses[6:], rtol=0, atol=1e-6)
    t2.close()
    AsyncCheckpointSaver.reset()

    # a sidecar from another step must refuse to load
    out = str(tmp_path / "port")
    side = os.path.join(out, "prestep_state.npy")
    payload = np.load(side, allow_pickle=True).item()
    payload["step"] = 99
    with open(side, "wb") as f:
        np.save(f, np.array(payload, dtype=object), allow_pickle=True)
    for name in os.listdir(out):
        if name.startswith("prestep_state") and name != "prestep_state.npy":
            os.remove(os.path.join(out, name))
    t3 = _port_trainer(tmp_path, params, batches,
                       make_tiered_embedding(cfg), flash=True)
    with pytest.raises(ValueError, match="prestep sidecar"):
        t3.maybe_resume()
    t3.close()


def test_a_table_on_a_device_mesh_raises():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from dlrover_tpu_torch.parallel.accelerate import TrainState

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("fsdp",))
        table = distribute_tensor(torch.zeros(64, 8), mesh, [Shard(0)])
        state = TrainState(step=0, params={"table": table}, optimizer=None)
        prep = TieredBatchPreparer(make_tiered_embedding(
            RecsysConfig(**CFG)))
        with pytest.raises(NotImplementedError, match="item 7"):
            prep(state, {"ids": np.zeros((2, 4), np.int64)})
    finally:
        dist.destroy_process_group()


def test_init_and_loss_shapes():
    cfg = RecsysConfig(**CFG)
    kv = make_tiered_embedding(cfg)
    params = recsys_init(cfg, torch.Generator().manual_seed(3), kv)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "table": (64, 8), "w1": (8, 16), "b1": (16,), "w2": (16, 1),
        "b2": (1,)}
    assert recsys_logical_axes(cfg) == jax_axes(JaxConfig(**CFG))
    batch = {"slots": torch.randint(0, 64, (5, 4)),
             "labels": torch.tensor([0., 1., 1., 0., 1.])}
    loss = recsys_loss_fn(cfg)(params, batch, None)
    assert loss.shape == () and torch.isfinite(loss)
