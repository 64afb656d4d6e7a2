"""The port's Flash Checkpoint engine (dlrover_tpu_torch/trainer/
flash_checkpoint/engine.py over agent/ckpt_saver.py) on the CPU.

Parity with the JAX engine: the same seeded tree, as jax arrays on one
device and as torch tensors (with a host numpy leaf, a bfloat16 leaf and
a 0-d step), saved by each package's replicated and sharded engine,
gives the same shm payload bytes, the same leaf metas (path, dtype,
shape, offset, nbytes, global shape, index) and the same manifest
``payload_crc``; each side is read with its own reader. Then the port's
own contract, mirroring tests/test_flash_checkpoint.py where the API is
the same: restore from shm and from storage bit-equal onto each leaf's
own device and dtype, no restored tensor aliasing shm, the two-phase
publish (a torn drain reads as empty), a save skipped while the lock is
busy, an async save followed at once by an in-place update storing the
values of the step it was called on, verify_step_dir, keep-latest-N,
leaf naming and the refusals. What waits for other items (the
FlashCheckpointer API and the agent's breakpoint flush: item 6;
restoring onto another mesh: item 7) is not here.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.agent import ckpt_saver as jax_saver
from dlrover_tpu.trainer.flash_checkpoint import engine as jax_engine
from dlrover_tpu_torch.agent import ckpt_saver
from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common.ipc import (
    SOCKET_DIR_ENV,
    PersistentSharedMemory,
)
from dlrover_tpu_torch.trainer.flash_checkpoint import engine as eng
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    ReplicatedCheckpointEngine,
    ShardedCheckpointEngine,
    _tree_flatten_with_names,
)

ENGINES = {
    "replicated": (ReplicatedCheckpointEngine,
                   jax_engine.ReplicatedCheckpointEngine),
    "sharded": (ShardedCheckpointEngine, jax_engine.ShardedCheckpointEngine),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small tensors gain nothing from many threads: two torch threads
    (and so two per checkpoint copy) keep this file from crowding the
    timing-sensitive tests that run beside it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _isolate(isolated_ckpt_env, tmp_path, monkeypatch):
    """The JAX engine's isolation (tests/conftest.py) and the port's: its
    own socket dir, a fresh saver singleton and step timer, and this
    job's port segments unlinked at the end."""
    from dlrover_tpu_torch.trainer import timer

    monkeypatch.setenv(SOCKET_DIR_ENV, str(tmp_path / "port-socks"))
    # the step timer the engine feeds attaches to this job's ring
    monkeypatch.setattr(timer, "_timer", None)
    AsyncCheckpointSaver.reset()
    yield isolated_ckpt_env
    AsyncCheckpointSaver.reset()
    job = isolated_ckpt_env
    for name in (f"dlrtpu_torch_ckpt_{job}_0", f"dlrtpu_torch_ckpt_{job}_1",
                 f"dlrtpu_torch_timer_{job}"):
        try:
            seg = PersistentSharedMemory(name=name)
        except FileNotFoundError:
            continue
        seg.close()
        seg.unlink()


def numpy_tree(seed=0):
    """A seeded tree of numpy arrays: f32 params, a list of moments, a
    bf16 leaf (as its 16-bit words), an int32 0-d step and a uint8 host
    leaf."""
    rng = np.random.default_rng(seed)
    bf16_words = (rng.standard_normal((4, 6)).astype(np.float32)
                  .view(np.uint32) >> 16).astype(np.uint16)
    return {
        "params": {"w": rng.standard_normal((16, 8)).astype(np.float32),
                   "b": rng.standard_normal(8).astype(np.float32)},
        "opt": [rng.standard_normal(3).astype(np.float32),
                rng.standard_normal((2, 2)).astype(np.float32)],
        "half": bf16_words,
        "step": np.asarray(3, np.int32),
        "data": np.arange(10, dtype=np.uint8),
    }


def as_torch(tree):
    """The numpy tree as the port holds it: tensors (bf16 from the same
    bits, a 0-d step), the host leaf left as numpy."""
    return {
        "params": {k: torch.from_numpy(v.copy())
                   for k, v in tree["params"].items()},
        "opt": [torch.from_numpy(v.copy()) for v in tree["opt"]],
        "half": torch.from_numpy(tree["half"].astype(np.int16))
        .view(torch.bfloat16),
        "step": torch.tensor(int(tree["step"]), dtype=torch.int32),
        "data": tree["data"].copy(),
    }


def as_jax(tree):
    """The numpy tree as the JAX Trainer holds it: jax arrays on one
    device, the host leaf left as numpy."""
    import ml_dtypes

    out = jax.tree.map(jnp.asarray, {k: v for k, v in tree.items()
                                     if k not in ("half", "data")})
    out["half"] = jnp.asarray(tree["half"].view(ml_dtypes.bfloat16))
    out["data"] = tree["data"].copy()
    return out


def zeros_like(tree):
    def z(x):
        if isinstance(x, torch.Tensor):
            return torch.zeros_like(x)
        return np.zeros_like(x)

    return {"params": {k: z(v) for k, v in tree["params"].items()},
            "opt": [z(v) for v in tree["opt"]], "half": z(tree["half"]),
            "step": z(tree["step"]), "data": z(tree["data"])}


def assert_bit_equal(got, want):
    names, g_leaves, _ = _tree_flatten_with_names(got)
    w_names, w_leaves, _ = _tree_flatten_with_names(want)
    assert names == w_names
    for name, g, w in zip(names, g_leaves, w_leaves):
        assert type(g) is type(w), name
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.device == w.device, name
            assert torch.equal(g, w), name
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), name


def _meta_fields(meta):
    return [dict(path=l.path, dtype=l.dtype, shape=tuple(l.shape),
                 offset=l.offset, nbytes=l.nbytes,
                 global_shape=tuple(l.global_shape),
                 index=l.index) for l in meta.leaves]


# ---------------------------------------------------------- JAX parity


@pytest.mark.parametrize("kind", list(ENGINES))
def test_shm_payload_and_metas_match_the_jax_engine(kind, tmp_path):
    port_cls, jax_cls = ENGINES[kind]
    tree = numpy_tree(1)
    pe = port_cls(str(tmp_path / "port"))
    je = jax_cls(str(tmp_path / "jax"))
    assert pe.save_to_memory(5, as_torch(tree))
    assert je.save_to_memory(5, as_jax(tree))
    p_meta, p_buf = pe._shm_handler.read()
    j_meta, j_buf = je._shm_handler.read()
    # each package reads its own classes
    assert type(p_meta).__module__ == "dlrover_tpu_torch.agent.ckpt_saver"
    assert type(j_meta).__module__ == "dlrover_tpu.agent.ckpt_saver"
    assert _meta_fields(p_meta) == _meta_fields(j_meta)
    for field in ("step", "engine", "host_rank", "num_hosts", "total_bytes"):
        assert getattr(p_meta, field) == getattr(j_meta, field), field
    assert bytes(p_buf) == bytes(j_buf)
    assert {l.dtype for l in p_meta.leaves} >= {"bfloat16", "int32",
                                                "uint8", "float32"}
    pe.close()
    je.close()


@pytest.mark.parametrize("kind", list(ENGINES))
def test_persisted_manifest_crc_matches_the_jax_engine(kind, tmp_path):
    port_cls, jax_cls = ENGINES[kind]
    tree = numpy_tree(2)
    pe = port_cls(str(tmp_path / "port"))
    je = jax_cls(str(tmp_path / "jax"))
    assert pe.save_to_storage(7, as_torch(tree))
    assert je.save_to_storage(7, as_jax(tree))
    assert pe.wait_for_persist(7, timeout=30)
    assert je.wait_for_persist(7, timeout=30)
    manifests = [json.loads((tmp_path / side / "checkpoint-7" /
                             "host_0.manifest.json").read_text())
                 for side in ("port", "jax")]
    assert manifests[0]["payload_crc"] == manifests[1]["payload_crc"]
    assert manifests[0]["payload_nbytes"] == manifests[1]["payload_nbytes"]
    assert manifests[0] == manifests[1]
    pe.close()
    je.close()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_verify_step_dir_accepts_its_own_and_rejects_a_flipped_byte(
        package, tmp_path):
    tree = numpy_tree(3)
    if package == "port":
        e = ShardedCheckpointEngine(str(tmp_path / "ckpt"))
        state, verify = as_torch(tree), ckpt_saver.verify_step_dir
    else:
        e = jax_engine.ShardedCheckpointEngine(str(tmp_path / "ckpt"))
        state, verify = as_jax(tree), jax_saver.verify_step_dir
    assert e.save_to_storage(4, state)
    assert e.wait_for_persist(4, timeout=30)
    e.close()
    step_dir = tmp_path / "ckpt" / "checkpoint-4"
    assert verify(str(step_dir), deep=True) == (True, "")
    shard = step_dir / "host_0.dlck"
    raw = bytearray(shard.read_bytes())
    raw[-5] ^= 0x40  # a payload byte
    shard.write_bytes(bytes(raw))
    (step_dir / ".verified").unlink()
    ok, reason = verify(str(step_dir), deep=True)
    assert not ok and "checksum mismatch" in reason


def test_port_reader_refuses_a_jax_meta(tmp_path):
    """A meta pickled by the JAX package names dlrover_tpu classes: the
    port's reader refuses it instead of importing that package."""
    je = jax_engine.ReplicatedCheckpointEngine(str(tmp_path / "jax"))
    assert je.save_to_storage(2, as_jax(numpy_tree()))
    assert je.wait_for_persist(2, timeout=30)
    je.close()
    shard = tmp_path / "jax" / "checkpoint-2" / "host_0.dlck"
    assert jax_saver.read_host_shard_meta(str(shard)) is not None
    assert ckpt_saver.read_host_shard_meta(str(shard)) is None


# ------------------------------------------------------ save / restore


@pytest.mark.parametrize("kind", list(ENGINES))
def test_memory_save_and_restore_bit_equal(kind, tmp_path):
    state = as_torch(numpy_tree(4))
    e = ENGINES[kind][0](str(tmp_path / "ckpt"))
    assert e.save_to_memory(10, state)
    restored, step = e.load(target=zeros_like(state))
    assert step == 10
    assert_bit_equal(restored, state)
    assert restored["half"].dtype == torch.bfloat16
    assert restored["step"].shape == () and restored["step"].device.type \
        == "cpu"
    e.close()


@pytest.mark.parametrize("kind", list(ENGINES))
def test_storage_persist_and_restore_bit_equal(kind, tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    state = as_torch(numpy_tree(5))
    e = ENGINES[kind][0](ckpt_dir)
    assert e.save_to_storage(20, state)
    assert e.wait_for_persist(20, timeout=30)
    e._shm_handler.close(unlink=True)  # a restart with no shm
    restored, step = e.load(target=zeros_like(state))
    assert step == 20
    assert_bit_equal(restored, state)
    assert AsyncCheckpointSaver.get_latest_step(ckpt_dir) == 20
    assert e.last_restore_stats["bytes"] == sum(
        x.numel() * x.element_size() if isinstance(x, torch.Tensor)
        else x.nbytes for x in _tree_flatten_with_names(state)[1])
    e.close()


def test_shm_restore_beats_disk(tmp_path):
    e = ReplicatedCheckpointEngine(str(tmp_path / "ckpt"))
    state = as_torch(numpy_tree(6))
    assert e.save_to_storage(5, state)
    assert e.wait_for_persist(5, timeout=30)
    newer = as_torch(numpy_tree(7))
    assert e.save_to_memory(6, newer)
    restored, step = e.load(target=zeros_like(state))
    assert step == 6
    assert_bit_equal(restored, newer)
    e.close()


def test_restored_tensors_do_not_alias_shm(tmp_path):
    e = ShardedCheckpointEngine(str(tmp_path / "ckpt"))
    state = as_torch(numpy_tree(8))
    assert e.save_to_memory(1, state)
    restored, _ = e.load(target=zeros_like(state))
    targetless = e.load()["state"]
    shm = e._shm_handler.shm.buf
    base = np.frombuffer(shm, np.uint8).ctypes.data
    for t in list(_tree_flatten_with_names(restored)[1]) + list(
            targetless.values()):
        ptr = t.data_ptr() if isinstance(t, torch.Tensor) else t.ctypes.data
        assert not base <= ptr < base + len(shm)
    before = restored["params"]["w"].clone()
    assert e.save_to_memory(2, zeros_like(state))
    assert torch.equal(restored["params"]["w"], before)
    assert torch.equal(targetless["params.w"], before)
    e.close()


def test_zero_copy_load_views(tmp_path):
    """zero_copy=True returns views of shm (the next save rewrites them);
    the default load returns independent copies."""
    e = ReplicatedCheckpointEngine(str(tmp_path / "ckpt"))
    e.save_to_memory(1, {"w": torch.arange(1024, dtype=torch.float32)})
    views = e.load(zero_copy=True)["state"]
    copies = e.load()["state"]
    assert torch.equal(views["w"], torch.arange(1024, dtype=torch.float32))
    e.save_to_memory(2, {"w": torch.zeros(1024)})
    assert float(views["w"][5]) == 0.0
    assert float(copies["w"][5]) == 5.0
    e.close()


def test_breakpoint_flush(tmp_path):
    """A shm-only checkpoint flushed by the saver (save_shm_to_storage,
    what the agent runs when a worker dies) restores from storage."""
    ckpt_dir = str(tmp_path / "ckpt")
    e = ReplicatedCheckpointEngine(ckpt_dir)
    state = as_torch(numpy_tree(9))
    e.save_to_memory(7, state)
    AsyncCheckpointSaver.get_ckpt_saver().save_shm_to_storage()
    assert AsyncCheckpointSaver.get_latest_step(ckpt_dir) == 7
    e._shm_handler.mark_empty()
    restored, step = e.load(target=zeros_like(state))
    assert step == 7
    assert_bit_equal(restored, state)
    e.close()


def test_agent_handler_refresh_after_regrow(tmp_path):
    """The saver re-attaches after the engine recreates a grown segment."""
    ckpt_dir = str(tmp_path / "ckpt")
    e = ReplicatedCheckpointEngine(ckpt_dir)
    e.save_to_memory(1, {"w": torch.ones(8)})
    saver = AsyncCheckpointSaver.get_ckpt_saver()
    saver.save_shm_to_storage()
    e.save_to_memory(2, {"w": torch.ones(8), "big": torch.zeros(1 << 16)})
    saver.save_shm_to_storage()
    assert AsyncCheckpointSaver.get_latest_step(ckpt_dir) == 2
    e.close()


def test_stale_factory_socket_falls_back(tmp_path):
    """A dead factory socket file must not brick the engine."""
    import pathlib

    from dlrover_tpu_torch.common.ipc import socket_path

    sock = pathlib.Path(socket_path("queue", "ckpt_factory"))
    sock.parent.mkdir(parents=True, exist_ok=True)
    sock.touch()
    e = ReplicatedCheckpointEngine(str(tmp_path / "ckpt"))
    assert e._standalone
    assert e.save_to_memory(1, {"w": torch.ones(4)})
    e.close()


def test_skip_when_lock_busy(tmp_path):
    e = ShardedCheckpointEngine(str(tmp_path / "ckpt"))
    assert e._shm_lock.acquire(blocking=False)
    try:
        assert not e.save_to_memory(12, {"w": torch.ones(4)})
        assert not e.save_to_storage(12, {"w": torch.ones(4)})
        assert not e.save_to_memory_async(12, {"w": torch.ones(4)})
    finally:
        e._shm_lock.release()
    assert e._shm_handler.read() is None
    e.close()


def test_torn_drain_reads_as_empty(tmp_path, monkeypatch):
    """A drain that dies after the meta is staged and part of the bytes
    landed leaves a meta that reads as empty (two-phase publish); a
    later save publishes normally."""
    e = ReplicatedCheckpointEngine(str(tmp_path / "ckpt"))
    assert e.save_to_memory(1, {"w": torch.ones(4), "v": torch.ones(3)})
    real = eng._scatter
    calls = []

    def dying(buf, parts):
        calls.append(len(parts))
        real(buf, parts[:1])
        raise RuntimeError("preempted mid-drain")

    monkeypatch.setattr(eng, "_scatter", dying)
    with pytest.raises(RuntimeError, match="mid-drain"):
        e.save_to_memory(2, {"w": torch.full((4,), 2.0),
                             "v": torch.full((3,), 2.0)})
    assert calls
    assert e._shm_handler.read() is None
    assert e._shm_handler.get_checkpoint_step() == -1
    monkeypatch.setattr(eng, "_scatter", real)
    assert e.save_to_memory(3, {"w": torch.full((4,), 3.0),
                                "v": torch.full((3,), 3.0)})
    assert e.load()["step"] == 3
    e.close()


def test_two_phase_meta_publish():
    h = ckpt_saver.SharedMemoryHandler(0)
    arr = np.arange(16, dtype=np.float32)
    meta = ckpt_saver.CheckpointMeta(
        step=7, leaves=[ckpt_saver.LeafMeta(
            path="w", dtype="float32", shape=(16,), offset=0,
            nbytes=arr.nbytes)],
        engine="replicated", total_bytes=arr.nbytes)
    buf = h.write_meta_and_reserve(meta, publish=False)
    assert h.read() is None, "unpublished meta must be invisible"
    buf[: arr.nbytes] = arr.tobytes()
    h.publish_meta()
    got = h.read()
    assert got is not None and got[0].step == 7
    np.testing.assert_array_equal(
        np.frombuffer(bytes(got[1][: arr.nbytes]), np.float32), arr)
    h.close(unlink=True)


def test_shape_mismatch_raises(tmp_path):
    e = ReplicatedCheckpointEngine(str(tmp_path / "ckpt"))
    e.save_to_memory(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="refusing"):
        e.load(target={"w": torch.zeros(8, 8)})
    e.close()


def test_dtype_mismatch_raises(tmp_path):
    """A saved f32 leaf never restores silently into a bf16 target."""
    e = ReplicatedCheckpointEngine(str(tmp_path / "ckpt"))
    e.save_to_memory(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="dtype"):
        e.load(target={"w": torch.zeros(4, dtype=torch.bfloat16)})
    e.close()


def test_storage_restore_refuses_missing_leaves(tmp_path):
    e = ReplicatedCheckpointEngine(str(tmp_path / "ckpt"))
    assert e.save_to_storage(2, {"params": {"w": torch.full((4,), 3.0)}})
    assert e.wait_for_persist(2, timeout=60)
    e._shm_handler.close(unlink=True)
    target = {"params": {"w": torch.zeros(4), "extra": torch.zeros(2)}}
    with pytest.raises(ValueError, match="missing"):
        e.load_from_storage(target=target)
    e.close()


def test_corrupt_newest_step_falls_back_to_an_older_one(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    e = ShardedCheckpointEngine(str(ckpt_dir))
    old, new = as_torch(numpy_tree(10)), as_torch(numpy_tree(11))
    for step, state in ((2, old), (4, new)):
        assert e.save_to_storage(step, state)
        assert e.wait_for_persist(step, timeout=30)
    e._shm_handler.close(unlink=True)
    shard = ckpt_dir / "checkpoint-4" / "host_0.dlck"
    raw = bytearray(shard.read_bytes())
    raw[-1] ^= 0x01
    shard.write_bytes(bytes(raw))
    restored, step = e.load(target=zeros_like(old))
    assert step == 2
    assert_bit_equal(restored, old)
    e.close()


def test_consensus_restore_step_caps_shm_and_storage(tmp_path, monkeypatch):
    e = ShardedCheckpointEngine(str(tmp_path / "ckpt"))
    old, new = as_torch(numpy_tree(12)), as_torch(numpy_tree(13))
    assert e.save_to_storage(2, old)
    assert e.wait_for_persist(2, timeout=30)
    assert e.save_to_memory(4, new)
    monkeypatch.setenv("DLROVER_TPU_RESTORE_STEP", "2")
    restored, step = e.load(target=zeros_like(old))
    assert step == 2
    assert_bit_equal(restored, old)
    monkeypatch.setenv("DLROVER_TPU_RESTORE_STEP", "3")
    with pytest.raises(ValueError, match="consensus restore step 3"):
        e.load(target=zeros_like(old))
    e.close()


# --------------------------------------------------------------- async


def test_async_save_then_in_place_update_keeps_the_saved_step(tmp_path):
    """The port's step updates params in place: an async save followed
    at once by an update stores the values it was called with."""
    e = ShardedCheckpointEngine(str(tmp_path / "ckpt"))
    state = as_torch(numpy_tree(14))
    want = {"params": {k: v.clone() for k, v in state["params"].items()},
            "opt": [v.clone() for v in state["opt"]],
            "half": state["half"].clone(), "step": state["step"].clone(),
            "data": state["data"].copy()}
    assert e.save_to_memory_async(11, state)
    for t in list(state["params"].values()) + state["opt"]:
        t.add_(1.0)
    state["half"].mul_(2)
    state["step"].add_(1)
    state["data"][:] = 255
    assert e.wait_for_shm_save(timeout=30)
    restored, step = e.load(target=zeros_like(want))
    assert step == 11
    assert_bit_equal(restored, want)
    e.close()


def test_second_async_save_skipped_while_busy(tmp_path):
    e = ReplicatedCheckpointEngine(str(tmp_path / "ckpt"))
    state = as_torch(numpy_tree())
    assert e.save_to_memory_async(1, state)
    assert e.wait_for_shm_save(timeout=30)
    assert e._shm_lock.acquire(blocking=False)
    try:
        assert not e.save_to_memory_async(2, state)
    finally:
        e._shm_lock.release()
    e.close()


def test_async_then_sync_sequence(tmp_path):
    e = ReplicatedCheckpointEngine(str(tmp_path / "ckpt"))
    assert e.save_to_memory_async(1, as_torch(numpy_tree(1)))
    assert e.wait_for_shm_save(timeout=30)
    assert e.save_to_memory(2, as_torch(numpy_tree(2)))
    assert e.load()["step"] == 2
    e.close()


def test_async_save_with_storage_path_persists(tmp_path):
    e = ShardedCheckpointEngine(str(tmp_path / "ckpt"))
    state = as_torch(numpy_tree(15))
    assert e.save_to_memory_async(3, state, storage_path="")
    assert e.wait_for_shm_save(timeout=30)
    assert e.wait_for_persist(3, timeout=30)
    e._shm_handler.close(unlink=True)
    restored, step = e.load(target=zeros_like(state))
    assert step == 3
    assert_bit_equal(restored, state)
    e.close()


# ------------------------------------------------------------ retention


def test_keep_latest_n(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_MAX_CKPTS_TO_KEEP", "2")
    ckpt_dir = str(tmp_path / "ckpt")
    e = ReplicatedCheckpointEngine(ckpt_dir)
    for step in (1, 2, 3, 4):
        assert e.save_to_storage(step, as_torch(numpy_tree(step)))
        assert e.wait_for_persist(step, timeout=60)
    dirs = sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("checkpoint-"))
    assert dirs == ["checkpoint-3", "checkpoint-4"]
    assert e.latest_step() == 4
    e.close()


def test_temp_dir_saver_renames_before_the_tracker(tmp_path):
    from dlrover_tpu_torch.agent.ckpt_saver import TempDirCheckpointSaver

    AsyncCheckpointSaver._saver_instance = TempDirCheckpointSaver(
        checkpoint_dir=str(tmp_path / "ckpt"))
    AsyncCheckpointSaver._saver_instance.start()
    e = ReplicatedCheckpointEngine(str(tmp_path / "ckpt"))
    assert e.save_to_storage(5, {"w": torch.ones(3)})
    assert e.wait_for_persist(5, timeout=30)
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "checkpoint-5", "latest_checkpointed_iteration.txt"]
    e.close()


# -------------------------------------------------------------- naming


def test_dotted_names_literal():
    tree = {"params": {"w": torch.zeros(2), "b": torch.zeros(1)},
            "opt": [torch.zeros(3)], "none": None}
    names, _, _ = _tree_flatten_with_names(tree)
    assert names == ["opt.0", "params.b", "params.w"]


def test_names_and_order_match_jax_tree_util():
    tree = numpy_tree()
    names, leaves, _ = _tree_flatten_with_names(tree)
    j_names, j_leaves, _ = jax_engine._tree_flatten_with_names(tree)
    assert names == j_names
    assert all(a is b for a, b in zip(leaves, j_leaves))
    colliding = {"a": {"b": np.zeros(1)}, "a.b": np.zeros(2), "c": [1, 2]}
    assert (_tree_flatten_with_names(colliding)[0]
            == jax_engine._tree_flatten_with_names(colliding)[0])


def test_colliding_names_roundtrip(tmp_path):
    """Colliding dotted names save under keystr names, and the load path
    does not translate them back."""
    e = ReplicatedCheckpointEngine(str(tmp_path / "ckpt"))
    state = {"a": {"b": torch.full((1,), 1.0)}, "a.b": torch.full((2,), 2.0)}
    assert e.save_to_memory(3, state)
    restored, step = e.load(target={"a": {"b": torch.zeros(1)},
                                    "a.b": torch.zeros(2)})
    assert step == 3
    assert float(restored["a"]["b"][0]) == 1.0
    assert torch.equal(restored["a.b"], torch.full((2,), 2.0))
    e.close()


def test_legacy_checkpoint_restores(tmp_path, monkeypatch):
    """A shm image written under keystr names restores through the
    legacy-name translation."""
    e = ReplicatedCheckpointEngine(str(tmp_path / "ckpt"))
    real = eng._tree_flatten_with_names

    def legacy(tree):
        pairs = []
        treedef = eng._flatten(tree, (), pairs)
        return ([eng._keystr(p) for p, _ in pairs], [x for _, x in pairs],
                treedef)

    monkeypatch.setattr(eng, "_tree_flatten_with_names", legacy)
    assert e.save_to_memory(5, {"params": {"w": torch.full((4,), 3.0)}})
    monkeypatch.setattr(eng, "_tree_flatten_with_names", real)
    restored, step = e.load(target={"params": {"w": torch.zeros(4)}})
    assert step == 5
    assert torch.equal(restored["params"]["w"], torch.full((4,), 3.0))
    e.close()


def test_unflatten_keeps_containers():
    tree = {"a": [torch.ones(1), (torch.zeros(2), None)], "b": np.ones(3)}
    names, leaves, treedef = _tree_flatten_with_names(tree)
    back = eng._unflatten(treedef, leaves)
    assert isinstance(back["a"], list) and isinstance(back["a"][1], tuple)
    assert back["a"][1][1] is None
    assert names == ["a.0", "a.1.0", "b"]


def test_segment_and_socket_names_are_the_ports_own(tmp_path, _isolate):
    """The port's segments and sockets never share a name with the JAX
    package's, so the two can run side by side."""
    assert ckpt_saver.shm_name(0) == f"dlrtpu_torch_ckpt_{_isolate}_0"
    assert jax_saver.shm_name(0) == f"dlrtpu_ckpt_{_isolate}_0"
    from dlrover_tpu.common import ipc as jax_ipc
    from dlrover_tpu_torch.common import ipc

    assert ipc.SOCKET_DIR_ENV != jax_ipc.SOCKET_DIR_ENV
    assert ipc.socket_path("lock", "x").startswith(str(tmp_path /
                                                       "port-socks"))
    from dlrover_tpu_torch.trainer import timer

    assert timer.ring_shm_name() == f"dlrtpu_torch_timer_{_isolate}"


def test_leaf_meta_dataclasses_match_the_jax_fields():
    for name in ("LeafMeta", "CheckpointMeta", "SaveEvent"):
        port = [f.name for f in dataclasses.fields(getattr(ckpt_saver, name))]
        ref = [f.name for f in dataclasses.fields(getattr(jax_saver, name))]
        assert port == ref, name
