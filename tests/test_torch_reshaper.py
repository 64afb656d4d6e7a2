"""The port's reshape mover (``parallel/reshaper.py``), the request's new
fields, the flash checkpoint engine's exact-step load with held pieces,
and the Trainer's reshape on one process, held against the JAX package.

- ``shard_boxes`` against ``NamedSharding.devices_indices_map`` and
  ``boxes_cover`` against JAX's ``survivors_cover`` on 8 virtual devices,
  the port's ranks standing for the devices' positions in the mesh;
- ``reshape_state``: which leaves go to the mover and which to the
  fallback, its report, and what it refuses;
- ``ShardedCheckpointEngine.load(step=..., held=...)`` on one process;
- a Trainer with no process group adopting a 1 -> 1 round in process:
  its losses after the round those of JAX's Trainer through a 1 -> 1
  round on one device (1e-5) and bit-equal to its own run with none;
  the channel installed, declined or refused by what the worker runs.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.ipc import (
    SOCKET_DIR_ENV,
    PersistentSharedMemory,
)
from dlrover_tpu_torch.models import (
    PRESETS,
    llama_logical_axes,
    llama_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.parallel import Strategy, reshaper
from dlrover_tpu_torch.trainer import Trainer, TrainingArgs, timer
from dlrover_tpu_torch.trainer.elastic import (
    ElasticDataLoader,
    ElasticSampler,
)
from dlrover_tpu_torch.trainer.elastic.reshape import (
    ReshapeChannel,
    ReshapeRequest,
)
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    ShardedCheckpointEngine,
)

TINY = PRESETS["tiny"]
LR = 1e-3

# (mesh shape over ("data", "fsdp"), global shape, spec by tensor dim)
LAYOUTS = {
    "fsdp-rows": ((2, 4), (16, 8), ("fsdp", None)),
    "data-cols": ((2, 4), (16, 8), (None, "data")),
    "both-rows": ((2, 4), (16, 8), (("data", "fsdp"), None)),
    "fsdp-data": ((2, 4), (16, 8), ("fsdp", "data")),
    "replicated": ((2, 4), (16, 8), (None, None)),
    "fsdp8": ((1, 8), (32,), ("fsdp",)),
}
LOST = {"none": (), "one": (5,), "a-data-row": (4, 5, 6, 7),
        "a-fsdp-col": (1, 5), "all-but-one": (1, 2, 3, 4, 5, 6, 7)}


def _placements(spec, names=("data", "fsdp")):
    out = []
    for axis in names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _jax_array(mesh_shape, shape, spec):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    n = int(np.prod(mesh_shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(mesh_shape),
                ("data", "fsdp"))
    sharding = NamedSharding(mesh, PartitionSpec(*spec))
    return jax.device_put(np.zeros(shape, np.float32), sharding), sharding


def _norm(index, shape):
    return tuple(slice(0 if s.start is None else s.start,
                       n if s.stop is None else s.stop)
                 for s, n in zip(index, shape))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_shard_boxes_match_jax_index_maps(layout):
    mesh_shape, shape, spec = LAYOUTS[layout]
    _, sharding = _jax_array(mesh_shape, shape, spec)
    ranks = np.arange(int(np.prod(mesh_shape))).reshape(mesh_shape)
    got = reshaper.shard_boxes(shape, ranks, _placements(spec))
    want = {d.id: _norm(idx, shape)
            for d, idx in sharding.devices_indices_map(shape).items()}
    assert got == want


def test_shard_boxes_split_uneven_dims_as_torch_chunk():
    ranks = np.arange(4).reshape(1, 4)
    got = reshaper.shard_boxes((10, 3), ranks, [Replicate(), Shard(0)])
    chunks = [c.shape[0] for c in torch.arange(10).chunk(4)]
    assert [b[0].stop - b[0].start for b in got.values()] == chunks


@pytest.mark.parametrize("lost", sorted(LOST))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_boxes_cover_matches_jax_survivors_cover(layout, lost):
    from dlrover_tpu.parallel.reshaper import survivors_cover as jax_cover

    mesh_shape, shape, spec = LAYOUTS[layout]
    arr, _ = _jax_array(mesh_shape, shape, spec)
    ranks = np.arange(int(np.prod(mesh_shape))).reshape(mesh_shape)
    dead = [r for r in LOST[lost] if r < ranks.size]
    assert reshaper.boxes_cover(shape, ranks, _placements(spec), dead) == \
        jax_cover(arr, dead)


def test_plain_leaves_always_survive():
    assert reshaper.survivors_cover(torch.zeros(4), {0, 1, 2})
    assert reshaper.survivors_cover(np.zeros(3), {0})


def _fake_cover(lost_names):
    """A survivors_cover that loses the leaves whose value is in
    ``lost_names`` (no DeviceMesh in this process)."""
    return lambda leaf, lost: not (lost and id(leaf) in lost_names)


def test_reshape_state_routes_movable_and_lost_leaves(monkeypatch):
    leaves = [torch.ones(2), torch.zeros(3), np.asarray(4), torch.tensor(7.)]
    targets = [torch.empty(2), torch.empty(3), np.asarray(0),
               torch.empty(())]
    names = ["a", "b", "host", "scalar"]
    monkeypatch.setattr(reshaper, "survivors_cover",
                        _fake_cover({id(leaves[1])}))
    calls = {}

    def move(req):
        calls["move"] = sorted(req)
        return {n: f"moved {n}" for n in req}

    def fallback(req):
        calls["fallback"] = sorted(req)
        return {n: f"pulled {n}" for n in req}

    out, report = reshaper.reshape_state(leaves, targets, names, move,
                                         lost_ranks={3}, fallback=fallback)
    assert calls == {"move": ["a", "host", "scalar"], "fallback": ["b"]}
    assert out == ["moved a", "pulled b", "moved host", "moved scalar"]
    # arrays only: the 0-d tensor and the host array are not counted
    assert (report.moved, report.pulled, report.lost_leaves) == (1, 1,
                                                                 ["b"])


def test_reshape_state_refuses_what_would_lose_state(monkeypatch):
    leaves, targets = [torch.ones(2), torch.ones(2)], [None, None]
    every = {n: 1 for n in ("a", "b")}
    with pytest.raises(ValueError, match="1 names for 2 leaves"):
        reshaper.reshape_state(leaves, targets, ["a"], lambda r: every)
    with pytest.raises(ValueError, match=r"mover did not return .*'b'"):
        reshaper.reshape_state(leaves, targets, ["a", "b"],
                               lambda r: {"a": 1})
    monkeypatch.setattr(reshaper, "survivors_cover",
                        _fake_cover({id(leaves[0])}))
    with pytest.raises(ValueError, match="no fallback loader"):
        reshaper.reshape_state(leaves, targets, ["a", "b"],
                               lambda r: every, lost_ranks={1})
    with pytest.raises(ValueError, match="fallback loader did not return"):
        reshaper.reshape_state(leaves, targets, ["a", "b"],
                               lambda r: every, lost_ranks={1},
                               fallback=lambda r: {})


def test_request_round_trips_its_new_fields(tmp_path):
    chan = ReshapeChannel(str(tmp_path))
    chan.signal(ReshapeRequest(round=3, world={0: 2}, prev_world={0: 2, 1: 2},
                               departed={1: "dead"}, leaving=True))
    got = chan.poll(-1)
    assert got.prev_world == {0: 2, 1: 2} and got.leaving and got.dead()
    req = ReshapeRequest(world={0: 2}, prev_world={0: 2, 1: 3, 2: 1},
                         departed={1: "dead", 2: "drained"})
    assert Trainer._departed_ranks(Trainer, req, "dead") == {2, 3, 4}
    assert Trainer._departed_ranks(Trainer, req, "drained") == {5}
    with pytest.raises(ValueError, match="no prev_world"):
        Trainer._departed_ranks(
            Trainer, ReshapeRequest(departed={1: "dead"}), "dead")


# ------------------------------------------- one process: engine, Trainer


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    job = f"rsu{os.getpid()}"
    monkeypatch.setenv("ELASTIC_JOB_NAME", job)
    monkeypatch.setenv(SOCKET_DIR_ENV, str(tmp_path / "socks"))
    monkeypatch.setenv("DLROVER_RUNTIME_METRICS_PATH",
                       str(tmp_path / "metrics.json"))
    monkeypatch.setenv("DLROVER_PARAL_CONFIG_PATH", "")
    monkeypatch.delenv(NodeEnv.RESHAPE_DIR, raising=False)
    monkeypatch.delenv("DLROVER_TPU_RESTORE_STEP", raising=False)
    monkeypatch.setattr(timer, "_timer", None)
    AsyncCheckpointSaver.reset()
    yield job
    AsyncCheckpointSaver.reset()
    for name in (f"dlrtpu_torch_ckpt_{job}_0", f"dlrtpu_torch_timer_{job}"):
        try:
            seg = PersistentSharedMemory(name=name)
        except FileNotFoundError:
            continue
        seg.close()
        seg.unlink()


def test_engine_loads_an_exact_step_and_copies_held_pieces(tmp_path,
                                                           isolated):
    engine = ShardedCheckpointEngine(str(tmp_path / "ckpt"),
                                     standalone=True)
    tree = lambda v: {"w": torch.full((4, 3), float(v)),  # noqa: E731
                      "n": np.asarray(v)}
    try:
        assert engine.save_to_storage(3, tree(3))
        assert engine.wait_for_persist(3, timeout=60)
        assert engine.save_to_memory(5, tree(5))
        target = tree(0)
        got, step = engine.load(target=target, step=5)
        assert step == 5 and torch.equal(got["w"], tree(5)["w"])
        # shm holds 5: step 3 comes from storage
        got, step = engine.load(target=target, step=3)
        assert step == 3 and torch.equal(got["w"], tree(3)["w"])
        assert int(got["n"]) == 3
        assert engine.load(target=target, step=4) is None
        # a held piece is copied, not read: its values win
        mine = torch.full((4, 3), 9.0)
        box = (slice(0, 4), slice(0, 3))
        got, _ = engine.load(target=target, step=5, held={"w": (box, mine)})
        assert torch.equal(got["w"], mine) and got["w"] is not mine
    finally:
        engine.close()


class _Rows:
    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        return self.rows[idx]


def _rows():
    rng = np.random.RandomState(5)
    return rng.randint(0, TINY.vocab_size, (48, 17)).astype(np.int32)


def _jax_params():
    import jax

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_init as jax_init

    return jax.tree.map(np.asarray, jax_init(
        JaxConfig(**dataclasses.asdict(TINY)), jax.random.key(0)))


class _Recording(Trainer):
    def __init__(self, *a, **kw):
        self.losses = {}
        super().__init__(*a, **kw)
        self._wrap()

    def _adopt_accel(self, params):
        super()._adopt_accel(params)
        self._wrap()

    def _wrap(self):
        inner = self._accel.train_step

        def step(state, batch, rng):
            state, metrics = inner(state, batch, rng)
            self.losses[state.step] = metrics["loss"].item()
            return state, metrics

        self._accel.train_step = step


def _port_trainer(out_dir, params_np, channel=None, factory=None, **args):
    loader = ElasticDataLoader(
        _Rows(_rows()), batch_size=8,
        sampler=ElasticSampler(48, num_replicas=1, rank=0, shuffle=False),
        collate_fn=lambda rows: {"tokens": np.stack(rows)})
    args = dict(dict(output_dir=str(out_dir), learning_rate=LR,
                     log_steps=0, max_steps=3,
                     strategy=Strategy(compute_dtype="float32",
                                       remat="none")), **args)
    return _Recording(
        llama_loss_fn(TINY), lambda s, d: params_from_jax(params_np, d),
        llama_logical_axes(TINY), TrainingArgs(**args), train_data=loader,
        reshape_channel=channel, device="cpu", optimizer=factory)


def _jax_one_to_one(tmp_path, params_np):
    """JAX's Trainer on one device: 3 steps, a 1 -> 1 round, 3 more."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_logical_axes as jax_axes
    from dlrover_tpu.models.llama import llama_loss_fn as jax_loss
    from dlrover_tpu.parallel import mesh as jax_mesh
    from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
    from dlrover_tpu.trainer.elastic.dataloader import (
        ElasticDataLoader as JaxLoader,
    )
    from dlrover_tpu.trainer.elastic.reshape import (
        ReshapeChannel as JaxChannel,
    )
    from dlrover_tpu.trainer.elastic.reshape import (
        ReshapeRequest as JaxRequest,
    )
    from dlrover_tpu.trainer.elastic.sampler import (
        ElasticSampler as JaxSampler,
    )
    from dlrover_tpu.trainer.trainer import Trainer as JaxTrainer
    from dlrover_tpu.trainer.trainer import TrainingArgs as JaxArgs

    saved = jax_mesh._global_mesh
    jc = JaxConfig(**dataclasses.asdict(TINY))
    loader = JaxLoader(
        _Rows(_rows()), batch_size=8,
        sampler=JaxSampler(48, num_replicas=1, rank=0, shuffle=False),
        collate_fn=lambda rows: {"tokens": np.stack(rows)}, config_file="")
    chan = JaxChannel(str(tmp_path / "jax_chan"))
    tr = JaxTrainer(
        jax_loss(jc), lambda rng: jax.tree.map(jnp.asarray, params_np),
        jax_axes(jc),
        JaxArgs(output_dir=str(tmp_path / "jax"), learning_rate=LR,
                log_steps=0, optimizer="adamw", flash_checkpoint=False,
                max_steps=3, micro_batch_size=8,
                strategy=JaxStrategy(compute_dtype="float32",
                                     remat="none")),
        train_data=loader, reshape_channel=chan)
    losses = {}

    def wrap():
        inner = tr._accel.train_step

        def step(st, batch, rng):
            st, m = inner(st, batch, rng)
            losses[int(st.step)] = float(m["loss"])
            return st, m

        tr._accel.train_step = step

    try:
        tr._adopt_accel(jax.devices()[:1], None)
        wrap()
        tr.train()
        chan.signal(JaxRequest(round=2, world={0: 1}, total=1,
                               device_count=1))
        assert tr._maybe_reshape() and chan.read_ack(2)["ok"]
        wrap()
        tr.args.max_steps = 6
        tr.train()
    finally:
        jax_mesh._global_mesh = saved
    return losses


def test_one_to_one_reshape_without_a_group_matches_jax(tmp_path, isolated,
                                                        monkeypatch):
    """No process group: a 1 -> 1 round leaves the state where it is (every
    leaf held) and steps 4-6 equal an uninterrupted run bit for bit and
    JAX's Trainer through the same round within 1e-5."""
    params_np = _jax_params()
    chan = ReshapeChannel(str(tmp_path / "chan"))
    tr = _port_trainer(tmp_path / "run", params_np, channel=chan)
    try:
        assert chan.worker_ready()
        tr.train()
        chan.signal(ReshapeRequest(round=2, world={0: 1}, total=1,
                                   prev_world={0: 1}))
        assert tr._maybe_reshape()
        ack = chan.read_ack(2)
        assert ack["ok"] and ack["step"] == 3 and ack["pulled"] == 0
        assert ack["moved"] == 3 * len(tr.state.params)
        # every leaf was held: the restore read no byte of the save
        assert tr._engine.last_restore_stats.get("bytes", 0) < 4096 * 2
        tr.args.max_steps = 6
        tr.train()
        got = tr.losses
    finally:
        tr.close()
    monkeypatch.setenv("ELASTIC_JOB_NAME", isolated + "ref")
    AsyncCheckpointSaver.reset()
    ref = _port_trainer(tmp_path / "ref", params_np, max_steps=6)
    try:
        ref.train()
    finally:
        ref.close()
        AsyncCheckpointSaver.reset()
        for name in (f"dlrtpu_torch_ckpt_{isolated}ref_0",
                     f"dlrtpu_torch_timer_{isolated}ref"):
            try:
                seg = PersistentSharedMemory(name=name)
                seg.close()
                seg.unlink()
            except FileNotFoundError:
                pass
    assert got == ref.losses and sorted(got) == list(range(1, 7))
    want = _jax_one_to_one(tmp_path, params_np)
    np.testing.assert_allclose([got[s] for s in range(1, 7)],
                               [want[s] for s in range(1, 7)], rtol=0,
                               atol=1e-5)


def test_the_agents_channel_is_installed_only_where_the_worker_can_reshape(
        tmp_path, isolated, monkeypatch):
    """The agent's channel (``NodeEnv.RESHAPE_DIR``) gets the ready marker
    from a worker that can reshape (AGD's too: every optimizer of the
    port steps on a DeviceMesh), and none from one that cannot (Flash
    Checkpoint off; an optimizer with no DeviceMesh step, torch's
    RMSprop), which the agent then restarts; a channel passed in to such
    a worker raises."""
    params_np = _jax_params()
    rmsprop = lambda params: torch.optim.RMSprop(  # noqa: E731
        [p for _, p in params], lr=LR)
    for name, args, ready, factory in (
            ("ok", {}, True, None),
            ("noflash", {"flash_checkpoint": False}, False, None),
            ("agd", {"optimizer": "agd"}, True, None),
            ("rmsprop", {}, False, rmsprop)):
        rdir = tmp_path / f"agent_{name}"
        monkeypatch.setenv(NodeEnv.RESHAPE_DIR, str(rdir))
        tr = _port_trainer(tmp_path / name, params_np, factory=factory,
                           **args)
        try:
            assert ReshapeChannel(str(rdir)).worker_ready() is ready, name
            assert (tr._reshape_channel is not None) is ready
        finally:
            tr.close()
    monkeypatch.delenv(NodeEnv.RESHAPE_DIR)
    with pytest.raises(NotImplementedError, match="flash_checkpoint is off"):
        _port_trainer(tmp_path / "raise", params_np,
                      channel=ReshapeChannel(str(tmp_path / "c")),
                      flash_checkpoint=False)
