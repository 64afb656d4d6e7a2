"""The port's in-process reshape over gloo processes on the CPU, held
against the JAX package's Trainer running the same schedules on
``jax.devices()[:n]``.

Eight processes are spawned once for the module; each is one slot of a
single host (``LOCAL_RANK`` = slot, its own shm segment) and takes part
in the scenarios that name it, one after another, each under a job name
of its own. A rank's node is its slot (one process a node), so a
request's ``world`` maps slots to 1. Scenarios, each the counterpart of
a case of ``tests/test_elastic_reshape.py``'s ``TestInProcessReshape``:

- ``flap``: 4 ranks train 6 steps; 4 joiners come in (8 ranks, no step
  there), leave again at the next boundary; the 4 train to 12. Its
  state must be bit-identical to ``control``'s, 12 steps with no flap.
- ``inout``: 4 ranks, 5 steps; 2 drain (they save at the boundary, ack,
  leave); 2 ranks to step 9; 2 join; the 4 run the epoch out. Every
  sample is served exactly once.
- ``remainder``: 4 ranks, 4 steps; 4 join; the 8 run the epoch out,
  each rank its round-robin share of the remainder.
- ``fail_reshard`` and ``fail_resume``: a chaos error at the ``reshard``
  and ``resume`` seams of a round that keeps the 4 ranks (the second
  with its ranks permuted, so the old group must be formed again): the
  ack is a failure, the old world stands, training goes on.
- ``dead_pull``, ``dead_rollback``, ``dead_nockpt``: ranks 2 and 3 die
  at a boundary; the survivors pull the lost slices from the checkpoint
  at the live step, roll back in process to an older one, or fail the
  ack without one.
- ``agree``: rank 0 reads a drain request at step 3; the others get
  theirs a second later (many steps at this size), yet every rank
  reshapes at step 3's boundary.
- ``control`` and ``flap`` again with FusedAdamW (bits 8) and with
  Adam8bit (JAX's rounding fields through its ``uniform`` hook), whose
  state is replicated (plain tensors of the global blocks): the flap
  must leave it, the params and the losses bit-identical to that
  optimizer's control; Adam8bit's losses are held against JAX's Trainer
  with ``optimizer="adam8bit"`` through the same flap within
  ``ATOL_8BIT`` (5e-5; see there).

The model is the tiny Llama preset (2 layers, f32, reference
attention) with weights made by the JAX package's ``llama_init`` and
crossed through ``models/convert.py``, AdamW at 1e-2, fsdp over every
rank (``MeshConfig(data=1, fsdp=-1)``), 96 rows of 17 tokens in a fixed
order, 8 rows a step. Tolerances: losses within 1e-5 of JAX's schedule
and of the uninterrupted run; the flap bit-identical; ``moved`` and
``pulled`` equal to JAX's report (the port counts array leaves, JAX
also its two scalars, step and Adam's count). The processes meet
through FileStores in the module's temp dir, and are killed after
``DEADLINE_S``, each rank's traceback in the failure message. The
module imports no jax at top level: the spawned processes import it.
"""

import dataclasses
import faulthandler
import os
import threading
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common import chaos
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
from dlrover_tpu_torch.ops.fused_optim import (
    flatten_meta,
    fused_adamw,
    tree_order,
)
from dlrover_tpu_torch.optimizers import Adam8bit
from dlrover_tpu_torch.parallel import MeshConfig, Strategy
from dlrover_tpu_torch.parallel.mesh import batch_place, reform_process_group
from dlrover_tpu_torch.trainer import Trainer, TrainingArgs
from dlrover_tpu_torch.trainer.elastic import (
    ElasticDataLoader,
    ElasticSampler,
)
from dlrover_tpu_torch.trainer.elastic.reshape import (
    ReshapeChannel,
    ReshapeRequest,
)
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    _tree_flatten_with_names,
)
from dlrover_tpu_torch.trainer.optim import optimizer_state_tree

SLOTS = 8
DEADLINE_S = 240
TINY = PRESETS["tiny"]
MESH = MeshConfig(data=1, fsdp=-1)
N_SAMPLES = 96
GLOBAL_BATCH = 8
LR = 1e-3
SCENARIOS = ("control", "flap", "inout", "remainder", "fail_reshard",
             "fail_resume", "dead_pull", "dead_rollback", "dead_nockpt",
             "agree", "inout_at_once", "control_fused8", "flap_fused8",
             "control_adam8bit", "flap_adam8bit")
# the 8-bit optimizers' scenarios; Adam8bit draws JAX's rounding fields
# (its ``uniform`` hook), FusedAdamW its own
EIGHT_BIT = {"fused8": lambda draws: fused_adamw(LR, bits=8),
             "adam8bit": lambda draws: lambda params: Adam8bit(
                 params, lr=LR,
                 uniform=lambda c, i, shape: draws[c, i])}


def _rows():
    rng = np.random.RandomState(3)
    return rng.randint(0, TINY.vocab_size, (N_SAMPLES, 17)).astype(np.int32)


def _jax_draws():
    """JAX's per-leaf 8-bit rounding fields of the tiny Llama (its seed
    ``count * 7919 + leaf``), for every step of an epoch."""
    import jax

    flat = params_from_jax(_jax_params())
    meta = flatten_meta([flat[k] for k in tree_order(flat)])
    return {(c, i): np.asarray(jax.random.uniform(
        jax.random.key(c * 7919 + i), (rows, 256)))
        for c in range(1, N_SAMPLES // GLOBAL_BATCH + 1)
        for i, rows in enumerate(meta.rows)}


def _jax_params():
    import jax

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_init as jax_init

    return jax.tree.map(np.asarray, jax_init(
        JaxConfig(**dataclasses.asdict(TINY)), jax.random.key(0)))


# ------------------------------------------------------------ the ranks


class _Dataset:
    """The rows, each fetch recorded."""

    def __init__(self, rows, record):
        self.rows, self.record = rows, record

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        self.record.append(int(idx))
        return self.rows[idx]


class _Recording(Trainer):
    """The port's Trainer with each step's loss kept by step, and an
    optional callback after each step."""

    def __init__(self, *args, after_step=None, **kw):
        self.losses, self.after_step = {}, after_step
        super().__init__(*args, **kw)
        self._wrap()

    def _adopt_accel(self, params):
        super()._adopt_accel(params)
        self._wrap()

    def _wrap(self):
        inner = self._accel.train_step

        def step(state, batch, rng):
            state, metrics = inner(state, batch, rng)
            self.losses[state.step] = metrics["loss"].item()
            if self.after_step is not None:
                self.after_step(state.step)
            return state, metrics

        self._accel.train_step = step


class _Rank:
    """One slot's view of a scenario: its dirs, channel and records."""

    def __init__(self, tmp, scn, slot, params_np, draws):
        self.tmp, self.scn, self.slot = tmp, scn, slot
        self.params_np = params_np
        kind = scn.rpartition("_")[2]
        self.optimizer = (EIGHT_BIT[kind](draws) if kind in EIGHT_BIT
                          else None)
        self.dir = os.path.join(tmp, scn)
        os.makedirs(self.dir, exist_ok=True)
        self.channel = ReshapeChannel(os.path.join(self.dir, f"chan{slot}"))
        self.record: list = []
        self.out: dict = {}

    def url(self, round_):
        return f"file://{os.path.join(self.dir, f'store{round_}')}"

    def trainer(self, hook=None, after_step=None, max_steps=0):
        index, count = batch_place(MESH)
        loader = ElasticDataLoader(
            _Dataset(_rows(), self.record),
            batch_size=GLOBAL_BATCH // count,
            sampler=ElasticSampler(N_SAMPLES, num_replicas=count, rank=index,
                                   shuffle=False),
            collate_fn=lambda rows: {"tokens": np.stack(rows)})
        tr = _Recording(
            llama_loss_fn(TINY),
            lambda s, d: params_from_jax(self.params_np, d),
            llama_logical_axes(TINY),
            TrainingArgs(output_dir=os.path.join(self.dir, "out"),
                         max_steps=max_steps, learning_rate=LR, log_steps=0,
                         save_storage_every=10 ** 6,
                         strategy=Strategy(mesh=MESH,
                                           compute_dtype="float32",
                                           remat="none")),
            train_data=loader, reshape_channel=self.channel,
            reshape_devices_fn=hook or _offset_place, device="cpu",
            after_step=after_step, optimizer=self.optimizer)
        tr.reshape_wait_s = 30.0
        return tr

    def request(self, round_, nodes, prev, departed=None, leaving=False):
        """This slot's request of a round whose world is ``nodes``."""
        nodes = sorted(nodes)
        return ReshapeRequest(
            round=round_, world={n: 1 for n in nodes},
            rank_offset=nodes.index(self.slot) if self.slot in nodes else 0,
            total=len(nodes), coordinator=self.url(round_),
            departed=dict(departed or {}),
            prev_world={n: 1 for n in prev}, leaving=leaving)

    def reshape(self, tr, req):
        """Signal this slot's own request and adopt it at this boundary."""
        self.channel.signal(req)
        adopted = tr._maybe_reshape()
        self.out.setdefault("acks", {})[req.round] = dict(
            self.channel.read_ack(req.round) or {}, adopted=adopted)
        return adopted

    def join(self, round_, nodes, max_steps=0, hook=None):
        """Start fresh as a rank of round ``round_``'s group."""
        nodes = sorted(nodes)
        reform_process_group(self.url(round_), nodes.index(self.slot),
                             len(nodes), "cpu")
        tr = self.trainer(hook=hook, max_steps=max_steps)
        tr._reshape_round = round_
        return tr

    def finish(self, tr):
        """Keep the losses, the records and this rank's final shards."""
        self.out["losses"] = dict(tr.losses)
        self.out["record"] = list(self.record)
        self.out["step"] = tr.global_step
        self.out["world"] = (dist.get_world_size() if dist.is_initialized()
                             else 1)
        self.out["shards"] = {
            name: (p.to_local() if isinstance(p, DTensor) else p)
            .detach().clone() for name, p in tr.state.params.items()}
        names, leaves, _ = _tree_flatten_with_names(optimizer_state_tree(
            tr.state.optimizer, tr.state.params))
        self.out["opt"] = {
            name: (v.to_local() if isinstance(v, DTensor) else v).clone()
            for name, v in zip(names, leaves)
            if isinstance(v, torch.Tensor)}
        tr.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def _offset_place(req):
    return req.rank_offset, req.total, req.coordinator


def _start(r: _Rank, nodes=range(4)):
    nodes = sorted(nodes)
    reform_process_group(r.url(1), nodes.index(r.slot), len(nodes), "cpu")


def _control(r):
    if r.slot >= 4:
        return
    _start(r)
    tr = r.trainer(max_steps=12)
    tr.train()
    r.finish(tr)


def _flap(r):
    four, eight = range(4), range(8)
    if r.slot < 4:
        _start(r)
        tr = r.trainer(max_steps=6)
        tr.train()
        r.reshape(tr, r.request(2, eight, four))
        r.out["mesh_size_8"] = dist.get_world_size()
        r.reshape(tr, r.request(3, four, eight,
                                {n: "drained" for n in range(4, 8)}))
        tr.args.max_steps = 12
        tr.train()
        r.finish(tr)
        return
    tr = r.join(2, eight)
    tr.maybe_resume()
    r.out["joined_at"] = tr.global_step
    r.reshape(tr, r.request(3, four, eight,
                            {n: "drained" for n in range(4, 8)},
                            leaving=True))
    r.out["departed"] = tr._departed
    r.out["record"] = list(r.record)
    tr.close()


def _inout(r):
    four, two = range(4), range(2)
    if r.slot >= 4:
        return
    _start(r)
    tr = r.trainer(max_steps=5)
    tr.train()
    drained = {2: "drained", 3: "drained"}
    if r.slot >= 2:
        r.reshape(tr, r.request(2, two, four, drained, leaving=True))
        r.out["record_before"] = list(r.record)
        tr.close()
        r.record.clear()
        tr = r.join(3, four)
        tr.train()
        r.finish(tr)
        return
    r.reshape(tr, r.request(2, two, four, drained))
    tr.args.max_steps = 9
    tr.train()
    r.out["world_after_drain"] = dist.get_world_size()
    r.reshape(tr, r.request(3, four, two))
    tr.args.max_steps = 0
    tr.train()
    r.finish(tr)


def _inout_at_once(r):
    """Drain 2 of 4 at step 5 and bring them back fresh at the same step,
    with no step on 2 between the rounds."""
    four, two = range(4), range(2)
    if r.slot >= 4:
        return
    _start(r)
    tr = r.trainer(max_steps=5)
    tr.train()
    drained = {2: "drained", 3: "drained"}
    if r.slot >= 2:
        r.reshape(tr, r.request(2, two, four, drained, leaving=True))
        tr.close()
        tr = r.join(3, four, max_steps=9)
        tr.train()
        r.finish(tr)
        return
    r.reshape(tr, r.request(2, two, four, drained))
    r.reshape(tr, r.request(3, four, two))
    tr.args.max_steps = 9
    tr.train()
    r.finish(tr)


def _remainder(r):
    four, eight = range(4), range(8)
    if r.slot < 4:
        _start(r)
        tr = r.trainer(max_steps=4)
        tr.train()
        r.out["record_before"] = list(r.record)
        r.record.clear()
        r.reshape(tr, r.request(2, eight, four))
        tr.args.max_steps = 0
        tr.train()
    else:
        tr = r.join(2, eight)
        tr.train()
    r.out["replicas"] = tr.train_data.sampler.num_replicas
    r.finish(tr)


def _fail(r, verb, hook=None):
    if r.slot >= 4:
        return
    _start(r)
    tr = r.trainer(max_steps=4, hook=hook)
    tr.train()
    chaos.install({"seed": 1, "rules": [{
        "site": "elastic.reshape", "action": "error", "verb": verb,
        "max": 1}]})
    try:
        r.out["adopted"] = r.reshape(tr, r.request(2, range(4), range(4)))
        r.out["after"] = dict(
            rank=dist.get_rank(), world=dist.get_world_size(),
            step=tr.global_step,
            sampler=(tr.train_data.sampler.num_replicas,
                     tr.train_data.sampler.rank),
            lost=tr._world_lost)
        # the failed round is consumed: no re-run at the next boundary
        r.out["again"] = tr._maybe_reshape()
    finally:
        chaos.uninstall()
    tr.args.max_steps = 8
    tr.train()
    r.finish(tr)


def _fail_resume(r):
    # the round numbers its ranks the other way round, so that the old
    # group (rank = slot) must be formed again after the failure
    _fail(r, "resume",
          hook=lambda req: (3 - r.slot, req.total, req.coordinator))


def _dead(r, mode):
    if r.slot >= 4:
        return
    _start(r)
    tr = r.trainer(max_steps=3)
    engine = tr._engine
    if mode == "nockpt":
        tr._engine = None
    tr.train()  # a checkpoint at step 3 (pull, rollback), none (nockpt)
    if mode == "rollback":
        # two steps past the checkpoint, leaving no newer save behind
        tr._engine = None
        tr.args.max_steps = 5
        tr.train()
    tr._engine = engine
    # the live params, gathered while every rank is there
    before = {k: v.full_tensor() for k, v in tr.state.params.items()}
    if r.slot >= 2:
        # dies at this boundary: it leaves its group and is gone
        dist.destroy_process_group()
        tr.close()
        return
    r.out["live_step"] = tr.global_step
    r.reshape(tr, r.request(2, range(2), range(4),
                            {2: "dead", 3: "dead"}))
    r.out["lost"] = tr._world_lost
    if mode == "nockpt":
        r.out["step"] = tr.global_step
        tr.close()
        dist.destroy_process_group()
        return
    r.out["completed"] = tr.train_data.sampler.completed_num
    r.out["world_after"] = dist.get_world_size()
    if mode == "pull":
        # the pulled and moved state equals the live one, gathered
        r.out["before"] = before
        r.out["after_full"] = {k: v.full_tensor()
                               for k, v in tr.state.params.items()}
    tr.args.max_steps = 6
    tr.train()
    r.finish(tr)


def _agree(r):
    if r.slot >= 4:
        return
    drained = {2: "drained", 3: "drained"}
    req = r.request(2, range(2), range(4), drained, leaving=r.slot >= 2)

    def after_step(step):
        if step != 3:
            return
        if r.slot == 0:
            r.channel.signal(req)
        else:
            timer = threading.Timer(1.0, r.channel.signal, (req,))
            timer.daemon = True
            timer.start()

    _start(r)
    tr = r.trainer(max_steps=8, after_step=after_step)
    tr.train()
    r.out["acks"] = {2: r.channel.read_ack(2)}
    r.out["departed"] = tr._departed
    if tr._departed:
        r.out["losses"] = dict(tr.losses)
        tr.close()
        return
    r.finish(tr)


RUNS = {"control_fused8": _control, "flap_fused8": _flap,
        "control_adam8bit": _control, "flap_adam8bit": _flap,
        "control": _control, "flap": _flap, "inout": _inout,
        "remainder": _remainder,
        "fail_reshard": lambda r: _fail(r, "reshard"),
        "fail_resume": _fail_resume,
        "dead_pull": lambda r: _dead(r, "pull"),
        "dead_rollback": lambda r: _dead(r, "rollback"),
        "dead_nockpt": lambda r: _dead(r, "nockpt"),
        "agree": _agree, "inout_at_once": _inout_at_once}


def _mark(tmp, slot, what):
    with open(os.path.join(tmp, f"slot{slot}.log"), "a") as f:
        f.write(f"{time.monotonic():.3f} {what}\n")


def _worker(slot, tmp, job):
    err = open(os.path.join(tmp, f"slot{slot}.err"), "w")
    faulthandler.dump_traceback_later(DEADLINE_S - 10, file=err)
    try:
        os.environ.update({
            "LOCAL_RANK": str(slot), "LOCAL_WORLD_SIZE": str(SLOTS),
            "NODE_RANK": "0", "DLROVER_PARAL_CONFIG_PATH": "",
        })
        torch.set_num_threads(1)
        params_np = torch.load(os.path.join(tmp, "params.pt"),
                               weights_only=False)
        draws = torch.load(os.path.join(tmp, "draws.pt"),
                           weights_only=False)
        got = {}
        for scn in SCENARIOS:
            os.environ["ELASTIC_JOB_NAME"] = f"{job}{scn}"
            os.environ[SOCKET_DIR_ENV] = os.path.join(tmp, scn, "socks")
            AsyncCheckpointSaver.reset()
            r = _Rank(tmp, scn, slot, params_np, draws)
            _mark(tmp, slot, f"{scn} start")
            RUNS[scn](r)
            _mark(tmp, slot, f"{scn} done")
            got[scn] = r.out
        torch.save(got, os.path.join(tmp, f"slot{slot}.pt"))
    except BaseException:
        err.write(traceback.format_exc())
        raise
    finally:
        AsyncCheckpointSaver.reset()
        faulthandler.cancel_dump_traceback_later()
        err.close()


def _failure(tmp, hung, codes):
    lines = [f"slots still running after {DEADLINE_S} s (killed): {hung}; "
             f"exit codes {codes}"]
    for s in range(SLOTS):
        for suffix in ("log", "err"):
            path = tmp / f"slot{s}.{suffix}"
            text = path.read_text() if path.exists() else "(none)"
            lines.append(f"--- slot {s} {suffix}:\n{text.strip()}")
    return "\n".join(lines)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 8 slots once; each slot's results by scenario."""
    return _spawn(tmp_path_factory.mktemp("reshape_gloo"))


def _spawn(tmp):
    job = f"rsh{os.getpid()}"
    # through a file: a large argument would hold each start() until its
    # process had imported this module
    torch.save(_jax_params(), tmp / "params.pt")
    torch.save(_jax_draws(), tmp / "draws.pt")
    mp = torch.multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_worker, args=(s, str(tmp), job))
             for s in range(SLOTS)]
    try:
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + DEADLINE_S
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        hung = [s for s, p in enumerate(procs) if p.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        codes = [p.exitcode for p in procs]
        assert not hung and codes == [0] * SLOTS, _failure(tmp, hung, codes)
        return [torch.load(tmp / f"slot{s}.pt", weights_only=False)
                for s in range(SLOTS)]
    finally:
        # the segments outlive their processes by design
        for scn in SCENARIOS:
            for name in [f"dlrtpu_torch_ckpt_{job}{scn}_{s}"
                         for s in range(SLOTS)] + [
                             f"dlrtpu_torch_timer_{job}{scn}"]:
                try:
                    seg = PersistentSharedMemory(name=name)
                    seg.close()
                    seg.unlink()
                except FileNotFoundError:
                    pass


# ------------------------------------------------------------- JAX side


def _jax_trainer(out_dir, params_np, *, flash=False, record=None,
                 max_steps=0, channel=None, optimizer="adamw"):
    """JAX's Trainer on the same model, data and optimizer, its mesh on
    the first 4 virtual devices; each step's loss kept by step."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_logical_axes as jax_axes
    from dlrover_tpu.models.llama import llama_loss_fn as jax_loss
    from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
    from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
    from dlrover_tpu.trainer.elastic.dataloader import (
        ElasticDataLoader as JaxLoader,
    )
    from dlrover_tpu.trainer.elastic.sampler import (
        ElasticSampler as JaxSampler,
    )
    from dlrover_tpu.trainer.trainer import Trainer as JaxTrainer
    from dlrover_tpu.trainer.trainer import TrainingArgs as JaxArgs

    class Rec(JaxTrainer):
        def _adopt_accel(self, devices, state):
            super()._adopt_accel(devices, state)
            inner = self._accel.train_step

            def step(st, batch, rng):
                st, m = inner(st, batch, rng)
                self.losses[int(st.step)] = float(m["loss"])
                return st, m

            self._accel.train_step = step

    jc = JaxConfig(**dataclasses.asdict(TINY))
    loader = JaxLoader(
        _Dataset(_rows(), record if record is not None else []),
        batch_size=GLOBAL_BATCH,
        sampler=JaxSampler(N_SAMPLES, num_replicas=1, rank=0,
                           shuffle=False),
        collate_fn=lambda rows: {"tokens": np.stack(rows)}, config_file="")
    tr = Rec(jax_loss(jc), lambda rng: jax.tree.map(jnp.asarray, params_np),
             jax_axes(jc),
             JaxArgs(output_dir=str(out_dir), micro_batch_size=GLOBAL_BATCH,
                     learning_rate=LR, log_steps=0, optimizer=optimizer,
                     flash_checkpoint=flash, save_steps=0,
                     save_storage_every=10 ** 6, num_epochs=1,
                     max_steps=max_steps,
                     strategy=JaxStrategy(mesh=JaxMesh(data=1, fsdp=-1),
                                          compute_dtype="float32",
                                          remat="none")),
             train_data=loader, reshape_channel=channel)
    tr.losses = {}
    tr._adopt_accel(jax.devices()[:4], None)
    return tr


def _jax_reshape(tr, channel, round_, devices, **kw):
    from dlrover_tpu.trainer.elastic.reshape import (
        ReshapeRequest as JaxRequest,
    )

    channel.signal(JaxRequest(round=round_, world={0: 1}, total=1,
                              device_count=devices, **kw))
    adopted = tr._maybe_reshape()
    return adopted, channel.read_ack(round_)


def _jax_scalars(tr) -> int:
    """The 0-d leaves of JAX's train state (step, Adam's count)."""
    import jax

    return sum(np.ndim(x) == 0 for x in jax.tree_util.tree_leaves(tr.state))


def _jax_flash_env(mp, tmp, job):
    from dlrover_tpu.agent.ckpt_saver import (
        AsyncCheckpointSaver as JaxSaver,
    )

    mp.setenv("DLROVER_TPU_SOCKET_DIR", str(tmp / "jax_socks"))
    mp.setenv("ELASTIC_JOB_NAME", job)
    JaxSaver.reset()


def _jax_unlink(job):
    from dlrover_tpu.agent.ckpt_saver import (
        AsyncCheckpointSaver as JaxSaver,
    )
    from dlrover_tpu.common.ipc import PersistentSharedMemory as JaxShm

    JaxSaver.reset()
    for name in (f"dlrtpu_ckpt_{job}_0", f"dlrtpu_timer_{job}"):
        try:
            seg = JaxShm(name=name)
            seg.close()
            seg.unlink()
        except FileNotFoundError:
            pass


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's Trainer through each scenario's schedule: its losses by
    step, its acks, records and reports."""
    from dlrover_tpu.common import chaos as jax_chaos
    from dlrover_tpu.parallel import mesh as jax_mesh
    from dlrover_tpu.trainer.elastic.reshape import (
        ReshapeChannel as JaxChannel,
    )

    tmp = tmp_path_factory.mktemp("reshape_jax")
    params_np = _jax_params()
    out = {}
    saved_mesh = jax_mesh._global_mesh

    def run(name, flash=False, **kw):
        return _jax_trainer(tmp / name, params_np, flash=flash, **kw)

    def chan(name):
        return JaxChannel(str(tmp / f"{name}_chan"))

    try:
        tr = run("control", max_steps=12)
        tr.train()
        out["control"] = {"losses": tr.losses}

        for name, optimizer in (("flap", "adamw"),
                                ("flap_adam8bit", "adam8bit")):
            c = chan(name)
            tr = run(name, max_steps=6, channel=c, optimizer=optimizer)
            tr.train()
            _jax_reshape(tr, c, 2, 8)
            _jax_reshape(tr, c, 3, 4, departed={1: "drained"})
            tr.args.max_steps = 12
            tr.train()
            out[name] = {"losses": tr.losses}

        c, record = chan("inout"), []
        tr = run("inout", max_steps=5, channel=c, record=record)
        tr.train()
        _jax_reshape(tr, c, 2, 2, departed={1: "drained"})
        tr.args.max_steps = 9
        tr.train()
        _jax_reshape(tr, c, 3, 4)
        tr.args.max_steps = 0
        tr.train()
        out["inout"] = {"losses": tr.losses, "record": record}

        c, record = chan("remainder"), []
        tr = run("remainder", max_steps=4, channel=c, record=record)
        tr.train()
        _jax_reshape(tr, c, 2, 4, rank_offset=0)
        tr.train_data.sampler.reshape(2, 0)
        out["remainder"] = {"replicas": tr.train_data.sampler.num_replicas}

        for verb in ("reshard", "resume"):
            c = chan(f"fail_{verb}")
            tr = run(f"fail_{verb}", max_steps=4, channel=c)
            tr.train()
            jax_chaos.install({"seed": 1, "rules": [{
                "site": "elastic.reshape", "action": "error", "verb": verb,
                "max": 1}]})
            try:
                adopted, ack = _jax_reshape(tr, c, 2, 2)
            finally:
                jax_chaos.uninstall()
            tr.args.max_steps = 8
            tr.train()
            out[f"fail_{verb}"] = {"losses": tr.losses, "ack": ack,
                                   "adopted": adopted}

        from dlrover_tpu.trainer.elastic.reshape import (
            ReshapeRequest as JaxRequest,
        )

        dead = JaxRequest(round=2, world={0: 1}, total=1, device_count=2,
                          departed={1: "dead"})
        for mode in ("pull", "rollback", "nockpt"):
            name = f"dead_{mode}"
            job = f"rshjax{os.getpid()}{mode}"
            with pytest.MonkeyPatch.context() as mp:
                _jax_flash_env(mp, tmp, job)
                c = chan(name)
                tr = run(name, flash=True, max_steps=3, channel=c)
                try:
                    engine = tr._engine
                    if mode == "nockpt":
                        tr._engine = None
                    tr.train()
                    if mode == "rollback":
                        tr._engine = None
                        tr.args.max_steps = 5
                        tr.train()
                    tr._engine = engine
                    c.signal(dead)
                    adopted = tr._maybe_reshape()
                    got = {"ack": c.read_ack(2), "adopted": adopted,
                           "scalars": _jax_scalars(tr),
                           "completed": tr.train_data.sampler.completed_num}
                    if adopted:
                        tr.args.max_steps = 6
                        tr.train()
                    got["losses"] = tr.losses
                    out[name] = got
                finally:
                    tr.close()
                    _jax_unlink(job)

        c = chan("agree")
        tr = run("agree", max_steps=3, channel=c)
        tr.train()
        _jax_reshape(tr, c, 2, 2, departed={1: "drained"})
        tr.args.max_steps = 8
        tr.train()
        out["agree"] = {"losses": tr.losses}
    finally:
        jax_mesh._global_mesh = saved_mesh
    return out


# ---------------------------------------------------------------- tests

ATOL = 1e-5
# the scenarios whose survivors train after the round(s)
TRAINED = ("flap", "inout", "remainder", "fail_reshard", "fail_resume",
           "dead_pull", "dead_rollback", "agree")


def _survivors(ranks, scn):
    return [(s, got[scn]) for s, got in enumerate(ranks)
            if got[scn].get("losses") and "shards" in got[scn]]


@pytest.mark.parametrize("scn", TRAINED)
def test_losses_match_jax_and_the_uninterrupted_run(ranks, jax_runs, scn):
    """Every rank that trains on after the schedule takes, step for
    step, the losses of JAX's Trainer through the same schedule and of
    the port's run with no membership change, within 1e-5. After the
    scale-out to 8 ranks (``remainder``) the global batch is the
    uninterrupted run's rows, so JAX's reference is its uninterrupted
    run: JAX's own scale-out hands half of each batch to another node."""
    control = ranks[0]["control"]["losses"]
    want_jax = jax_runs["control" if scn == "remainder" else scn]["losses"]
    survivors = _survivors(ranks, scn)
    assert survivors
    for slot, got in survivors:
        steps = sorted(got["losses"])
        assert steps[-1] == got["step"], (slot, steps)
        np.testing.assert_allclose(
            [got["losses"][s] for s in steps], [control[s] for s in steps],
            rtol=0, atol=ATOL, err_msg=f"{scn} slot {slot} vs uninterrupted")
        np.testing.assert_allclose(
            [got["losses"][s] for s in steps], [want_jax[s] for s in steps],
            rtol=0, atol=ATOL, err_msg=f"{scn} slot {slot} vs JAX")


def test_flap_is_bit_identical_to_no_flap(ranks):
    """4 -> 8 -> 4 with no step on 8: the joiners restore step 6 and leave
    at the next boundary, where step 6, persisted by the join, is not
    saved again; the 4 ranks' state after step 12 equals, bit for bit, a
    run that never saw a membership change."""
    for slot in range(4):
        flap, control = ranks[slot]["flap"], ranks[slot]["control"]
        assert flap["mesh_size_8"] == 8
        for round_ in (2, 3):
            ack = flap["acks"][round_]
            assert ack["ok"] and ack["adopted"] and ack["step"] == 6, ack
            assert ack["moved"] > 0 and ack["pulled"] == 0, ack
        assert flap["losses"] == control["losses"]
        for name, shard in control["shards"].items():
            assert torch.equal(flap["shards"][name], shard), (slot, name)
    for slot in range(4, 8):
        flap = ranks[slot]["flap"]
        assert flap["joined_at"] == 6 and flap["departed"]
        assert flap["acks"][3]["ok"] and flap["acks"][3]["departed"]
        assert flap["record"] == []


def test_scale_in_and_out_serves_every_sample_exactly_once(ranks,
                                                           jax_runs):
    """Drain 2 of 4 at step 5, 4 steps on 2, 2 join at step 9, the epoch
    out on 4: across the three worlds every row is fetched once, as JAX's
    one process fetches them."""
    served = []
    for slot in range(4):
        got = ranks[slot]["inout"]
        served += got.get("record_before", []) + got["record"]
        assert got["step"] == 12 and got["world"] == 4
    for slot in (0, 1):
        got = ranks[slot]["inout"]
        assert got["world_after_drain"] == 2
        assert [got["acks"][r]["step"] for r in (2, 3)] == [5, 9]
    for slot in (2, 3):
        assert ranks[slot]["inout"]["acks"][2]["departed"]
    assert sorted(served) == list(range(N_SAMPLES)) == sorted(
        jax_runs["inout"]["record"])


def test_world_change_reaccounts_the_epoch_remainder(ranks, jax_runs):
    """Scale-out at step 4 to 8 replicas: each rank serves exactly its
    round-robin share of the remainder (JAX's process, one of 2 nodes,
    its half: the same rule over its replicas)."""
    tail = list(range(32, N_SAMPLES))
    for slot in range(8):
        got = ranks[slot]["remainder"]
        assert got["replicas"] == 8
        assert got["record"] == tail[slot::8], slot
    before = sorted(x for s in range(4)
                    for x in ranks[s]["remainder"]["record_before"])
    assert before == list(range(32))
    assert jax_runs["remainder"]["replicas"] == 2


@pytest.mark.parametrize("scn", ["fail_reshard", "fail_resume"])
def test_failed_reshape_acks_failure_and_the_old_world_stands(
        ranks, jax_runs, scn):
    """A chaos error at the seam acks failure, as in JAX; the world is
    the one before the round (after ``resume``, where the group had been
    re-formed with the ranks reversed, the old group is formed again):
    each slot's old rank of 4, step 4, its sampler place; the round is
    consumed, and training goes on to step 8."""
    want = jax_runs[scn]["ack"]
    assert not want["ok"] and not jax_runs[scn]["adopted"]
    for slot in range(4):
        got = ranks[slot][scn]
        ack = got["acks"][2]
        assert not got["adopted"] and not ack["ok"]
        assert "ChaosError" in ack["error"] and ack["step"] == want["step"]
        assert got["after"] == {"rank": slot, "world": 4, "step": 4,
                                "sampler": (4, slot), "lost": False}
        assert got["again"] is False and got["step"] == 8


def test_dead_rank_pulls_only_the_lost_slices(ranks, jax_runs):
    """Ranks 2 and 3 die at step 3, where a checkpoint is: the survivors'
    state on 2 ranks equals the live one bit for bit; ``pulled`` and
    ``moved`` are JAX's (the port counts no scalar)."""
    want = jax_runs["dead_pull"]["ack"]
    for slot in (0, 1):
        got = ranks[slot]["dead_pull"]
        ack = got["acks"][2]
        assert ack["ok"] and ack["step"] == got["live_step"] == 3
        assert ack["pulled"] == want["pulled"] > 0
        assert ack["moved"] == want["moved"] - jax_runs["dead_pull"][
            "scalars"]
        assert got["world_after"] == 2 and got["completed"] == 24
        for name, full in got["before"].items():
            assert torch.equal(got["after_full"][name], full), name


def test_dead_rank_with_an_older_checkpoint_rolls_back(ranks, jax_runs):
    """Live at step 5, checkpoint at 3: the whole state and the loader
    roll back to step 3 in process on 2 ranks, as JAX's do."""
    want = jax_runs["dead_rollback"]
    for slot in (0, 1):
        got = ranks[slot]["dead_rollback"]
        ack = got["acks"][2]
        assert got["live_step"] == 5
        assert ack["ok"] and ack["rolled_back_to"] == 3 == want["ack"][
            "rolled_back_to"]
        assert ack["step"] == want["ack"]["step"] == 3
        assert ack["pulled"] == want["ack"]["pulled"] - want["scalars"]
        assert got["completed"] == want["completed"] == 24
        assert got["world_after"] == 2 and got["step"] == 6


def test_dead_rank_without_a_checkpoint_fails_the_ack(ranks, jax_runs):
    """No checkpoint when ranks die: the ack is a failure, as JAX's; the
    old group is gone, so the worker must be restarted."""
    assert not jax_runs["dead_nockpt"]["ack"]["ok"]
    for slot in (0, 1):
        got = ranks[slot]["dead_nockpt"]
        ack = got["acks"][2]
        assert not ack["ok"] and not ack["adopted"]
        assert "no checkpoint" in ack["error"]
        assert got["lost"] and got["step"] == 3


def test_ranks_agree_on_one_boundary(ranks):
    """Rank 0 reads the drain request at step 3, the others a second
    later: the boundary agreement holds the world at step 3 until every
    rank has its request; all four reshape there, 2 and 3 leave."""
    for slot in range(4):
        got = ranks[slot]["agree"]
        ack = got["acks"][2]
        assert ack["ok"] and ack["step"] == 3, (slot, ack)
        assert got["departed"] == (slot >= 2)
        assert max(got["losses"]) == (3 if slot >= 2 else 8)


def test_a_drain_and_a_join_at_one_boundary(ranks):
    """Drain 2 of 4 at step 5, then at once a round that brings 2 fresh
    ranks back, no step between: the join finds step 5 persisted by the
    drain at 4 ranks' layout, saves it at no other layout, and the fresh
    ranks restore it; all 4 train on to step 9 with the losses of the run
    that never changed its world, bit for bit."""
    control = ranks[0]["control"]["losses"]
    for slot in range(4):
        got = ranks[slot]["inout_at_once"]
        assert got["step"] == 9 and got["world"] == 4
        rounds = (2, 3) if slot < 2 else (2,)
        for round_ in rounds:
            ack = got["acks"][round_]
            assert ack["ok"] and ack["step"] == 5, (slot, round_, ack)
        assert sorted(got["losses"]) == list(
            range(1 if slot < 2 else 6, 10)), slot
        assert all(got["losses"][s] == control[s] for s in got["losses"]), \
            (slot, got["losses"], control)


@pytest.mark.parametrize("kind", list(EIGHT_BIT))
def test_8bit_state_flaps_bit_identically(ranks, kind):
    """FusedAdamW (bits 8) and Adam8bit through the flap, 4 -> 8 -> 4 with
    no step on 8: their replicated state (plain tensors of the global
    blocks, copied by the mover) and the params after step 12 equal, bit
    for bit, each optimizer's run with no membership change, and so do
    the losses."""
    for slot in range(4):
        flap = ranks[slot][f"flap_{kind}"]
        control = ranks[slot][f"control_{kind}"]
        assert flap["mesh_size_8"] == 8
        for round_ in (2, 3):
            ack = flap["acks"][round_]
            assert ack["ok"] and ack["adopted"] and ack["step"] == 6, ack
            assert ack["moved"] > 0 and ack["pulled"] == 0, ack
        assert flap["losses"] == control["losses"]
        assert sorted(flap["losses"]) == list(range(1, 13))
        for name, shard in control["shards"].items():
            assert torch.equal(flap["shards"][name], shard), (slot, name)
        assert flap["opt"].keys() == control["opt"].keys()
        assert any("mu_q" in name for name in control["opt"])
        for name, leaf in control["opt"].items():
            assert torch.equal(flap["opt"][name], leaf), (slot, name)
    for slot in range(4, 8):
        flap = ranks[slot][f"flap_{kind}"]
        assert flap["joined_at"] == 6 and flap["departed"]


# Adam8bit against JAX's: its nu codes are the nearest in log space, and
# the two libraries' log/exp can differ by an ulp across a rounding edge
# (tests/test_torch_optim.py); a flipped code moves that entry's update by
# about 5%, so over 12 steps the losses drift apart further than f32
# AdamW's (1.05e-5 at step 8 here)
ATOL_8BIT = 5e-5


def test_adam8bit_flap_matches_jax(ranks, jax_runs):
    """Adam8bit with JAX's rounding fields through the flap takes JAX's
    Trainer's losses with ``optimizer="adam8bit"`` through the same
    schedule, step for step, within ``ATOL_8BIT``."""
    want = jax_runs["flap_adam8bit"]["losses"]
    for slot in range(4):
        got = ranks[slot]["flap_adam8bit"]["losses"]
        steps = sorted(got)
        np.testing.assert_allclose(
            [got[s] for s in steps], [want[s] for s in steps], rtol=0,
            atol=ATOL_8BIT, err_msg=f"slot {slot} vs JAX")
