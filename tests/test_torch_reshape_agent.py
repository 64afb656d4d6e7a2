"""The agent's side of the port's in-process reshape, and the scale-flap
schedule over real gloo processes.

- ``TestAgentReshapeSignaling``: the counterpart of
  ``tests/test_elastic_reshape.py``'s class of that name, on the port's
  agent with fake workers: a reshape is signalled only to workers that
  advertised a watcher, on a "reshape" verdict, and every other outcome
  (no watcher, a "restart" verdict, a node left out of the round, a
  failed or missing ack, a fault at the signal seam) restarts them.
- ``TestDrainedNodeOrder``: a drained host's workers are alive at the
  drain point, so the agent reports the drain, waits for the round
  formed without its host, signals its workers a request that marks
  them leaving, waits for their acks, and only then flushes shm to
  storage and stops them; a worker late to ack is stopped unsaved, and
  its peers' failed boundary agreement turns its departure dead.
- ``test_scale_flap_schedule``: the port's copy of the JAX harness
  ``tools/chaos_run.py`` ``_run_scale_flap``, with processes for cards.
  Two ranks train; one drains and leaves, a fresh one joins, both
  adopted in process with no restart of the rank that stays; the third
  round (the same drain) meets the armed ``scale-flap`` kill at the
  survivor's ``reshard`` seam, and a fresh process resumes from the
  boundary save and runs the epoch out. Every row is fetched exactly
  once across the incarnations, the kill leaves a flight dump, and the
  final state equals, bit for bit, a control run that replays the same
  world schedule with no agent, kill or restart.

The module imports no jax: the spawned processes import it.
"""

import json
import os
import threading
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.agent.training_agent import (
    ElasticLaunchConfig,
    ElasticTrainingAgent,
)
from dlrover_tpu_torch.common import chaos, flight
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.ipc import (
    SOCKET_DIR_ENV,
    PersistentSharedMemory,
)
from dlrover_tpu_torch.common.messages import CommWorld
from dlrover_tpu_torch.models import (
    PRESETS,
    llama_init,
    llama_logical_axes,
    llama_loss_fn,
)
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

# ----------------------------------------------------- agent signalling


class _FakeWorker:
    def __init__(self, local_rank=0, returncode=None):
        self.local_rank = local_rank
        self.returncode = returncode


def _bare_agent(tmp_path, workers, channels, client=None, **cfg):
    agent = object.__new__(ElasticTrainingAgent)
    agent._config = ElasticLaunchConfig(
        min_nodes=1, max_nodes=2, nproc_per_node=len(workers),
        log_dir=str(tmp_path), **cfg,
    )
    agent._workers = workers
    agent._reshape_channels = channels
    agent._client = client
    agent._last_round = 1
    agent._last_world = {0: len(workers), 1: len(workers)}
    agent._restarted = 0
    agent._restart_workers = lambda: setattr(
        agent, "_restarted", agent._restarted + 1
    )
    return agent


def _acker(channels, check=None, timeout=5.0):
    """A thread acking each channel's first request (after ``check``)."""

    def run():
        deadline = time.time() + timeout
        pending = dict(channels)
        while pending and time.time() < deadline:
            for lr, chan in list(pending.items()):
                req = chan.poll(-1)
                if req is not None:
                    if check is not None:
                        check(req)
                    chan.ack(req.round, True, dur=0.01)
                    del pending[lr]
            time.sleep(0.02)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


class _Client:
    def __init__(self, world):
        self.world = world

    def get_comm_world(self, name, rank):
        assert name == RendezvousName.ELASTIC_TRAINING
        return self.world


def _ready_chan(path):
    chan = ReshapeChannel(str(path))
    chan.mark_ready()
    return chan


class TestAgentReshapeSignaling:
    def test_signal_reshape_waits_for_all_acks(self, tmp_path):
        workers = [_FakeWorker(0), _FakeWorker(1)]
        channels = {w.local_rank: ReshapeChannel(
            str(tmp_path / f"c{w.local_rank}")) for w in workers}
        agent = _bare_agent(tmp_path, workers, channels, node_rank=1,
                            reshape_ack_timeout=5.0)
        world = CommWorld(round=4, world={0: 2, 1: 2},
                          coordinator_addr="h:1", departed={2: "dead"})
        seen = []

        def check(req):
            # node_rank 1 sits after node 0's two workers
            assert (req.rank_offset, req.total) == (2, 4)
            assert req.departed == {2: "dead"} and not req.leaving
            # the old world places the departed node's ranks
            assert req.prev_world == {0: 2, 1: 2}
            seen.append(req.round)

        t = _acker(channels, check)
        assert agent._signal_reshape(world) is True
        t.join(timeout=5)
        assert seen == [4, 4]

    def test_signal_reshape_fails_without_acks(self, tmp_path):
        agent = _bare_agent(tmp_path, [_FakeWorker(0)],
                            {0: ReshapeChannel(str(tmp_path / "c0"))},
                            node_rank=0, reshape_ack_timeout=0.3)
        world = CommWorld(round=4, world={0: 1}, coordinator_addr="h")
        assert agent._signal_reshape(world) is False

    def test_signal_failure_degrades_to_restart(self, tmp_path):
        """A fault at the elastic.signal seam falls back to the restart
        path, never crashes the agent's monitor loop."""
        world = CommWorld(round=5, world={0: 1}, coordinator_addr="h:1",
                          verdicts={0: "reshape"})
        agent = _bare_agent(
            tmp_path, [_FakeWorker(0)], {0: _ready_chan(tmp_path / "c0")},
            client=_Client(world), node_rank=0, rdzv_timeout=5,
            reshape_ack_timeout=1.0)
        chaos.install({"seed": 1, "rules": [
            {"site": "elastic.signal", "action": "error"}]})
        try:
            agent._handle_membership_change()
        finally:
            chaos.uninstall()
        assert agent._restarted == 1

    def test_membership_change_restarts_when_no_watcher(self, tmp_path):
        agent = _bare_agent(tmp_path, [_FakeWorker(0)],
                            {0: ReshapeChannel(str(tmp_path / "c0"))},
                            node_rank=0)
        # no ready marker -> not reshape-ready -> classic restart
        assert not agent._workers_reshape_ready()
        agent._handle_membership_change()
        assert agent._restarted == 1

    def test_membership_change_reshapes_on_verdict(self, tmp_path):
        chan = _ready_chan(tmp_path / "c0")
        world = CommWorld(round=5, world={0: 1}, coordinator_addr="h:1",
                          verdicts={0: "reshape"})
        agent = _bare_agent(tmp_path, [_FakeWorker(0)], {0: chan},
                            client=_Client(world), node_rank=0,
                            reshape_ack_timeout=5.0, rdzv_timeout=5)
        t = _acker({0: chan})
        agent._handle_membership_change()
        t.join(timeout=5)
        assert agent._restarted == 0
        assert agent._last_round == 5 and agent._last_world == {0: 1}

    @pytest.mark.parametrize("verdicts,world", [
        ({0: "restart"}, {0: 1}),   # the master says restart
        ({1: "reshape"}, {1: 1}),   # this node is not in the round
    ], ids=["restart-verdict", "excluded-node"])
    def test_membership_change_falls_back_to_restart(self, tmp_path,
                                                     verdicts, world):
        comm = CommWorld(round=5, world=world, coordinator_addr="h:1",
                         verdicts=verdicts)
        agent = _bare_agent(tmp_path, [_FakeWorker(0)],
                            {0: _ready_chan(tmp_path / "c0")},
                            client=_Client(comm), node_rank=0,
                            rdzv_timeout=1)
        agent._handle_membership_change()
        assert agent._restarted == 1


# ------------------------------------------------- the drained node

class _DrainClient:
    """Records the agent's calls; the round without node 1 forms after
    two polls."""

    def __init__(self, log):
        self.log, self.polls = log, 0

    def drain_node(self, rank):
        self.log.append(("drain", rank))
        return True

    def get_comm_world(self, name, rank):
        self.polls += 1
        if self.polls < 3:
            return CommWorld(round=1, world={0: 1, 1: 1})
        return CommWorld(round=2, world={0: 1}, coordinator_addr="h:2",
                         departed={1: "drained"})


def _drained_agent(tmp_path, log, chan):
    agent = _bare_agent(tmp_path, [_FakeWorker(0)], {0: chan},
                        client=_DrainClient(log), node_rank=1)
    agent._draining = False
    agent._save_ckpt_at_breakpoint = lambda: log.append(("persist",))
    agent._stop_workers = lambda timeout=30.0: log.append(("stop",))
    return agent


class TestDrainedNodeOrder:
    def test_departing_workers_ack_before_they_are_stopped(self, tmp_path):
        log = []
        chan = _ready_chan(tmp_path / "c0")
        agent = _drained_agent(tmp_path, log, chan)

        def check(req):
            assert req.leaving and req.round == 2
            assert req.world == {0: 1} and req.prev_world == {0: 1, 1: 1}
            assert req.departed == {1: "drained"}
            log.append(("ack", req.round))

        t = _acker({0: chan}, check)
        agent._execute_predrain(time.time() + 30.0, "plan-1")
        t.join(timeout=5)
        assert log == [("drain", 1), ("ack", 2), ("persist",), ("stop",)]
        assert agent._last_round == 2

    def test_a_late_ack_stops_the_worker_unsaved(self, tmp_path):
        """No ack within the plan's deadline less the persist's budget:
        the agent still persists and stops in time; the worker never
        saved at the boundary."""
        log = []
        agent = _drained_agent(tmp_path, log, _ready_chan(tmp_path / "c0"))
        agent.PERSIST_BUDGET_S = 0.5
        t0 = time.time()
        agent._execute_predrain(time.time() + 2.0, "plan-2")
        assert log == [("drain", 1), ("persist",), ("stop",)]
        assert time.time() - t0 < 5.0 and agent._last_round == 1

    def test_a_failed_boundary_agreement_turns_departures_dead(
            self, tmp_path, monkeypatch):
        """A peer gone from the old group before the boundary save (its
        agent stopped it unsaved): the survivor's agreement fails, and the
        drained departure its request names is taken as a dead one."""
        chan = ReshapeChannel(str(tmp_path / "w"))
        chan.signal(ReshapeRequest(round=2, world={0: 1},
                                   prev_world={0: 1, 1: 1},
                                   departed={1: "drained"}))
        tr = object.__new__(Trainer)
        tr._reshape_channel, tr._reshape_round = chan, -1
        tr._side_group, tr.reshape_wait_s = None, 1.0

        def broken(*a, **kw):
            raise RuntimeError("Connection closed by peer")

        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
        monkeypatch.setattr(dist, "get_rank", lambda *a: 0)
        monkeypatch.setattr(dist, "all_reduce", broken)
        req = tr._agreed_request()
        assert req.round == 2 and req.departed == {1: "dead"}
        assert tr._departed_ranks(req, "dead") == {1}


# ------------------------------------------------ the scale-flap schedule

TINY = PRESETS["tiny"]
BATCH = 8
STEPS = 12
N_ROWS = STEPS * BATCH
FLAP_DEADLINE_S = 150


class _Paced:
    """Rows fetched slowly enough for the harness to interleave rounds
    with steps; each fetch logged for the exactly-once check."""

    def __init__(self, log_path):
        rng = np.random.RandomState(7)
        self.rows = rng.randint(0, TINY.vocab_size,
                                (N_ROWS, 17)).astype(np.int32)
        self.log = open(log_path, "a")

    def __len__(self):
        return N_ROWS

    def __getitem__(self, idx):
        self.log.write(f"{idx}\n")
        self.log.flush()
        time.sleep(0.01)
        return self.rows[idx]


def _flap_trainer(tmp, name, chan_dir, save_steps, out="out"):
    index, count = batch_place(MeshConfig(data=1, fsdp=-1))
    loader = ElasticDataLoader(
        _Paced(os.path.join(tmp, f"consumed.{name}")),
        batch_size=BATCH // count,
        sampler=ElasticSampler(N_ROWS, num_replicas=count, rank=index,
                               shuffle=False),
        collate_fn=lambda rows: {"tokens": np.stack(rows)})

    class Progress(Trainer):
        def _adopt_accel(self, params):
            super()._adopt_accel(params)
            self._wrap()

        def _wrap(self):
            inner = self._accel.train_step

            def step(state, batch, rng):
                state, metrics = inner(state, batch, rng)
                with open(os.path.join(tmp, f"progress.{name}"), "w") as f:
                    f.write(str(state.step))
                return state, metrics

            self._accel.train_step = step

    tr = Progress(
        llama_loss_fn(TINY), lambda s, d: llama_init(TINY, s, d),
        llama_logical_axes(TINY),
        TrainingArgs(output_dir=os.path.join(tmp, out), log_steps=0,
                     learning_rate=1e-3, save_steps=save_steps,
                     save_storage_every=10 ** 6,
                     strategy=Strategy(mesh=MeshConfig(data=1, fsdp=-1),
                                       compute_dtype="float32",
                                       remat="none")),
        train_data=loader, reshape_channel=ReshapeChannel(chan_dir),
        reshape_devices_fn=lambda r: (r.rank_offset, r.total, r.coordinator),
        device="cpu")
    tr._wrap()
    tr.reshape_wait_s = 60.0
    return tr


def _flap_request(tmp, round_, slot, *, leaving=False, arm="elastic"):
    """Rounds 2 and 4 drain node 1 to a world of one (no group), round 3
    brings a fresh node 1 back (a group of two)."""
    if round_ == 3:
        return ReshapeRequest(
            round=3, world={0: 1, 1: 1}, prev_world={0: 1}, total=2,
            rank_offset=slot,
            coordinator=f"file://{os.path.join(tmp, f'{arm}.store3')}")
    return ReshapeRequest(round=round_, world={0: 1}, total=1,
                          prev_world={0: 1, 1: 1}, departed={1: "drained"},
                          leaving=leaving)


def _flap_proc(tmp, job, name, slot, join, schedule):
    """One incarnation: ``join``: the store URL, rank and size it starts
    in (None: no group); ``schedule``: None for an elastic worker (the
    harness signals its rounds), else the control's boundaries."""
    err = open(os.path.join(tmp, f"{name}.err"), "w")
    try:
        # started early (a process takes seconds to import), it begins
        # when the harness lets it: a fresh incarnation all the same
        go = os.path.join(tmp, f"go.{name}")
        deadline = time.monotonic() + FLAP_DEADLINE_S
        while not os.path.exists(go) and time.monotonic() < deadline:
            time.sleep(0.01)
        os.environ.update({
            "LOCAL_RANK": str(slot), "LOCAL_WORLD_SIZE": "2",
            "NODE_RANK": "0", "DLROVER_PARAL_CONFIG_PATH": "",
            "ELASTIC_JOB_NAME": job,
            SOCKET_DIR_ENV: os.path.join(tmp, f"socks{slot}"),
            "DLROVER_TELEMETRY_DIR": os.path.join(tmp, "telemetry"),
        })
        torch.set_num_threads(1)
        if name == "A0":
            chaos.install(chaos.NAMED_SCHEDULES["scale-flap"])
        if join is not None:
            reform_process_group(*join, "cpu")
        chan = os.path.join(tmp, f"chan.{name}")
        # each arm persists into its own storage: a control that found the
        # elastic arm's final checkpoint would resume from it instead of
        # training, and under load its ranks raced over rewriting it
        tr = _flap_trainer(tmp, name, chan, save_steps=1,
                           out="out" if schedule is None else "out.control")
        if join is not None and join[0].endswith("store3"):
            tr._reshape_round = 3
        if schedule is None:
            tr.train()
        else:
            for round_, boundary, leaving in schedule:
                tr.args.max_steps = boundary
                tr.train()
                if round_ is None:
                    break
                tr._reshape_channel.signal(_flap_request(
                    tmp, round_, slot, leaving=leaving, arm="control"))
                assert tr._maybe_reshape()
                if tr._departed:
                    break
        if not tr._departed:
            params = {k: (v.full_tensor() if hasattr(v, "full_tensor")
                          else v).detach() for k, v in
                      tr.state.params.items()}
            torch.save({"params": params, "step": tr.global_step},
                       os.path.join(tmp, f"final.{name}.pt"))
        tr.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:
        err.write(traceback.format_exc())
        raise
    finally:
        AsyncCheckpointSaver.reset()
        err.close()


def _progress(tmp, name) -> int:
    try:
        with open(os.path.join(tmp, f"progress.{name}")) as f:
            return int(f.read() or 0)
    except (FileNotFoundError, ValueError):
        return 0


def _consumed(tmp, name) -> list:
    try:
        with open(os.path.join(tmp, f"consumed.{name}")) as f:
            return [int(x) for x in f if x.strip()]
    except FileNotFoundError:
        return []


def _run_scale_flap(tmp: str, job: str) -> dict:
    """The harness: spawns the elastic arm's incarnations and signals
    their rounds as an agent would, then the control arm. Returns what
    it observed; raises AssertionError naming the first broken claim."""
    mp = torch.multiprocessing.get_context("spawn")
    procs = {}
    cstore = f"file://{os.path.join(tmp, 'control.store')}"
    estore = f"file://{os.path.join(tmp, 'elastic.store')}"
    # name: (slot, the group it starts in, the control's schedule)
    plan = {"A0": (0, (estore + "1", 0, 2)), "B0": (1, (estore + "1", 1, 2)),
            "B1": (1, (estore + "3", 1, 2)), "A1": (0, None),
            "C0": (0, (cstore + "1", 0, 2)), "C1": (1, (cstore + "1", 1, 2)),
            "C2": (1, (cstore + "3", 1, 2))}

    def prestart(name, schedule=None):
        slot, join = plan[name]
        arm_job = job + ("c" if name.startswith("C") else "")
        p = mp.Process(target=_flap_proc,
                       args=(tmp, arm_job, name, slot, join, schedule))
        p.start()
        procs[name] = p

    def spawn(name):
        with open(os.path.join(tmp, f"go.{name}"), "w"):
            pass
        return procs[name]

    def wait_for(name, step):
        deadline = time.monotonic() + 60
        while _progress(tmp, name) < step:
            assert procs[name].is_alive(), f"{name} died at "\
                f"{_progress(tmp, name)} waiting for step {step}"
            assert time.monotonic() < deadline, f"{name} stuck"
            time.sleep(0.02)

    def chan(name):
        return ReshapeChannel(os.path.join(tmp, f"chan.{name}"))

    def signal(round_, names_slots):
        for name, slot, leaving in names_slots:
            chan(name).signal(_flap_request(tmp, round_, slot,
                                            leaving=leaving))

    def ack(name, round_):
        return chan(name).await_ack(round_, timeout=60.0,
                                    alive_fn=procs[name].is_alive)

    try:
        for name in ("A0", "B0", "B1", "A1"):
            prestart(name)
        a0 = spawn("A0")
        spawn("B0")
        seen = {"a0_pid": a0.pid}
        # --- the flap: node 1 drains, then a fresh node 1 joins
        wait_for("A0", 3)
        signal(2, [("A0", 0, False), ("B0", 1, True)])
        seen["ack2"], seen["ack2_leaver"] = ack("A0", 2), ack("B0", 2)
        assert seen["ack2"] and seen["ack2"]["ok"], seen["ack2"]
        assert seen["ack2_leaver"]["ok"] and seen["ack2_leaver"]["departed"]
        # the survivor takes the round at its next boundary and waits there
        # for the joiner's process
        signal(3, [("A0", 0, False)])
        spawn("B1")
        procs["B0"].join(30)
        assert procs["B0"].exitcode == 0
        seen["ack3"] = ack("A0", 3)
        assert seen["ack3"] and seen["ack3"]["ok"], seen["ack3"]
        assert a0.is_alive() and a0.pid == seen["a0_pid"], "A0 restarted"
        # --- the third round meets the armed kill at A0's reshard seam
        wait_for("A0", int(seen["ack3"]["step"]) + 2)
        signal(4, [("A0", 0, False), ("B1", 1, True)])
        seen["ack4_leaver"] = ack("B1", 4)
        seen["ack4"] = ack("A0", 4)
        a0.join(30)
        seen["a0_exit"] = a0.exitcode
        procs["B1"].join(30)
        assert seen["ack4"] is None and a0.exitcode not in (0, None)
        assert seen["ack4_leaver"] and seen["ack4_leaver"]["ok"]
        # --- the restart path: a fresh incarnation on the round-4 world
        s2, s3 = int(seen["ack2"]["step"]), int(seen["ack3"]["step"])
        s4 = int(seen["ack4_leaver"]["step"])
        seen["boundaries"] = (s2, s3, s4)
        # the control, replaying the observed boundaries in process, starts
        # its processes meanwhile
        prestart("C0", [(2, s2, False), (3, s3, False), (4, s4, False),
                        (None, 0, False)])
        prestart("C1", [(2, s2, True)])
        prestart("C2", [(4, s4, True)])
        spawn("A1")
        procs["A1"].join(90)
        assert procs["A1"].exitcode == 0, "the restarted worker failed"
        spawn("C0")
        spawn("C1")
        procs["C1"].join(60)
        spawn("C2")
        for name in ("C0", "C2"):
            procs[name].join(90)
        for name, p in procs.items():
            assert name == "A0" or p.exitcode == 0, (name, p.exitcode)
        seen["consumed"] = {n: _consumed(tmp, n) for n in ("A0", "B0", "B1",
                                                           "A1")}
        seen["final"] = torch.load(os.path.join(tmp, "final.A1.pt"))
        seen["control"] = torch.load(os.path.join(tmp, "final.C0.pt"))
        seen["dumps"] = [p for p in flight.list_dumps(
            os.path.join(tmp, "telemetry")) if "chaos-kill" in p]
        return seen
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join()


@pytest.mark.chaos
def test_scale_flap_schedule(tmp_path):
    tmp, job = str(tmp_path), f"flap{os.getpid()}"
    try:
        seen = _run_scale_flap(tmp, job)
    except AssertionError as e:
        errs = "\n".join(
            f"--- {n}:\n{open(os.path.join(tmp, n)).read()[-3000:]}"
            for n in sorted(os.listdir(tmp)) if n.endswith(".err"))
        raise AssertionError(f"{e}\n{errs}") from e
    finally:
        for arm_job in (job, job + "c"):
            for name in [f"dlrtpu_torch_ckpt_{arm_job}_{s}" for s in (0, 1)
                         ] + [f"dlrtpu_torch_timer_{arm_job}"]:
                try:
                    seg = PersistentSharedMemory(name=name)
                    seg.close()
                    seg.unlink()
                except FileNotFoundError:
                    pass
    # the flap rode in process; the kill took the restart path
    assert seen["ack2"]["ok"] and seen["ack3"]["ok"]
    assert seen["ack4"] is None and seen["a0_exit"] not in (0, None)
    assert seen["dumps"], "the kill left no flight dump"
    # every row fetched exactly once across the four incarnations
    served = sorted(x for rows in seen["consumed"].values() for x in rows)
    assert served == list(range(N_ROWS)), json.dumps(seen["consumed"])
    s2, s3, s4 = seen["boundaries"]
    assert s2 < s3 < s4 < STEPS
    assert seen["final"]["step"] == seen["control"]["step"] == STEPS
    for name, value in seen["control"]["params"].items():
        assert torch.equal(seen["final"]["params"][name], value), name
