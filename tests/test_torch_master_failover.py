"""The port's master failover held against the JAX package on the CPU.

The same servicer operations go to both packages' masters (a servicer
wired as ``LocalJobMaster`` wires it, with a ``MasterStateStore`` bound):
the snapshot payloads ``collect()`` gathers, and the state a fresh master
restores from a snapshot, from the write-ahead log alone and from a WAL
with a torn tail, must be equal (exactly: nothing here is floating point
but the wall-clock fields, which are left out and named below). Then a
twin of ``tests/test_master_failover.py::test_master_kill_failover_smoke``
through the port's entry points: a ``master.kill`` chaos rule kills the
port's master process on its 7th task request, a supervisor restarts it
with ``--restore-state`` after a real outage, and a CPU worker reading an
``ElasticDataset`` must see every shard once, never restart, and find the
outage charged to ``restart`` in the goodput ledger."""

import importlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from http.client import HTTPException

import pytest

from dlrover_tpu_torch.common.constants import (
    NodeEnv,
    NodeType,
    RendezvousName,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("dlrover_tpu", "dlrover_tpu_torch")
# wall-clock fields of the snapshot payload: when it was taken and when
# the first node joined a round; every other field must be equal
CLOCK_FIELDS = ("time", "first_join_time")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def build_servicer(pkg):
    """A servicer wired like ``LocalJobMaster`` builds it (no server)."""
    tasks = _mod(pkg, "master.shard.task_manager").TaskManager()
    jobs = _mod(pkg, "master.job_manager").LocalJobManager(
        None, tasks.speed_monitor)
    jobs.start()
    rdzv_mod = _mod(pkg, "master.rendezvous")
    rdzv = {
        RendezvousName.ELASTIC_TRAINING:
            rdzv_mod.ElasticTrainingRendezvousManager(),
        RendezvousName.NETWORK_CHECK:
            rdzv_mod.NetworkCheckRendezvousManager(),
    }
    for mgr in rdzv.values():
        mgr.update_rdzv_params(1, 1, 30, 1)
    kv = _mod(pkg, "master.kvstore")
    return _mod(pkg, "master.servicer").MasterServicer(
        task_manager=tasks, job_manager=jobs, rdzv_managers=rdzv,
        kv_store=kv.KVStoreService(), sync_service=kv.SyncService(),
        elastic_ps_service=_mod(pkg, "master.elastic_ps").ElasticPsService(),
    )


def bind_store(pkg, servicer, state_dir):
    store = _mod(pkg, "master.state_store").MasterStateStore(str(state_dir))
    store.bind(task_manager=servicer.task_manager,
               rdzv_managers=servicer.rdzv_managers,
               kv_store=servicer.kv_store,
               sync_service=servicer.sync_service, servicer=servicer,
               port=12345)
    servicer.state_store = store
    return store


def drive(pkg, servicer) -> list:
    """The operations of the JAX package's snapshot round trip, sent as
    RPCs would send them: a dataset, two dispatches and one result, a
    formed round with verified steps, kv writes, a checkpoint sync.
    Returns the ranges of the two dispatched shards."""
    msg = _mod(pkg, "common.messages")
    w = NodeType.WORKER
    servicer.report(w, 0, msg.DatasetShardParams(
        batch_size=2, num_epochs=1, dataset_size=16, dataset_name="train",
        task_type="training", num_minibatches_per_shard=2))
    first = servicer.get(w, 0, msg.TaskRequest(dataset_name="train"))
    servicer.report(w, 0, msg.TaskResult(dataset_name="train",
                                         task_id=first.task_id))
    second = servicer.get(w, 0, msg.TaskRequest(dataset_name="train"))
    servicer.report(w, 0, msg.JoinRendezvousRequest(
        node_rank=0, local_world_size=1,
        rdzv_name=RendezvousName.ELASTIC_TRAINING,
        verified_ckpt_steps=[4, 8]))
    world = servicer.get(w, 0, msg.CommWorldRequest(
        node_id=0, rdzv_name=RendezvousName.ELASTIC_TRAINING))
    assert world.world
    servicer.report(w, 0, msg.KeyValuePair(key="store/k", value=b"\x01\x02"))
    servicer.get(w, 0, msg.KeyValueAddRequest(key="counter", delta=7))
    servicer.report(w, 0, msg.CheckpointSyncRequest(node_id=0, step=8))
    return [(t.task_id, t.shard.start, t.shard.end) for t in (first, second)]


def without_clock(obj):
    """The payload with its wall-clock fields left out."""
    if isinstance(obj, dict):
        return {k: without_clock(v) for k, v in obj.items()
                if k not in CLOCK_FIELDS}
    if isinstance(obj, list):
        return [without_clock(v) for v in obj]
    return obj


def serve_rest(pkg, servicer, in_flight) -> list:
    """Complete the in-flight task, then take and complete every task the
    master still hands out; returns what was served and whether the
    dataset finished."""
    msg = _mod(pkg, "common.messages")
    w = NodeType.WORKER
    out = [servicer.report(w, 0, msg.TaskResult(
        dataset_name="train", task_id=in_flight))]
    while True:
        t = servicer.get(w, 0, msg.TaskRequest(dataset_name="train"))
        if t.task_id < 0:
            break
        out.append((t.task_id, t.shard.start, t.shard.end))
        servicer.report(w, 0, msg.TaskResult(dataset_name="train",
                                             task_id=t.task_id))
    out.append(servicer.task_manager.finished())
    return out


def test_collect_payload_equals_jax(tmp_path):
    got = {}
    for pkg in PACKAGES:
        servicer = build_servicer(pkg)
        store = bind_store(pkg, servicer, tmp_path / pkg)
        drive(pkg, servicer)
        got[pkg] = without_clock(json.loads(json.dumps(store.collect())))
    assert got["dlrover_tpu_torch"] == got["dlrover_tpu"]
    assert got["dlrover_tpu"]["wal_seq"] > 0


@pytest.mark.parametrize("source", ["snapshot", "wal-only", "torn-tail"])
def test_restored_state_equals_jax(tmp_path, source):
    """A fresh master restores the same rendezvous round, kv-store and
    shard accounting, and serves the same remaining shards, from a
    snapshot, from the WAL alone (the kill came before any snapshot) and
    from a WAL whose last line was torn mid-append."""
    got = {}
    for pkg in PACKAGES:
        state_dir = tmp_path / pkg
        servicer = build_servicer(pkg)
        store = bind_store(pkg, servicer, state_dir)
        tasks = drive(pkg, servicer)
        if source == "snapshot":
            assert store.write_snapshot() is not None
        elif source == "torn-tail":
            wal = _mod(pkg, "master.state_store").WAL_FILE
            with open(state_dir / wal, "a") as f:
                f.write('{"op": "kv", "key": "torn..')
        fresh = build_servicer(pkg)
        fresh_store = bind_store(pkg, fresh, state_dir)
        assert fresh_store.restore()
        state = without_clock(json.loads(json.dumps(fresh_store.collect())))
        kv = [fresh.kv_store.get("store/k"), fresh.kv_store.get("counter")]
        got[pkg] = (state, kv, serve_rest(pkg, fresh, tasks[1][0]))
    assert got["dlrover_tpu_torch"] == got["dlrover_tpu"]
    state, kv, served = got["dlrover_tpu_torch"]
    assert kv == [b"\x01\x02", b"7"]
    assert served[-1] is True
    # the in-flight shard completes once and no shard is served twice
    ranges = {(s, e) for _i, s, e in tasks} | {
        (s, e) for _i, s, e in served[1:-1]}
    assert ranges == {(0, 4), (4, 8), (8, 12), (12, 16)}


def test_port_restores_a_state_dir_the_jax_package_wrote(tmp_path):
    """The snapshot and WAL formats are the JAX package's: the port
    restores what a JAX master persisted to the same state."""
    got = {}
    for writer in PACKAGES:
        servicer = build_servicer(writer)
        store = bind_store(writer, servicer, tmp_path / writer)
        tasks = drive(writer, servicer)
        store.write_snapshot()
        fresh = build_servicer("dlrover_tpu_torch")
        assert bind_store("dlrover_tpu_torch", fresh,
                          tmp_path / writer).restore()
        got[writer] = serve_rest("dlrover_tpu_torch", fresh, tasks[1][0])
    assert got["dlrover_tpu"] == got["dlrover_tpu_torch"]


def test_peek_port_and_reset_equal_jax(tmp_path):
    for pkg in PACKAGES:
        store_mod = _mod(pkg, "master.state_store")
        servicer = build_servicer(pkg)
        store = bind_store(pkg, servicer, tmp_path / pkg)
        assert store_mod.MasterStateStore.peek_port(
            str(tmp_path / pkg)) == 0
        store.wal_append("kv", key="a", value="YQ==")
        store.write_snapshot()
        assert store_mod.MasterStateStore.peek_port(
            str(tmp_path / pkg)) == 12345
        fresh = build_servicer(pkg)
        fresh_store = bind_store(pkg, fresh, tmp_path / pkg)
        fresh_store.reset()
        assert not fresh_store.restore()
        assert fresh.kv_store.get("a") == b""


# ------------------------------------------------- the master-kill twin

SHARD_WORKER = """
import json, os, time
from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.trainer.elastic import ElasticDataset

out_dir = os.environ["FAILOVER_OUT"]
dataset_size = int(os.environ["FAILOVER_DATASET_SIZE"])


class Rows(ElasticDataset):
    def read_sample(self, index):
        return index


ds = Rows("train", dataset_size=dataset_size, batch_size=2, epochs=1,
          num_minibatches_per_shard=2)
done, batch = [], []
while True:
    try:
        batch.append(ds[len(done)])
    except IndexError:
        break
    if len(batch) < 4:  # one shard: 2 minibatches of 2
        continue
    t0 = time.time()
    time.sleep(0.12)
    ds.report_batch_done()
    done.append(batch)
    batch = []
    telemetry.event("step.end", step=len(done), dur=time.time() - t0)
    telemetry.flush()
with open(out_dir + "/result.json", "w") as f:
    json.dump({"shards": done, "pid": os.getpid()}, f)
"""


def dispatched(http_addr) -> float:
    """The dispatched-task count on the master's /metrics page: the
    WAL-append histogram's count for ``dispatch`` records, after
    /report.json folded the master's own registry in."""
    base = f"http://{http_addr}"
    urllib.request.urlopen(base + "/report.json", timeout=5).read()
    text = urllib.request.urlopen(base + "/metrics", timeout=5).read()
    for line in text.decode().splitlines():
        if line.startswith("dlrtpu_master_wal_append_seconds_count") and \
                'op="dispatch"' in line:
            return float(line.rsplit(" ", 1)[1])
    return 0.0


@pytest.mark.chaos
def test_master_kill_failover_smoke_through_the_port(tmp_path, monkeypatch):
    """The port's ``master.main`` (``--port 0 --state-dir --http-port 0
    --addr-file``) dies at its 7th task request and is restarted with
    ``--restore-state`` and ``--port 0``, which re-binds the previous
    port. Its HTTP plane answers before and after, and the dispatched
    count there continues. The in-process agent rides the outage
    through; its worker never restarts; every shard is read once; the
    ledger charges the outage to ``restart``."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.agent.training_agent import (
        ElasticLaunchConfig,
        ElasticTrainingAgent,
        WorkerSpec,
    )
    from dlrover_tpu_torch.common import retry, telemetry
    from dlrover_tpu_torch.common.ipc import SOCKET_DIR_ENV
    from dlrover_tpu_torch.common.rpc import addr_connectable
    from dlrover_tpu_torch.common.telemetry import JobTelemetry

    dataset_size = 48  # shard size 4 -> 12 shards
    state_dir = tmp_path / "master_state"
    addr_file = tmp_path / "master_addr"
    tele_dir = tmp_path / "telemetry"
    master_log = tmp_path / "master.log"

    monkeypatch.setenv("FAILOVER_OUT", str(tmp_path))
    monkeypatch.setenv("FAILOVER_DATASET_SIZE", str(dataset_size))
    monkeypatch.setenv("ELASTIC_JOB_NAME", f"tfailover{os.getpid()}")
    monkeypatch.setenv(SOCKET_DIR_ENV, str(tmp_path / "socks"))
    monkeypatch.setenv("DLROVER_TELEMETRY_DIR", str(tele_dir))
    monkeypatch.setenv(NodeEnv.DLROVER_MASTER_ADDR_FILE, str(addr_file))
    monkeypatch.setenv("DLROVER_PROBE_DISABLE", "1")
    # the deadline, not an attempt count, bounds each rpc's wait for the
    # restarted master: at 40 attempts of at most 0.3 s a loaded host's
    # restart outlived the worker's shard fetch (it exited, and the agent
    # restarted it) and the agent's rendezvous join
    monkeypatch.setenv("DLROVER_RPC_MAX_ATTEMPTS", "1000")
    monkeypatch.setenv("DLROVER_RPC_BASE_DELAY", "0.05")
    monkeypatch.setenv("DLROVER_RPC_MAX_DELAY", "0.3")
    monkeypatch.setenv("DLROVER_RPC_DEADLINE", "45")
    monkeypatch.setenv("DLROVER_MASTER_RIDE_POLL", "0.1")
    retry.set_default_rpc_policy(None)

    master_env = dict(os.environ)
    master_env["PYTHONPATH"] = REPO
    master_env["DLROVER_CHAOS"] = json.dumps({"seed": 29, "rules": [{
        "site": "master.kill", "action": "kill", "msg": ["TaskRequest"],
        "after": 6, "max": 1}]})
    master_env["DLROVER_TELEMETRY_ROLE"] = "master"

    def spawn(restore: bool) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.master.main",
               "--port", "0", "--node_num", "1", "--http-port", "0",
               "--addr-file", str(addr_file)]
        env = dict(master_env)
        if restore:
            cmd += ["--restore-state", str(state_dir)]
            env.pop("DLROVER_CHAOS")  # the kill is one-shot
        else:
            cmd += ["--state-dir", str(state_dir)]
        with open(master_log, "ab") as log:
            return subprocess.Popen(cmd, env=env, stdout=log,  # noqa: S603
                                    stderr=subprocess.STDOUT, cwd=REPO)

    def http_addrs() -> list:
        return [line.split("=", 1)[1] for line in
                master_log.read_text().splitlines()
                if line.startswith("DLROVER_MASTER_HTTP=")]

    def wait_for(pred, what, limit=30.0):
        deadline = time.time() + limit
        while not pred():
            assert proc.poll() in (None, 0), (
                f"master died while waiting for {what}; log:\n"
                f"{master_log.read_text()}")
            assert time.time() < deadline, f"no {what}"
            time.sleep(0.05)

    proc = spawn(False)
    wait_for(lambda: addr_file.exists() and len(http_addrs()) == 1,
             "master address")
    addr = addr_file.read_text()
    assert addr_connectable(addr, timeout=0.5)
    readings = {"before": [], "after": []}
    restarts: list = []
    done = threading.Event()

    def supervise():
        nonlocal proc
        while not done.is_set():
            rc = proc.poll()
            if rc is not None and rc != 0 and not done.is_set():
                restarts.append(rc)
                time.sleep(1.2)  # a real outage: the agent must see it
                proc = spawn(True)
            http = http_addrs()
            if proc.poll() is None and http:
                try:
                    readings["after" if restarts else "before"].append(
                        dispatched(http[-1]))
                except (OSError, HTTPException):
                    # not serving yet, or killed mid-response (an
                    # IncompleteRead), which would end this thread
                    pass
            time.sleep(0.05)

    supervisor = threading.Thread(target=supervise, daemon=True)
    supervisor.start()
    telemetry.enable("failover-agent")
    script = tmp_path / "shard_worker.py"
    script.write_text(SHARD_WORKER)
    config = ElasticLaunchConfig(
        min_nodes=1, max_nodes=1, nproc_per_node=1, monitor_interval=0.2,
        rdzv_timeout=60, max_restarts=3, log_dir=str(tmp_path),
        master_ride_through=60, accelerator="cpu")
    client = MasterClient(addr, 0, NodeType.WORKER)
    agent = ElasticTrainingAgent(config, WorkerSpec(str(script), (), config),
                                 client)
    try:
        rc = agent.run()
    finally:
        done.set()
        supervisor.join(timeout=10)
        client.close()
        retry.set_default_rpc_policy(None)
        if proc.poll() is None:
            proc.terminate()
        proc.wait(timeout=20)
        telemetry.flush()

    assert rc == 0, f"agent failed; master log:\n{master_log.read_text()}"
    assert restarts == [137], f"expected one chaos kill, saw {restarts}"
    assert agent._restart_count == 0
    # --port 0 with --restore-state re-bound the first incarnation's port
    assert addr_file.read_text() == addr
    assert len(http_addrs()) == 2

    result = json.loads((tmp_path / "result.json").read_text())
    covered = sorted(tuple(b) for b in result["shards"])
    assert covered == [tuple(range(i, i + 4))
                       for i in range(0, dataset_size, 4)], covered

    # /metrics answered on both sides of the outage, and the restored
    # master's count went on from the first incarnation's (its merged
    # telemetry came back from the snapshot) instead of from zero: it
    # ends above the 6 dispatches the restored master made itself. (The
    # snapshot holds the count as of the master's last fold of its own
    # registry, so it may lag the dispatches before the kill.)
    before, after = readings["before"], readings["after"]
    assert before and after, readings
    assert after == sorted(after), after
    assert after[0] > 0, after
    assert after[-1] > dataset_size // 4 - 6, readings

    report = JobTelemetry.from_dir(str(tele_dir)).report()
    kinds = [e["kind"] for e in report["timeline"]]
    assert "master.unreachable" in kinds
    restart_events = [e for e in report["timeline"]
                      if e["kind"] == "master.restart"]
    assert any(e.get("restored") for e in restart_events)
    assert any(e.get("dur", 0) > 0 for e in restart_events)
    ledger = report["ledger"]
    assert ledger["categories"]["restart"] > 0.0
    assert ledger["categories"]["productive"] > 0.0
    assert sum(ledger["categories"].values()) == pytest.approx(
        ledger["total_s"], rel=1e-6, abs=1e-6)
