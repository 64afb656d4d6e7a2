"""The port's elastic agent and launcher on the CPU: the exit taxonomy
with the CUDA/NCCL patterns, the worker env contract, restarts, the
probe's child, capture directives, the launcher end to end, and a chaos
kill whose restarted worker resumes from the agent-held shm segment with
the losses of an uninterrupted run. Three tests spawn processes, each
under its own time limit."""

import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

from dlrover_tpu.agent import training_agent as jax_agent
from dlrover_tpu_torch.agent import probe
from dlrover_tpu_torch.agent.ckpt_saver import (
    AGENT_SAVER_ENV,
    AsyncCheckpointSaver,
    verify_step_dir,
)
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.training_agent import (
    ElasticLaunchConfig,
    ElasticTrainingAgent,
    WorkerSpec,
    classify_exit,
    launch_agent,
)
from dlrover_tpu_torch.common import chaos, telemetry
from dlrover_tpu_torch.common.constants import (
    CheckpointConstant,
    ExitCode,
    NodeEnv,
    NodeType,
)
from dlrover_tpu_torch.common.ipc import SOCKET_DIR_ENV, PersistentSharedMemory
from dlrover_tpu_torch.master.master import LocalJobMaster
from dlrover_tpu_torch.ops._build import BUILD_DIR_ENV
from dlrover_tpu_torch.scheduler.job import new_job_args
from dlrover_tpu_torch.trainer import timer as timer_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolate(tmp_path, monkeypatch):
    """This test's own job name, socket dir, metrics files and saver
    singleton; the job's segments unlinked at the end."""
    job = f"tag{os.getpid()}"
    monkeypatch.setenv(NodeEnv.JOB_NAME, job)
    # a short dir: a unix socket's path is limited to 107 bytes
    socks = tempfile.mkdtemp(prefix="tag")
    monkeypatch.setenv(SOCKET_DIR_ENV, socks)
    monkeypatch.setenv("DLROVER_RUNTIME_METRICS_PATH",
                       str(tmp_path / "metrics.json"))
    monkeypatch.setenv("DLROVER_PARAL_CONFIG_PATH", "")
    for key in ("DLROVER_MASTER_ADDR", NodeEnv.RESTORE_STEP,
                chaos.ENV_VAR, telemetry.ENV_DIR):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(timer_mod, "_timer", None)
    AsyncCheckpointSaver.reset()
    yield job
    AsyncCheckpointSaver.reset()
    shutil.rmtree(socks, ignore_errors=True)
    for name in (f"dlrtpu_torch_ckpt_{job}_0", f"dlrtpu_torch_timer_{job}"):
        try:
            seg = PersistentSharedMemory(name=name)
        except FileNotFoundError:
            continue
        seg.close()
        seg.unlink()


def start_port_master():
    master = LocalJobMaster(0, new_job_args("local", "agent-test",
                                            node_num=1))
    master.prepare()
    return master


@pytest.fixture
def port_master():
    master = start_port_master()
    yield master
    master.stop()


@contextlib.contextmanager
def deadline(seconds):
    """Raise TimeoutError in this (the main) thread after ``seconds``:
    the time limit of a test that runs an agent in process (the agent's
    ``finally`` then stops its workers)."""
    def expire(signum, frame):
        raise TimeoutError(f"the test's {seconds} s ran out")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def make_agent(addr, entrypoint, log_dir, **cfg):
    config = ElasticLaunchConfig(min_nodes=1, max_nodes=1,
                                 monitor_interval=0.3, rdzv_timeout=30,
                                 log_dir=str(log_dir), **cfg)
    client = MasterClient(addr, 0, NodeType.WORKER)
    return ElasticTrainingAgent(
        config, WorkerSpec(str(entrypoint), (), config), client), client


# ------------------------------------------------------------ exit kinds

@pytest.mark.parametrize("rc,tail,stopping,draining,kind", [
    (0, "", False, False, "succeeded"),
    (1, "", False, False, "software"),
    (ExitCode.DEVICE_ERROR, "", False, False, "hardware"),
    (ExitCode.CORE_DUMP, "", False, False, "hardware"),
    (-signal.SIGBUS, "", False, False, "hardware"),
    (ExitCode.OOM, "", False, False, "oom"),
    (-signal.SIGKILL, "", False, False, "oom"),
    (137, "", False, False, "software"),
    (-signal.SIGTERM, "", True, False, "stopped"),
    (ExitCode.TERMED, "", False, True, "stopped"),
    (-signal.SIGKILL, "", False, True, "preempted"),
    (1, "RuntimeError: CUDA error: an illegal memory access was "
        "encountered", False, False, "hardware"),
    (1, "CUDA error: uncorrectable ECC error encountered", False, False,
     "hardware"),
    (1, "torch.distributed.DistBackendError: NCCL error in: "
        "ProcessGroupNCCL.cpp", False, False, "hardware"),
    (1, "cudaErrorLaunchFailure: unspecified launch failure", False, False,
     "hardware"),
    (1, "jax XlaRuntimeError: INTERNAL something", False, False,
     "software"),
    (1, "ValueError: shapes do not match", False, False, "software"),
])
def test_classify_exit(rc, tail, stopping, draining, kind):
    """The exit taxonomy of the JAX agent, with CUDA/NCCL patterns in
    place of the XLA/libtpu ones."""
    assert classify_exit(rc, tail, stopping, draining) == kind
    if not tail:
        assert jax_agent.classify_exit(rc, tail, stopping, draining) == kind


# ------------------------------------------------------------ worker env

def test_worker_env_contract(tmp_path, monkeypatch):
    """No JAX_* names, the port's PYTHONPATH, the ranks, the store
    address init_distributed reads, the agent-hosted saver, the kernel
    build dir and per-incarnation reshape and capture channels."""
    for key in [k for k in os.environ if k.startswith("JAX_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    client = types.SimpleNamespace(master_addr="127.0.0.1:1", node_id=0)
    cache = tmp_path / "kernels"
    agent = ElasticTrainingAgent(
        ElasticLaunchConfig(nproc_per_node=4, node_rank=1,
                            log_dir=str(tmp_path),
                            compilation_cache_dir=str(cache)),
        WorkerSpec("w.py", (), None), client)
    env = agent._worker_env(2, 6, 8, "10.0.0.1:7659")
    assert not [k for k in env if k.startswith("JAX_")]
    assert NodeEnv.JAX_PROCESS_ID not in env
    assert env["PYTHONPATH"].split(os.pathsep) == [REPO, "/elsewhere"]
    assert (env[NodeEnv.LOCAL_RANK], env[NodeEnv.RANK],
            env[NodeEnv.WORLD_SIZE], env[NodeEnv.LOCAL_WORLD_SIZE],
            env[NodeEnv.NODE_RANK]) == ("2", "6", "8", "4", "1")
    assert env[NodeEnv.JAX_COORDINATOR_ADDR] == "10.0.0.1:7659"
    assert env[AGENT_SAVER_ENV] == "1"
    assert env[BUILD_DIR_ENV] == str(cache) and cache.is_dir()
    assert env[NodeEnv.RESHAPE_DIR] == str(tmp_path / "reshape_1_2")
    assert env[telemetry.ENV_ROLE] == "worker"
    # the default cache dir leaves the package's own build dir in place
    agent._config.compilation_cache_dir = ""
    monkeypatch.delenv(BUILD_DIR_ENV, raising=False)
    assert BUILD_DIR_ENV not in agent._worker_env(0, 0, 1, "h:1")


def test_capture_directive_gets_a_failed_ack_once(tmp_path):
    """Deep captures used to be acked as failed naming ROADMAP item 12;
    the agent now relays a directive into local worker 0's capture
    channel (JAX's ``_maybe_execute_capture``). Without a worker's
    channel the directive is acked as failed; with a channel whose
    worker never marked it ready, the relay acks it as failed once, the
    re-serves of the directive while its relay runs absorbed by the
    in-flight guard."""
    import threading

    acks, release = [], threading.Event()

    def report(cid, rank, ok, artifact="", summary=None, error=""):
        if cid != "c0":
            release.wait(10)  # the relay is in flight until released
        acks.append((cid, rank, ok, error))

    client = types.SimpleNamespace(master_addr="127.0.0.1:1", node_id=0,
                                   report_capture_result=report)
    agent = ElasticTrainingAgent(
        ElasticLaunchConfig(log_dir=str(tmp_path)),
        WorkerSpec("w.py", (), None), client)
    agent._maybe_execute_capture({"capture_id": "c0"})
    assert acks == [("c0", 0, False, "no worker capture channel")]
    agent._worker_env(0, 0, 1, "h:1")  # creates worker 0's channel
    for cid in ("c1", "c1", "c2"):
        agent._maybe_execute_capture({"capture_id": cid})
    release.set()
    agent._capture_thread.join(10)
    assert acks[1:] == [("c1", 0, False, "no capture watcher on worker")]
    assert agent._capture_inflight == ""


def test_network_check_raises_naming_item_6(port_master, tmp_path,
                                            monkeypatch):
    """``--network-check`` used to raise naming ROADMAP item 6; it now
    runs agent/node_check.py (here on the CPU, as the config asks) before
    any worker, and a node the check fails stops with
    ``NETWORK_CHECK_FAILED`` and starts no worker."""
    monkeypatch.setattr("dlrover_tpu_torch.agent.node_check.CHECK_TIME_DIR",
                        str(tmp_path / "node_check"))
    monkeypatch.setenv(NodeEnv.MOCK_ERR_RANK, "0")
    monkeypatch.setenv(NodeEnv.NODE_RANK, "0")
    monkeypatch.setenv("DLROVER_PROBE_DISABLE", "1")
    script = tmp_path / "never.py"
    script.write_text("raise SystemExit('the worker must not start')\n")
    rc = launch_agent(
        ElasticLaunchConfig(network_check=True, accelerator="cpu",
                            rdzv_timeout=30, log_dir=str(tmp_path)),
        str(script), (), port_master.addr)
    assert rc == ExitCode.NETWORK_CHECK_FAILED
    assert not list(tmp_path.glob("worker_*.log"))


# ---------------------------------------------------------------- probe

def test_probe_runs_device_legs_in_a_child(monkeypatch):
    """On a GPU host the legs run in ``python -m ...agent.probe --child``
    and come back on its stdout; a failed child is a probe error, never
    an agent crash. The host arm runs in process."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        out = "noise\n" + probe._CHILD_TAG + json.dumps(
            {"hbm": 1.0, "matmul": 2.0, "collective": 3.0}) + "\n"
        return subprocess.CompletedProcess(cmd, 0, out, "")

    monkeypatch.setattr(probe, "_device_backend", lambda: "cuda")
    monkeypatch.setattr(probe.subprocess, "run", fake_run)
    report = probe.run_probe(0)
    assert calls[0][1:] == ["-m", "dlrover_tpu_torch.agent.probe",
                            "--child", "0"]
    assert report["legs"] == {"hbm": 1.0, "matmul": 2.0, "collective": 3.0}
    assert report["backend"] == "cuda" and not report["error"]
    monkeypatch.setattr(probe.subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 1, "", "no card"))
    report = probe.run_probe(0)
    assert report["legs"] == {} and "no card" in report["error"]
    monkeypatch.setattr(probe, "_device_backend", lambda: "")
    report = probe.run_probe(0)
    assert sorted(report["legs"]) == ["collective", "hbm", "matmul"]
    assert report["backend"] == "host"


# ------------------------------------------------- checkpoint plumbing

def test_engine_refuses_a_saver_of_its_own_under_the_agent(tmp_path,
                                                           monkeypatch):
    from dlrover_tpu_torch.trainer.flash_checkpoint.checkpointer import (
        host_place,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        ShardedCheckpointEngine,
    )

    monkeypatch.setenv(AGENT_SAVER_ENV, "1")
    with pytest.raises(RuntimeError, match="factory queue"):
        ShardedCheckpointEngine(str(tmp_path / "ckpt"))
    # the host's place: one process per card, LOCAL_WORLD_SIZE of them
    monkeypatch.setenv(NodeEnv.NODE_RANK, "1")
    monkeypatch.setenv(NodeEnv.WORLD_SIZE, "8")
    monkeypatch.setenv(NodeEnv.LOCAL_WORLD_SIZE, "4")
    assert host_place() == (1, 2)


def test_trainer_adopts_the_brain_cadence(port_master, tmp_path,
                                          monkeypatch):
    from dlrover_tpu_torch.master.brain import CADENCE_CONFIG_KEY

    trainer = build_trainer(tmp_path / "out", steps=2, flash=True)
    try:
        trainer._maybe_adopt_cadence()  # no master: keeps save_steps
        assert trainer._cadence_client is False
        trainer._cadence_client = None
        monkeypatch.setenv("DLROVER_MASTER_ADDR", port_master.addr)
        client = MasterClient(port_master.addr, 0, NodeType.WORKER)
        client.report_elastic_run_config({CADENCE_CONFIG_KEY: 3})
        client.close()
        trainer._maybe_adopt_cadence()
        assert trainer.args.save_steps == 3
    finally:
        trainer.close()
        if trainer._cadence_client:
            trainer._cadence_client.close()


# ------------------------------------------------------ spawning tests

def test_restart_on_software_failure_then_restarts_exhausted(
        port_master, tmp_path):
    """A worker that fails once is restarted and succeeds; one that keeps
    failing exhausts the restarts and fails the job."""
    marker = tmp_path / "marker"
    flaky = tmp_path / "flaky.py"
    flaky.write_text(
        f"import os, sys\nm = {str(marker)!r}\n"
        "if not os.path.exists(m):\n    open(m, 'w').close()\n"
        "    sys.exit(1)\nprint('recovered')\n")
    agent, client = make_agent(port_master.addr, flaky, tmp_path / "a",
                               max_restarts=2)
    try:
        with deadline(60):
            assert agent.run() == 0
        assert agent._restart_count == 1
        assert port_master.servicer.job_success
    finally:
        client.close()
    bad = tmp_path / "bad.py"
    bad.write_text("import sys; sys.exit(1)\n")
    master = start_port_master()
    agent, client = make_agent(master.addr, bad, tmp_path / "b",
                               max_restarts=1)
    try:
        with deadline(60):
            assert agent.run() == 1
        assert agent._restart_count == 1
        assert master.servicer.job_ended
        assert not master.servicer.job_success
    finally:
        client.close()
        master.stop()


TRAIN_SCRIPT = """
import torch

from dlrover_tpu_torch import trainer as torch_trainer
from dlrover_tpu_torch.agent.master_client import build_master_client
from dlrover_tpu_torch.agent.monitor import write_runtime_metrics

torch_trainer.init_distributed(device="cpu")
client = build_master_client()
client.report_dataset_shard_params(batch_size=4, num_epochs=1,
                                   dataset_size=32, dataset_name="train",
                                   num_minibatches_per_shard=2)
gen = torch.Generator().manual_seed(0)
w = torch.zeros(8, 1, requires_grad=True)
n_steps = 0
while True:
    task = client.get_task("train")
    if task.task_id < 0:
        break
    n = task.shard.end - task.shard.start
    x = torch.randn(n, 8, generator=gen)
    loss = ((x @ w - x.sum(1, keepdim=True)) ** 2).mean()
    loss.backward()
    with torch.no_grad():
        w -= 0.1 * w.grad
        w.grad = None
    client.report_task_result("train", task.task_id, "")
    n_steps += 1
    write_runtime_metrics(n_steps, loss=float(loss))
print(f"TRAINED steps={n_steps} final_loss={float(loss):.4f}")
assert n_steps == 4  # 32 samples / (4*2 per shard)
"""


def test_tpu_run_torch_end_to_end(tmp_path):
    """``python -m dlrover_tpu_torch.trainer.run`` spawns the port's
    local master and runs the agent, whose worker takes its shards from
    the master."""
    script = tmp_path / "train.py"
    script.write_text(TRAIN_SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["DLROVER_PROBE_DISABLE"] = "1"
    result = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.trainer.run", "--nnodes",
         "1", "--nproc_per_node", "1", "--max-restarts", "1", "--log-dir",
         str(tmp_path), str(script)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=180)
    logs = "\n".join((tmp_path / p).read_text()
                     for p in os.listdir(tmp_path) if p.endswith(".log"))
    assert result.returncode == 0, (
        f"stdout={result.stdout}\nstderr={result.stderr}\nlogs={logs}")
    assert "TRAINED steps=4" in logs
    assert "LocalJobMaster serving" in result.stderr


TRAINER_SCRIPT = """
import os
import numpy as np
import torch

from dlrover_tpu_torch.models import LlamaConfig, llama_init, llama_loss_fn
from dlrover_tpu_torch.parallel import Strategy
from dlrover_tpu_torch.trainer import Trainer, TrainingArgs
from dlrover_tpu_torch.trainer.elastic import (
    ElasticDataLoader,
    ElasticSampler,
)

CONFIG = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
              mlp_dim=96, max_seq_len=64, attn_impl="flash",
              dtype="float32", attn_block_q=16, attn_block_k=16)
N, SEQ, BATCH = 256, 17, 4


class TokenDataset:
    def __len__(self):
        return N

    def __getitem__(self, idx):
        return np.random.RandomState(idx).randint(0, 64, size=(SEQ,),
                                                  dtype=np.int32)


def build_trainer(out, steps, flash=True):
    torch.set_num_threads(1)
    cfg = LlamaConfig(**CONFIG)
    loader = ElasticDataLoader(
        TokenDataset(), BATCH, sampler=ElasticSampler(N, shuffle=True,
                                                      seed=1),
        collate_fn=lambda rows: {"tokens": np.stack(rows)},
        config_file="")
    return Trainer(
        llama_loss_fn(cfg), lambda s, d: llama_init(cfg, s, d), None,
        TrainingArgs(output_dir=str(out), max_steps=steps, num_epochs=100,
                     learning_rate=1e-2, save_steps=2, save_storage_every=2,
                     flash_checkpoint=flash, log_steps=10,
                     compute_dtype="float32",
                     strategy=Strategy(remat="none")),
        train_data=loader, device="cpu")


if __name__ == "__main__":
    trainer = build_trainer(os.environ["AGENT_TEST_OUT"], 6)
    trainer.train()
    trainer.close()
"""

_ns: dict = {}
exec(compile(TRAINER_SCRIPT, "trainer_script", "exec"), _ns)
build_trainer = _ns["build_trainer"]


def worker_snapshots(tele_dir):
    """The worker incarnations' telemetry snapshots, oldest first."""
    snaps = []
    for path, source in telemetry.snapshot_files(str(tele_dir)):
        if source.startswith("worker-"):
            with open(path) as f:
                snaps.append(json.load(f))
    return sorted(snaps, key=lambda s: s["created"])


def test_chaos_kill_resumes_from_the_agent_held_segment(port_master,
                                                        tmp_path,
                                                        monkeypatch):
    """The worker dies right after its step-4 shm save; the agent, whose
    saver holds the segment, restarts it, and the new incarnation
    restores step 4 from shm (not storage) and trains steps 5-6 with the
    losses of an uninterrupted run; the agent persisted the last step."""
    prev_threads = torch.get_num_threads()
    ref = build_trainer(tmp_path / "ref", 6, flash=False)
    inner, ref_losses = ref._accel.train_step, []

    def recording(state, batch, rng):
        state, metrics = inner(state, batch, rng)
        ref_losses.append(metrics["loss"].item())
        return state, metrics

    ref._accel.train_step = recording
    ref.train()
    torch.set_num_threads(prev_threads)

    script = tmp_path / "trainer_worker.py"
    script.write_text(TRAINER_SCRIPT)
    out = tmp_path / "out"
    monkeypatch.setenv("AGENT_TEST_OUT", str(out))
    monkeypatch.setenv(telemetry.ENV_DIR, str(tmp_path / "tele"))
    monkeypatch.setenv(chaos.ENV_VAR, json.dumps({"seed": 7, "rules": [
        {"site": "ckpt.save", "action": "kill", "step": 4}]}))
    agent, client = make_agent(port_master.addr, script, tmp_path / "logs",
                               max_restarts=1)
    try:
        with deadline(150):
            assert agent.run() == 0
    finally:
        client.close()
    assert agent._restart_count == 1
    first, second = worker_snapshots(tmp_path / "tele")
    fired = [e for e in first["events"] if e["kind"] == "chaos.fire"]
    assert fired and fired[0]["step"] == 4
    restores = [e for e in second["events"] if e["kind"] == "ckpt.restore"]
    assert [(e["step"], e["source_kind"]) for e in restores] == [(4, "shm")]
    losses = {e["step"]: e["loss"] for e in second["events"]
              if e["kind"] == "train.loss"}
    assert sorted(losses) == [5, 6]
    np.testing.assert_allclose([losses[5], losses[6]], ref_losses[4:6],
                               rtol=1e-5)
    step_dir = out / "checkpoints" / f"{CheckpointConstant.STEP_DIR_PREFIX}6"
    assert verify_step_dir(str(step_dir), deep=True)[0]
    # a clean finish unlinks the job's checkpoint segment
    job = os.environ[NodeEnv.JOB_NAME]
    with pytest.raises(FileNotFoundError):
        PersistentSharedMemory(name=f"dlrtpu_torch_ckpt_{job}_0")
