"""Flash Checkpoint in the port's ``Trainer`` on the CPU: the SMALL
Llama config (2 layers, dim 64), float32, adamw unless named.

- A worker process killed by the copied ``DLROVER_CHAOS`` ``kill`` rule
  right after its step-4 save, then resumed in a new process from the shm
  segment it left, and in another from storage (step 2), gives losses
  bit-equal to an uninterrupted run's at every step.
- Optimizer state restores bit-equal, moments included: torch AdamW's
  (created lazily by torch, up front by the Trainer), a save taken
  before the first step, 8-bit Adam's (codes, scales, its count) and
  AGD's (its moments and its global count).
- The elastic loader resumes mid-epoch: the batches before and after
  the resume are the uninterrupted run's, none replayed or lost, across
  an epoch boundary.
- A restore calls ``notify_progress_reset`` once; the shm timing ring
  holds the step, data-wait and checkpoint tags; an incompatible
  checkpoint raises unless ``DLROVER_TPU_IGNORE_CKPT`` is set; saving
  changes no loss.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common.ipc import (
    SOCKET_DIR_ENV,
    PersistentSharedMemory,
)
from dlrover_tpu_torch.device import CUDA_SKIP_REASON, cuda_available
from dlrover_tpu_torch.models import LlamaConfig, llama_init, llama_loss_fn
from dlrover_tpu_torch.parallel import Strategy
from dlrover_tpu_torch.trainer import Trainer, TrainingArgs
from dlrover_tpu_torch.trainer import timer as timer_mod
from dlrover_tpu_torch.trainer import trainer as trainer_mod
from dlrover_tpu_torch.trainer.elastic import (
    ElasticDataLoader,
    ElasticSampler,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(
    vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=96,
    max_seq_len=64, attn_impl="flash", dtype="float32", attn_block_q=16,
    attn_block_k=16,
)
# 24 samples in batches of 4: 6 steps an epoch
N, BATCH, SEQ = 24, 4, 17


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread, as in the worker processes: the CPU results
    are then bit-for-bit reproducible, and the file leaves the cores to
    the timing-sensitive tests beside it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _unlink(job):
    for name in (f"dlrtpu_torch_ckpt_{job}_0", f"dlrtpu_torch_timer_{job}"):
        try:
            seg = PersistentSharedMemory(name=name)
        except FileNotFoundError:
            continue
        seg.close()
        seg.unlink()


@pytest.fixture(autouse=True)
def _isolate(tmp_path, monkeypatch):
    """This test's own job name, socket dir, saver singleton and step
    timer; the job's segments unlinked at the end."""
    job = f"tck{os.getpid()}"
    monkeypatch.setenv("ELASTIC_JOB_NAME", job)
    monkeypatch.setenv(SOCKET_DIR_ENV, str(tmp_path / "socks"))
    monkeypatch.setenv("DLROVER_RUNTIME_METRICS_PATH",
                       str(tmp_path / "metrics.json"))
    monkeypatch.setenv("DLROVER_PARAL_CONFIG_PATH", "")
    monkeypatch.delenv("DLROVER_TPU_IGNORE_CKPT", raising=False)
    monkeypatch.delenv("DLROVER_TPU_RESTORE_STEP", raising=False)
    monkeypatch.setattr(timer_mod, "_timer", None)
    AsyncCheckpointSaver.reset()
    yield job
    AsyncCheckpointSaver.reset()
    _unlink(job)


class TokenDataset:
    def __len__(self):
        return N

    def __getitem__(self, idx):
        return np.random.RandomState(idx).randint(0, 64, size=(SEQ,),
                                                  dtype=np.int32)


def make_trainer(out, max_steps, optimizer="adamw", flash=True,
                 save_steps=2, config=SMALL):
    cfg = LlamaConfig(**config)
    loader = ElasticDataLoader(
        TokenDataset(), BATCH, sampler=ElasticSampler(N, shuffle=True,
                                                      seed=1),
        collate_fn=lambda rows: {"tokens": np.stack(rows)}, config_file="")
    return Trainer(
        llama_loss_fn(cfg), lambda s, d: llama_init(cfg, s, d), None,
        TrainingArgs(output_dir=str(out), max_steps=max_steps,
                     num_epochs=100, optimizer=optimizer,
                     learning_rate=1e-2, save_steps=save_steps,
                     flash_checkpoint=flash, log_steps=0,
                     compute_dtype="float32",
                     strategy=Strategy(remat="none")),
        train_data=loader, device="cpu")


def record(trainer):
    """Each step's loss and batch."""
    inner, seen = trainer._accel.train_step, {"losses": [], "batches": []}

    def recording(state, batch, rng):
        state, metrics = inner(state, batch, rng)
        seen["losses"].append(metrics["loss"].item())
        seen["batches"].append(np.asarray(batch["tokens"]).copy())
        return state, metrics

    trainer._accel.train_step = recording
    return seen


def restart():
    """What a new process starts from: no saver, no step timer."""
    AsyncCheckpointSaver.reset()
    timer_mod._timer = None


def opt_tensors(optimizer):
    out = {}
    for key, value in optimizer.state_dict()["state"].items():
        if isinstance(value, dict):
            out.update({f"{key}.{k}": v for k, v in value.items()})
        else:
            out[str(key)] = value
    return out


# -------------------------------------------------------------- in-process


def test_saving_changes_no_loss(tmp_path):
    a = make_trainer(tmp_path / "a", 5, flash=False, save_steps=0)
    b = make_trainer(tmp_path / "b", 5)
    seen_a, seen_b = record(a), record(b)
    a.train()
    b.train()
    b.close()
    assert seen_a["losses"] == seen_b["losses"]
    assert len(seen_b["losses"]) == 5
    # the cadence saves and the final persisted save landed
    assert AsyncCheckpointSaver.get_latest_step(
        str(tmp_path / "b" / "checkpoints")) == 5


@pytest.mark.parametrize("optimizer,steps", [
    ("adamw", 3), ("adamw", 0), ("adam8bit", 3), ("agd", 3), ("agd", 0),
], ids=["adamw", "adamw-before-step-1", "adam8bit", "agd",
        "agd-before-step-1"])
def test_optimizer_state_restores_bit_equal(tmp_path, optimizer, steps):
    a = make_trainer(tmp_path / "out", steps, optimizer=optimizer,
                     save_steps=0)
    if steps:
        a.train()  # ends with the final persisted save
    else:
        assert a.save_checkpoint(persist=False)
    restart()
    b = make_trainer(tmp_path / "out", steps + 2, optimizer=optimizer)
    if optimizer == "adamw":
        # torch AdamW creates its moments at its first step; the Trainer
        # creates them up front, so the restore target names them
        assert all(len(s) == 3 for s in b.state.optimizer.state.values())
    assert b.maybe_resume() == steps
    assert b.global_step == steps and b.state.step == steps
    want, got = opt_tensors(a.state.optimizer), opt_tensors(
        b.state.optimizer)
    assert set(got) == set(want) and len(want) >= 12
    if optimizer == "agd":
        # created with the optimizer: a save before step 1 names them too
        assert all(set(s) == {"mu", "nu"}
                   for s in b.state.optimizer.state.values()
                   if isinstance(s, dict))
    for key, w in want.items():
        g = got[key]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.device == w.device, key
            assert torch.equal(g, w), key
        else:
            assert g == w and type(g) is type(w), key
    for name, p in a.state.params.items():
        assert torch.equal(b.state.params[name], p), name
    assert b.state.optimizer.param_groups[0]["lr"] == 1e-2
    # both continue identically
    a.args.max_steps = b.args.max_steps
    a._engine.close()
    a._engine = None
    seen_a = record(a)
    a.train()
    seen_b = record(b)
    b.train()
    b.close()
    assert seen_b["losses"] == seen_a["losses"] and len(seen_a["losses"]) == 2


def test_loader_resumes_mid_epoch_without_replay_or_loss(tmp_path):
    ref = make_trainer(tmp_path / "ref", 10, flash=False, save_steps=0)
    seen_ref = record(ref)
    ref.train()
    a = make_trainer(tmp_path / "out", 4)
    seen_a = record(a)
    a.train()
    restart()
    b = make_trainer(tmp_path / "out", 10)
    seen_b = record(b)
    b.train()  # resumes from the step-4 shm save, crosses epoch 0 -> 1
    b.close()
    batches = seen_a["batches"] + seen_b["batches"]
    assert len(batches) == 10
    for got, want in zip(batches, seen_ref["batches"]):
        np.testing.assert_array_equal(got, want)
    assert seen_a["losses"] + seen_b["losses"] == seen_ref["losses"]
    assert b.train_data.sampler.epoch == 1


def test_restore_resets_progress_once_and_the_ring_holds_the_tags(
        tmp_path, monkeypatch):
    from dlrover_tpu_torch.trainer.timer import Tag, get_step_timer

    resets = []
    monkeypatch.setattr(trainer_mod, "notify_progress_reset",
                        lambda reason="": resets.append(reason))
    a = make_trainer(tmp_path / "out", 4)
    a.train()
    assert resets == []  # nothing to restore
    tags = {tag for tag, _start, _dur in get_step_timer().drain()}
    assert {Tag.STEP, Tag.DATA_WAIT, Tag.CKPT_SHM} <= tags
    restart()
    b = make_trainer(tmp_path / "out", 4)
    b.train()  # resumed at max_steps: restores, takes no step
    b.close()
    assert resets == ["checkpoint-restore"]
    assert b.global_step == 4


def test_incompatible_checkpoint_raises_unless_ignored(tmp_path,
                                                       monkeypatch):
    a = make_trainer(tmp_path / "out", 2)
    a.train()
    restart()
    wider = dict(SMALL, mlp_dim=128)
    b = make_trainer(tmp_path / "out", 2, config=wider)
    with pytest.raises(ValueError, match="incompatible"):
        b.maybe_resume()
    monkeypatch.setenv("DLROVER_TPU_IGNORE_CKPT", "1")
    assert b.maybe_resume() == 0
    b.close()


@pytest.mark.cuda
@pytest.mark.parametrize("blocking", [False, True], ids=["async", "blocking"])
def test_save_then_in_place_update_on_the_card(tmp_path, blocking):
    """On the card the copies run on a side stream: a save followed at
    once by in-place updates on the compute stream stores the values it
    was called with (the async save makes the compute stream wait on its
    last copy; the blocking one returns after it)."""
    if not cuda_available():
        pytest.skip(CUDA_SKIP_REASON)
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        ShardedCheckpointEngine,
    )

    e = ShardedCheckpointEngine(str(tmp_path / "ckpt"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = {"w": torch.randn(1 << 26, device="cuda", generator=gen),
             "h": torch.randn(2048, 2048, device="cuda",
                              generator=gen).bfloat16(),
             "step": torch.tensor(3.0)}
    want = {k: v.clone() for k, v in state.items()}
    if blocking:
        assert e.save_to_memory(1, state)
    else:
        assert e.save_to_memory_async(1, state)
    state["w"].add_(1.0)
    state["h"].mul_(2)
    state["step"].add_(1)
    assert e.wait_for_shm_save(timeout=120)
    # the copies went straight into the segment, registered with the card
    assert e.last_save_stats["registered"]
    assert e.last_save_stats["card_bytes"] == (1 << 28) + (2048 * 2048 * 2)
    restored, step = e.load(
        target={k: torch.zeros_like(v) for k, v in want.items()})
    assert step == 1
    for k, w in want.items():
        assert restored[k].device == w.device and torch.equal(restored[k], w)
    # a larger state re-creates the segment: its new mapping is
    # registered in place of the old one
    state["x"] = torch.randn(1 << 26, device="cuda", generator=gen)
    want = {k: v.clone() for k, v in state.items()}
    assert e.save_to_memory(2, state)
    assert e.last_save_stats["registered"]
    restored, step = e.load(
        target={k: torch.zeros_like(v) for k, v in want.items()})
    assert step == 2
    for k, w in want.items():
        assert torch.equal(restored[k], w)
    e.close()


def test_flash_checkpoint_true_no_longer_raises(tmp_path):
    t = make_trainer(tmp_path / "out", 1, save_steps=2)
    assert t._engine is not None and t.args.flash_checkpoint
    t.close()


# --------------------------------------------------- kill and resume

WORKER = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from dlrover_tpu_torch.models import LlamaConfig, llama_init, llama_loss_fn
from dlrover_tpu_torch.parallel import Strategy
from dlrover_tpu_torch.trainer import Trainer, TrainingArgs
from dlrover_tpu_torch.trainer.elastic import ElasticDataLoader, ElasticSampler

spec = json.loads(sys.argv[1])
cfg = LlamaConfig(**spec["config"])
N, BATCH, SEQ = spec["n"], spec["batch"], spec["seq"]

class TokenDataset:
    def __len__(self):
        return N
    def __getitem__(self, idx):
        return np.random.RandomState(idx).randint(0, 64, size=(SEQ,),
                                                  dtype=np.int32)

loader = ElasticDataLoader(
    TokenDataset(), BATCH, sampler=ElasticSampler(N, shuffle=True, seed=1),
    collate_fn=lambda rows: {"tokens": np.stack(rows)}, config_file="")
trainer = Trainer(
    llama_loss_fn(cfg), lambda s, d: llama_init(cfg, s, d), None,
    TrainingArgs(output_dir=spec["out"], max_steps=spec["steps"],
                 num_epochs=100, learning_rate=1e-2, save_steps=2,
                 save_storage_every=1, log_steps=0,
                 compute_dtype="float32", strategy=Strategy(remat="none")),
    train_data=loader, device="cpu")
losses = {}
inner = trainer._accel.train_step

def recording(state, batch, rng):
    state, metrics = inner(state, batch, rng)
    losses[state.step] = metrics["loss"].item()
    return state, metrics

trainer._accel.train_step = recording
save = trainer.save_checkpoint

def save_and_wait(persist=False):
    # a persist finishes before the next step: the next cadence save can
    # never find the saver busy
    ok = save(persist=persist)
    if ok and persist:
        assert trainer._engine.wait_for_persist(trainer.global_step, 60)
    return ok

trainer.save_checkpoint = save_and_wait
resume = trainer.maybe_resume
resumed = []
trainer.maybe_resume = lambda: resumed.append(resume()) or resumed[-1]
trainer.train()
trainer.close()
with open(spec["report"], "w") as f:
    json.dump({"resumed_from": resumed[0], "losses": losses}, f)
"""


def run_worker(tmp_path, out, steps, label, job, chaos=None):
    report = tmp_path / f"{label}.json"
    spec = {"config": SMALL, "n": N, "batch": BATCH, "seq": SEQ,
            "steps": steps, "out": str(out), "report": str(report)}
    env = dict(os.environ, PYTHONPATH=str(ROOT), ELASTIC_JOB_NAME=job)
    env.pop("DLROVER_CHAOS", None)
    if chaos is not None:
        env["DLROVER_CHAOS"] = json.dumps(chaos)
    proc = subprocess.run([sys.executable, "-c", WORKER, json.dumps(spec)],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    result = json.loads(report.read_text()) if report.exists() else None
    return proc, result


def test_kill_at_ckpt_save_then_resume_from_shm_and_storage(tmp_path,
                                                            _isolate):
    job = _isolate
    proc, ref = run_worker(tmp_path, tmp_path / "ref", 6, "ref",
                           job + "r")
    _unlink(job + "r")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert ref["resumed_from"] == 0 and len(ref["losses"]) == 6

    out = tmp_path / "run"
    kill = {"seed": 7, "rules": [{"site": "ckpt.save", "action": "kill",
                                  "step": 4}]}
    proc, result = run_worker(tmp_path, out, 6, "killed", job, chaos=kill)
    assert proc.returncode == 137, proc.stderr[-2000:]
    assert result is None
    assert "chaos[kill] at ckpt.save" in proc.stderr
    # storage holds step 2 (persisted); shm holds step 4 (saved, then the
    # kill before its persist was asked for)
    assert AsyncCheckpointSaver.get_latest_step(
        str(out / "checkpoints")) == 2
    shutil.copytree(out, tmp_path / "storage-only")

    proc, result = run_worker(tmp_path, out, 6, "from-shm", job)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert result["resumed_from"] == 4
    assert result["losses"] == {k: v for k, v in ref["losses"].items()
                                if int(k) > 4}

    _unlink(job)
    proc, result = run_worker(tmp_path, tmp_path / "storage-only", 6,
                              "from-storage", job)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert result["resumed_from"] == 2
    assert result["losses"] == {k: v for k, v in ref["losses"].items()
                                if int(k) > 2}


# ------------------------------------------- default paths and job names

TWIN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from dlrover_tpu_torch.common.ipc import job_name
from dlrover_tpu_torch.examples import llama_pretrain
from dlrover_tpu_torch.trainer import Trainer

inner, resumed = Trainer.maybe_resume, []

def maybe_resume(self):
    resumed.append(inner(self))
    return resumed[-1]

Trainer.maybe_resume = maybe_resume
t = llama_pretrain.main(sys.argv[1:], device="cpu")
print(json.dumps({"resumed_from": resumed[0], "step": t.global_step,
                  "job": job_name(), "out": t.args.output_dir}))
"""


def test_default_runs_in_different_temp_dirs_never_meet(tmp_path):
    """The twin with its defaults (no ELASTIC_JOB_NAME, no --output-dir)
    under two temp dirs: each run trains from step 0 into an output dir
    under its own temp dir and a segment named for it, and a rerun under
    the first temp dir resumes from that run's step, not the other's."""
    dirs = [tmp_path / "a", tmp_path / "b"]
    jobs = [trainer_mod.default_job_name(
        str(d / "dlrover_tpu_torch" / "llama_pretrain")) for d in dirs]

    def run(tmp, steps):
        env = dict(os.environ, PYTHONPATH=str(ROOT), TMPDIR=str(tmp))
        # the sockets stay in the fixture's short dir (a unix socket's
        # path is limited to 107 bytes)
        for key in ("ELASTIC_JOB_NAME", "DLROVER_CHAOS"):
            env.pop(key, None)
        proc = subprocess.run(
            [sys.executable, "-c", TWIN, "--preset", "tiny", "--steps",
             str(steps), "--batch-size", "2", "--seq-len", "16",
             "--save-steps", "1"],
            env=env, capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    try:
        for d in dirs:
            d.mkdir()
        first, second = run(dirs[0], 2), run(dirs[1], 2)
        again = run(dirs[0], 3)
    finally:
        for job in jobs:
            _unlink(job)
    assert [first["job"], second["job"], again["job"]] == [
        jobs[0], jobs[1], jobs[0]] and jobs[0] != jobs[1]
    for result, d in ((first, dirs[0]), (second, dirs[1]), (again, dirs[0])):
        assert result["out"] == str(d / "dlrover_tpu_torch" / "llama_pretrain")
    assert (first["resumed_from"], first["step"]) == (0, 2)
    assert (second["resumed_from"], second["step"]) == (0, 2)
    assert (again["resumed_from"], again["step"]) == (2, 3)


def test_trainer_names_its_job_for_its_output_dir(tmp_path, monkeypatch):
    """Without ELASTIC_JOB_NAME the segments carry a name derived from
    the resolved output dir; with it, the agent's name wins."""
    from dlrover_tpu_torch.agent.ckpt_saver import shm_name
    from dlrover_tpu_torch.common.ipc import set_default_job_name

    monkeypatch.delenv("ELASTIC_JOB_NAME")
    job = trainer_mod.default_job_name(str(tmp_path / "out"))
    try:
        t = make_trainer(tmp_path / "x" / ".." / "out", 1, flash=False)
        assert shm_name(0) == f"dlrtpu_torch_ckpt_{job}_0"
        assert timer_mod.ring_shm_name() == f"dlrtpu_torch_timer_{job}"
        monkeypatch.setenv("ELASTIC_JOB_NAME", "agentjob")
        assert shm_name(0) == "dlrtpu_torch_ckpt_agentjob_0"
        t.close()
    finally:
        _unlink(job)
        set_default_job_name(None)
