"""Parity of the port's ``Trainer`` with the JAX package's, on the CPU in
float32: the SMALL Llama config, the same weights (``params_from_jax``),
each package's own ``ElasticDataLoader`` over the same seeded token
dataset, ``flash_checkpoint=False``.

Over optimizers adamw and sgd and grad_accum 1 and 2 under the default
``Strategy()`` (remat "minimal"), and adamw and agd under remat "none", 4 steps
across an epoch boundary with ``log_steps=2``, both must agree on: the loss of
every step within 1e-5 (absolute), ``global_step`` and ``max_steps``
stopping, ``evaluate()`` within 1e-5, the runtime-metrics file reading
the last step, and the telemetry timeline (one ``compile`` event, then
``step.end`` events). Each option the port does not run yet raises
``NotImplementedError`` naming its ROADMAP item. (Flash Checkpoint in
the Trainer: tests/test_torch_trainer_ckpt.py.)
"""

import json

import jax
import numpy as np
import pytest
import torch

from dlrover_tpu.common import telemetry as jax_telemetry
from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
from dlrover_tpu.models.llama import llama_init as jax_init
from dlrover_tpu.models.llama import llama_logical_axes
from dlrover_tpu.models.llama import llama_loss_fn as jax_loss_fn
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.trainer.elastic import ElasticDataLoader as JaxLoader
from dlrover_tpu.trainer.elastic import ElasticSampler as JaxSampler
from dlrover_tpu.trainer.trainer import Trainer as JaxTrainer
from dlrover_tpu.trainer.trainer import TrainingArgs as JaxArgs
from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.models import (
    LlamaConfig,
    llama_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.parallel import Strategy
from dlrover_tpu_torch.trainer import Trainer, TrainingArgs
from dlrover_tpu_torch.trainer.elastic import (
    ElasticDataLoader,
    ElasticSampler,
)

SMALL = dict(
    vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=96,
    max_seq_len=64, attn_impl="flash", dtype="float32", attn_block_q=16,
    attn_block_k=16,
)
# 3 batches of 16 an epoch: 4 steps cross an epoch boundary. 16 rows
# split over the JAX package's 8 virtual CPU devices (its default mesh),
# also in 2 microbatches
N, BATCH, SEQ = 48, 16, 17
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small shapes gain nothing from many intra-op threads; two keep this
    file from crowding the timing-sensitive tests that run beside it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _isolate(isolated_ckpt_env, tmp_path, monkeypatch):
    """The JAX Trainer's shm isolation (tests/conftest.py) and the port's
    (its socket dir, saver singleton, checkpoint and step-timer segments
    of this job), no paral-config file, fresh telemetry registries, and
    both process-global meshes put back."""
    from dlrover_tpu.parallel import mesh
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.common.ipc import (
        SOCKET_DIR_ENV,
        PersistentSharedMemory,
    )
    from dlrover_tpu_torch.parallel import set_mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)
    monkeypatch.setenv("DLROVER_PARAL_CONFIG_PATH", "")
    monkeypatch.setenv(SOCKET_DIR_ENV, str(tmp_path / "port-socks"))
    monkeypatch.delenv(NodeEnv.RESHAPE_DIR, raising=False)
    AsyncCheckpointSaver.reset()
    prev = (telemetry.active_registry(), jax_telemetry.active_registry())
    telemetry.enable("port")
    jax_telemetry.enable("jax")
    yield
    telemetry._REGISTRY, jax_telemetry._REGISTRY = prev
    set_mesh(None)
    AsyncCheckpointSaver.reset()
    for name in (f"dlrtpu_torch_ckpt_{isolated_ckpt_env}_0",
                 f"dlrtpu_torch_timer_{isolated_ckpt_env}"):
        try:
            seg = PersistentSharedMemory(name=name)
        except FileNotFoundError:
            continue
        seg.close()
        seg.unlink()


class TokenDataset:
    def __len__(self):
        return N

    def __getitem__(self, idx):
        return np.random.RandomState(idx).randint(0, 64, size=(SEQ,),
                                                  dtype=np.int32)


def _collate(rows):
    return {"tokens": np.stack(rows)}


def _eval_batches():
    rng = np.random.RandomState(7)
    return [{"tokens": rng.randint(0, 64, (BATCH, SEQ)).astype(np.int32)}
            for _ in range(2)]


def _record_losses(trainer):
    """Wrap the trainer's train step to keep each step's loss."""
    losses, step = [], trainer._accel.train_step

    def recording(state, batch, rng):
        state, metrics = step(state, batch, rng)
        losses.append(float(metrics["loss"]))
        return state, metrics

    trainer._accel.train_step = recording
    return losses


def _run_jax(tmp_path, monkeypatch, optimizer, grad_accum, remat):
    jc = JaxConfig(**SMALL)
    loader = JaxLoader(TokenDataset(), BATCH,
                       sampler=JaxSampler(N, shuffle=True, seed=1),
                       collate_fn=_collate, config_file="")
    strategy = None if remat == "minimal" else JaxStrategy(remat=remat)
    trainer = JaxTrainer(
        jax_loss_fn(jc), lambda r: jax_init(jc, r), llama_logical_axes(jc),
        JaxArgs(output_dir=str(tmp_path / "jax"), max_steps=STEPS,
                num_epochs=5, learning_rate=1e-2, optimizer=optimizer,
                grad_accum=grad_accum, compute_dtype="float32",
                strategy=strategy, flash_checkpoint=False, log_steps=2),
        train_data=loader, eval_data=_eval_batches())
    params = jax.tree.map(np.asarray, trainer.state.params)
    losses = _record_losses(trainer)
    monkeypatch.setenv("DLROVER_RUNTIME_METRICS_PATH",
                       str(tmp_path / "jax_metrics.json"))
    trainer.train()
    return trainer, params, losses


def _run_port(tmp_path, monkeypatch, params, optimizer, grad_accum, remat):
    loader = ElasticDataLoader(TokenDataset(), BATCH,
                               sampler=ElasticSampler(N, shuffle=True,
                                                      seed=1),
                               collate_fn=_collate, config_file="")
    strategy = None if remat == "minimal" else Strategy(remat=remat)
    trainer = Trainer(
        llama_loss_fn(LlamaConfig(**SMALL)),
        lambda seed, device: params_from_jax(params, device), None,
        TrainingArgs(output_dir=str(tmp_path / "port"), max_steps=STEPS,
                     num_epochs=5, learning_rate=1e-2, optimizer=optimizer,
                     grad_accum=grad_accum, compute_dtype="float32",
                     strategy=strategy, flash_checkpoint=False,
                     log_steps=2),
        train_data=loader, eval_data=_eval_batches(), device="cpu")
    losses = _record_losses(trainer)
    monkeypatch.setenv("DLROVER_RUNTIME_METRICS_PATH",
                       str(tmp_path / "port_metrics.json"))
    trainer.train()
    return trainer, losses


def _step_events(snapshot):
    return [(e["kind"], e["step"]) for e in snapshot["events"]
            if e["kind"] in ("compile", "step.end")]


@pytest.mark.parametrize("optimizer,grad_accum,remat", [
    ("adamw", 1, "minimal"), ("adamw", 2, "minimal"), ("sgd", 1, "minimal"),
    ("sgd", 2, "minimal"), ("adamw", 1, "none"), ("agd", 1, "none"),
])
def test_trainer_matches_jax(tmp_path, monkeypatch, optimizer, grad_accum,
                             remat):
    j_trainer, params, j_losses = _run_jax(tmp_path, monkeypatch, optimizer,
                                           grad_accum, remat)
    t_trainer, t_losses = _run_port(tmp_path, monkeypatch, params, optimizer,
                                    grad_accum, remat)
    assert t_trainer._accel.strategy.remat == remat
    assert len(t_losses) == len(j_losses) == STEPS
    np.testing.assert_allclose(t_losses, j_losses, atol=1e-5)
    # max_steps stopped both inside the second epoch
    assert t_trainer.global_step == j_trainer.global_step == STEPS
    assert t_trainer.train_data.sampler.epoch == \
        j_trainer.train_data.sampler.epoch == 1
    np.testing.assert_allclose(t_trainer.evaluate(), j_trainer.evaluate(),
                               atol=1e-5)
    for name in ("jax", "port"):
        with open(tmp_path / f"{name}_metrics.json") as f:
            assert json.load(f)["step"] == STEPS
    want = [("compile", 1)] + [("step.end", s) for s in range(2, STEPS + 1)]
    assert _step_events(telemetry.snapshot()) == want
    assert _step_events(jax_telemetry.snapshot()) == want
    gauges = {g["name"] for g in telemetry.snapshot()["gauges"]}
    assert {"train.step.last_s", "train.steps_per_s", "train.tokens_per_s",
            "train.mfu"} <= gauges
    assert [h["name"] for h in telemetry.snapshot()["histograms"]] == [
        "train.step.seconds"]


def test_default_args_train_on_the_cpu_and_need_a_device(monkeypatch,
                                                         tmp_path):
    """TrainingArgs(flash_checkpoint=False) with the default Strategy()
    (remat "minimal", bf16) trains with device="cpu"; with no device and
    no GPU the Trainer raises."""
    loader = ElasticDataLoader(TokenDataset(), BATCH, collate_fn=_collate,
                               config_file="")
    cfg = LlamaConfig(**dict(SMALL, dtype="bfloat16"))
    from dlrover_tpu_torch.models import llama_init

    def make(device):
        return Trainer(llama_loss_fn(cfg),
                       lambda s, d: llama_init(cfg, s, d), None,
                       TrainingArgs(flash_checkpoint=False, max_steps=3,
                                    log_steps=1),
                       train_data=loader, device=device)

    monkeypatch.setenv("DLROVER_RUNTIME_METRICS_PATH",
                       str(tmp_path / "metrics.json"))
    trainer = make("cpu")
    assert trainer._accel.strategy.remat == "minimal"
    assert trainer._accel.strategy.compute_dtype == "bfloat16"
    _, metrics = trainer.train()
    assert trainer.global_step == 3 and torch.isfinite(metrics["loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        make(None)


def _tiny_trainer(args, **kw):
    cfg = LlamaConfig(**SMALL)
    from dlrover_tpu_torch.models import llama_init

    return Trainer(llama_loss_fn(cfg), lambda s, d: llama_init(cfg, s, d),
                   None, args, train_data=[], device="cpu", **kw)


@pytest.mark.parametrize("args,kw,item", [
    (TrainingArgs(flash_checkpoint=False, profile=True), {}, None),
    (TrainingArgs(flash_checkpoint=False), {"reshape_channel": object()}, 8),
], ids=["profile", "reshape_channel"])
def test_unported_options_raise(args, kw, item):
    """``profile=True`` raised naming ROADMAP item 12 until the profiling
    plane was ported: it now builds the step profiler beside the
    always-on sampler. The reshape channel still raises naming item 8."""
    if item is None:
        trainer = _tiny_trainer(args, **kw)
        assert trainer._profiler is not None and trainer._prof is not None
        trainer.close()
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 item {item}"):
        _tiny_trainer(args, **kw)


def test_default_args_name_the_flash_checkpoint_way_out(tmp_path):
    """The default ``TrainingArgs()`` (``flash_checkpoint=True``), which
    raised until Flash Checkpoint was ported, builds the Trainer with its
    checkpoint engine under ``output_dir``; ``flash_checkpoint=False`` is
    the way out of checkpointing."""
    trainer = _tiny_trainer(TrainingArgs(output_dir=str(tmp_path)))
    assert trainer._engine.checkpoint_dir == str(tmp_path / "checkpoints")
    trainer.close()
    assert _tiny_trainer(TrainingArgs(flash_checkpoint=False))._engine is None


def test_reshape_dir_and_checkpoint_calls_raise(monkeypatch, tmp_path):
    """The reshape channel the agent offers every worker
    (``NodeEnv.RESHAPE_DIR``) is declined: the Trainer builds but never
    marks the channel ready, so the agent keeps the restart path; an
    explicit ``reshape_channel`` raises (item 8)."""
    from dlrover_tpu_torch.trainer.elastic.reshape import ReshapeChannel

    monkeypatch.setenv(NodeEnv.RESHAPE_DIR, str(tmp_path))
    _tiny_trainer(TrainingArgs(flash_checkpoint=False))
    channel = ReshapeChannel(str(tmp_path))
    assert not channel.worker_ready()
    with pytest.raises(NotImplementedError, match="item 8"):
        _tiny_trainer(TrainingArgs(flash_checkpoint=False),
                      reshape_channel=channel)
    monkeypatch.delenv(NodeEnv.RESHAPE_DIR)
    # with checkpointing off, as in the JAX Trainer: nothing to restore,
    # and a save is refused
    trainer = _tiny_trainer(TrainingArgs(flash_checkpoint=False))
    assert trainer.maybe_resume() == 0
    assert trainer.save_checkpoint() is False


def test_prestep_runs_before_every_step_and_eval(tmp_path, monkeypatch):
    """The prestep hook sees every train batch, and eval batches with
    count=False where it takes a count."""
    monkeypatch.setenv("DLROVER_RUNTIME_METRICS_PATH",
                       str(tmp_path / "metrics.json"))
    seen = []

    def prestep(state, batch, count=True):
        seen.append((state.step, count))
        return state, batch

    loader = ElasticDataLoader(TokenDataset(), BATCH, collate_fn=_collate,
                               config_file="")
    cfg = LlamaConfig(**SMALL)
    from dlrover_tpu_torch.models import llama_init

    trainer = Trainer(llama_loss_fn(cfg), lambda s, d: llama_init(cfg, s, d),
                      None, TrainingArgs(flash_checkpoint=False, max_steps=2,
                                         compute_dtype="float32"),
                      train_data=loader, eval_data=_eval_batches(),
                      prestep=prestep, device="cpu")
    trainer.train()
    assert seen == [(0, True), (1, True)]
    assert np.isfinite(trainer.evaluate())
    assert seen[2:] == [(2, False), (2, False)]


def test_batch_tokens_reads_shapes_only():
    ids = np.zeros((4, 9), np.int32)
    assert Trainer._batch_tokens({"tokens": ids}) == 36
    assert Trainer._batch_tokens({"x": np.zeros((4, 9), np.float32),
                                  "y": torch.zeros(2, 3, dtype=torch.long)}
                                 ) == 6
    assert Trainer._batch_tokens((np.zeros((3,)), torch.zeros(2, 2))) == 0


def test_the_example_twin_trains_on_the_cpu(monkeypatch, tmp_path):
    """The twin of examples/llama_pretrain.py, on the "tiny" preset: the
    same chain (auto_strategy, the elastic loader, Trainer.train)."""
    from dlrover_tpu_torch.examples import llama_pretrain

    metrics = tmp_path / "metrics.json"
    monkeypatch.setenv("DLROVER_RUNTIME_METRICS_PATH", str(metrics))
    trainer = llama_pretrain.main(
        ["--preset", "tiny", "--steps", "3", "--batch-size", "2",
         "--seq-len", "16", "--output-dir", str(tmp_path / "out")],
        device="cpu")
    assert trainer.global_step == 3
    assert trainer._accel.strategy.remat == "none"
    assert json.loads(metrics.read_text())["step"] == 3


def test_the_example_twin_trains_with_agd_on_the_cpu(monkeypatch,
                                                     tmp_path):
    """``--optimizer agd``, the example's last choice, through the same
    chain: the Trainer steps AGD, and its state rides the checkpoint."""
    from dlrover_tpu_torch.examples import llama_pretrain
    from dlrover_tpu_torch.optimizers import AGD

    monkeypatch.setenv("DLROVER_RUNTIME_METRICS_PATH",
                       str(tmp_path / "metrics.json"))
    trainer = llama_pretrain.main(
        ["--preset", "tiny", "--steps", "3", "--batch-size", "2",
         "--seq-len", "16", "--optimizer", "agd", "--save-steps", "2",
         "--output-dir", str(tmp_path / "out")],
        device="cpu")
    assert trainer.global_step == 3
    opt = trainer.state.optimizer
    assert isinstance(opt, AGD) and opt.state["count"] == 3
    tree = trainer._state_tree()["opt"]
    assert int(tree["extra"]["count"]) == 3
    assert set(tree["state"]) == set(trainer.state.params)
