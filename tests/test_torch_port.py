"""Boundaries of the PyTorch port: device resolution never drops to the
CPU on its own, the port imports neither jax nor the JAX package, and
its accounting uses the H100's peak."""

import ast
import pathlib

import pytest
import torch

from dlrover_tpu_torch import device as port_device
from dlrover_tpu_torch.common import mfu
from dlrover_tpu_torch.models import LlamaConfig, llama_init
from dlrover_tpu_torch.parallel import Strategy, auto_accelerate
from dlrover_tpu_torch.trainer import build_optimizer

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA"):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    cfg = LlamaConfig(vocab_size=32, dim=32, n_layers=1, n_heads=2,
                      n_kv_heads=2, mlp_dim=32, dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA"):
        llama_init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA"):
        auto_accelerate(lambda p, b, r: 0, lambda s, d: {},
                        build_optimizer("sgd"), Strategy(remat="none"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


# calls that take a path, and whose string arguments are path parts
_PATH_CALLS = {"join", "Path", "PurePath", "open", "CDLL", "LoadLibrary",
               "exists", "isdir", "isfile", "listdir", "getmtime", "stat",
               "memmap", "fromfile", "load"}


def _path_parts(path):
    """String constants the module builds paths from: the arguments of
    path calls and the operands of ``/``, split into components."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else getattr(
                func, "id", "")
            operands = node.args if name in _PATH_CALLS else []
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            operands = [node.left, node.right]
        else:
            continue
        for arg in operands:
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield from arg.value.replace("\\", "/").split("/")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Nor does it read the JAX package's files: no port module builds a
    path through the repo's ``native/`` or ``dlrover_tpu/``, and the
    port's native library is built from its own copy of the source into
    its own directory."""
    files = sorted((ROOT / "dlrover_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    # the control plane's, the serving arm's and the RL stack's modules
    # are among them
    for rel in ("agent/training_agent.py", "agent/probe.py",
                "master/servicer.py", "master/main.py", "trainer/run.py",
                "serving/engine.py", "serving/scheduler.py",
                "serving/worker.py", "serving/loadgen.py",
                "serving/manager.py", "rl/generation.py",
                "rl/ppo_utils.py", "rl/replay_buffer.py",
                "rl/model_engine.py", "rl/ppo_trainer.py",
                "examples/ppo_rlhf.py"):
        assert ROOT / "dlrover_tpu_torch" / rel in files
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "dlrover_tpu"), f"{path}: imports {mod}"
        parts = set(_path_parts(path))
        assert not parts & {"native", "dlrover_tpu"}, (
            f"{path}: builds a path through {parts & {'native', 'dlrover_tpu'}}")
    from dlrover_tpu_torch import native as port_native

    own = ROOT / "dlrover_tpu_torch" / "native"
    assert pathlib.Path(port_native._SRC_DIR) == own
    assert (own / "dlrtpu.cc").is_file()
    assert pathlib.Path(port_native._LIB_PATH).parent == own / "build"


def test_mfu_uses_the_h100_bf16_peak(monkeypatch):
    monkeypatch.delenv(mfu.PEAK_FLOPS_ENV, raising=False)
    assert mfu.peak_flops() == 989e12
    monkeypatch.setenv(mfu.PEAK_FLOPS_ENV, "5e14")
    assert mfu.peak_flops() == 5e14
    monkeypatch.setenv(mfu.PEAK_FLOPS_ENV, "989 TFLOP/s")
    with pytest.raises(ValueError, match=mfu.PEAK_FLOPS_ENV):
        mfu.peak_flops()
    flops = mfu.transformer_step_flops(1000, 10, n_layers=2, dim=4, seq=10)
    assert flops == 6.0 * 1000 * 10 + 12.0 * 2 * 4 * 10 * 10 / 2
    assert mfu.mfu(flops, 1.0, peak=flops) == 1.0
