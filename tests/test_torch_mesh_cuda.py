"""The data, fsdp and tensor mesh axes over NCCL across cards: the
4-rank accelerate case of tests/test_torch_mesh_gloo.py on four cards, one
process per card, through the hand-written kernels (bf16 compute over
f32 masters). Each mesh's three adamw steps against the same steps in
one process on one card, unsharded: losses within 1e-2 relative (bf16:
the sharded step sums gradients over the ranks in another order, and
the reduce-scatter of the gathered bf16 weights sums in bf16). On
``fsdp=4`` also: ``fused_adamw`` bits 32 and 8 (K7 and K8, one launch a
step on each rank, over the gathered whole grads) against the same
optimizer on one card, within 1e-2 relative; and adamw under
``overlap_collectives`` "xla" and "manual" against "off" on the same
mesh: "xla" issues the same NCCL collectives earlier (within 1e-5
relative), "manual" sums its ring reduce-scatter of bf16 gradients in
the ring's order (within 1e-2 relative). The seq axis beside data and
fsdp (``data=2, seq=2`` and ``fsdp=2, seq=2``: the ring's K12-K14 over
the DeviceMesh's seq sub-group, at head_dim 128) against one card's
``MeshConfig(data=1, fsdp=-1, seq=2)`` (the two seq ranks in process)
on the same global batch, within 1e-2 relative; and ``search_strategy``
(``search_algo="bo"``, 3 dry-runs, the cards' memory) on the 4 ranks,
which must return one ``Strategy`` on every rank.

Needs four cards; skips with that reason otherwise. One more case needs
one card: a gloo group (a DeviceMesh on the CPU) under a step on the
card raises, naming the backend. Run on a machine with four:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dlrover_tpu_torch.models import (
    LlamaConfig,
    llama_init,
    llama_logical_axes,
    llama_loss_fn,
)
from dlrover_tpu_torch.ops import fused_optim
from dlrover_tpu_torch.ops.fused_optim import fused_adamw
from dlrover_tpu_torch.parallel import (
    MeshConfig,
    Strategy,
    auto_accelerate,
    search_strategy,
)
from dlrover_tpu_torch.parallel.mesh import batch_place
from dlrover_tpu_torch.trainer import build_optimizer

pytestmark = pytest.mark.cuda

N = 4
DEADLINE_S = 420
# head_dim 64: K1-K4's; 4 q heads over 2 kv heads split by a tensor of 2
CFG = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                  n_kv_heads=2, mlp_dim=512, max_seq_len=256, remat=False)
MESHES = {
    "data4": dict(),
    "fsdp4": dict(data=1, fsdp=4),
    "fsdp2-tensor2": dict(data=1, fsdp=2, tensor=2),
    "data2-tensor2": dict(data=2, tensor=2),
}
# head_dim 128: the ring kernels' (K12-K14)
SEQ_CFG = LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, mlp_dim=1024, max_seq_len=256,
                      remat=False)
SEQ_MESHES = {
    "data2-seq2": dict(data=2, seq=2),
    "fsdp2-seq2": dict(data=1, fsdp=2, seq=2),
}


def _batches():
    rng = np.random.RandomState(1)
    return [rng.randint(0, CFG.vocab_size, (8, 129)).astype(np.int64)
            for _ in range(3)]


# the optimizer of each fused case, and its kernel
FUSED = {"fused_adamw32": lambda: fused_adamw(1e-3),
         "fused_adamw8": lambda: fused_adamw(1e-3, bits=8)}
OVERLAP = ("off", "xla", "manual")


def _losses(config, axes, optimizer=None, cfg=CFG, **strategy):
    res = auto_accelerate(
        llama_loss_fn(cfg), lambda s, d: llama_init(cfg, 0, d),
        optimizer or build_optimizer("adamw", 1e-3),
        Strategy(mesh=config, remat="none", **strategy),
        device="cuda", param_logical_axes=axes)
    index, count = batch_place(config)
    state, out = res.state, []
    for tokens in _batches():
        state, m = res.train_step(
            state, {"tokens": np.split(tokens, count)[index]}, None)
        out.append(m["loss"].item())
    return out


def _worker(rank, store, out_dir):
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=N)
    try:
        axes = llama_logical_axes(CFG)
        got = {name: _losses(MeshConfig(**kw), axes)
               for name, kw in MESHES.items()}
        fsdp4 = MeshConfig(**MESHES["fsdp4"])
        for name, make in FUSED.items():
            kernel = getattr(fused_optim, name)
            kernel.launches = 0
            got[name] = (_losses(fsdp4, axes, make()), kernel.launches)
        for mode in OVERLAP:
            got["overlap", mode] = _losses(fsdp4, axes,
                                           overlap_collectives=mode)
        for name, kw in SEQ_MESHES.items():
            got[name] = _losses(MeshConfig(**kw), llama_logical_axes(SEQ_CFG),
                                cfg=SEQ_CFG)
        got["search"] = search_strategy(
            llama_loss_fn(SEQ_CFG), lambda s, d: llama_init(SEQ_CFG, s, d),
            build_optimizer("adamw", 1e-3), llama_logical_axes(SEQ_CFG),
            lambda: {"tokens": _batches()[0]}, search_algo="bo",
            max_dryruns=3).to_json()
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def nccl_run(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < N:
        pytest.skip(f"needs {N} CUDA devices, this machine has "
                    f"{torch.cuda.device_count()}")
    tmp = tmp_path_factory.mktemp("mesh_cuda")
    mp = torch.multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_worker, args=(r, str(tmp / "store"),
                                             str(tmp))) for r in range(N)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + DEADLINE_S
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [p.pid for p in procs if p.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    assert not hung, f"NCCL ranks {hung} still running; killed"
    assert [p.exitcode for p in procs] == [0] * N
    ref = {"adamw": _losses(MeshConfig(), None)}
    ref.update({name: _losses(MeshConfig(), None, make())
                for name, make in FUSED.items()})
    ref["seq2"] = _losses(MeshConfig(data=1, fsdp=-1, seq=2), None,
                          cfg=SEQ_CFG)
    return ref, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(N)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_nccl_mesh_matches_one_card(nccl_run, mesh_name):
    ref, saved = nccl_run
    for got in saved:
        np.testing.assert_allclose(got[mesh_name], ref["adamw"], rtol=1e-2)


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_adamw_on_four_cards_matches_one_card(nccl_run, name):
    ref, saved = nccl_run
    for got in saved:
        losses, launches = got[name]
        np.testing.assert_allclose(losses, ref[name], rtol=1e-2)
        assert launches == len(_batches())


@pytest.mark.parametrize("mode", ["xla", "manual"])
def test_overlap_on_four_cards_matches_off(nccl_run, mode):
    _, saved = nccl_run
    for got in saved:
        off = got["overlap", "off"]
        np.testing.assert_allclose(got["overlap", mode], off,
                                   rtol=1e-5 if mode == "xla" else 1e-2)


@pytest.mark.parametrize("mesh_name", list(SEQ_MESHES))
def test_seq_beside_data_and_fsdp_matches_one_card(nccl_run, mesh_name):
    ref, saved = nccl_run
    for got in saved:
        np.testing.assert_allclose(got[mesh_name], ref["seq2"], rtol=1e-2)


def test_search_on_four_cards_agrees(nccl_run):
    _, saved = nccl_run
    picks = {got["search"] for got in saved}
    assert len(picks) == 1
    m = Strategy.from_json(picks.pop()).mesh
    assert m.data * m.fsdp * m.tensor * m.seq * m.pipe * m.expert == N


def test_gloo_mesh_under_a_cuda_step_raises(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="NCCL for cuda"):
            auto_accelerate(
                llama_loss_fn(CFG), lambda s, d: llama_init(CFG, 0, d),
                build_optimizer("adamw", 1e-3),
                Strategy(mesh=MeshConfig(data=1, fsdp=-1), remat="none"),
                device="cuda", param_logical_axes=llama_logical_axes(CFG))
    finally:
        dist.destroy_process_group()
