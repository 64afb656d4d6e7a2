"""Ulysses over a process group: 4 gloo processes on the CPU join through
``init_distributed`` and run ``ulysses_attention`` on their sequence
shards (one ``all_to_all_single`` each way, parallel/mesh.py) and two
``auto_accelerate`` steps of a Llama with ``attn_impl="ulysses"`` under
``MeshConfig(seq=4)``. Each rank's output and gradient shards are held
against the JAX package's ``ulysses_attention`` on 4 virtual CPU
devices; its losses and params against the port's single-process steps
of the same model.

Each process is spawned and imports this module, so its top level
imports the port only; the JAX package is imported where a reference is
made, in the test's own process. The processes meet through a FileStore
in the test's ``tmp_path`` and are killed after ``GLOO_DEADLINE_S``. The
port-side helpers here are shared with tests/test_torch_ulysses.py (the
in-process transport), which holds the JAX reference.

Tolerances: outputs within 1e-5 absolute, gradients within 1e-5
relative to each tensor's largest entry (tests/test_torch_ulysses.py's);
the train steps as tests/test_torch_accelerate.py holds them.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist
from test_torch_ring_gloo import _assert_params_close

from dlrover_tpu_torch import trainer
from dlrover_tpu_torch.models import (
    LlamaConfig,
    llama_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.parallel import (
    MeshConfig,
    Strategy,
    auto_accelerate,
    build_mesh,
    set_mesh,
    ulysses_attention,
)
from dlrover_tpu_torch.parallel.accelerate import global_value
from dlrover_tpu_torch.trainer import build_optimizer

N = 4
GLOO_DEADLINE_S = 90
UL_SMALL = dict(
    vocab_size=64, dim=128, n_layers=2, n_heads=8, n_kv_heads=4, mlp_dim=96,
    max_seq_len=64, remat=False, dtype="float32", attn_block_q=16,
    attn_block_k=16, attn_impl="ulysses",
)
LR = 1e-2


def ulysses_qkv(b=2, h=8, kvh=4, s=32, d=16, seed=0):
    """q, k, v, do as numpy f32 [b, heads, s, d]."""
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, heads, s, d).astype(np.float32)
                 for heads in (h, kvh, kvh, h))


def port_ulysses(q, k, v, do, causal, mesh):
    """The port's ulysses_attention and its (dq, dk, dv) for loss
    sum(o * do), as numpy."""
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = ulysses_attention(*leaves, mesh=mesh, causal=causal)
    (out * torch.tensor(do)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_ulysses_close(port, ref):
    (p_out, p_grads), (j_out, j_grads) = port, ref
    np.testing.assert_allclose(p_out, j_out, rtol=0, atol=1e-5)
    for got, want in zip(p_grads, j_grads):
        assert rel(got, want) < 1e-5


def train(p_np, mesh_config, **changes):
    """Two adamw steps of UL_SMALL with ``changes`` through
    auto_accelerate on the CPU: (result, losses, params). The active
    mesh is cleared between building the step and running it: the step
    must run its own."""
    res = auto_accelerate(
        llama_loss_fn(LlamaConfig(**dict(UL_SMALL, **changes))),
        lambda seed, device: params_from_jax(p_np, device),
        build_optimizer("adamw", LR, weight_decay=0.0),
        Strategy(mesh=mesh_config, compute_dtype="float32", remat="none"),
        device="cpu")
    set_mesh(None)
    rng = np.random.RandomState(1)
    state, losses = res.state, []
    for _ in range(2):
        tokens = rng.randint(0, 64, (4, 33)).astype(np.int32)
        state, m = res.train_step(state, {"tokens": tokens}, None)
        losses.append(m["loss"].item())
    # over a process group the params are DTensors (replicated over seq)
    return res, losses, {k: global_value(v).detach()
                         for k, v in state.params.items()}


# (causal, kv heads): seed of the inputs
CASES = {(causal, kvh): seed for seed, (causal, kvh) in enumerate(
    [(True, 4), (False, 4), (True, 8)])}


def _gloo_worker(rank, store, out_dir, p_np):
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(N),
                       "DLROVER_JAX_COORDINATOR_ADDR": f"file://{store}"})
    torch.set_num_threads(1)
    assert trainer.init_distributed(device="cpu")
    try:
        mesh = build_mesh(MeshConfig(seq=N))
        assert mesh.ring.kind == "process-group"
        got = {}
        for (causal, kvh), seed in CASES.items():
            shard = [np.array(np.split(x, N, axis=2)[rank])
                     for x in ulysses_qkv(kvh=kvh, seed=seed)]
            got[causal, kvh] = port_ulysses(*shard, causal, mesh)
        _, losses, params = train(p_np, MeshConfig(seq=N))
        torch.save({"ulysses": got, "losses": losses, "params": params},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_ulysses_over_four_gloo_processes(tmp_path):
    """Each rank's output and gradient shards against JAX's Ulysses
    (causal and not, MHA and GQA), and two seq=4 Ulysses steps over the
    group against one process's steps of the same model."""
    import jax

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_init as jax_init
    from test_torch_ulysses import jax_ulysses

    p_np = jax.tree.map(np.asarray, jax_init(JaxConfig(**UL_SMALL),
                                             jax.random.key(0)))
    mp = torch.multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_gloo_worker,
                        args=(r, tmp_path / "store", str(tmp_path), p_np))
             for r in range(N)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + GLOO_DEADLINE_S
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [p.pid for p in procs if p.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    assert not hung, (f"gloo ranks {hung} still running after "
                      f"{GLOO_DEADLINE_S} s; killed")
    assert [p.exitcode for p in procs] == [0] * N

    _, ref_losses, ref_params = train(p_np, MeshConfig(), attn_impl="flash")
    saved = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(N)]
    for (causal, kvh), seed in CASES.items():
        q, k, v, do = ulysses_qkv(kvh=kvh, seed=seed)
        j_out, j_grads = jax_ulysses(q, k, v, do, causal)
        for rank, got in enumerate(saved):
            ref = (np.split(j_out, N, axis=2)[rank],
                   [np.split(g, N, axis=2)[rank] for g in j_grads])
            assert_ulysses_close(got["ulysses"][causal, kvh], ref)
    for got in saved:
        np.testing.assert_allclose(got["losses"], ref_losses, atol=1e-5)
        assert got["losses"][1] < got["losses"][0]
        _assert_params_close(got["params"], ref_params)
