"""The port's ``seq`` axis over a process group: 4 gloo processes on the
CPU join through ``init_distributed`` and run ``ring_attention`` on
their shards (the process-group transport of
``dlrover_tpu_torch.parallel.mesh``) and two ``auto_accelerate`` steps
under ``MeshConfig(seq=4)``. Each rank's output and gradient shards are
held against the JAX package's ``ring_attention`` on 4 virtual CPU
devices; its losses and params against the port's single-process steps.

Each process is spawned and imports this module, so its top level
imports the port only; the JAX package is imported where a reference is
made, in the test's own process. The processes meet through a FileStore
in the test's ``tmp_path`` (no TCP port: the suite runs under xdist),
and the test kills them and fails after ``GLOO_DEADLINE_S``. The helpers
here are shared with tests/test_torch_ring.py (the in-process transport).

Tolerances, as the JAX package's own ring tests: 2e-5 on outputs, 1e-4
on gradients; the train steps as tests/test_torch_accelerate.py.
"""

import functools
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch import trainer
from dlrover_tpu_torch.models import LlamaConfig, llama_loss_fn, params_from_jax
from dlrover_tpu_torch.parallel import (
    MeshConfig,
    Strategy,
    auto_accelerate,
    build_mesh,
    ring_attention,
    set_mesh,
)
from dlrover_tpu_torch.trainer import build_optimizer

N = 4  # ranks of the seq axis
SMALL = dict(
    vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=96,
    max_seq_len=64, remat=False, dtype="float32", attn_block_q=16,
    attn_block_k=16,
)
LR = 1e-2
GLOO_DEADLINE_S = 60


def _qkv(b=2, h=4, kvh=4, s=32, d=16, seed=0):
    """q, k, v, do as numpy f32 [b, heads, s, d]."""
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, heads, s, d).astype(np.float32)
                 for heads in (h, kvh, kvh, h))


def _jax_ring(q, k, v, do, causal):
    """JAX ring_attention on 4 virtual devices: (out, (dq, dk, dv))."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from dlrover_tpu.parallel import get_shard_map
    from dlrover_tpu.parallel.sequence import ring_attention as jax_ring

    mesh = Mesh(np.array(jax.devices()[:N]), ("seq",))
    spec = P(None, None, "seq", None)
    fn = get_shard_map()(
        functools.partial(jax_ring, axis_name="seq", axis_size=N,
                          causal=causal),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    sharding = NamedSharding(mesh, spec)
    args = [jax.device_put(x, sharding) for x in (q, k, v)]
    with mesh:
        out = jax.jit(fn)(*args)
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * do),
                                 argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_ring(q, k, v, do, causal, mesh):
    """The port's ring_attention and its (dq, dk, dv) for loss sum(o*do),
    as numpy."""
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = ring_attention(*leaves, mesh=mesh, causal=causal)
    (out * torch.tensor(do)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _assert_ring_close(port, ref):
    (p_out, p_grads), (j_out, j_grads) = port, ref
    np.testing.assert_allclose(p_out, j_out, rtol=2e-5, atol=2e-5)
    for got, want in zip(p_grads, j_grads):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _small_params():
    """The JAX package's llama_init params of SMALL, as numpy."""
    import jax

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_init as jax_init

    jc = JaxConfig(**dict(SMALL, attn_impl="flash"))
    return jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))


def _train(p_np, mesh_config):
    """Two adamw steps of the small Llama through auto_accelerate on the
    CPU: (result, losses, params). The active mesh is cleared between
    building the step and running it, as another auto_accelerate or a
    caller's set_mesh would replace it: the step must run its own."""
    res = auto_accelerate(
        llama_loss_fn(LlamaConfig(**SMALL)),
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
    return res, losses, {k: v.detach() for k, v in state.params.items()}


def _assert_params_close(params, ref):
    """Params after the steps, as tests/test_torch_accelerate.py holds
    them: Adam divides by sqrt(nu) + eps, so a 1e-7 relative difference
    in a gradient within a few orders of eps moves its update by a
    visible fraction of lr."""
    diffs = torch.cat([(params[k] - ref[k]).abs().flatten() for k in ref])
    assert diffs.median().item() < 1e-6
    assert diffs.quantile(0.99).item() < 2e-3 * LR
    assert diffs.max().item() < 0.25 * LR


def _gloo_worker(rank, store, out_dir, inputs, p_np):
    """One rank: joins through init_distributed, runs the ring on its
    shards (causal and not) and two seq=4 train steps, and saves what it
    got."""
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(N),
                       "DLROVER_JAX_COORDINATOR_ADDR": f"file://{store}"})
    torch.set_num_threads(1)
    assert trainer.init_distributed(device="cpu")
    try:
        mesh = build_mesh(MeshConfig(seq=N))
        assert mesh.ring.kind == "process-group" and mesh.ring.ranks == (rank,)
        got = {}
        for causal in (True, False):
            shard = [np.array(np.split(x, N, axis=2)[rank]) for x in inputs]
            got[causal] = _port_ring(*shard, causal, mesh)
        res, losses, params = _train(p_np, MeshConfig(seq=N))
        assert "process-group (gloo)" in res.strategy.describe(res.mesh)
        torch.save({"ring": got, "losses": losses, "params": params},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_ring_over_four_gloo_processes(tmp_path):
    """Each rank's output and gradient shards against JAX's ring, and the
    seq=4 train step over the group (labels across shard edges, the loss
    normalised by the global label count, the gradients summed over the
    group) against one process's steps."""
    inputs = _qkv(kvh=2, seed=5)
    p_np = _small_params()
    mp = torch.multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_gloo_worker,
                        args=(r, tmp_path / "store", str(tmp_path), inputs,
                              p_np)) for r in range(N)]
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

    _, ref_losses, ref_params = _train(p_np, MeshConfig())
    saved = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(N)]
    for causal in (True, False):
        j_out, j_grads = _jax_ring(*inputs, causal)
        for rank, got in enumerate(saved):
            ref = (np.split(j_out, N, axis=2)[rank],
                   [np.split(g, N, axis=2)[rank] for g in j_grads])
            _assert_ring_close(got["ring"][causal], ref)
    for got in saved:
        np.testing.assert_allclose(got["losses"], ref_losses, atol=1e-5)
        _assert_params_close(got["params"], ref_params)
