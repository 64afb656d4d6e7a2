"""The port's ElasticTrainer and DevicePrefetcher on the CPU: the
accumulation arithmetic against the JAX package's for many (global,
micro, world) triples, ``wrap_step`` against JAX's ``wrap_step`` (its
``lax.scan`` fold) on the same data within 1e-6, the same update at
world sizes 1, 2 and 4 for a fixed global batch, and the prefetcher as
the CPU pass-through it is when the caller asks for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.trainer.elastic import ElasticTrainer as JaxElastic
from dlrover_tpu_torch.trainer.elastic import (
    DevicePrefetcher,
    ElasticTrainer,
)


@pytest.mark.parametrize("global_batch,micro", [(64, 4), (16, 2), (10, 3),
                                                (7, 7), (96, 8)])
def test_accum_math_matches_jax(global_batch, micro):
    t, j = ElasticTrainer(global_batch, micro), JaxElastic(global_batch,
                                                           micro)
    for world in (1, 2, 3, 4, 8, 16, 200):
        t.set_world_size(world)
        j.set_world_size(world)
        assert (t.world_size, t.accum_steps, t.local_batch_size) == (
            j.world_size, j.accum_steps, j.local_batch_size)
    t.set_world_size(0)
    assert t.world_size == 1


def test_accum_math():
    t = ElasticTrainer(global_batch_size=64, micro_batch_size=4,
                       world_size=4)
    assert t.accum_steps == 4 and t.local_batch_size == 16
    t.set_world_size(8)
    assert t.accum_steps == 2
    t.set_world_size(16)
    assert t.accum_steps == 1


def _mlp_data(n=16, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 8).astype(np.float32),
            rs.randn(n, 1).astype(np.float32),
            {"w1": (rs.randn(8, 6) * 0.3).astype(np.float32),
             "w2": (rs.randn(6, 1) * 0.3).astype(np.float32)})


def _jax_loss(params, batch):
    x, y = batch
    return jnp.mean((jnp.tanh(x @ params["w1"]) @ params["w2"] - y) ** 2)


def _torch_grad(params, batch):
    x, y = batch
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = ((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), dict(zip(p, grads))


@pytest.mark.parametrize("micro", [16, 8, 4, 2])
def test_wrap_step_matches_jax(micro):
    """Two steps of SGD with momentum through each package's wrap_step."""
    x, y, w = _mlp_data()
    j = JaxElastic(global_batch_size=16, micro_batch_size=micro)
    t = ElasticTrainer(global_batch_size=16, micro_batch_size=micro)
    assert t.accum_steps == j.accum_steps == 16 // micro

    def japply(params, opt, grads):
        opt = jax.tree.map(lambda m, g: 0.9 * m + g, opt, grads)
        return jax.tree.map(lambda p, m: p - 0.1 * m, params, opt), opt

    def tapply(params, opt, grads):
        opt = {k: 0.9 * opt[k] + grads[k] for k in opt}
        return {k: params[k] - 0.1 * opt[k] for k in params}, opt

    jstep = jax.jit(j.wrap_step(jax.value_and_grad(_jax_loss), japply))
    tstep = t.wrap_step(_torch_grad, tapply)
    jp, jo = {k: jnp.asarray(v) for k, v in w.items()}, {
        k: jnp.zeros(v.shape) for k, v in w.items()}
    tp, to = {k: torch.from_numpy(v.copy()) for k, v in w.items()}, {
        k: torch.zeros(v.shape) for k, v in w.items()}
    for _ in range(2):
        jp, jo, jloss = jstep(jp, jo, (jnp.asarray(x), jnp.asarray(y)))
        tp, to, tloss = tstep(tp, to, (torch.from_numpy(x),
                                       torch.from_numpy(y)))
        assert abs(float(tloss) - float(jloss)) <= 1e-6
        for k in w:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)


def test_accumulation_matches_the_full_batch():
    x, y, w = _mlp_data()
    t = ElasticTrainer(global_batch_size=16, micro_batch_size=4)
    params = {k: torch.from_numpy(v.copy()) for k, v in w.items()}
    step = t.wrap_step(_torch_grad, lambda p, o, g: (
        {k: p[k] - 0.1 * g[k] for k in p}, o))
    new, _, loss = step(params, None, (torch.from_numpy(x),
                                       torch.from_numpy(y)))
    full_loss, full_grad = _torch_grad(params, (torch.from_numpy(x),
                                                torch.from_numpy(y)))
    assert abs(float(loss) - float(full_loss)) <= 1e-6
    for k in params:
        torch.testing.assert_close(new[k], params[k] - 0.1 * full_grad[k],
                                   rtol=0, atol=1e-6)


def test_the_update_holds_across_world_sizes():
    """A fixed global batch of 8 at micro 2: one rank accumulating 4
    microbatches, two ranks 2 each and four ranks 1 each (ranks run in
    turn; their gradients averaged before the update) give one update."""
    x, y, w = _mlp_data(n=8, seed=1)
    results = []
    for world in (1, 2, 4):
        t = ElasticTrainer(global_batch_size=8, micro_batch_size=2,
                           world_size=world)
        assert t.accum_steps * world == 4
        local = t.local_batch_size
        params = {k: torch.from_numpy(v.copy()) for k, v in w.items()}
        taken = []
        step = t.wrap_step(_torch_grad,
                           lambda p, o, g: (taken.append(g) or p, o))
        losses = []
        for rank in range(world):
            rows = slice(rank * local, (rank + 1) * local)
            _, _, loss = step(params, None, (torch.from_numpy(x[rows]),
                                             torch.from_numpy(y[rows])))
            losses.append(loss)
        grads = {k: sum(g[k] for g in taken) / world for k in params}
        results.append((float(sum(losses) / world),
                        {k: params[k] - 0.1 * grads[k] for k in params}))
    for loss, new in results[1:]:
        assert abs(loss - results[0][0]) <= 1e-6
        for k in new:
            torch.testing.assert_close(new[k], results[0][1][k], rtol=0,
                                       atol=1e-6)


# ------------------------------------------------------------ prefetch


def test_prefetcher_yields_all_batches_on_the_cpu():
    ds = [np.ones((2, 2)) * i for i in range(5)]
    for depth in (1, 2, 8):
        out = list(DevicePrefetcher(iter(ds), device="cpu", depth=depth))
        assert len(out) == 5
        assert all(isinstance(o, torch.Tensor) for o in out)
        np.testing.assert_array_equal(out[3].numpy(), ds[3])


def test_prefetcher_keeps_the_tree_and_re_iterates():
    batches = [{"tokens": np.arange(6).reshape(2, 3) + i,
                "pair": (np.float32(i) * np.ones(2, np.float32), "tag"),
                "step": i} for i in range(4)]
    feed = DevicePrefetcher(batches, device="cpu")
    for _ in range(2):  # one iterator per epoch
        out = list(feed)
        assert [b["step"] for b in out] == [0, 1, 2, 3]
        for b, want in zip(out, batches):
            assert torch.equal(b["tokens"], torch.from_numpy(want["tokens"]))
            assert b["pair"][1] == "tag"
            assert isinstance(b["pair"], tuple)


def test_prefetcher_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        DevicePrefetcher([np.zeros(2)])
    with pytest.raises(RuntimeError, match="no CUDA"):
        DevicePrefetcher([np.zeros(2)], device="cuda")


def test_prefetcher_places_rows_on_a_device_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        ds = [np.ones((2, 4), dtype=np.float32)] * 3
        out = list(DevicePrefetcher(iter(ds), device="cpu",
                                    device_mesh=mesh))
        assert len(out) == 3
        assert isinstance(out[0], DTensor)
        assert out[0].placements == (Shard(0),)
        assert out[0].shape == (8, 4)
    finally:
        dist.destroy_process_group()
