"""Parity of the port's Ulysses sequence parallelism
(``dlrover_tpu_torch.parallel.sequence.ulysses_attention`` and the
Llama's ``attn_impl="ulysses"``) with the JAX package's, on the CPU in
float32 from the same numpy inputs, with the in-process transport (4
ranks of the seq axis in this process); tests/test_torch_ulysses_gloo.py
runs the process-group transport.

JAX side: ``ulysses_attention`` in a shard_map over 4 virtual CPU
devices, and the Llama under a ``seq=4`` mesh, its flash kernel in
Pallas interpret mode, as tests/test_sequence_parallel.py runs them.
Port side: the wrappers' CPU route (the plain versions of K1-K4).

Tolerances: outputs, logits and losses within 1e-5 absolute; gradients
within 1e-5 relative to each tensor's largest entry; the train steps as
tests/test_torch_accelerate.py holds them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ring_gloo import _assert_params_close
from test_torch_ulysses_gloo import (
    UL_SMALL,
    assert_ulysses_close,
    port_ulysses,
    rel,
    train,
    ulysses_qkv,
)

from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
from dlrover_tpu.models.llama import llama_apply as jax_apply
from dlrover_tpu.models.llama import llama_init as jax_init
from dlrover_tpu.models.llama import llama_loss_fn as jax_loss_fn
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from dlrover_tpu.parallel.mesh import build_mesh as jax_build_mesh
from dlrover_tpu.parallel.mesh import set_mesh as jax_set_mesh
from dlrover_tpu_torch.models import (
    LlamaConfig,
    llama_apply,
    llama_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.parallel import (
    MeshConfig,
    build_mesh,
    set_mesh,
    ulysses_attention,
)
from dlrover_tpu_torch.parallel import mesh as port_mesh
from dlrover_tpu_torch.parallel import sequence as port_seq

N = 4  # ranks of the seq axis


@pytest.fixture(autouse=True)
def _restore_global_meshes(monkeypatch):
    """Both packages keep a process-global mesh; put each back after the
    test so other test files in this process see what they expect."""
    from dlrover_tpu.parallel import mesh as jax_mesh_mod

    monkeypatch.setattr(jax_mesh_mod, "_global_mesh",
                        jax_mesh_mod._global_mesh)
    monkeypatch.setattr(port_mesh, "_global_mesh", port_mesh._global_mesh)


def jax_ulysses(q, k, v, do, causal):
    """JAX ulysses_attention on 4 virtual devices: (out, (dq, dk, dv))."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from dlrover_tpu.parallel import get_shard_map
    from dlrover_tpu.parallel.sequence import ulysses_attention as jax_ul

    mesh = Mesh(np.array(jax.devices()[:N]), ("seq",))
    spec = P(None, None, "seq", None)
    fn = get_shard_map()(
        functools.partial(jax_ul, axis_name="seq", axis_size=N,
                          causal=causal, interpret=True),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    sharding = NamedSharding(mesh, spec)
    args = [jax.device_put(x, sharding) for x in (q, k, v)]
    with mesh:
        out = jax.jit(fn)(*args)
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * do),
                                 argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def small_params(**changes):
    """The JAX package's llama_init params of UL_SMALL, as numpy."""
    jc = JaxConfig(**dict(UL_SMALL, **changes))
    return jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))


# ---------------------------------------------------------------------------
# the attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [8, 4])
def test_ulysses_attention_matches_jax(causal, kv_heads):
    """4 in-process ranks against JAX's Ulysses on 4 virtual devices,
    forward and gradients, MHA and GQA."""
    q, k, v, do = ulysses_qkv(kvh=kv_heads)
    mesh = build_mesh(MeshConfig(seq=N))
    assert mesh.ring.kind == "in-process"
    assert_ulysses_close(port_ulysses(q, k, v, do, causal, mesh),
                         jax_ulysses(q, k, v, do, causal))


@pytest.mark.parametrize("heads,kv_heads", [(6, 6), (8, 2)],
                         ids=["q-heads", "kv-heads"])
def test_indivisible_heads_raise(heads, kv_heads):
    q, k, v, _ = ulysses_qkv(h=heads, kvh=kv_heads)
    mesh = build_mesh(MeshConfig(seq=N))
    with pytest.raises(ValueError, match="divisible by axis size"):
        ulysses_attention(*(torch.tensor(x) for x in (q, k, v)), mesh=mesh)


def test_ulysses_runs_one_flash_call_per_head_group(monkeypatch):
    """Each held rank runs ``flash_attention`` (K1-K4 on the card) once,
    over its head group and the whole sequence."""
    shapes = []
    flash = port_seq.flash_attention
    monkeypatch.setattr(port_seq, "flash_attention",
                        lambda q, *a, **kw: shapes.append(q.shape)
                        or flash(q, *a, **kw))
    q, k, v, do = ulysses_qkv(s=32)
    port_ulysses(q, k, v, do, True, build_mesh(MeshConfig(seq=N)))
    assert shapes == [(2, 8 // N, 32, 16)] * N


def test_ulysses_on_a_seq_axis_of_one_is_flash():
    from dlrover_tpu_torch.ops.attention import flash_attention

    q, k, v, do = ulysses_qkv()
    out, _ = port_ulysses(q, k, v, do, True, build_mesh(MeshConfig()))
    plain = flash_attention(*(torch.tensor(x) for x in (q, k, v)),
                            causal=True)
    np.testing.assert_array_equal(out, plain.numpy())


# ---------------------------------------------------------------------------
# the model and the train step
# ---------------------------------------------------------------------------


def test_llama_ulysses_seq4_loss_and_grads_match_jax():
    """Both packages under a seq=4 mesh with ``attn_impl="ulysses"``:
    rope outside at global positions, the all-to-all, flash over each
    head group; the loss and every gradient."""
    jc = JaxConfig(**UL_SMALL)
    j_params = jax_init(jc, jax.random.key(0))
    tokens = np.random.RandomState(1).randint(0, 64, (2, 33)).astype(np.int32)
    mesh = jax_build_mesh(JaxMeshConfig(seq=N), devices=jax.devices()[:N])
    jax_set_mesh(mesh)
    with mesh:
        j_loss, j_grads = jax.jit(jax.value_and_grad(
            lambda p, t: jax_loss_fn(jc)(p, {"tokens": t}, None)))(
            j_params, jnp.asarray(tokens))

    set_mesh(build_mesh(MeshConfig(seq=N)))
    params = {k: v.requires_grad_() for k, v in params_from_jax(
        jax.tree.map(np.asarray, j_params)).items()}
    loss = llama_loss_fn(LlamaConfig(**UL_SMALL))(
        params, {"tokens": torch.tensor(tokens)}, None)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) < 1e-5
    for name, g in params_from_jax(jax.tree.map(np.asarray,
                                                j_grads)).items():
        assert rel(params[name].grad, g) < 1e-5, name


def test_ulysses_without_a_seq_axis_is_plain_attention():
    """No seq axis: ``attn_impl="ulysses"`` runs the plain attention, as
    the JAX package falls through to ``mha_reference``: bit-equal to the
    port's "reference" model, within 1e-5 of JAX's ulysses logits."""
    p_np = small_params()
    tokens = np.random.RandomState(2).randint(0, 64, (2, 32)).astype(np.int32)
    jc = JaxConfig(**UL_SMALL)
    jax_set_mesh(jax_build_mesh(JaxMeshConfig(data=1),
                                devices=jax.devices()[:1]))
    j_logits = np.asarray(jax_apply(jc, jax.tree.map(jnp.asarray, p_np),
                                    jnp.asarray(tokens)))
    set_mesh(None)
    params = params_from_jax(p_np)
    ours = llama_apply(LlamaConfig(**UL_SMALL), params, torch.tensor(tokens))
    plain = llama_apply(LlamaConfig(**dict(UL_SMALL, attn_impl="reference")),
                        params, torch.tensor(tokens))
    assert torch.equal(ours, plain)
    np.testing.assert_allclose(ours.numpy(), j_logits, rtol=0, atol=1e-5)


def test_two_seq4_ulysses_steps_match_one_device_steps():
    """auto_accelerate with MeshConfig(seq=4) and Ulysses (4 in-process
    ranks) against the port's single-device steps of the same model."""
    p_np = small_params()
    _, ref_losses, ref_params = train(p_np, MeshConfig(),
                                      attn_impl="flash")
    res, losses, params = train(p_np, MeshConfig(seq=N))
    assert res.mesh.ring.kind == "in-process"
    np.testing.assert_allclose(losses, ref_losses, atol=1e-5)
    assert losses[1] < losses[0]
    _assert_params_close(params, ref_params)


def test_moe_llama_with_ulysses_seq4_matches_jax():
    """A MoE Llama under seq=4 with Ulysses, in process (the whole
    sequence routes here): loss and gradients against JAX's."""
    changes = dict(n_experts=4, moe_top_k=2, mlp_dim=32)
    jc = JaxConfig(**dict(UL_SMALL, **changes))
    j_params = jax_init(jc, jax.random.key(0))
    tokens = np.random.RandomState(3).randint(0, 64, (2, 33)).astype(np.int32)
    mesh = jax_build_mesh(JaxMeshConfig(seq=N), devices=jax.devices()[:N])
    jax_set_mesh(mesh)
    with mesh:
        j_loss, j_grads = jax.jit(jax.value_and_grad(
            lambda p, t: jax_loss_fn(jc)(p, {"tokens": t}, None)))(
            j_params, jnp.asarray(tokens))
    set_mesh(build_mesh(MeshConfig(seq=N)))
    tc = dataclasses.replace(LlamaConfig(**UL_SMALL), **changes)
    params = {k: v.requires_grad_() for k, v in params_from_jax(
        jax.tree.map(np.asarray, j_params)).items()}
    loss = llama_loss_fn(tc)(params, {"tokens": torch.tensor(tokens)}, None)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) < 1e-5
    for name, g in params_from_jax(jax.tree.map(np.asarray,
                                                j_grads)).items():
        assert rel(params[name].grad, g) < 1e-5, name
