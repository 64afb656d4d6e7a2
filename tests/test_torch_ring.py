"""Parity of the port's ring attention with the JAX package's, on the CPU
in float32 from the same numpy inputs: the ring-block plain versions
(``dlrover_tpu_torch.ops.attention``), ``ring_attention`` over a ``seq``
axis of 4 ranks (``dlrover_tpu_torch.parallel``), the Llama logits and
two ``auto_accelerate`` steps under ``MeshConfig(seq=4)``.

JAX side: ``ring_fwd_block``/``ring_dq_block``/``ring_dkv_block`` in
Pallas interpret mode with 16-row blocks, and ``ring_attention`` /
``llama_apply`` under a 4-device mesh of virtual CPU devices, as
tests/test_sequence_parallel.py runs them. Port side: the wrappers' CPU
route (the plain versions) and the in-process transport (4 ranks in this
process); tests/test_torch_ring_gloo.py runs the process-group transport
(4 gloo processes) and holds the helpers both files use.

Tolerances, as the JAX package's own ring tests: 2e-5 on o and lse,
1e-4 on gradients (relative to the largest entry for the blocks), 2e-4
on the Llama logits; the train steps as tests/test_torch_accelerate.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_ring_gloo import (
    N,
    SMALL,
    _assert_params_close,
    _assert_ring_close,
    _jax_ring,
    _port_ring,
    _qkv,
    _small_params,
    _train,
)

from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
from dlrover_tpu.models.llama import llama_apply as jax_apply
from dlrover_tpu.models.llama import llama_init as jax_init
from dlrover_tpu.ops import attention as jax_att
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from dlrover_tpu.parallel.mesh import build_mesh as jax_build_mesh
from dlrover_tpu.parallel.mesh import set_mesh as jax_set_mesh
from dlrover_tpu_torch import trainer
from dlrover_tpu_torch.models import LlamaConfig, llama_apply, params_from_jax
from dlrover_tpu_torch.ops import attention as port_att
from dlrover_tpu_torch.parallel import (
    MeshConfig,
    build_mesh,
    ring_attention,
    sequence_sharded_attention,
    set_mesh,
)
from dlrover_tpu_torch.parallel import mesh as port_mesh
from dlrover_tpu_torch.parallel import sequence as port_seq


@pytest.fixture(autouse=True)
def _restore_global_meshes(monkeypatch):
    """Both packages keep a process-global mesh; put each back after the
    test so other test files in this process see what they expect."""
    from dlrover_tpu.parallel import mesh as jax_mesh_mod

    monkeypatch.setattr(jax_mesh_mod, "_global_mesh",
                        jax_mesh_mod._global_mesh)
    monkeypatch.setattr(port_mesh, "_global_mesh", port_mesh._global_mesh)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# one ring block
# ---------------------------------------------------------------------------

# name: (B, H, KVH, shard length); D = 16, JAX blocks of 16 rows
BLOCK_CASES = {"gqa": (1, 4, 2, 32), "ragged": (2, 4, 2, 24)}
# the q shard of rank 1 against the kv shard of rank 1, 0 and 2
RELATIONS = {"diagonal": 1, "visible": 0, "future": 2}


@pytest.mark.parametrize("relation", sorted(RELATIONS))
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_ring_blocks_match_jax(case, relation):
    B, H, KVH, S = BLOCK_CASES[case]
    q, k, v, do = _qkv(B, H, KVH, S, seed=1)
    rng = np.random.RandomState(2)
    lse = (rng.randn(B, H, S) + 3).astype(np.float32)
    delta = rng.randn(B, H, S).astype(np.float32)
    q_start, k_start, scale = S, RELATIONS[relation] * S, 16 ** -0.5
    blocks = dict(block_q=16, block_k=16)

    j_o, j_lse = jax_att.ring_fwd_block(q, k, v, q_start, k_start, scale,
                                        **blocks)
    wide = [np.broadcast_to(x[..., None], x.shape + (jax_att.STATS_W,))
            for x in (lse, delta)]
    j_dq = jax_att.ring_dq_block(q, k, v, do, *wide, q_start, k_start, scale,
                                 **blocks)
    j_dk, j_dv = jax_att.ring_dkv_block(q, k, v, do, *wide, q_start, k_start,
                                        scale, **blocks)

    t = [torch.tensor(x) for x in (q, k, v, do, lse, delta)]
    t_o, t_lse = port_att.flash_ring_fwd(*t[:3], q_start, k_start, scale)
    args = (*t, q_start, k_start, scale)
    t_dq = port_att.flash_ring_dq(*args)
    t_dk, t_dv = port_att.flash_ring_dkv(*args)

    np.testing.assert_allclose(t_o.numpy(), np.asarray(j_o), atol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[..., 0],
                               atol=2e-5, rtol=0)
    for got, want in ((t_dq, j_dq), (t_dk, j_dk), (t_dv, j_dv)):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        if relation == "future":
            assert not want.any() and not got.any()
        else:
            assert _rel(got.numpy(), want) < 1e-4
    if relation == "future":
        assert torch.all(t_o == 0)
        assert torch.all(t_lse == port_att.NEG_INF)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_ring_attention_matches_jax(causal, kv_heads):
    """4 in-process ranks against JAX's ring on 4 virtual devices."""
    q, k, v, do = _qkv(kvh=kv_heads)
    mesh = build_mesh(MeshConfig(seq=N))
    assert mesh.ring.kind == "in-process" and mesh.ring.ranks == (0, 1, 2, 3)
    _assert_ring_close(_port_ring(q, k, v, do, causal, mesh),
                       _jax_ring(q, k, v, do, causal))


def test_causal_ring_runs_only_the_visible_blocks(monkeypatch):
    """The kernel ring visits n(n+1)/2 blocks forward and backward, and
    takes delta per rank from K2's wrapper."""
    calls = {}

    def counting(name, fn):
        def wrapper(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        monkeypatch.setattr(port_seq, name, wrapper)

    for name in ("flash_ring_fwd", "flash_ring_dq", "flash_ring_dkv",
                 "flash_bwd_preprocess"):
        counting(name, getattr(port_seq, name))
    q, k, v, do = _qkv(kvh=2)
    _port_ring(q, k, v, do, True, build_mesh(MeshConfig(seq=N)))
    assert calls == {"flash_ring_fwd": 10, "flash_ring_dq": 10,
                     "flash_ring_dkv": 10, "flash_bwd_preprocess": N}


# ---------------------------------------------------------------------------
# the model and the train step under seq=4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["flash", "bshd"])
def test_llama_logits_with_seq_axis_match_jax(attn_impl):
    """Both packages take the ring under a seq axis, whatever attn_impl
    says: rope outside at global positions, then the kernel ring."""
    kw = dict(SMALL, attn_impl=attn_impl)
    jc = JaxConfig(**kw)
    j_params = jax_init(jc, jax.random.key(0))
    tokens = np.random.RandomState(1).randint(0, 64, (2, 32)).astype(np.int32)
    mesh = jax_build_mesh(JaxMeshConfig(seq=N), devices=jax.devices()[:N])
    jax_set_mesh(mesh)
    with mesh:
        j_logits = np.asarray(jax.jit(lambda p, t: jax_apply(jc, p, t))(
            j_params, jnp.asarray(tokens)))

    set_mesh(build_mesh(MeshConfig(seq=N)))
    t_logits = llama_apply(LlamaConfig(**kw),
                           params_from_jax(jax.tree.map(np.asarray,
                                                        j_params)),
                           torch.tensor(tokens))
    np.testing.assert_allclose(t_logits.numpy(), j_logits, rtol=2e-4,
                               atol=2e-4)


def test_two_seq4_steps_match_one_device_steps(monkeypatch):
    """auto_accelerate with MeshConfig(seq=4) (4 in-process ranks) against
    the port's single-device steps, which tests/test_torch_accelerate.py
    holds against JAX. The seq steps run the ring (10 forward blocks per
    layer and step) though ``_train`` clears the active mesh first."""
    p_np = _small_params()
    _, ref_losses, ref_params = _train(p_np, MeshConfig())
    blocks = []
    fwd = port_seq.flash_ring_fwd
    monkeypatch.setattr(port_seq, "flash_ring_fwd",
                        lambda *a: blocks.append(1) or fwd(*a))
    res, losses, params = _train(p_np, MeshConfig(seq=N))
    assert len(blocks) == SMALL["n_layers"] * 10 * 2
    assert res.mesh.ring.kind == "in-process"
    assert "seq transport=in-process, 4 ranks on one device" in \
        res.strategy.describe(res.mesh)
    np.testing.assert_allclose(losses, ref_losses, atol=1e-5)
    assert losses[1] < losses[0]
    _assert_params_close(params, ref_params)


# ---------------------------------------------------------------------------
# what the seq mesh refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", [
    MeshConfig(seq=4, tensor=2), MeshConfig(data=2), MeshConfig(fsdp=2),
], ids=["seq4-tensor2", "data2", "fsdp2"])
def test_build_mesh_refuses_other_axes(config):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        build_mesh(config)


def test_build_mesh_refuses_a_group_of_another_size(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="2 of the 4 seq ranks"):
        build_mesh(MeshConfig(data=1, seq=4))


@pytest.mark.parametrize("config,warned", [
    (MeshConfig(seq=4), True),
    (MeshConfig(data=2, seq=4), False),
    (MeshConfig(data=1, seq=2), False),
], ids=["wildcard", "explicit", "one-seq-rank-a-process"])
def test_layout_warns_when_a_wildcard_takes_the_seq_ranks(monkeypatch,
                                                          config, warned):
    """seq=4 on 2 ranks: the -1 data axis takes both ranks and each
    process holds the whole seq axis, which a warning names; asked for
    explicitly, or one seq rank a process, it is said nowhere."""
    said = []
    monkeypatch.setattr(port_mesh.logger, "warning",
                        lambda *a: said.append(a[0] % a[1:]))
    sizes, in_process = port_mesh.layout(config, 2)
    assert in_process == (config.seq == 4)
    assert sizes["data"] * (1 if in_process else sizes["seq"]) == 2
    assert bool(said) == warned
    if warned:
        assert "every process holds all 4 seq ranks" in said[0]


def test_ring_refuses_a_sequence_it_does_not_divide():
    q, k, v, _ = _qkv(s=30)
    mesh = build_mesh(MeshConfig(seq=N))
    with pytest.raises(ValueError, match="does not divide"):
        ring_attention(*(torch.tensor(x) for x in (q, k, v)), mesh=mesh)


def test_ulysses_is_not_ported():
    """What Ulysses does not run: heads the seq axis does not divide
    raise ``ValueError``, as in the JAX package; the impl itself runs
    (tests/test_torch_ulysses.py holds it against JAX's)."""
    mesh = build_mesh(MeshConfig(seq=N))
    q = torch.zeros(1, 6, 8, 16)
    with pytest.raises(ValueError, match="divisible by axis size"):
        sequence_sharded_attention(q, q, q, mesh=mesh, impl="ulysses")
    q = torch.zeros(1, 4, 8, 16)
    out = sequence_sharded_attention(q, q, q, mesh=mesh, impl="ulysses")
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="unknown"):
        sequence_sharded_attention(q, q, q, mesh=mesh, impl="striped")


def test_single_process_init_distributed_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert trainer.init_distributed(device="cpu") is False
    assert not dist.is_initialized()
    assert trainer.world_size() == 1 and trainer.global_rank() == 0
