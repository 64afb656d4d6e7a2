"""Low-precision compute in the port (ops/fp8.py, the int8 matmul half of
ops/quantization.py, ops/lowp.py's plain versions) held against the JAX
package on the same numpy inputs, on the CPU: the counterparts of
tests/test_fp8.py, then the Llama and GPT-2 train step under
``compute_dtype`` "fp8" and "int8" with every remat mode.

Tolerances and their reasons:

- quantize (``quantize_e4m3``/``quantize_e5m2``, ``_per_channel_q``):
  bit for bit, codes and scales; the JAX side is jitted, as in its train
  step, where XLA turns ``amax / 448`` into a product with the f32
  reciprocal (the port does the same).
- ``fp8_dot``/``int8_dot``/``int8_einsum`` in f32: the codes and scales
  are equal, so forward and gradients differ only by the f32 summation
  order of the matmuls: 1e-5 relative to each tensor's largest entry.
  int8 forwards are exact integer products scaled in the same order:
  bit for bit.
- in bf16: the dequantized operands are rounded to bf16 at the same
  places on both sides; the bf16 matmuls round their outputs after f32
  sums taken in different orders, one bf16 step (2^-8) at most: 1e-2
  relative to the largest entry.
- the model's loss and gradients in f32 through the quantized matmuls:
  the loss within 1e-4 absolute; the gradients relative to each leaf's
  largest entry within 5e-2 under fp8 and 1e-2 under int8. The two
  sides' attention and matmuls differ in f32 summation order (~1e-7),
  and where a value lies that close to a rounding boundary its code
  flips: one e5m2 step of the cotangent is 12.5%, one e4m3 step 6%, one
  int8 step 1/127 of the channel's amax, and a flip moves the gradient
  leaves upstream of it by up to a few percent of their largest entry
  (measured: 1.7% under fp8, 0.13% under int8, on GPT-2). A cast in the
  wrong place or the wrong format is pinned by the op tests above.
- three steps through ``auto_accelerate`` (bf16 compute around the
  quantized matmuls): 2e-2 absolute, the bf16 default path's tolerance
  (tests/test_torch_bf16_default.py).
- remat: the gradients of a checkpointed step equal ``remat="none"``'s
  exactly (the recompute runs the same ops on the same inputs and the
  quantized matmuls hand back their saved outputs).
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dlrover_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from dlrover_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from dlrover_tpu.models.gpt2 import gpt2_logical_axes as jax_gpt2_axes
from dlrover_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn
from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
from dlrover_tpu.models.llama import llama_init as jax_init
from dlrover_tpu.models.llama import llama_logical_axes
from dlrover_tpu.models.llama import llama_loss_fn as jax_loss_fn
from dlrover_tpu.ops import fp8 as jfp8
from dlrover_tpu.ops import quantization as jquant
from dlrover_tpu.parallel.accelerate import auto_accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
from dlrover_tpu.parallel.mesh import build_mesh as jax_build_mesh
from dlrover_tpu.parallel.mesh import set_mesh as jax_set_mesh
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu_torch.models import (
    GPT2Config,
    LlamaConfig,
    gpt2_loss_fn,
    llama_init,
    llama_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.ops import fp8, lowp, quantization
from dlrover_tpu_torch.parallel import Strategy, auto_accelerate
from dlrover_tpu_torch.parallel import accelerate as accel_mod
from dlrover_tpu_torch.parallel import remat as remat_lib
from dlrover_tpu_torch.parallel.mesh import Mesh
from dlrover_tpu_torch.trainer import build_optimizer

LLAMA = dict(
    vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=96,
    max_seq_len=64, attn_impl="flash", attn_block_q=16, attn_block_k=16,
    remat=False, dtype="float32",
)
GPT2 = dict(
    vocab_size=64, dim=128, n_layers=2, n_heads=2, mlp_dim=256,
    max_seq_len=64, dtype="float32", attn_impl="flash", attn_block_q=16,
    attn_block_k=16, remat=False,
)
MODES = ("fp8", "int8")
QUANT_OPS = set(remat_lib.QUANT)


@pytest.fixture(autouse=True)
def _restore_global_mesh(monkeypatch):
    from dlrover_tpu.parallel import mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(t):
    return t.detach().float().numpy()


def _jnp_f32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _same_codes(port_q, jax_q):
    """fp8 codes equal as values, NaN where NaN (the NaN code's sign bit
    is not part of the contract)."""
    np.testing.assert_array_equal(_np(port_q), _jnp_f32(jax_q))


def _jax_mesh():
    jax_set_mesh(jax_build_mesh(JaxMesh(data=1), devices=jax.devices()[:1]))


# ---------------------------------------------------------------------------
# quantize, bit for bit
# ---------------------------------------------------------------------------


def _fp8_operands():
    rs = np.random.RandomState(0)
    exact = rs.randn(16, 24).astype(np.float32)
    exact[3, 5] = 896.0     # amax -> scale 2.0, codes +-448 exactly
    exact[7, 1] = -896.0
    return {
        "normal": (rs.randn(32, 48) * 3).astype(np.float32),
        "amax_to_448": exact,
        "zeros": np.zeros((8, 16), np.float32),
        "tiny": (rs.randn(8, 16) * 1e-30).astype(np.float32),
    }


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("case", ["normal", "amax_to_448", "zeros", "tiny"])
def test_quantize_fp8_bit_for_bit(fmt, case):
    x = _fp8_operands()[case]
    jfn = jfp8.quantize_e4m3 if fmt == "e4m3" else jfp8.quantize_e5m2
    pfn = fp8.quantize_e4m3 if fmt == "e4m3" else fp8.quantize_e5m2
    jq, js = jax.jit(jfn)(jnp.asarray(x))
    pq, ps = pfn(torch.from_numpy(x))
    assert pq.dtype == lowp.FP8_DTYPES[fmt] and pq.shape == x.shape
    assert np.float32(ps.item()) == np.float32(js), (ps.item(), float(js))
    _same_codes(pq, jq)
    if case == "amax_to_448" and fmt == "e4m3":
        assert ps.item() == 2.0 and _np(pq).max() == 448.0
        assert _np(pq).min() == -448.0


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_quantize_fp8_given_scale_overflows_like_jax(fmt):
    """A delayed (given) scale below the operand's amax: e4m3 overflows to
    NaN, e5m2 to inf (no saturation), in bf16 input too."""
    x = np.array([[1.0, -3.0, 500.0, 465.0, 464.0, -7e4, 6e4, 0.3]],
                 np.float32)
    scale = np.float32(1.0)
    jfn = jfp8.quantize_e4m3 if fmt == "e4m3" else jfp8.quantize_e5m2
    pfn = fp8.quantize_e4m3 if fmt == "e4m3" else fp8.quantize_e5m2
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        xj = jnp.asarray(x).astype(jdt)
        jq, _ = jax.jit(jfn)(xj, jnp.float32(scale))
        pq, ps = pfn(torch.from_numpy(_jnp_f32(xj)).to(dt),
                     torch.tensor(scale))
        _same_codes(pq, jq)
        assert ps.item() == 1.0


def test_quantize_fp8_layouts_and_bf16_input():
    """K15's plain version: "col" is the transposed codes of the 2-D view,
    "both" both; a bf16 operand quantizes like JAX's bf16 operand."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 8, 16).astype(np.float32)).bfloat16()
    q, qt, s = lowp.quantize_fp8(x, "e4m3", layout="both")
    _, qt_only, s2 = lowp.quantize_fp8(x, "e4m3", layout="col")
    assert torch.equal(qt.view(torch.uint8), qt_only.view(torch.uint8))
    assert torch.equal(qt.view(torch.uint8),
                       q.reshape(16, 16).t().contiguous().view(torch.uint8))
    jq, js = jax.jit(jfp8.quantize_e4m3)(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    _same_codes(q, jq)
    assert s.item() == s2.item() == np.float32(js)
    assert lowp.quantize_fp8.launches == 0  # the CPU path launches nothing


def _int8_operand():
    rs = np.random.RandomState(5)
    x = (rs.randn(3, 6, 10) * 2).astype(np.float32)
    # ties: a row with amax 127 has scale 1.0, so these are exact halves
    x[0, 0, :] = [127.0, 2.5, 3.5, -0.5, 1.5, -2.5, 0.5, 4.5, -126.5, 0.0]
    x[1, 2, :] = 0.0  # an all-zero channel: scale 1
    return x


@pytest.mark.parametrize("axis", [-1, 0, (1, 2), (0, 2)],
                         ids=["last", "first", "tuple12", "tuple02"])
def test_per_channel_q_bit_for_bit(axis):
    x = _int8_operand()
    jq, js = jax.jit(jquant._per_channel_q, static_argnums=1)(
        jnp.asarray(x), axis)
    pq, ps = lowp.per_channel_q(torch.from_numpy(x), axis)
    assert pq.dtype == torch.int8 and tuple(ps.shape) == js.shape
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    if axis == -1:
        # half to even: 2.5 -> 2, 3.5 -> 4, -0.5 -> 0, 1.5 -> 2
        assert pq[0, 0, :8].tolist() == [127, 2, 4, 0, 2, -2, 0, 4]
        assert ps[0, 0, 0].item() == 1.0 and ps[1, 2, 0].item() == 1.0


@pytest.mark.parametrize("channels", ["rows", "cols"])
def test_int8_channels_and_dequant_plain_versions(channels):
    """K16's plain version on a 2-D operand (the cols codes transposed)
    and K17's two orders against the JAX package's int8 dot."""
    rs = np.random.RandomState(6)
    a = rs.randn(24, 40).astype(np.float32)
    b = rs.randn(40, 16).astype(np.float32)
    x = a if channels == "rows" else b
    q, s = lowp.quantize_int8_channels(torch.from_numpy(x), channels)
    jq, js = jax.jit(jquant._per_channel_q, static_argnums=1)(
        jnp.asarray(x), -1 if channels == "rows" else 0)
    want_q = np.asarray(jq) if channels == "rows" else np.asarray(jq).T
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    qa, sa = lowp.quantize_int8_channels(torch.from_numpy(a), "rows")
    qbt, sb = lowp.quantize_int8_channels(torch.from_numpy(b), "cols")
    acc = lowp.int8_mm(qa, qbt)
    assert acc.dtype == torch.int32
    out = lowp.dequantize_int32(acc, sa, sb, torch.float32)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax.jit(jquant.int8_dot)(a, b)))


# ---------------------------------------------------------------------------
# fp8_dot (TestFp8Dot)
# ---------------------------------------------------------------------------


def _vjp_jax(fn, a, b, g):
    out, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(b))
    da, db = vjp(jnp.asarray(g))
    return out, da, db


def _vjp_port(fn, a, b, g, dtype):
    ta = torch.tensor(np.asarray(a, np.float32)).to(dtype)
    tb = torch.tensor(np.asarray(b, np.float32)).to(dtype)
    ta.requires_grad_()
    tb.requires_grad_()
    out = fn(ta, tb)
    out.backward(torch.tensor(np.asarray(g, np.float32)).to(dtype))
    return out, ta.grad, tb.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lhs", [(32, 64), (4, 16, 32)],
                         ids=["2d", "batched"])
def test_fp8_dot_forward_and_grads_match_jax(dtype, lhs):
    rs = np.random.RandomState(len(lhs))
    a = rs.randn(*lhs).astype(np.float32)
    b = rs.randn(lhs[-1], 16).astype(np.float32)
    g = rs.randn(*lhs[:-1], 16).astype(np.float32)
    jdt = jnp.dtype(dtype)
    aj, bj, gj = (jnp.asarray(t).astype(jdt) for t in (a, b, g))
    j_out, j_da, j_db = _vjp_jax(jax.jit(jfp8.fp8_dot), aj, bj, gj)
    p_out, p_da, p_db = _vjp_port(fp8.fp8_dot, _jnp_f32(aj), _jnp_f32(bj),
                                  _jnp_f32(gj), getattr(torch, dtype))
    assert p_out.dtype == getattr(torch, dtype) and p_da.shape == a.shape
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got, want in ((p_out, j_out), (p_da, j_da), (p_db, j_db)):
        assert _rel(_np(got), _jnp_f32(want)) < tol
    # TestFp8Dot's own bound against the exact product (relative norm)
    exact = a.reshape(-1, a.shape[-1]) @ b
    err = np.linalg.norm(_np(p_out).reshape(exact.shape) - exact)
    assert err / np.linalg.norm(exact) < 0.05


# ---------------------------------------------------------------------------
# int8_dot and int8_einsum (TestInt8Dot, TestInt8Einsum)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lhs", [(32, 64), (2, 24, 40)],
                         ids=["2d", "batched"])
def test_int8_dot_forward_and_grads_match_jax(dtype, lhs):
    rs = np.random.RandomState(10 + len(lhs))
    a = rs.randn(*lhs).astype(np.float32)
    b = rs.randn(lhs[-1], 24).astype(np.float32)
    g = rs.randn(*lhs[:-1], 24).astype(np.float32)
    jdt = jnp.dtype(dtype)
    aj, bj, gj = (jnp.asarray(t).astype(jdt) for t in (a, b, g))
    j_out, j_da, j_db = _vjp_jax(jax.jit(jquant.int8_dot), aj, bj, gj)
    p_out, p_da, p_db = _vjp_port(quantization.int8_dot, _jnp_f32(aj),
                                  _jnp_f32(bj), _jnp_f32(gj),
                                  getattr(torch, dtype))
    if dtype == "float32":
        np.testing.assert_array_equal(_np(p_out), _jnp_f32(j_out))
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got, want in ((p_out, j_out), (p_da, j_da), (p_db, j_db)):
        assert _rel(_np(got), _jnp_f32(want)) < tol


EINSUMS = {
    "bsd,dhk->bhsk": ((2, 16, 32), (32, 4, 8)),
    "bhsk,hkd->bsd": ((2, 4, 16, 8), (4, 8, 32)),
    "bsd,dthk->tbhsk": ((2, 16, 32), (32, 3, 4, 8)),
}


@pytest.mark.parametrize("spec", list(EINSUMS))
def test_int8_einsum_forward_and_grads_match_jax(spec):
    a_shape, b_shape = EINSUMS[spec]
    rs = np.random.RandomState(len(spec))
    a = rs.randn(*a_shape).astype(np.float32)
    b = rs.randn(*b_shape).astype(np.float32)
    j_out = jax.jit(jquant.int8_einsum, static_argnums=0)(spec, a, b)
    g = rs.randn(*j_out.shape).astype(np.float32)
    _, j_da, j_db = _vjp_jax(
        jax.jit(lambda x, y: jquant.int8_einsum(spec, x, y)), a, b, g)
    p_out, p_da, p_db = _vjp_port(
        lambda x, y: quantization.int8_einsum(spec, x, y), a, b, g,
        torch.float32)
    assert tuple(p_out.shape) == j_out.shape
    np.testing.assert_array_equal(_np(p_out), np.asarray(j_out))
    assert _rel(_np(p_da), j_da) < 1e-5 and _rel(_np(p_db), j_db) < 1e-5
    # the 2-D GEMM route equals the JAX computation written out
    ref = quantization.int8_einsum_reference(spec, torch.from_numpy(a),
                                             torch.from_numpy(b))
    assert torch.equal(p_out.detach(), ref)
    # close to the exact einsum (TestInt8Einsum's bound)
    exact = np.einsum(spec, a.astype(np.float64), b.astype(np.float64))
    assert _rel(_np(p_out), exact) < 0.1


@pytest.mark.parametrize("bad", ["bsd,dhk->bhs", "bsd,shk->bhk", "bsd,dhk"])
def test_einsum_parts_rejects_what_jax_rejects(bad):
    a, b = torch.zeros(2, 16, 32), torch.zeros(32, 4, 8)
    with pytest.raises(ValueError):
        jquant._einsum_parts(bad, 3, 3)
    with pytest.raises(ValueError):
        quantization.int8_einsum(bad, a, b)


def test_int8_einsum_batch_dims_raise():
    """A dim in both operands and the output is not one 2-D GEMM."""
    with pytest.raises(NotImplementedError, match="batch dims"):
        quantization.int8_einsum("bsd,bdk->bsk", torch.zeros(2, 4, 8),
                                 torch.zeros(2, 8, 4))


def test_scale_to_out_matches_jax():
    rs = np.random.RandomState(8)
    # keepdims scales of 'bsd,dthk->tbhsk' (d contracted) and of
    # 'bhsk,hkd->bsd' (h, k contracted)
    for shape, sub, out_sub in (((1, 3, 4, 8), "dthk", "tbhsk"),
                                ((2, 16, 1), "bsd", "tbhsk"),
                                ((2, 1, 16, 1), "bhsk", "bsd")):
        s = rs.rand(*shape).astype(np.float32)
        want = jquant._scale_to_out(jnp.asarray(s), sub, out_sub)
        got = quantization._scale_to_out(torch.from_numpy(s), sub, out_sub)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# routing (TestQdot, qeinsum, TestDelayedScaling)
# ---------------------------------------------------------------------------


def _ab(rows=16, k=32, n=8, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(rows, k).astype(np.float32),
            rs.randn(k, n).astype(np.float32))


def test_qdot_and_qeinsum_pass_through_without_autocast():
    a, b = _ab()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert fp8.quant_mode() is None and not fp8.fp8_enabled()
    assert torch.equal(fp8.qdot(ta, tb), ta @ tb)
    w = torch.from_numpy(np.random.RandomState(1).randn(32, 2, 4)
                         .astype(np.float32))
    x = ta.view(2, 8, 32)
    assert torch.equal(fp8.qeinsum("bsd,dhk->bhsk", x, w),
                       torch.einsum("bsd,dhk->bhsk", x, w))


@pytest.mark.parametrize("mode", MODES)
def test_qdot_routes_by_mode_like_jax(mode):
    a, b = _ab(seed=2)
    with jfp8.quant_autocast(mode):
        # a fresh function: jit caches a trace, and the flag is read there
        want = np.asarray(jax.jit(lambda x, y: jfp8.qdot(x, y))(a, b))
    with fp8.quant_autocast(mode):
        assert fp8.quant_mode() == mode and fp8.fp8_enabled()
        got = fp8.qdot(torch.from_numpy(a), torch.from_numpy(b))
    assert fp8.quant_mode() is None
    assert not np.array_equal(got.numpy(), a @ b)  # the path engaged
    assert _rel(got.numpy(), want) < 1e-5


def test_qdot_site_filter_untagged_sites_and_forced_off():
    a, b = _ab(seed=3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    plain = ta @ tb
    quant = fp8.fp8_dot(ta, tb)
    with fp8.quant_autocast("fp8", sites="mlp,attn_out"):
        assert fp8.quant_sites() == frozenset({"mlp", "attn_out"})
        assert torch.equal(fp8.qdot(ta, tb, site="attn_qkv"), plain)
        assert torch.equal(fp8.qdot(ta, tb, site="mlp"), quant)
        assert torch.equal(fp8.qdot(ta, tb), quant)  # untagged: quantizes
        with fp8.fp8_autocast(False):
            assert fp8.quant_mode() is None
            assert torch.equal(fp8.qdot(ta, tb, site="mlp"), plain)
        assert fp8.quant_mode() == "fp8"
        # only the linear-layer shape quantizes: a 3-D right operand not
        a3, b3 = ta.view(2, 8, 32), torch.stack([tb, tb])
        assert torch.equal(fp8.qdot(a3, b3), a3 @ b3)
    assert fp8.parse_quant_sites("all") is None
    assert fp8.parse_quant_sites("") is None
    with fp8.fp8_autocast():
        assert fp8.quant_mode() == "fp8"
    with pytest.raises(ValueError):
        with fp8.quant_autocast("int4"):
            pass


def test_qeinsum_quantizes_under_int8_only():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 32).astype(np.float32)
    w = rs.randn(32, 2, 16).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    plain = torch.einsum("bsd,dhk->bhsk", tx, tw)
    with fp8.quant_autocast("fp8"):
        assert torch.equal(fp8.qeinsum("bsd,dhk->bhsk", tx, tw), plain)
    with fp8.quant_autocast("int8"):
        got = fp8.qeinsum("bsd,dhk->bhsk", tx, tw, site="attn_qkv")
    with jfp8.quant_autocast("int8"):
        want = jax.jit(lambda p, q: jfp8.qeinsum("bsd,dhk->bhsk", p, q))(
            x, w)
    assert not torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with fp8.quant_autocast("int8", sites=["mlp"]):
        assert torch.equal(
            fp8.qeinsum("bsd,dhk->bhsk", tx, tw, site="attn_qkv"), plain)


def test_fp8_history_window():
    h = fp8.Fp8History.create(window=4)
    h = h.update(torch.full((2,), 100.0))
    h = h.update(torch.full((2,), 50.0))
    jh = jfp8.Fp8History.create(window=4)
    jh = jh.update(jnp.full((2,), 100.0)).update(jnp.full((2,), 50.0))
    np.testing.assert_array_equal(h.amax_history.numpy(),
                                  np.asarray(jh.amax_history))
    assert h.scale().item() == np.float32(jax.jit(lambda x: x.scale())(jh))
    np.testing.assert_allclose(h.scale().item(), 100.0 / 448.0, rtol=1e-6)
    assert fp8.Fp8History.create().scale().item() == np.float32(1 / 448.0)


def test_fp8_dot_delayed_matches_jax():
    """Two delayed steps from the same numpy window: the first with the
    empty history's default scale, the second with the real amaxes (the
    output converges to the current-scaling one, as TestDelayedScaling
    holds); outputs and histories equal to JAX's."""
    rs = np.random.RandomState(3)
    a = rs.randn(16, 16).astype(np.float32)
    b = rs.randn(16, 16).astype(np.float32)
    window = (rs.rand(16) * 3).astype(np.float32)
    window[:3] = 0.0
    ah = fp8.Fp8History(torch.from_numpy(window), fp8.E4M3_MAX)
    bh = fp8.Fp8History(torch.zeros(16), fp8.E4M3_MAX)
    jah = jfp8.Fp8History(jnp.asarray(window), jfp8.E4M3_MAX)
    jbh = jfp8.Fp8History.create()
    step = jax.jit(jfp8.fp8_dot_delayed)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for i in range(2):
        out, ah, bh = fp8.fp8_dot_delayed(ta, tb, ah, bh)
        jout, jah, jbh = step(a, b, jah, jbh)
        if i == 0:
            # b's empty history: scale 1/448, |b| * 448 overflows e4m3
            np.testing.assert_array_equal(np.isnan(out.numpy()),
                                          np.isnan(np.asarray(jout)))
            assert np.isnan(out.numpy()).any()
        else:
            assert _rel(out.numpy(), jout) < 1e-5
        np.testing.assert_array_equal(ah.amax_history.numpy(),
                                      np.asarray(jah.amax_history))
        np.testing.assert_array_equal(bh.amax_history.numpy(),
                                      np.asarray(jbh.amax_history))
    assert _rel(out.numpy(), a @ b) < 0.05
    # the backward is fp8_dot's: the cotangent in e5m2, e4m3 residuals
    ta.requires_grad_()
    fp8.fp8_dot_delayed(ta, tb, ah, bh)[0].sum().backward()
    assert _rel(ta.grad.numpy(), np.ones((16, 16)) @ b.T) < 0.08


# ---------------------------------------------------------------------------
# the slice: Llama and GPT-2 through the quantized matmuls
# ---------------------------------------------------------------------------


def _jax_grads(loss_fn, p_np, tokens, mode, sites=None):
    """Jitted, as in the JAX train step (a division by a constant is then
    a product with its reciprocal), traced under the quant flag."""
    with jfp8.quant_autocast(mode, sites=sites), jfp8.no_remat_autocast():
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, {"tokens": jnp.asarray(tokens)}, None)))(
            jax.tree.map(jnp.asarray, p_np))
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def _port_grads(loss_fn, p_np, tokens, mode, sites=None):
    params = {k: v.requires_grad_() for k, v in params_from_jax(p_np).items()}
    with fp8.quant_autocast(mode, sites=sites):
        loss = loss_fn(params, {"tokens": torch.tensor(tokens)}, None)
    loss.backward()
    return loss.item(), {k: v.grad for k, v in params.items()}


GRAD_TOL = {"fp8": 5e-2, "int8": 1e-2}


def _compare_grads(port, jax_side, mode):
    (p_loss, p_grads), (j_loss, j_grads) = port, jax_side
    np.testing.assert_allclose(p_loss, j_loss, atol=1e-4)
    assert set(p_grads) == set(j_grads)
    for name, g in j_grads.items():
        err = _rel(p_grads[name].numpy(), g.numpy())
        assert err < GRAD_TOL[mode], f"{name}: relative error {err}"


def _tokens(seq_plus_one=33, batch=2, seed=1):
    return np.random.RandomState(seed).randint(
        0, 64, (batch, seq_plus_one)).astype(np.int32)


@pytest.mark.parametrize("mode,sites", [("fp8", None), ("int8", None),
                                        ("int8", "mlp")],
                         ids=["fp8", "int8", "int8_mlp"])
def test_llama_loss_and_grads_match_jax(mode, sites):
    _jax_mesh()
    jc = JaxConfig(**LLAMA)
    p_np = jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))
    tokens = _tokens()
    want = _jax_grads(jax_loss_fn(jc), p_np, tokens, mode, sites)
    got = _port_grads(llama_loss_fn(LlamaConfig(**LLAMA)), p_np, tokens,
                      mode, sites)
    _compare_grads(got, want, mode)
    plain = _port_grads(llama_loss_fn(LlamaConfig(**LLAMA)), p_np, tokens,
                        mode, sites="none_of_them")
    assert got[0] != plain[0]  # the quantized matmuls ran


@pytest.mark.parametrize("mode", MODES)
def test_gpt2_loss_and_grads_match_jax(mode):
    _jax_mesh()
    jc = JaxGPT2Config(**GPT2)
    p_np = jax.tree.map(np.asarray, jax_gpt2_init(jc, jax.random.key(0)))
    tokens = _tokens()
    want = _jax_grads(jax_gpt2_loss_fn(jc), p_np, tokens, mode)
    got = _port_grads(gpt2_loss_fn(GPT2Config(**GPT2)), p_np, tokens, mode)
    _compare_grads(got, want, mode)


def _jax_steps(jc, loss_fn, init, axes, strategy, tokens, steps=3):
    res = jax_accelerate(loss_fn(jc), lambda r: init(jc, r),
                         optax.adamw(1e-2, weight_decay=0.0), axes(jc),
                         strategy=strategy, devices=jax.devices()[:1])
    state, losses = res.state, []
    for i in range(steps):
        state, m = res.train_step(state, {"tokens": jnp.asarray(tokens)},
                                  jax.random.key(i))
        losses.append(float(m["loss"]))
    return losses


def _port_steps(loss_fn, p_np, strategy, tokens, steps=3):
    res = auto_accelerate(
        loss_fn, lambda seed, device: params_from_jax(p_np, device),
        build_optimizer("adamw", 1e-2, weight_decay=0.0), strategy,
        device="cpu")
    state, losses = res.state, []
    for _ in range(steps):
        state, m = res.train_step(state, {"tokens": tokens}, None)
        losses.append(m["loss"].item())
    return losses, res


@pytest.mark.parametrize("mode,sites", [("fp8", "all"), ("int8", "all"),
                                        ("int8", "mlp")],
                         ids=["fp8", "int8", "int8_mlp"])
def test_llama_steps_through_auto_accelerate_match_jax(mode, sites):
    kw = dict(LLAMA, dtype="bfloat16")
    jc = JaxConfig(**kw)
    p_np = jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))
    tokens = _tokens(seed=3, batch=4)
    want = _jax_steps(jc, jax_loss_fn, jax_init, llama_logical_axes,
                      JaxStrategy(mesh=JaxMesh(data=1), compute_dtype=mode,
                                  remat="none", quant_sites=sites), tokens)
    strategy = Strategy(compute_dtype=mode, remat="none", quant_sites=sites)
    got, res = _port_steps(llama_loss_fn(LlamaConfig(**kw)), p_np, strategy,
                           tokens)
    assert f"dtype={mode}" in res.strategy.describe()
    assert all(np.isfinite(got)) and got[-1] < got[0]
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_gpt2_steps_through_auto_accelerate_match_jax(mode):
    kw = dict(GPT2, dtype="bfloat16")
    jc = JaxGPT2Config(**kw)
    p_np = jax.tree.map(np.asarray, jax_gpt2_init(jc, jax.random.key(0)))
    tokens = _tokens(seed=4, batch=4)
    want = _jax_steps(jc, jax_gpt2_loss_fn, jax_gpt2_init, jax_gpt2_axes,
                      JaxStrategy(mesh=JaxMesh(data=1), compute_dtype=mode,
                                  remat="none"), tokens)
    got, _ = _port_steps(gpt2_loss_fn(GPT2Config(**kw)), p_np,
                         Strategy(compute_dtype=mode, remat="none"), tokens)
    assert all(np.isfinite(got)) and got[-1] < got[0]
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def _tracks_bf16_run(dtype, steps=12, lr=5e-3):
    """tests/test_fp8.py ``TestEndToEndNumerics._run`` on one device."""
    cfg = LlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4,
                      n_kv_heads=2, mlp_dim=64, max_seq_len=32,
                      attn_impl="reference", remat=False, dtype="float32")
    res = auto_accelerate(llama_loss_fn(cfg),
                          lambda s, d: llama_init(cfg, s, d),
                          build_optimizer("adamw", lr),
                          Strategy(compute_dtype=dtype, remat="none"),
                          device="cpu")
    tokens = np.random.RandomState(1).randint(0, 64, (8, 33))
    state, losses = res.state, []
    for _ in range(steps):
        state, m = res.train_step(state, {"tokens": tokens}, None)
        losses.append(m["loss"].item())
    return losses


@pytest.mark.parametrize("mode", MODES)
def test_quant_mode_tracks_bf16_training(mode):
    """test_fp8_tracks_bf16 and test_int8_tracks_bf16_training on the
    port: the loss drops and ends within 5% of the bf16 run's."""
    lq, l16 = _tracks_bf16_run(mode), _tracks_bf16_run("bfloat16")
    assert lq[-1] < lq[0] * 0.9, f"{mode} loss did not drop: {lq}"
    assert abs(lq[-1] - l16[-1]) / l16[-1] < 0.05, (lq[-1], l16[-1])


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


class _CountQuant(TorchDispatchMode):
    """Counts the quantized matmul ops (and the GEMMs inside them) that
    reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in QUANT_OPS:
            self.calls += 1
        return func(*args, **(kwargs or {}))


def _remat_grads(cfg, mode, remat, tokens, p_np, model="llama"):
    loss_fn = (llama_loss_fn if model == "llama" else gpt2_loss_fn)(cfg)
    wrapped = accel_mod._remat_wrap(loss_fn, remat)
    params = {k: v.bfloat16().requires_grad_()
              for k, v in params_from_jax(p_np).items()}
    rctx = (remat_lib.no_remat if remat == "none"
            else contextlib.nullcontext)
    counter = _CountQuant()
    with rctx(), fp8.quant_autocast(mode):
        with counter:
            loss = wrapped(params, {"tokens": torch.tensor(tokens)}, None)
        forward_calls = counter.calls
    counter.calls = 0
    with counter:
        loss.backward()
    return loss.item(), {k: v.grad for k, v in params.items()}, (
        forward_calls, counter.calls)


@pytest.mark.parametrize("remat", ["minimal", "full", "offload"])
@pytest.mark.parametrize("mode", MODES)
def test_remat_grads_equal_none_and_recompute_no_quant(mode, remat):
    """Under the strategy's remat with the model's per-layer checkpoints
    (dots_attn), the gradients equal remat "none"'s bit for bit, which
    shows that the recompute ran under the forward's quant mode; and the
    backward runs no quantized matmul (their outputs are saved)."""
    cfg = LlamaConfig(**dict(LLAMA, dtype="bfloat16", remat=True))
    _jax_mesh()
    p_np = jax.tree.map(np.asarray, jax_init(JaxConfig(**LLAMA),
                                             jax.random.key(0)))
    tokens = _tokens()
    loss0, grads0, (fwd0, bwd0) = _remat_grads(cfg, mode, "none", tokens,
                                               p_np)
    loss1, grads1, (fwd1, bwd1) = _remat_grads(cfg, mode, remat, tokens,
                                               p_np)
    assert loss1 == loss0
    for name in grads0:
        assert torch.equal(grads1[name], grads0[name]), name
    assert fwd1 == fwd0 == 7 * LLAMA["n_layers"]
    assert bwd0 == bwd1 == 0


@pytest.mark.parametrize("mode", MODES)
def test_gpt2_layer_remat_grads_equal_none(mode):
    cfg = GPT2Config(**dict(GPT2, dtype="bfloat16", remat=True))
    _jax_mesh()
    p_np = jax.tree.map(np.asarray, jax_gpt2_init(JaxGPT2Config(**GPT2),
                                                  jax.random.key(0)))
    tokens = _tokens()
    loss0, grads0, _ = _remat_grads(cfg, mode, "none", tokens, p_np, "gpt2")
    loss1, grads1, (_, bwd) = _remat_grads(cfg, mode, "full", tokens, p_np,
                                           "gpt2")
    assert loss1 == loss0 and bwd == 0
    for name in grads0:
        assert torch.equal(grads1[name], grads0[name]), name


def test_every_remat_table_saves_the_quantized_matmuls():
    remat = remat_lib
    for mode in ("minimal", "full", "offload"):
        table = remat.strategy_policy(mode)
        assert all(table[op] == remat.SAVE for op in QUANT_OPS)
    for name in ("dots_attn", "dots_attn_offload", "dots_no_batch", "dots"):
        table = remat.layer_policy(name)
        assert all(table[op] == remat.SAVE for op in QUANT_OPS)


# ---------------------------------------------------------------------------
# auto_accelerate's checks and the Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,capability,raises", [
    ("fp8", (9, 0), False), ("fp8", (8, 0), True), ("int8", (8, 0), False),
    ("int8", (7, 5), True)], ids=["fp8_h100", "fp8_a100", "int8_a100",
                                  "int8_t4"])
def test_quant_modes_need_their_tensor_cores(monkeypatch, mode, capability,
                                             raises):
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: capability)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "a card")
    mesh = Mesh(shape={})
    check = accel_mod._check_quant
    if raises:
        with pytest.raises(NotImplementedError, match="compute capability"):
            check(mode, torch.device("cuda"), mesh)
    else:
        check(mode, torch.device("cuda"), mesh)


def test_trainer_takes_the_quant_modes(tmp_path, monkeypatch):
    """TrainingArgs.compute_dtype and Strategy.quant_sites reach the
    Trainer's strategy and its description, and three steps under each
    mode take the losses of the bare auto_accelerate loop."""
    from dlrover_tpu_torch.common.ipc import (
        SOCKET_DIR_ENV,
        PersistentSharedMemory,
    )
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    job = f"fp8test{os.getpid()}"
    monkeypatch.setenv("ELASTIC_JOB_NAME", job)
    monkeypatch.setenv("DLROVER_PARAL_CONFIG_PATH", "")
    monkeypatch.setenv("DLROVER_RUNTIME_METRICS_PATH",
                       str(tmp_path / "metrics.json"))
    monkeypatch.setenv(SOCKET_DIR_ENV, str(tmp_path / "socks"))
    cfg = LlamaConfig(**dict(LLAMA, dtype="bfloat16"))
    rs = np.random.RandomState(9)
    batches = [{"tokens": rs.randint(0, 64, (4, 33)).astype(np.int32)}
               for _ in range(3)]
    try:
        for mode, sites in (("fp8", "all"), ("int8", "attn_qkv,mlp")):
            trainer = Trainer(
                llama_loss_fn(cfg), lambda s, d: llama_init(cfg, s, d), None,
                TrainingArgs(output_dir=str(tmp_path / mode), max_steps=3,
                             learning_rate=1e-2, compute_dtype=mode,
                             strategy=Strategy(remat="none",
                                               quant_sites=sites),
                             flash_checkpoint=False, log_steps=0),
                train_data=batches, device="cpu")
            strategy = trainer._accel.strategy
            assert strategy.compute_dtype == mode
            assert strategy.quant_sites == sites
            assert f"dtype={mode}" in strategy.describe()
            losses, inner = [], trainer._accel.train_step

            def step(state, batch, rng, inner=inner, losses=losses):
                state, metrics = inner(state, batch, rng)
                losses.append(metrics["loss"].item())
                return state, metrics

            trainer._accel.train_step = step
            trainer.train()
            bare = auto_accelerate(
                llama_loss_fn(cfg), lambda s, d: llama_init(cfg, s, d),
                trainer.optimizer, strategy, device="cpu")
            state, want = bare.state, []
            for batch in batches:
                state, m = bare.train_step(state, batch, None)
                want.append(m["loss"].item())
            assert len(losses) == 3 and all(np.isfinite(losses))
            np.testing.assert_allclose(losses, want, rtol=1e-6, atol=0)
    finally:
        for name in (f"dlrtpu_torch_ckpt_{job}_0",
                     f"dlrtpu_torch_timer_{job}"):
            try:
                seg = PersistentSharedMemory(name=name)
                seg.close()
                seg.unlink()
            except FileNotFoundError:
                pass


def test_quant_strategy_dataclass_keeps_sites():
    s = dataclasses.replace(Strategy(), compute_dtype="int8",
                            quant_sites="mlp")
    assert Strategy.from_json(s.to_json()) == s
    assert "qsites=mlp" in s.describe()
