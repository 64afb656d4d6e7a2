"""The low-precision compute kernels (K15 ``quantize_fp8``, K16
``quantize_int8_channels``, K17 ``dequantize_int32``) and the fp8/int8
GEMM calls on the card. These need an NVIDIA GPU and nvcc: without CUDA
they skip with a reason. Run them on the GPU with

    python -m pytest --noconftest -m cuda tests/test_torch_lowp_cuda.py

Tolerances:

- K15, K16 and K17 against their plain versions on the same CUDA inputs:
  bit for bit (codes, scales, values; NaN where NaN): the kernels do the
  plain versions' f32 operations in their order;
- the int8 GEMM (``torch._int_mm``) against the exact integer products:
  equal;
- the fp8 GEMM (``torch._scaled_mm``, f32 accumulation, the scales
  applied in f32) against the plain dequantized matmul (the operands
  dequantized to bf16, a bf16 matmul): 1e-2 of the largest value (the
  plain side rounds each dequantized operand to bf16, 2^-9, and both
  round the output to bf16);
- ``fp8_dot``/``int8_dot``/``int8_einsum`` forward and gradients on the
  card against the same op on the CPU from the same bf16 inputs: 2e-2
  of the largest value (bf16 matmuls in another order, and a code that
  flips where a value lies within that rounding of a boundary).
"""


import numpy as np
import pytest
import torch

from dlrover_tpu_torch.device import CUDA_SKIP_REASON, cuda_available
from dlrover_tpu_torch.ops import attention, fp8, lowp, quantization

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not cuda_available():
        pytest.skip(CUDA_SKIP_REASON)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device, dtype=torch.bfloat16, scale=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


def _rel(got, want):
    diff = (got.float() - want.float()).abs().max()
    return (diff / want.float().abs().max()).item()


def _equal_codes(got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=0,
                               equal_nan=True)


# the slice's operands (llama3-8b at B4 S2048: rows 8192) and ragged ones
FP8_SHAPES = [((8192, 4096), torch.bfloat16), ((4096, 6144), torch.bfloat16),
              ((1000, 200), torch.bfloat16), ((64, 48), torch.float32),
              ((3, 40, 24), torch.float32)]


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("shape,dtype", FP8_SHAPES,
                         ids=["act", "weight", "ragged", "f32", "3d"])
def test_quantize_fp8_matches_plain(cuda, fmt, shape, dtype):
    x = _randn(shape, 1, cuda, dtype, scale=3.0)
    before = lowp.quantize_fp8.launches
    q, qt, s = lowp.quantize_fp8(x, fmt, layout="both")
    assert lowp.quantize_fp8.launches == before + 1
    pq, pqt, ps = lowp.quantize_fp8_plain(x, fmt, layout="both")
    torch.cuda.synchronize()
    assert s.item() == ps.item()
    _equal_codes(q, pq)
    _equal_codes(qt, pqt)
    # a given scale below the amax: overflows (NaN / inf) as the plain
    given = torch.tensor(0.5, device=cuda)
    q, _, s = lowp.quantize_fp8(x, fmt, scale=given)
    pq, _, _ = lowp.quantize_fp8_plain(x, fmt, scale=given)
    _equal_codes(q, pq)
    assert s.item() == 0.5


def test_quantize_fp8_zeros_and_replays_in_a_graph(cuda):
    """An all-zero operand (scale 1e-12/448) and K15's amax ticket, which
    must come back to 0 after every launch: 3 graph replays give the same
    scale as eager calls."""
    z = torch.zeros(256, 512, dtype=torch.bfloat16, device=cuda)
    q, _, s = lowp.quantize_fp8(z)
    assert s.item() == lowp.quantize_fp8_plain(z)[2].item()
    assert q.float().abs().max().item() == 0.0
    x = _randn((2048, 1024), 2, cuda)
    out = {}
    graph = torch.cuda.CUDAGraph()
    lowp.quantize_fp8(x)  # warm-up outside the capture
    with torch.cuda.graph(graph):
        out["q"], _, out["s"] = lowp.quantize_fp8(x)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert out["s"].item() == lowp.quantize_fp8_plain(x)[2].item()
        _equal_codes(out["q"], lowp.quantize_fp8_plain(x)[0])


@pytest.mark.parametrize("channels", ["rows", "cols"])
@pytest.mark.parametrize("shape,dtype", [
    ((8192, 4096), torch.bfloat16), ((14336, 4096), torch.bfloat16),
    ((1000, 200), torch.bfloat16), ((96, 72), torch.float32)],
    ids=["act", "down", "ragged", "f32"])
def test_quantize_int8_channels_matches_plain(cuda, channels, shape, dtype):
    x = _randn(shape, 3, cuda, dtype, scale=2.0)
    x[5] = 0  # an all-zero row (and zeros in every column)
    q, s = lowp.quantize_int8_channels(x, channels)
    pq, ps = lowp.quantize_int8_channels_plain(x, channels)
    torch.cuda.synchronize()
    assert torch.equal(q, pq) and torch.equal(s, ps)


@pytest.mark.parametrize("product_first", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequantize_int32_matches_plain(cuda, product_first, dtype):
    gen = torch.Generator(device=cuda).manual_seed(4)
    for M, N in ((2048, 1024), (33, 50)):
        acc = torch.randint(-2 ** 24, 2 ** 24, (M, N), generator=gen,
                            device=cuda, dtype=torch.int32)
        sa = torch.rand(M, 1, generator=gen, device=cuda) * 1e-3
        sb = torch.rand(1, N, generator=gen, device=cuda) * 1e-3
        got = lowp.dequantize_int32(acc, sa, sb, dtype, product_first)
        want = lowp.dequantize_int32_plain(acc, sa, sb, dtype,
                                           product_first)
        assert torch.equal(got, want)


def test_gemm_routes(cuda):
    """``torch._int_mm`` gives the exact integer products; the fp8
    ``torch._scaled_mm`` the plain dequantized matmul within 1e-2."""
    a, b = _randn((2048, 4096), 5, cuda), _randn((4096, 1024), 6, cuda)
    qa, sa = lowp.quantize_int8_channels(a, "rows")
    qbt, sb = lowp.quantize_int8_channels(b, "cols")
    got = lowp.int8_mm(qa, qbt)
    want = (qa.double() @ qbt.double().t()).to(torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    qa8, _, sa8 = lowp.quantize_fp8(a, "e4m3")
    _, qbt8, sb8 = lowp.quantize_fp8(b, "e4m3", layout="col")
    out = lowp.fp8_mm(qa8, qbt8.t(), sa8, sb8, torch.bfloat16)
    plain = (lowp.dequantize_fp8(qa8, sa8, torch.bfloat16)
             @ lowp.dequantize_fp8(qbt8.t(), sb8, torch.bfloat16))
    assert out.dtype == torch.bfloat16 and _rel(out, plain) < 1e-2
    with pytest.raises(ValueError, match="multiple of 16"):
        lowp.fp8_mm(qa8[:, :40], qbt8.t()[:40], sa8, sb8, torch.bfloat16)
    with pytest.raises(ValueError, match="column-major"):
        lowp.fp8_mm(qa8, qbt8.t().contiguous(), sa8, sb8, torch.bfloat16)
    with pytest.raises(ValueError, match="M > 16"):
        lowp.int8_mm(qa[:16], qbt)


def _card_vs_cpu(fn, shapes, seed, cuda):
    """fn's output and input gradients on the card and on the CPU from
    the same bf16 inputs and cotangent."""
    inputs = [_randn(s, seed + i, cuda) for i, s in enumerate(shapes)]
    results = []
    for device in (cuda, torch.device("cpu")):
        xs = [x.detach().to(device).requires_grad_() for x in inputs]
        out = fn(*xs)
        g = _randn(tuple(out.shape), seed + 9, cuda).to(device)
        out.backward(g)
        results.append([out.detach()] + [x.grad for x in xs])
    return results


@pytest.mark.parametrize("op", ["fp8_dot", "int8_dot", "int8_einsum_qkv",
                                "int8_einsum_out", "int8_einsum_gpt2"])
def test_quantized_matmuls_on_the_card_match_the_cpu(cuda, op):
    fns = {
        "fp8_dot": (fp8.fp8_dot, [(2, 512, 1024), (1024, 768)]),
        "int8_dot": (quantization.int8_dot, [(2, 512, 1024), (1024, 768)]),
        "int8_einsum_qkv": (
            lambda a, b: quantization.int8_einsum("bsd,dhk->bhsk", a, b),
            [(2, 512, 1024), (1024, 8, 128)]),
        "int8_einsum_out": (
            lambda a, b: quantization.int8_einsum("bhsk,hkd->bsd", a, b),
            [(2, 8, 512, 128), (8, 128, 1024)]),
        "int8_einsum_gpt2": (
            lambda a, b: quantization.int8_einsum("bsd,dthk->tbhsk", a, b),
            [(2, 512, 1024), (1024, 3, 16, 64)]),
    }
    fn, shapes = fns[op]
    before = {k.__name__: k.launches for k in lowp.KERNELS}
    card, cpu = _card_vs_cpu(fn, shapes, 7, cuda)
    torch.cuda.synchronize()
    for got, want in zip(card, cpu):
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got.cpu(), want) < 2e-2
    after = {k.__name__: k.launches for k in lowp.KERNELS}
    if op == "fp8_dot":
        # a and b forward, the cotangent backward
        assert after["quantize_fp8"] - before["quantize_fp8"] == 3
    else:
        assert after["quantize_int8_channels"] - before[
            "quantize_int8_channels"] == 2
        assert after["dequantize_int32"] - before["dequantize_int32"] == 1


@pytest.mark.parametrize("mode", ["fp8", "int8"])
def test_llama_trains_on_the_card_under_the_quant_mode(cuda, mode):
    """Three steps of a 2-layer Llama (dim 512, head_dim 128) through
    auto_accelerate: finite, falling losses, K1-K4 and the mode's
    quantize kernels launched."""
    from dlrover_tpu_torch.models import LlamaConfig, llama_init, llama_loss_fn
    from dlrover_tpu_torch.parallel import Strategy, auto_accelerate
    from dlrover_tpu_torch.trainer import build_optimizer

    cfg = LlamaConfig(vocab_size=1024, dim=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, mlp_dim=1024, max_seq_len=512)
    res = auto_accelerate(llama_loss_fn(cfg),
                          lambda s, d: llama_init(cfg, s, d),
                          build_optimizer("adamw", 1e-3),
                          Strategy(compute_dtype=mode, remat="minimal"),
                          device="cuda")
    tokens = torch.randint(0, 1024, (4, 513), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(0))
    attention.reset_launches()
    for k in lowp.KERNELS:
        k.launches = 0
    state, losses = res.state, []
    for _ in range(3):
        state, m = res.train_step(state, {"tokens": tokens}, None)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    counts = attention.launches()
    assert all(counts[k] > 0 for k in ("flash_fwd", "flash_bwd_preprocess",
                                       "flash_bwd_dq", "flash_bwd_dkv"))
    if mode == "fp8":
        # 7 projections a layer: 2 operands forward, 1 cotangent backward
        assert lowp.quantize_fp8.launches == 3 * 7 * 2 * 3
    else:
        assert lowp.quantize_int8_channels.launches == 2 * 7 * 2 * 3
        assert lowp.dequantize_int32.launches == 7 * 2 * 3
