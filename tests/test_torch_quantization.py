"""Parity of the port's optimizer-state quantization (ops/quantization.py)
with the JAX package's on the CPU: the JAX side runs its Pallas kernels
in interpret mode, as its own tests do; the port runs the plain versions
of K5/K6, which the CUDA kernels are held to on the card.

Both sides get the same inputs (numpy, from a seed) and the same
rounding field ``u``, drawn with ``jax.random.uniform`` exactly where
``quantize_int8`` draws it. Tolerances: int8 codes, scales and
dequantized values bit-equal (the same f32 operations in the same
order). Log codes equal except where a log differs by an ulp across a
rounding edge (the two libraries' log): at most 1e-3 of entries, each
off by 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import quantization as jq
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import quantization as tq

SHAPES = {
    "ragged": (1000,),
    "matrix": (7, 33),
    "rows": (4, 512),
}


def _x(shape, seed, zero_block=False):
    x = (np.random.RandomState(seed).randn(*shape) * 3).astype(np.float32)
    if zero_block:
        x.reshape(-1)[:256] = 0.0  # an all-zero block: scale 1
    return x


def _jax_u(seed, rows):
    return np.array(jax.random.uniform(jax.random.key(seed),
                                       (rows, jq.BLOCK)))


@pytest.mark.parametrize("stochastic", [True, False],
                         ids=["stochastic", "nearest"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_int8_quantize_and_dequantize_bit_equal(name, stochastic):
    x = _x(SHAPES[name], seed=len(name), zero_block=(name == "rows"))
    seed = 11
    jqz, jscale, jshape = jq.quantize_int8(jnp.asarray(x), seed=seed,
                                           stochastic=stochastic)
    rows = jqz.shape[0]
    u = torch.from_numpy(_jax_u(seed, rows)) if stochastic else None
    tqz, tscale, tshape = tq.quantize_int8(torch.from_numpy(x), u=u,
                                           stochastic=stochastic)
    assert tshape == tuple(jshape)
    np.testing.assert_array_equal(tqz.numpy(), np.asarray(jqz))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    if name == "rows":
        assert tscale[0].item() == 1.0
    jout = jq.dequantize_int8(jqz, jscale, jshape)
    tout = tq.dequantize_int8(tqz, tscale, tshape)
    assert tout.shape == tuple(jshape)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_stochastic_rounding_draws_from_the_explicit_generator():
    x = torch.from_numpy(_x((3, 300), seed=5))
    draws = [tq.quantize_int8(x, generator=torch.Generator().manual_seed(7))
             for _ in range(2)]
    assert torch.equal(draws[0][0], draws[1][0])
    other = tq.quantize_int8(x, generator=torch.Generator().manual_seed(8))
    assert not torch.equal(draws[0][0], other[0])
    # unbiased: the mean of dequantized draws approaches x
    gen = torch.Generator().manual_seed(0)
    mean = sum(tq.dequantize_int8(*tq.quantize_int8(x, generator=gen))
               for _ in range(200)) / 200
    q, s, _ = tq.quantize_int8(x, stochastic=False)
    step = s.max().item()
    assert (mean - x).abs().max().item() < 0.2 * step


@pytest.mark.parametrize("name", list(SHAPES))
def test_pos_log_codes_match_jax(name):
    x = np.abs(_x(SHAPES[name], seed=3 + len(name)))
    x.reshape(-1)[::7] *= 1e-6      # a wide dynamic range
    x.reshape(-1)[::13] = 0.0       # exact zeros keep code 0
    if name == "rows":
        x.reshape(-1)[:256] = 0.0
    jcode, jscale = jq.quantize_pos_log(jnp.asarray(x))
    tcode, tscale = tq.quantize_pos_log(torch.from_numpy(x))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    diff = np.abs(tcode.numpy().astype(np.int32)
                  - np.asarray(jcode).astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 1e-3
    assert np.array_equal(tcode.numpy() == 0, np.asarray(jcode) == 0)
    # the table decode is bit-equal on equal codes
    jout = np.asarray(jq.dequantize_pos_log(jcode, jscale, x.shape))
    tout = tq.dequantize_pos_log(torch.from_numpy(np.array(jcode)),
                                 tscale, x.shape).numpy()
    np.testing.assert_array_equal(tout, jout)


def test_wrappers_refuse_mixed_devices():
    x = torch.zeros(300)
    meta = torch.zeros(2, tq.BLOCK, device="meta")
    with pytest.raises(ValueError, match="mixed devices"):
        tq.quantize_int8(x, u=meta)
    with pytest.raises(ValueError, match="mixed devices"):
        tq.dequantize_int8(meta.to(torch.int8), torch.ones(2, 1), (300,))


def test_a_device_tensor_launches_the_kernel_never_the_plain_version(
        monkeypatch):
    """Off the CPU the wrappers go to the kernel (here a stub launcher on
    meta tensors): there is no path from a device tensor to the plain
    version."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda symbol, library, argtypes, *args:
                        calls.append((symbol, library, len(argtypes),
                                      len(args))))
    monkeypatch.setattr(tq, "quantize_int8_plain", None)
    monkeypatch.setattr(tq, "dequantize_int8_plain", None)
    before = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
    x = torch.zeros(3, 300, device="meta")
    u = torch.zeros(4, tq.BLOCK, device="meta")
    q, s, shape = tq.quantize_int8(x, u=u)
    assert q.shape == (4, tq.BLOCK) and s.shape == (4, 1) and shape == (3, 300)
    out = tq.dequantize_int8(q, s, shape)
    assert out.shape == (3, 300)
    assert [c[:2] for c in calls] == [("quantize_int8", "optim"),
                                      ("dequantize_int8", "optim")]
    assert all(n_types == n_args for _s, _l, n_types, n_args in calls)
    assert (tq.quantize_int8.launches, tq.dequantize_int8.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError, match="float32"):
        tq.quantize_int8(x.double(), u=u)
