"""The port's KV-cache generation (dlrover_tpu_torch/rl/generation.py)
held against the JAX package's (dlrover_tpu/rl/generation.py) on the CPU.

``PRESETS["tiny"]`` in f32 (GQA 4/2), the same with 8 heads over 2 kv
heads, and a tiny MoE config; weights from JAX's ``llama_init`` through
``params_from_jax``, inputs seeded numpy. Logits, logprobs and cache
contents agree within 1e-5 of the largest value; greedy tokens, cache
positions and masks are equal. The port's cache is laid out
[L, B, KVH, C, hd], the JAX package's [L, B, C, KVH, hd]: the comparison
transposes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.rl import generation as jg
from dlrover_tpu_torch.models import llama as port_llama
from dlrover_tpu_torch.models import params_from_jax
from dlrover_tpu_torch.rl import generation as tg

REL_TOL = 1e-5

CONFIGS = {
    "tiny": {},
    "gqa8": {"n_heads": 8, "n_kv_heads": 2},
    "moe": {"n_experts": 4, "moe_top_k": 2, "mlp_dim": 64},
}


def configs(name):
    """(JAX config, port config) of ``PRESETS["tiny"]`` with CONFIGS'
    changes."""
    fields = dataclasses.asdict(port_llama.PRESETS["tiny"])
    fields.update(CONFIGS[name])
    return jax_llama.LlamaConfig(**fields), port_llama.LlamaConfig(**fields)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jc, tc = configs(request.param)
    jp = jax_llama.llama_init(jc, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return request.param, jc, tc, jp, tp


@pytest.fixture(scope="module")
def dense():
    jc, tc = configs("tiny")
    jp = jax_llama.llama_init(jc, jax.random.key(0))
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def tokens(seed, shape, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def assert_close(got, want, what, tol=REL_TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def assert_cache_equal(port_cache, jax_cache, what):
    """The port's [L, B, KVH, C, hd] cache against JAX's
    [L, B, C, KVH, hd]; positions exactly."""
    np.testing.assert_array_equal(port_cache.pos.numpy(),
                                  np.asarray(jax_cache.pos), what)
    assert_close(port_cache.k.transpose(2, 3), jax_cache.k, f"{what} k")
    assert_close(port_cache.v.transpose(2, 3), jax_cache.v, f"{what} v")


def test_bucket_len_is_the_jax_policy():
    for n in (1, 3, 8, 9, 100, 1000, 2049):
        for cap in (None, 64, 2048):
            assert tg.bucket_len(n, cap) == jg.bucket_len(n, cap)
    assert tg.MIN_PROMPT_BUCKET == jg.MIN_PROMPT_BUCKET


@pytest.mark.parametrize("bucketed", [False, True])
def test_prefill_matches_jax(model, bucketed):
    _, jc, tc, jp, tp = model
    toks = tokens(1, (2, 9))
    valid = None
    if bucketed:
        toks = np.concatenate([toks, np.zeros((2, 7), np.int32)], 1)
        valid = 9
    jl, jcache = jg.prefill(jc, jp, jnp.asarray(toks),
                            jg.init_kv_cache(jc, 2, 32), valid_len=valid)
    tl, tcache = tg.prefill(tc, tp, torch.as_tensor(toks),
                            tg.init_kv_cache(tc, 2, 32, device="cpu"),
                            valid_len=valid)
    assert_close(tl, jl, "prefill logits")
    assert_cache_equal(tcache, jcache, "prefill cache")


def test_decode_steps_match_jax(model):
    _, jc, tc, jp, tp = model
    toks = tokens(1, (2, 6))
    _, jcache = jg.prefill(jc, jp, jnp.asarray(toks),
                           jg.init_kv_cache(jc, 2, 32))
    _, tcache = tg.prefill(tc, tp, torch.as_tensor(toks),
                           tg.init_kv_cache(tc, 2, 32, device="cpu"))
    for step in range(4):
        nxt = tokens(10 + step, (2,))
        jl, jcache = jg.decode_step(jc, jp, jnp.asarray(nxt), 6 + step,
                                    jcache)
        tl, tcache = tg.decode_step(tc, tp, torch.as_tensor(nxt), 6 + step,
                                    tcache)
        assert_close(tl, jl, f"decode step {step}")
    assert_cache_equal(tcache, jcache, "after 4 decode steps")


def test_decode_matches_the_port_full_forward(dense):
    """The cached decode equals the port's non-cached forward over the
    growing prefix (the twin of test_decode_steps_match)."""
    _, tc, _, tp = dense
    prefix = tokens(1, (2, 6))
    logits, cache = tg.prefill(tc, tp, torch.as_tensor(prefix),
                               tg.init_kv_cache(tc, 2, 32, device="cpu"))
    for step in range(3):
        full = port_llama.llama_apply(tc, tp, torch.as_tensor(prefix))
        assert_close(logits, full[:, -1], f"step {step}")
        nxt = tokens(20 + step, (2,))
        logits, cache = tg.decode_step(tc, tp, torch.as_tensor(nxt),
                                       prefix.shape[1], cache)
        prefix = np.concatenate([prefix, nxt[:, None]], 1)


def test_prefill_longer_than_cache_keeps_last_window(dense):
    jc, tc, jp, tp = dense
    toks = tokens(1, (2, 20))
    jl, jcache = jg.prefill(jc, jp, jnp.asarray(toks),
                            jg.init_kv_cache(jc, 2, 8))
    tl, tcache = tg.prefill(tc, tp, torch.as_tensor(toks),
                            tg.init_kv_cache(tc, 2, 8, device="cpu"))
    assert_close(tl, jl, "window prefill logits")
    assert_cache_equal(tcache, jcache, "window cache")
    np.testing.assert_array_equal(np.sort(tcache.pos.numpy()),
                                  np.arange(12, 20))
    with pytest.raises(ValueError, match="bucket"):
        tg.prefill(tc, tp, torch.as_tensor(toks),
                   tg.init_kv_cache(tc, 2, 8, device="cpu"), valid_len=3)


def test_ring_wraparound_matches_jax(dense):
    """Decode well past the capacity: every step's logits and the ring's
    positions as the JAX package's."""
    jc, tc, jp, tp = dense
    C = 8
    toks = tokens(2, (1, 20))
    _, jcache = jg.prefill(jc, jp, jnp.asarray(toks[:, :6]),
                           jg.init_kv_cache(jc, 1, C))
    _, tcache = tg.prefill(tc, tp, torch.as_tensor(toks[:, :6]),
                           tg.init_kv_cache(tc, 1, C, device="cpu"))
    for pos in range(6, 15):
        jl, jcache = jg.decode_step(jc, jp, jnp.asarray(toks[:, pos]), pos,
                                    jcache)
        tl, tcache = tg.decode_step(tc, tp, torch.as_tensor(toks[:, pos]),
                                    pos, tcache)
        assert_close(tl, jl, f"position {pos}")
    assert_cache_equal(tcache, jcache, "wrapped ring")
    np.testing.assert_array_equal(np.sort(tcache.pos.numpy()),
                                  np.arange(7, 15))


def test_greedy_generate_matches_jax(model):
    _, jc, tc, jp, tp = model
    prompt = tokens(1, (2, 5))
    want = jg.generate(jc, jp, jnp.asarray(prompt), jax.random.key(2),
                       jg.GenerateConfig(max_new_tokens=6, temperature=0.0))
    got = tg.generate(tc, tp, torch.as_tensor(prompt), 2,
                      tg.GenerateConfig(max_new_tokens=6, temperature=0.0))
    np.testing.assert_array_equal(got.sequences.numpy(),
                                  np.asarray(want.sequences))
    assert_close(got.logprobs, want.logprobs, "greedy logprobs")
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


@pytest.mark.parametrize("P", [3, 6, 11])
def test_backend_bucketed_and_exact_match_jax(model, P):
    """Both backends (padded length buckets and exact lengths) give the
    JAX backends' greedy sequences."""
    _, jc, tc, jp, tp = model
    gen_j = jg.GenerateConfig(max_new_tokens=6, temperature=0.0)
    gen_t = tg.GenerateConfig(max_new_tokens=6, temperature=0.0)
    prompt = tokens(P, (2, P))
    for bucket in (True, False):
        want = jg.KVCacheGenerationBackend(jc, gen_j, bucket).generate(
            jp, prompt, jax.random.key(4))
        got = tg.KVCacheGenerationBackend(tc, gen_t, bucket,
                                          device="cpu").generate(
            tp, prompt, 4)
        np.testing.assert_array_equal(got.sequences.numpy(),
                                      np.asarray(want.sequences),
                                      f"bucketed={bucket}")
        assert_close(got.logprobs, want.logprobs, f"bucketed={bucket}")


def test_backend_one_variant_per_bucket(dense):
    _, tc, _, tp = dense
    backend = tg.KVCacheGenerationBackend(
        tc, tg.GenerateConfig(max_new_tokens=4, temperature=0.0),
        device="cpu")
    for P in (3, 5, 6, 7, 8):
        res = backend.generate(tp, tokens(P, (2, P)), 2)
        assert res.sequences.shape == (2, P + 4)
    assert backend.trace_count() == 1
    backend.generate(tp, tokens(9, (2, 9)), 2)
    assert backend.trace_count() == 2


def test_small_cache_takes_the_sliding_window_path(dense):
    """A cache smaller than the bucket: the static truncation path, as
    the JAX backend takes it (greedy sequences equal)."""
    jc, tc, jp, tp = dense
    prompt = tokens(1, (2, 10))
    want = jg.KVCacheGenerationBackend(
        jc, jg.GenerateConfig(max_new_tokens=4, temperature=0.0,
                              cache_capacity=6)).generate(
        jp, prompt, jax.random.key(2))
    got = tg.KVCacheGenerationBackend(
        tc, tg.GenerateConfig(max_new_tokens=4, temperature=0.0,
                              cache_capacity=6), device="cpu").generate(
        tp, prompt, 2)
    np.testing.assert_array_equal(got.sequences.numpy(),
                                  np.asarray(want.sequences))
    assert_close(got.logprobs, want.logprobs, "sliding window logprobs")


def test_eos_mask_matches_jax(dense):
    """An eos taken from the greedy continuation: the mask is 1 through
    the first eos and 0 after it, as the JAX package's."""
    jc, tc, jp, tp = dense
    prompt = tokens(3, (2, 5))
    free = tg.generate(tc, tp, torch.as_tensor(prompt), 0,
                       tg.GenerateConfig(max_new_tokens=8, temperature=0.0))
    eos = int(free.sequences[0, 5 + 2])
    want = jg.generate(jc, jp, jnp.asarray(prompt), jax.random.key(0),
                       jg.GenerateConfig(max_new_tokens=8, temperature=0.0,
                                         eos_id=eos))
    got = tg.generate(tc, tp, torch.as_tensor(prompt), 0,
                      tg.GenerateConfig(max_new_tokens=8, temperature=0.0,
                                        eos_id=eos))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    mask = got.mask.numpy()[0]
    first = int(np.argmax(got.sequences.numpy()[0, 5:] == eos))
    assert mask[:first + 1].all() and not mask[first + 1:].any()


def test_sampling_is_a_function_of_the_seed(dense):
    """At temperature 1: the same seed draws the same sequence, another
    seed another; each logprob is log_softmax of the port's full forward
    at the drawn token; token 0's draw does not depend on the later
    draws (the JAX package splits its key before the first sample)."""
    _, tc, _, tp = dense
    prompt = torch.as_tensor(tokens(1, (4, 5)))
    gen = tg.GenerateConfig(max_new_tokens=8, temperature=1.0)
    a = tg.generate(tc, tp, prompt, 7, gen)
    b = tg.generate(tc, tp, prompt, 7, gen)
    c = tg.generate(tc, tp, prompt, 8, gen)
    assert torch.equal(a.sequences, b.sequences)
    assert not torch.equal(a.sequences, c.sequences)
    first = tg.generate(tc, tp, prompt, 7,
                        tg.GenerateConfig(max_new_tokens=1, temperature=1.0))
    assert torch.equal(first.sequences[:, 5], a.sequences[:, 5])
    full = port_llama.llama_apply(tc, tp, a.sequences[:, :-1])
    logp = torch.log_softmax(full[:, 4:], -1).gather(
        -1, a.sequences[:, 5:, None].long())[..., 0]
    assert_close(a.logprobs, logp, "sampled logprobs")
    assert np.isfinite(a.logprobs.numpy()).all()


def test_moe_params_and_decode_without_the_training_raise():
    """``params_from_jax`` carries the router and the [L, E, D, M] expert
    leaves; the decode path runs MoE, where the training forward still
    raises (ROADMAP item 10)."""
    jc, tc = configs("moe")
    jp = jax_llama.llama_init(jc, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    L, D, E, M = tc.n_layers, tc.dim, tc.n_experts, tc.mlp_dim
    assert tp["layers.router"].shape == (L, D, E)
    assert tp["layers.w_gate"].shape == (L, E, D, M)
    assert tp["layers.w_up"].shape == (L, E, D, M)
    assert tp["layers.w_down"].shape == (L, E, M, D)
    np.testing.assert_array_equal(tp["layers.router"].numpy(),
                                  np.asarray(jp["layers"]["router"]))
    with pytest.raises(NotImplementedError, match="item 10"):
        port_llama.llama_apply(tc, tp, torch.zeros(1, 3, dtype=torch.long))
    res = tg.KVCacheGenerationBackend(
        tc, tg.GenerateConfig(max_new_tokens=4), device="cpu").generate(
        tp, np.zeros((1, 3), np.int32), 0)
    assert res.sequences.shape == (1, 7)
    assert np.isfinite(res.logprobs.numpy()).all()


def test_default_device_raises_without_cuda(dense, monkeypatch):
    _, tc, _, _ = dense
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tg.KVCacheGenerationBackend(tc)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tg.init_kv_cache(tc, 1, 8)
