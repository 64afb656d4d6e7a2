"""The port's serving arm (dlrover_tpu_torch/serving) held against the
JAX package's (dlrover_tpu/serving) on the CPU.

The slot engine's admissions and decode steps on mixed slots, slot reuse
after an eviction, the ring past its capacity and an over-long prompt:
tokens equal, logprobs and cache contents within 1e-5 of the largest
value, positions equal (``PRESETS["tiny"]`` in f32, GQA 4/2, and a tiny
MoE config; weights from JAX's ``llama_init``). The scheduler's outputs
and its EOS eviction are held against JAX's scheduler on the same
requests, not against a hand-made expectation. Then the pool under a
chaos kill (the twin of tests/test_serving.py's ``TestServingSmoke``)
against the port's servicer, a decode worker over the port's master
process through ``RpcServingClient``, and the master's torch-free start.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.serving import engine as je
from dlrover_tpu.serving import loadgen as jax_loadgen
from dlrover_tpu.serving import scheduler as jsched
from dlrover_tpu_torch.common import chaos
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.models import llama as port_llama
from dlrover_tpu_torch.models import params_from_jax
from dlrover_tpu_torch.serving import engine as te
from dlrover_tpu_torch.serving import loadgen
from dlrover_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    ServeRequest,
)
from dlrover_tpu_torch.serving.worker import (
    DecodeWorker,
    LocalServingClient,
    RpcServingClient,
)

pytestmark = pytest.mark.serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-5
CONFIGS = {
    "tiny": {},
    "moe": {"n_experts": 4, "moe_top_k": 2, "mlp_dim": 64},
}


def configs(name):
    fields = dataclasses.asdict(port_llama.PRESETS["tiny"])
    fields.update(CONFIGS[name])
    return jax_llama.LlamaConfig(**fields), port_llama.LlamaConfig(**fields)


def build(name):
    jc, tc = configs(name)
    jp = jax_llama.llama_init(jc, jax.random.key(0))
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    return build(request.param)


@pytest.fixture(scope="module")
def dense():
    return build("tiny")


def prompt(seed, n, vocab=256):
    return [int(t) for t in
            np.random.RandomState(seed).randint(0, vocab, n)]


def assert_close(got, want, what, tol=REL_TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), f"{what}: {err}"


def assert_pool_equal(port_eng, jax_eng, what):
    """The port's [L, S, KVH, C, hd] pool against JAX's [L, S, C, KVH,
    hd]; the position rows exactly."""
    np.testing.assert_array_equal(port_eng.cache.pos.numpy(),
                                  np.asarray(jax_eng.cache.pos), what)
    assert_close(port_eng.cache.k.transpose(2, 3), jax_eng.cache.k,
                 f"{what} k")
    assert_close(port_eng.cache.v.transpose(2, 3), jax_eng.cache.v,
                 f"{what} v")


def engines(m, slots, capacity):
    jc, tc, jp, tp = m
    return (je.DecodeEngine(jc, jp, slots=slots, capacity=capacity),
            te.DecodeEngine(tc, tp, slots=slots, capacity=capacity,
                            device="cpu"))


def both_admit(jeng, teng, slot, p, seed, temperature=0.0):
    a = jeng.admit(slot, p, jax.random.key(seed), temperature)
    b = teng.admit(slot, p, seed, temperature)
    assert (a[0], a[2]) == (b[0], b[2]), (a, b)
    assert abs(a[1] - b[1]) <= REL_TOL * max(abs(a[1]), 1.0), (a, b)
    return b


def both_step(jeng, teng, tokens, positions, live, seed):
    S = len(tokens)
    jt, jl = jeng.step(tokens, positions, live, jax.random.key(seed),
                       [0.0] * S)
    tt, tl = teng.step(tokens, positions, live, seed, [0.0] * S)
    # every slot, dead ones included: the garbage is the same garbage
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert_close(tl, jl, "step logprobs")
    return tt


def greedy_reference(tc, tp, seq, n):
    """n greedy tokens from the port's full non-cached forward."""
    seq = list(seq)
    out = []
    for _ in range(n):
        logits = port_llama.llama_apply(tc, tp, torch.as_tensor([seq]))
        out.append(int(torch.argmax(logits[0, -1])))
        seq.append(out[-1])
    return out


# =========================================================== slot engine


def test_bucket_len_reexported():
    from dlrover_tpu_torch.rl import generation

    assert te.bucket_len is generation.bucket_len
    assert te.moe_mixture is generation.moe_mixture
    assert te.MIN_BUCKET == je.MIN_BUCKET
    assert [te.bucket_len(n, 64) for n in (3, 8, 9, 200)] == [8, 8, 16, 64]


def test_mixed_slots_match_jax(model):
    """Two sequences of different lengths in slots 2 and 0, decoding in
    one step: tokens, logprobs and the whole pool as the JAX engine's
    after every step."""
    jeng, teng = engines(model, 4, 32)
    pa, pb = prompt(1, 7), prompt(2, 4)
    ta = both_admit(jeng, teng, 2, pa, 5)
    tb = both_admit(jeng, teng, 0, pb, 6)
    assert_pool_equal(teng, jeng, "after admission")
    seqs = {2: pa + [ta[0]], 0: pb + [tb[0]]}
    pos = {2: ta[2], 0: tb[2]}
    for i in range(4):
        tokens, positions, live = [0] * 4, [0] * 4, [False] * 4
        for slot, seq in seqs.items():
            tokens[slot], positions[slot], live[slot] = seq[-1], pos[slot], True
        nxt = both_step(jeng, teng, tokens, positions, live, 10 + i)
        for slot in seqs:
            seqs[slot].append(int(nxt[slot]))
            pos[slot] += 1
        assert_pool_equal(teng, jeng, f"step {i}")


def test_mixed_slots_match_the_port_full_forward(dense):
    _, tc, _, tp = dense
    eng = te.DecodeEngine(tc, tp, slots=4, capacity=32, device="cpu")
    pa, pb = prompt(1, 7), prompt(2, 4)
    ta, _, ua = eng.admit(2, pa, 5, 0.0)
    tb, _, ub = eng.admit(0, pb, 6, 0.0)
    assert ta == greedy_reference(tc, tp, pa, 1)[0]
    assert tb == greedy_reference(tc, tp, pb, 1)[0]
    seqs, pos = {2: pa + [ta], 0: pb + [tb]}, {2: ua, 0: ub}
    for i in range(3):
        tokens, positions, live = [0] * 4, [0] * 4, [False] * 4
        for slot, seq in seqs.items():
            tokens[slot], positions[slot], live[slot] = seq[-1], pos[slot], True
        nxt, _ = eng.step(tokens, positions, live, 10 + i, [0.0] * 4)
        for slot, seq in seqs.items():
            assert int(nxt[slot]) == greedy_reference(tc, tp, seq, 1)[0]
            seq.append(int(nxt[slot]))
            pos[slot] += 1


def test_slot_reuse_after_eviction_matches_jax(model):
    """A slot whose previous occupant wrote deep into the ring serves a
    new short sequence exactly as the JAX engine does: admission resets
    the whole position row."""
    jeng, teng = engines(model, 2, 16)
    long_p = prompt(3, 12)
    tok, _, used = both_admit(jeng, teng, 1, long_p, 1)
    seq = long_p + [tok]
    for i in range(3):
        nxt = both_step(jeng, teng, [0, seq[-1]], [0, used + i],
                        [False, True], 20 + i)
        seq.append(int(nxt[1]))
    tok, _, used = both_admit(jeng, teng, 1, prompt(4, 5), 2)
    assert_pool_equal(teng, jeng, "after re-admission")
    both_step(jeng, teng, [0, tok], [0, used], [False, True], 9)
    assert_pool_equal(teng, jeng, "after the step")


def test_ring_wraparound_matches_jax(dense):
    """Decoding past the ring's capacity keeps a sliding window, step for
    step as the JAX engine."""
    jeng, teng = engines(dense, 1, 8)
    tok, _, pos = both_admit(jeng, teng, 0, prompt(5, 6), 0)
    for i in range(12):
        nxt = both_step(jeng, teng, [tok], [pos], [True], 30 + i)
        tok, pos = int(nxt[0]), pos + 1
    assert_pool_equal(teng, jeng, "wrapped ring")
    rows = teng.cache.pos.numpy()[0]
    assert rows.min() >= pos - 8 and rows.max() == pos - 1


def test_ring_past_capacity_is_a_sliding_window_forward(dense):
    """Past its capacity C the ring holds each token's C latest
    positions, so the decode logits equal a plain forward over the whole
    sequence with a sliding window of C keys (``chip_smoke.py``'s
    reference for the same check on the card)."""
    import chip_smoke

    _, tc, _, tp = dense
    C, S, n, steps = 16, 4, 12, 14
    eng = te.DecodeEngine(tc, tp, slots=S, capacity=C, device="cpu")
    seq = torch.as_tensor(prompt(9, n + steps))
    padded = torch.zeros(eng.bucket_for(n), dtype=torch.long)
    padded[:n] = seq[:n]
    te.prefill_logits(tc, eng.weights, eng.cache, padded, n, 2)
    got = []
    for t in range(steps):
        tokens = torch.zeros(S, dtype=torch.long)
        positions = torch.zeros(S, dtype=torch.long)
        live = torch.zeros(S, dtype=torch.bool)
        tokens[2], positions[2], live[2] = seq[n + t], n + t, True
        got.append(te.decode_logits(tc, eng.weights, eng.cache, tokens,
                                    positions, live)[2])
    want = chip_smoke.windowed_forward(tc, tp, seq[None], C,
                                       chip_smoke.plain_attend)[0, n:]
    assert_close(torch.stack(got), want, "windowed forward")
    # and the ring is not a fresh forward over its window alone: the
    # tokens it holds were computed with their own windows
    window = seq[None, n + steps - C:]
    fresh = port_llama.llama_apply(
        tc, tp, window, torch.arange(n + steps - C, n + steps)[None])
    assert float((fresh[0, -1] - got[-1]).abs().max()) > 1e-3


def test_over_long_prompt_keeps_the_last_capacity_tokens(dense):
    jeng, teng = engines(dense, 2, 8)
    tok, _, used = both_admit(jeng, teng, 1, prompt(6, 20), 3)
    assert used == 8
    both_step(jeng, teng, [0, tok], [0, used], [False, True], 4)
    assert_pool_equal(teng, jeng, "truncated prompt")


def test_prefill_variants_bounded_by_buckets(dense):
    _, tc, _, tp = dense
    eng = te.DecodeEngine(tc, tp, slots=2, capacity=32, device="cpu")
    for n in (3, 4, 5, 6, 7, 8):
        eng.admit(0, prompt(n, n), n, 0.0)
    assert eng.prefill_traces() == 1
    for n in (9, 12, 16):
        eng.admit(0, prompt(n, n), n, 0.0)
    assert eng.prefill_traces() == 2
    assert eng.decode_traces() == 0  # decode untouched so far
    eng.step([0, 0], [0, 0], [False, False], 0, [0.0, 0.0])
    assert eng.decode_traces() == 1


def test_warmup_leaves_the_pool_as_it_was(dense):
    _, tc, _, tp = dense
    eng = te.DecodeEngine(tc, tp, slots=2, capacity=32, device="cpu")
    eng.admit(1, prompt(7, 9), 1, 0.0)
    before = [t.clone() for t in eng.cache]
    eng.warmup()
    assert all(torch.equal(a, b) for a, b in zip(before, eng.cache))
    assert eng.prefill_traces() == 3 and eng.decode_traces() == 1


def test_temperature_sampling_is_a_function_of_the_seed(dense):
    """Same seeds, same draws; the returned logprob is log_softmax of the
    full forward's logits at the drawn token."""
    _, tc, _, tp = dense
    outs = []
    for _ in range(2):
        eng = te.DecodeEngine(tc, tp, slots=2, capacity=32, device="cpu")
        p = prompt(7, 6)
        tok, logp, used = eng.admit(0, p, 3, 0.8)
        seq, lps = p + [tok], [logp]
        for i in range(4):
            nxt, lp = eng.step([seq[-1], 0], [used + i, 0], [True, False],
                               40 + i, [0.8, 0.0])
            seq.append(int(nxt[0]))
            lps.append(float(lp[0]))
        outs.append((tuple(seq), tuple(lps)))
    assert outs[0] == outs[1]
    seq = list(outs[0][0])
    full = port_llama.llama_apply(tc, tp, torch.as_tensor([seq[:-1]]))
    logp = torch.log_softmax(full[0, 5:], -1).gather(
        -1, torch.as_tensor(seq[6:])[:, None])[:, 0]
    assert_close(torch.as_tensor(outs[0][1]), logp, "sampled logprobs")


def test_engine_default_device_raises_without_cuda(dense, monkeypatch):
    _, tc, _, tp = dense
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        te.DecodeEngine(tc, tp, slots=2, capacity=8)


# ============================================================ scheduler


def run_scheduler(sched, n, limit=50):
    done = []
    for _ in range(limit):
        done.extend(sched.step())
        if len(done) == n:
            break
    return {f.request_id: f for f in done}


def both_schedulers(m, reqs, slots=2, capacity=32):
    """The same requests through JAX's scheduler and the port's."""
    jeng, teng = engines(m, slots, capacity)
    js = jsched.ContinuousBatchingScheduler(jeng, rng_seed=7)
    ts = ContinuousBatchingScheduler(teng, rng_seed=7)
    for r in reqs:
        js.submit(jsched.ServeRequest(**r))
        ts.submit(ServeRequest(**r))
    return run_scheduler(js, len(reqs)), run_scheduler(ts, len(reqs)), \
        js, ts


def test_scheduler_outputs_match_jax(model):
    """Three requests with different budgets over two slots: the third is
    admitted mid-flight. Tokens, finish reasons and the overlap high
    water as JAX's scheduler."""
    reqs = [dict(request_id=f"r{i}", prompt=prompt(50 + i, 4 + i),
                 max_new_tokens=budget, temperature=0.0)
            for i, budget in enumerate((2, 6, 4))]
    want, got, js, ts = both_schedulers(model, reqs)
    assert sorted(got) == ["r0", "r1", "r2"]
    for rid, fin in got.items():
        assert fin.tokens == want[rid].tokens, rid
        assert fin.finish_reason == want[rid].finish_reason == "length"
        assert fin.prompt_len == want[rid].prompt_len
    stats = ts.stats()
    for key in ("completed", "tokens_out", "overlap_high_water",
                "queue_depth", "live"):
        assert stats[key] == js.stats()[key], key
    assert stats["overlap_high_water"] == 2


def eos_cases():
    """(eos index, eos id) of the tiny model's greedy continuation of
    the request: index 1 (the JAX test's choice, where a repeated greedy
    token may make it equal the first token) and the first index >= 2
    whose token did not come before it."""
    _, tc, _, tp = build("tiny")
    p = prompt(70, 5)
    ref = greedy_reference(tc, tp, p, 12)
    late = next(j for j in range(2, len(ref)) if ref[j] not in ref[:j])
    return p, ref, [(1, ref[1]), (late, ref[late])]


@pytest.mark.parametrize("case", ["second", "late"])
def test_eos_eviction_matches_jax_scheduler(dense, case):
    p, ref, cases = eos_cases()
    index, eos = cases[["second", "late"].index(case)]
    req = dict(request_id="r0", prompt=p, max_new_tokens=12,
               temperature=0.0, eos_id=eos)
    want, got, _, _ = both_schedulers(dense, [req], slots=1)
    assert got["r0"].tokens == want["r0"].tokens
    assert got["r0"].finish_reason == want["r0"].finish_reason == "eos"
    # evicted at the FIRST occurrence of the eos id
    first = ref.index(eos)
    assert got["r0"].tokens == ref[:first + 1]
    if case == "late":
        assert first == index >= 2


def test_abandon_surfaces_every_request_id(dense):
    _, teng = engines(dense, 1, 32)
    sched = ContinuousBatchingScheduler(teng, rng_seed=7)
    for i in range(3):
        sched.submit(ServeRequest(request_id=f"r{i}",
                                  prompt=prompt(80 + i, 4),
                                  max_new_tokens=8))
    sched.step()
    assert sorted(sched.abandon()) == ["r0", "r1", "r2"]
    assert sched.live() == 0 and sched.queue_depth() == 0


def test_scheduler_seeds_are_deterministic_and_key_factory_stays(dense):
    _, teng = engines(dense, 1, 32)
    a = ContinuousBatchingScheduler(teng, rng_seed=3)
    b = ContinuousBatchingScheduler(teng, rng_seed=3)
    assert [a._next_key() for _ in range(3)] == \
        [b._next_key() for _ in range(3)]
    c = ContinuousBatchingScheduler(teng, key_factory=lambda: 11)
    assert c._next_key() == 11


def test_loadgen_is_the_jax_copy():
    assert loadgen.poisson_arrivals(8, 10.0, seed=5) == \
        jax_loadgen.poisson_arrivals(8, 10.0, seed=5)
    assert loadgen.make_requests(5, 64, seed=1) == \
        jax_loadgen.make_requests(5, 64, seed=1)
    fins = [{"request_id": "a", "ttft_s": 0.1, "tokens": [1, 2]},
            {"request_id": "b", "ttft_s": 0.3, "tokens": [1]},
            {"request_id": "a", "ttft_s": 9.0, "tokens": [1, 2]}]
    assert loadgen.summarize(4, fins, 2.0) == \
        jax_loadgen.summarize(4, fins, 2.0)


# ================================================== the pool, in process


def servicer_with_store(tmp_path):
    from tests.test_torch_master_failover import bind_store, build_servicer

    servicer = build_servicer("dlrover_tpu_torch")
    return servicer, bind_store("dlrover_tpu_torch", servicer, tmp_path)


@pytest.mark.chaos
def test_pool_serves_under_chaos_kill(dense, tmp_path):
    """The twin of TestServingSmoke through the port's servicer: a burst
    submitted to an empty pool breaches the queue SLO and the brain plans
    a scale-out; two decode workers arrive, one killed by a chaos rule on
    its 3rd serving step. Nothing dropped, nothing double-served, nothing
    failed; every request's tokens are a reference engine's greedy
    tokens."""
    from dlrover_tpu_torch.master.http_plane import render_prometheus

    _, tc, _, tp = dense
    servicer, store = servicer_with_store(tmp_path)
    servicer.serving._lease_timeout = 2.0
    servicer.serving._worker_ttl = 5.0
    brain = servicer.brain
    brain._cooldown = 0.0
    n_requests = 20
    requests = loadgen.make_requests(
        n_requests, tc.vocab_size, prompt_len_range=(4, 12),
        max_new_tokens=6, seed=11)
    for req in requests:
        assert servicer.report("client", 0, msg.ServeSubmitRequest(**req))
    for i in range(9):
        servicer.diagnosis.check(now=time.time() + i, force=True)
    breaches = servicer.diagnosis.slo.breaches()
    assert breaches["serve_queue"]["rule"] == "serve_queue_depth"
    assert [p.kind for p in brain.plans()] == ["scale_decode_pool"]
    with open(store._wal_path, encoding="utf-8") as f:
        wal = [json.loads(line) for line in f if line.strip()]
    assert "scale_decode_pool" in [e["plan"]["kind"] for e in wal
                                   if e["op"] == "brain_plan"]

    chaos.install({"seed": 41, "rules": [{
        "site": "serve.step", "action": "error", "rank": 1,
        "verb": "serving", "after": 2, "max": 1}]})
    workers = []
    try:
        for rank in range(2):
            eng = te.DecodeEngine(tc, tp, slots=3, capacity=32,
                                  device="cpu")
            eng.warmup(buckets=[8, 16])
            workers.append(DecodeWorker(
                LocalServingClient(servicer, rank), eng, rank,
                source=f"decode-{rank}-{os.getpid()}"))
        for w in (workers[1], workers[0]):
            w.start()
        deadline = time.time() + 90
        while time.time() < deadline:
            counts = servicer.serving.counts()
            if counts["done"] + counts["failed"] >= n_requests:
                break
            time.sleep(0.05)
    finally:
        for w in workers:
            w.stop()
        chaos.uninstall()

    counts = servicer.serving.counts()
    assert counts["done"] == n_requests, counts
    assert counts["failed"] == 0
    assert counts["max_attempts_seen"] <= 2
    assert workers[1].crashed and workers[1].abandoned
    assert counts["requeued_total"] >= len(workers[1].abandoned)
    assert max(w.scheduler.stats()["overlap_high_water"]
               for w in workers) >= 2
    # the scale-out plan completes once the pool showed up (swept before
    # the workers' lease activity ages out of the pool's view)
    brain.sweep({"stragglers": {}, "hangs": {}, "slo": {}})
    assert brain.plans()[0].state == "done"
    _round, members = servicer.rdzv_managers[
        RendezvousName.DECODE_POOL].latest_members()
    assert set(members) == {0, 1}
    ref = ContinuousBatchingScheduler(
        te.DecodeEngine(tc, tp, slots=3, capacity=32, device="cpu"))
    for req in requests:
        ref.submit(ServeRequest.from_payload(req))
    want = run_scheduler(ref, n_requests, limit=200)
    for req in requests:
        rec = servicer.serving.fetch(req["request_id"])
        assert rec["state"] == "done", req["request_id"]
        assert rec["tokens"] == want[req["request_id"]].tokens
    text = render_prometheus(servicer)
    assert "dlrtpu_serve_ttft_seconds_bucket" in text
    assert 'worker="0"' in text and 'worker="1"' in text
    assert 'dlrtpu_serve_requests{state="done"}' in text


# ============================================ over the port's master process


def test_decode_worker_over_the_port_master_process(dense, tmp_path,
                                                    monkeypatch):
    """``python -m dlrover_tpu_torch.master.main`` and a decode worker
    over ``RpcServingClient``: requests submitted through
    ``MasterClient.serve_submit`` are fetched ``done`` with the
    reference engine's tokens, and the ledger counts them."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.ipc import SOCKET_DIR_ENV

    _, tc, _, tp = dense
    monkeypatch.setenv(SOCKET_DIR_ENV, str(tmp_path / "socks"))
    addr_file = tmp_path / "addr"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(  # noqa: S603
        [sys.executable, "-m", "dlrover_tpu_torch.master.main",
         "--platform", "local", "--port", "0", "--node_num", "1",
         "--addr-file", str(addr_file)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        cwd=REPO)
    worker = None
    try:
        deadline = time.time() + 60
        while not addr_file.exists():
            assert proc.poll() is None and time.time() < deadline
            time.sleep(0.05)
        addr = addr_file.read_text().strip()
        eng = te.DecodeEngine(tc, tp, slots=4, capacity=64, device="cpu")
        eng.warmup(buckets=[8, 16])
        worker = DecodeWorker(RpcServingClient(
            MasterClient(addr, 0, "decode"), 0), eng, 0)
        worker.start()
        client = MasterClient(addr, 0, "client")
        requests = loadgen.make_requests(6, tc.vocab_size,
                                         prompt_len_range=(4, 14),
                                         max_new_tokens=5, seed=3)
        for req in requests:
            assert client.serve_submit(**req)
        while time.time() < deadline:
            if client.serve_status()["counts"]["done"] == len(requests):
                break
            time.sleep(0.05)
        ref = ContinuousBatchingScheduler(
            te.DecodeEngine(tc, tp, slots=4, capacity=64, device="cpu"))
        for req in requests:
            ref.submit(ServeRequest.from_payload(req))
        want = run_scheduler(ref, len(requests))
        for req in requests:
            res = client.serve_fetch(req["request_id"])
            assert res.state == "done", req["request_id"]
            assert list(res.tokens) == want[req["request_id"]].tokens
        counts = client.serve_status()["counts"]
        assert counts["failed"] == 0 and counts["done"] == len(requests)
    finally:
        if worker is not None:
            worker.stop()
        proc.kill()
        proc.wait(10)


def test_master_and_manager_import_no_torch():
    """The master builds the serving ledger; neither it nor the serving
    package's lazy exports import torch."""
    code = ("import sys\n"
            "import dlrover_tpu_torch.master.main\n"
            "import dlrover_tpu_torch.serving.manager\n"
            "from dlrover_tpu_torch import serving\n"
            "assert serving.ServingRequestManager\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
