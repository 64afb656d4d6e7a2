"""The port's decode engine on the card: the CUDA-graph-captured decode
step against the same step run eagerly, bit for bit. These need an
NVIDIA GPU: without CUDA they skip with a reason. Run them on the GPU
with

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py

A small bf16 Llama (4 layers, dim 512, 8 heads over 2 kv heads) in a
4-slot pool of 256 positions: greedy and sampled (temperature 0.8) steps
over mixed live slots give the same tokens, logprobs and cache contents
from a graph replay as from the eager step; a request served alone gives
the tokens it gets among others in the same pool; a step driven from
another thread gives the same result.
"""

import threading

import pytest
import torch

from dlrover_tpu_torch.device import CUDA_SKIP_REASON, cuda_available
from dlrover_tpu_torch.models import LlamaConfig, llama_init
from dlrover_tpu_torch.serving.engine import DecodeEngine
from dlrover_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    ServeRequest,
)

pytestmark = pytest.mark.cuda

CONFIG = LlamaConfig(vocab_size=4096, dim=512, n_layers=4, n_heads=8,
                     n_kv_heads=2, mlp_dim=1024, max_seq_len=256,
                     remat=False)


@pytest.fixture(scope="module")
def params():
    if not cuda_available():
        pytest.skip(CUDA_SKIP_REASON)
    return {k: v.to(torch.bfloat16)
            for k, v in llama_init(CONFIG, seed=0, device="cuda").items()}


def prompt(seed, n):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CONFIG.vocab_size, (n,), generator=g).tolist()


def drive(engine, temperature, eager=False, steps=20):
    """Admit three prompts of different lengths into slots 3, 0 and 1,
    then decode ``steps`` steps (graph replays, or ``eager``) with slot 1
    evicted half way."""
    step = engine.step_eager if eager else engine.step
    seqs, pos = {}, {}
    for slot, (seed, n) in zip((3, 0, 1), ((1, 37), (2, 100), (3, 9))):
        p = prompt(seed, n)
        tok, _, used = engine.admit(slot, p, seed, temperature)
        seqs[slot], pos[slot] = p + [tok], used
    out = []
    for i in range(steps):
        if i == steps // 2:
            del seqs[1]
        tokens, positions = [0] * 4, [0] * 4
        live, temps = [False] * 4, [0.0] * 4
        for slot, seq in seqs.items():
            tokens[slot], positions[slot] = seq[-1], pos[slot]
            live[slot], temps[slot] = True, temperature
        nxt, logp = step(tokens, positions, live, 100 + i, temps)
        out.append((nxt.tolist(), logp.tolist()))
        for slot, seq in seqs.items():
            seq.append(int(nxt[slot]))
            pos[slot] += 1
    return out


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_graph_replay_is_bit_equal_to_eager(params, temperature):
    graph = DecodeEngine(CONFIG, params, slots=4, capacity=256,
                         device="cuda")
    graph.warmup(buckets=[16, 64, 128])
    eager = DecodeEngine(CONFIG, params, slots=4, capacity=256,
                         device="cuda")
    assert graph.decode_traces() == 1 and graph._graph is not None
    assert drive(graph, temperature) == drive(eager, temperature, True)
    assert eager._graph is None
    for a, b in zip(graph.cache, eager.cache):
        assert torch.equal(a, b)


def test_a_request_alone_gets_its_tokens_among_others(params):
    """Rows of the pool are independent: the same request served alone
    and among five others in the same 4-slot pool, bit for bit."""
    engine = DecodeEngine(CONFIG, params, slots=4, capacity=256,
                          device="cuda")
    engine.warmup(buckets=[8, 16, 32, 64, 128])
    reqs = [ServeRequest(request_id=f"r{i}", prompt=prompt(10 + i, 5 + 17 * i),
                         max_new_tokens=12 + 5 * i) for i in range(6)]

    def serve(batch):
        sched = ContinuousBatchingScheduler(engine, rng_seed=1)
        for r in batch:
            sched.submit(ServeRequest(**r.to_payload()))
        done = {}
        while len(done) < len(batch):
            done.update({f.request_id: f.tokens for f in sched.step()})
        return done, sched.stats()["overlap_high_water"]

    together, overlap = serve(reqs)
    assert overlap == 4
    for r in reqs:
        alone, _ = serve([r])
        assert alone[r.request_id] == together[r.request_id], r.request_id


def test_a_step_from_another_thread_is_the_same(params):
    engine = DecodeEngine(CONFIG, params, slots=4, capacity=256,
                          device="cuda")
    engine.warmup(buckets=[64])
    tok, _, used = engine.admit(2, prompt(5, 40), 5, 0.0)
    saved = [t.clone() for t in engine.cache]
    args = ([0, 0, tok, 0], [0, 0, used, 0], [False, False, True, False],
            7, [0.0] * 4)
    here = engine.step(*args)
    for dst, src in zip(engine.cache, saved):
        dst.copy_(src)
    there = []
    worker = threading.Thread(target=lambda: there.append(engine.step(*args)))
    worker.start()
    worker.join(60)
    assert there and there[0][0].tolist() == here[0].tolist()
    assert there[0][1].tolist() == here[1].tolist()
