"""Poisson load generator + latency summarizer for the serving arm (the
port's copy of dlrover_tpu/serving/loadgen.py).

The bench story ("millions of users", scaled down to a harness): open-
loop Poisson arrivals at a configured rate — arrival times are drawn
once from a seeded RNG, so a sweep replays identically across
comparison arms (chaos-killed worker vs clean) — submitted through any
``submit(payload) -> bool`` door (the master RPC arm, or the manager
directly in-process). :func:`summarize` turns the finished-request
records into the headline keys ``tools/bench_diff.py`` gates:

- ``serve_tokens_per_s``  — generated tokens per wall second;
- ``serve_ttft_p50_ms`` / ``serve_ttft_p99_ms`` — time-to-first-token
  percentiles over completed requests;
- ``serve_goodput_pct``   — completed / submitted: under a chaos-
  killed decode worker this is the "degrades instead of dropping"
  number (re-queued requests that complete still count; silently
  dropped ones can't).
"""

from __future__ import annotations

import random
import time

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


# the one nearest-rank definition, shared with the SLO watchdog so the
# bench keys and the gate can never drift
percentile = telemetry.nearest_rank_percentile


def poisson_arrivals(
    n: int, rate_hz: float, seed: int = 0
) -> list[float]:
    """n seeded exponential inter-arrival offsets (seconds from t0)."""
    rng = random.Random(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate_hz)
        out.append(t)
    return out


def make_requests(
    n: int,
    vocab_size: int,
    prompt_len_range: tuple[int, int] = (4, 12),
    max_new_tokens: int = 8,
    temperature: float = 0.0,
    eos_id: int = -1,
    seed: int = 0,
    id_prefix: str = "req",
) -> list[dict]:
    """Seeded synthetic request payloads (deterministic across arms)."""
    rng = random.Random(seed * 7919 + 1)
    lo, hi = prompt_len_range
    out = []
    for i in range(n):
        plen = rng.randint(lo, max(hi, lo))
        out.append({
            "request_id": f"{id_prefix}-{i}",
            "prompt": [rng.randrange(vocab_size) for _ in range(plen)],
            "max_new_tokens": max_new_tokens,
            "temperature": temperature,
            "eos_id": eos_id,
        })
    return out


def run_open_loop(
    submit,
    requests: list[dict],
    arrivals: list[float],
    now_fn=time.monotonic,
    sleep_fn=time.sleep,
    speedup: float = 1.0,
) -> int:
    """Submit ``requests`` at their Poisson ``arrivals`` (scaled by
    ``speedup``); blocks until all are submitted. Returns how many the
    door accepted. Open loop: arrival times never wait for service —
    a saturated pool shows up as queue depth, exactly like real
    traffic."""
    t0 = now_fn()
    accepted = 0
    for req, at in zip(requests, arrivals):
        target = t0 + at / max(speedup, 1e-9)
        delay = target - now_fn()
        if delay > 0:
            sleep_fn(delay)
        req = dict(req)
        if submit(req):
            accepted += 1
    return accepted


def summarize(
    submitted: int,
    finished,
    wall_s: float,
) -> dict:
    """The headline serving keys from a sweep's finished-request
    records (each needs ``request_id``, ``ttft_s`` and ``tokens``).
    Records are de-duplicated by request id (first completion wins):
    a re-queued request a zombie worker ALSO finished counts once —
    goodput measures requests served, not compute spent."""
    seen: dict[str, object] = {}
    for f in finished:
        rid = f["request_id"] if isinstance(f, dict) else f.request_id
        seen.setdefault(str(rid), f)
    records = list(seen.values())
    ttfts = [float(f["ttft_s"] if isinstance(f, dict) else f.ttft_s)
             for f in records]
    tokens = sum(
        len(f["tokens"] if isinstance(f, dict) else f.tokens)
        for f in records
    )
    wall_s = max(float(wall_s), 1e-9)
    goodput = (len(records) / submitted * 100.0) if submitted else 0.0
    return {
        "serve_requests_submitted": int(submitted),
        "serve_requests_completed": len(records),
        "serve_tokens_per_s": round(tokens / wall_s, 3),
        "serve_ttft_p50_ms": round(percentile(ttfts, 0.50) * 1e3, 3),
        "serve_ttft_p99_ms": round(percentile(ttfts, 0.99) * 1e3, 3),
        "serve_goodput_pct": round(goodput, 3),
    }
