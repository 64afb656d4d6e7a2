"""Continuous-batching scheduler: the host-side slot map over the
decode engine (port of dlrover_tpu/serving/scheduler.py; its random keys
are int seeds drawn from a ``torch.Generator`` seeded with
``rng_seed``).

Equivalent capability: vLLM's continuous batching loop (admit new
requests into the running batch between decode iterations, retire
finished ones) — the reference serves its RL and user traffic through
exactly that loop. Here the device side is the slotted KV pool
(:mod:`dlrover_tpu_torch.serving.engine`): the scheduler owns the **slot
map** — which request occupies which device slot — and each call to
:meth:`ContinuousBatchingScheduler.step` does one iteration:

1. **admit**: pop queued requests into free slots; each admission is
   one length-bucketed prefill that also samples
   the request's first token — TTFT is measured right here;
2. **decode**: one step over the WHOLE pool (a CUDA-graph replay on
   the card), whatever mix of live slots exists (dead slots compute
   garbage nobody reads);
3. **evict**: sequences that hit EOS or their token budget free their
   slot and surface as finished — the freed slot is eligible for a new
   admission in the very next step, which is what makes the batching
   *continuous* (requests overlap mid-flight instead of queueing
   behind the longest member of a static batch).

Lock discipline (dlint DL008 / dtsan): one leaf lock guards the queue
and the slot map; it is NEVER held across the engine (a decode step
is milliseconds of device time) or across telemetry emission. The
engine itself is single-threaded by contract — only :meth:`step`
touches it, and only one thread may call ``step`` (the decode
worker's loop); ``submit``/``stats`` are safe from any thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# histogram buckets for TTFT observations (seconds)
TTFT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


@dataclasses.dataclass
class ServeRequest:
    """One generation request as the scheduler sees it."""

    request_id: str
    prompt: list
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_id: int = -1          # -1 = never stop early
    arrival_t: float = 0.0    # worker-local monotonic (lease time)
    # master-ledger wall clock of the ORIGINAL submit (rides the lease
    # payload): when present, TTFT/latency measure from here, so
    # master-queue time and re-queue delay are priced in — the
    # worker-local clock alone would hide exactly the overload the
    # serve_ttft SLO exists to catch
    submit_t: float = 0.0

    @classmethod
    def from_payload(cls, payload: dict) -> "ServeRequest":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{
            k: v for k, v in payload.items() if k in fields
        })

    def to_payload(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FinishedSequence:
    """A retired request: its continuation and why it ended."""

    request_id: str
    tokens: list
    finish_reason: str        # "eos" | "length"
    ttft_s: float
    latency_s: float
    prompt_len: int


@dataclasses.dataclass
class _SlotState:
    """Host-side record of one occupied device slot."""

    request: ServeRequest
    prompt_len: int           # effective (ring-truncated) prompt length
    tokens: list              # sampled continuation so far
    position: int             # next absolute position to consume
    admitted_t: float
    first_token_t: float
    ttft_s: float = 0.0


class ContinuousBatchingScheduler:
    def __init__(
        self,
        engine,
        registry=None,
        rng_seed: int = 0,
        now_fn=time.monotonic,
        key_factory=None,
        worker_label: str = "",
    ):
        self._engine = engine
        # a worker-owned registry keeps per-worker sources; None falls
        # back to the process-global one (standalone/bench use)
        self._registry = registry
        # rides the TTFT/token histograms as a label, so the rollup
        # view (/metrics merges histograms across sources) still keeps
        # one family per decode worker
        self._worker_label = worker_label
        self._now = now_fn
        # ``key_factory`` lets torch-free harnesses (a fake engine)
        # drive the scheduler without a generator
        self._rng = None
        if key_factory is None:
            import torch

            self._rng = torch.Generator().manual_seed(int(rng_seed))
        self._key_factory = key_factory
        # one leaf lock over queue + slot map; never held across the
        # engine or telemetry
        self._lock = threading.Lock()
        self._queue: list[ServeRequest] = []
        self._slots: dict[int, _SlotState] = {}
        self._free: list[int] = list(range(engine.slots))[::-1]
        self._steps = 0
        self._completed = 0
        self._tokens_out = 0
        # max distinct requests live inside ONE decode step — the
        # "continuous" proof the e2e smoke asserts on (>= 2 overlap)
        self._overlap_high_water = 0

    # ------------------------------------------------------------- intake

    def submit(self, request: ServeRequest):
        if not request.arrival_t:
            request.arrival_t = self._now()
        with self._lock:
            self._queue.append(request)
            depth = len(self._queue)
        self._tele().gauge_set("serve.queue.depth", float(depth))

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def live(self) -> int:
        with self._lock:
            return len(self._slots)

    def abandon(self) -> list[str]:
        """Drop everything (crash simulation / shutdown without
        drain): returns the request ids left un-served so the caller
        can account for them — the scheduler never loses them
        silently."""
        with self._lock:
            ids = [r.request_id for r in self._queue] + [
                s.request.request_id for s in self._slots.values()
            ]
            self._queue.clear()
            self._slots.clear()
            self._free = list(range(self._engine.slots))[::-1]
        return ids

    # -------------------------------------------------------------- step

    def _next_key(self):
        """The next draw's seed (the JAX scheduler splits its key)."""
        if self._key_factory is not None:
            return self._key_factory()
        import torch

        with self._lock:
            return int(torch.randint(0, 2 ** 62, (), generator=self._rng))

    def step(self) -> list[FinishedSequence]:
        """One continuous-batching iteration (admit, decode, evict).
        Single caller only (the worker loop)."""
        with self._lock:
            self._steps += 1
        finished: list[FinishedSequence] = []

        # ---- admit into free slots (one bucketed prefill per admit)
        while True:
            with self._lock:
                if not self._queue or not self._free:
                    break
                req = self._queue.pop(0)
                slot = self._free.pop()
            # admission fault seam: chaos schedules can kill/delay a
            # worker exactly between dequeue and prefill — the leased
            # request must then be requeued by the master, not lost
            try:
                chaos_point(
                    "serve.admit", request=req.request_id, slot=slot
                )
                now = self._now()
                tok, _logp, used = self._engine.admit(
                    slot, req.prompt, self._next_key(),
                    req.temperature,
                )
            except BaseException:
                # the popped-but-not-admitted window: put the request
                # and the slot back so abandon()'s accounting (and a
                # later retry) still sees them — a crash here must not
                # lose the id silently
                with self._lock:
                    self._queue.insert(0, req)
                    self._free.append(slot)
                raise
            state = _SlotState(
                request=req,
                prompt_len=used,
                tokens=[tok],
                position=used,
                admitted_t=now,
                first_token_t=self._now(),
            )
            if req.submit_t:
                # master-submit wall clock: queue + re-queue time
                # included (same-cluster clocks; skew is noise next to
                # the seconds of queueing this exists to expose)
                state.ttft_s = max(time.time() - req.submit_t, 0.0)
            else:
                state.ttft_s = max(
                    state.first_token_t - req.arrival_t, 0.0
                )
            self._observe_ttft(state.ttft_s)
            with self._lock:
                self._slots[slot] = state
            fin = self._maybe_finish(slot, state, tok)
            if fin is not None:
                finished.append(fin)

        # ---- one decode step over the whole pool
        with self._lock:
            live_items = sorted(self._slots.items())
            self._overlap_high_water = max(
                self._overlap_high_water, len(live_items)
            )
        if live_items:
            S = self._engine.slots
            tokens = [0] * S
            positions = [0] * S
            live = [False] * S
            temps = [0.0] * S
            for slot, st in live_items:
                tokens[slot] = st.tokens[-1]
                positions[slot] = st.position
                live[slot] = True
                temps[slot] = st.request.temperature
            nxt, _logps = self._engine.step(
                tokens, positions, live, self._next_key(), temps
            )
            for slot, st in live_items:
                with self._lock:
                    if self._slots.get(slot) is not st:
                        continue  # evicted concurrently (abandon)
                    st.tokens.append(int(nxt[slot]))
                    st.position += 1
                fin = self._maybe_finish(slot, st, int(nxt[slot]))
                if fin is not None:
                    finished.append(fin)

        with self._lock:
            depth = len(self._queue)
            live_n = len(self._slots)
        self._tele().gauge_set("serve.queue.depth", float(depth))
        self._tele().gauge_set("serve.slots.live", float(live_n))
        return finished

    def _maybe_finish(self, slot: int, st: _SlotState,
                      last_tok: int) -> FinishedSequence | None:
        """Evict on EOS or token budget; returns the finished record
        (and frees the slot) or None."""
        req = st.request
        reason = None
        if req.eos_id >= 0 and last_tok == req.eos_id:
            reason = "eos"
        elif len(st.tokens) >= req.max_new_tokens:
            reason = "length"
        if reason is None:
            return None
        n = len(st.tokens)
        with self._lock:
            if self._slots.get(slot) is not st:
                return None  # abandoned concurrently (crash path)
            del self._slots[slot]
            self._free.append(slot)
            self._completed += 1
            self._tokens_out += n
        now = self._now()
        self._tele().counter_inc(
            "serve.completed", 1.0, reason=reason, **self._labels()
        )
        self._tele().counter_inc(
            "serve.tokens", float(n), **self._labels()
        )
        latency = (
            max(time.time() - req.submit_t, 0.0) if req.submit_t
            else max(now - req.arrival_t, 0.0)
        )
        return FinishedSequence(
            request_id=req.request_id,
            tokens=list(st.tokens),
            finish_reason=reason,
            ttft_s=st.ttft_s,
            latency_s=latency,
            prompt_len=st.prompt_len,
        )

    # ---------------------------------------------------------- telemetry

    def _tele(self):
        """The worker's own registry (per-worker source) or the
        process-global module — same counter/gauge/observe surface."""
        return self._registry if self._registry is not None else telemetry

    def _labels(self) -> dict:
        return {"worker": self._worker_label} if self._worker_label \
            else {}

    def _observe_ttft(self, ttft_s: float):
        self._tele().observe(
            "serve.ttft.seconds", ttft_s, buckets=TTFT_BUCKETS,
            **self._labels(),
        )
        self._tele().gauge_set("serve.ttft.last_s", ttft_s)

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            return {
                "steps": self._steps,
                "queue_depth": len(self._queue),
                "live": len(self._slots),
                "completed": self._completed,
                "tokens_out": self._tokens_out,
                "overlap_high_water": self._overlap_high_water,
                "prefill_traces": self._engine.prefill_traces(),
                "decode_traces": self._engine.decode_traces(),
            }
