"""Unified retry/deadline policy + degraded mode for non-critical clients.

Equivalent capability: the reference wraps every master RPC in one
``retry_grpc_request`` decorator (dlrover/python/elastic_agent/
master_client.py:27) — fixed attempts, fixed sleeps. This module replaces
our per-call-site ``retries=3`` / ``sleep(2**attempt)`` copies with a
single :class:`RetryPolicy` (exponential backoff, **full jitter**, and a
per-call total deadline budget) configured from one place (env), plus a
:class:`NonCriticalGuard` that turns budget exhaustion in best-effort
subsystems (brain reporting, paral tuning, stats) into self-disable
instead of a crashed trainer.

Full jitter (sleep ~ U(0, min(cap, base*2^n))) decorrelates the retry
storms of many hosts hammering a recovering master — the AWS
architecture-blog result the reference's fixed sleeps lack.

The PyTorch port's copy of dlrover_tpu/common/retry.py.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# One knob namespace for every RPC call site (satellite: configurable
# from one place instead of per-call-site defaults).
ENV_MAX_ATTEMPTS = "DLROVER_RPC_MAX_ATTEMPTS"
ENV_BASE_DELAY = "DLROVER_RPC_BASE_DELAY"
ENV_MAX_DELAY = "DLROVER_RPC_MAX_DELAY"
ENV_DEADLINE = "DLROVER_RPC_DEADLINE"
ENV_JITTER = "DLROVER_RPC_JITTER"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + full jitter + total-deadline budget.

    ``deadline`` caps the attempt/backoff schedule: no new attempt or
    sleep starts past the budget. A single in-flight attempt can
    overshoot by at most the transport timeout — RpcClient clamps its
    per-attempt socket timeout to the remaining budget for exactly
    this reason.
    """

    max_attempts: int = 3
    base_delay: float = 0.5
    max_delay: float = 5.0
    deadline: float = 60.0
    jitter: bool = True

    def backoff(self, attempt: int, rng=random) -> float:
        """Sleep before retry number ``attempt`` (0-based)."""
        cap = min(self.base_delay * (2.0 ** attempt), self.max_delay)
        return rng.uniform(0.0, cap) if self.jitter else cap

    def with_attempts(self, max_attempts: int) -> "RetryPolicy":
        return dataclasses.replace(self, max_attempts=max_attempts)


def run_with_retry(
    fn,
    policy: RetryPolicy,
    retry_on: tuple = (ConnectionError, OSError),
    on_failure=None,
    describe: str = "call",
    op: str = "call",
):
    """Run ``fn`` under ``policy``. ``on_failure`` runs after each failed
    attempt (e.g. drop a dead connection). Raises the last error wrapped
    in ConnectionError once attempts or the deadline budget run out.

    ``op`` is the bounded-cardinality telemetry label (``describe`` may
    embed addresses and must stay out of metric labels)."""
    start = time.monotonic()
    last_err: Exception | None = None
    attempts = max(policy.max_attempts, 1)
    made = 0
    for attempt in range(attempts):
        if attempt:
            remaining = policy.deadline - (time.monotonic() - start)
            if remaining <= 0:
                break
            time.sleep(min(policy.backoff(attempt - 1), remaining))
        made += 1
        try:
            return fn()
        except retry_on as e:
            last_err = e
            telemetry.counter_inc("retry.attempt_failed", op=op)
            if on_failure is not None:
                on_failure(e)
    telemetry.counter_inc("retry.exhausted", op=op)
    telemetry.event(
        "retry.exhausted",
        op=op,
        attempts=made,
        dur_budget=policy.deadline,
        error=f"{type(last_err).__name__}: {last_err}"[:200],
    )
    raise ConnectionError(
        f"{describe} failed after {made} attempt(s) in "
        f"{time.monotonic() - start:.1f}s "
        f"(budget {policy.deadline:.0f}s): {last_err}"
    ) from last_err


_DEFAULT_POLICY: RetryPolicy | None = None


def default_rpc_policy() -> RetryPolicy:
    """The process-wide RPC policy; env is read once, then cached."""
    global _DEFAULT_POLICY
    if _DEFAULT_POLICY is None:
        _DEFAULT_POLICY = RetryPolicy(
            max_attempts=int(os.environ.get(ENV_MAX_ATTEMPTS, "5")),
            base_delay=float(os.environ.get(ENV_BASE_DELAY, "0.5")),
            max_delay=float(os.environ.get(ENV_MAX_DELAY, "5.0")),
            deadline=float(os.environ.get(ENV_DEADLINE, "60.0")),
            jitter=os.environ.get(ENV_JITTER, "1") not in ("0", "false"),
        )
    return _DEFAULT_POLICY


def set_default_rpc_policy(policy: RetryPolicy | None):
    """Override (or with None: re-read env on next use) — tests."""
    global _DEFAULT_POLICY
    _DEFAULT_POLICY = policy


def noncritical_rpc_policy() -> RetryPolicy:
    """Short budget for best-effort subsystems: fail fast, then let the
    NonCriticalGuard degrade them instead of stalling training."""
    base = default_rpc_policy()
    return dataclasses.replace(
        base,
        max_attempts=min(base.max_attempts, 2),
        deadline=min(base.deadline, 10.0),
    )


class NonCriticalGuard:
    """Degraded mode for best-effort subsystems.

    Wrap every remote call of a non-critical client (brain metrics,
    paral tuner, stats reporting). After ``max_consecutive_failures``
    exhausted retry budgets the subsystem disables itself: subsequent
    calls return the default instantly and the trainer keeps running —
    a dead brain service must cost goodput exactly zero.

    ``cooldown`` turns the permanent disable into a circuit breaker:
    after ``cooldown`` seconds the guard lets ONE probe call through
    (half-open) — success fully re-arms it, failure re-opens for
    another cooldown. Use it for subsystems that must come back after
    a healed partition (e.g. global-step stats, whose permanent
    silence could later read as a job-wide hang); leave it None for
    truly optional ones (brain, paral tuner).
    """

    _FAILURE_TYPES = (ConnectionError, OSError, RuntimeError)

    def __init__(
        self,
        name: str,
        max_consecutive_failures: int = 3,
        cooldown: float | None = None,
    ):
        self.name = name
        self.disabled = False
        self._max = max(max_consecutive_failures, 1)
        self._failures = 0
        self._cooldown = cooldown
        self._reopen_at = 0.0
        # set while the guard has tripped at least once and not yet
        # recovered: a later success is a degrade->recover transition
        # worth surfacing, not business as usual
        self._tripped = False

    def run(self, fn, default=None):
        if self.disabled:
            if (
                self._cooldown is None
                or time.monotonic() < self._reopen_at
            ):
                return default
            # half-open: one probe; a failure re-trips immediately
            self.disabled = False
            self._failures = self._max - 1
            logger.info("%s: cooldown elapsed; probing", self.name)
        try:
            result = fn()
        except self._FAILURE_TYPES as e:
            self._failures += 1
            if self._failures >= self._max:
                self.disabled = True
                self._tripped = True
                if self._cooldown is not None:
                    self._reopen_at = time.monotonic() + self._cooldown
                # a silently-degraded subsystem must be VISIBLE in the
                # job report, not just a log line scrolled past
                telemetry.event(
                    "guard.degrade",
                    name=self.name,
                    failures=self._failures,
                    cooldown=self._cooldown or 0.0,
                )
                telemetry.counter_inc("guard.degrades", name=self.name)
                telemetry.gauge_set(
                    "guard.degraded", 1.0, name=self.name
                )
                logger.warning(
                    "%s: disabled after %d consecutive failures "
                    "(degraded mode; training continues%s): %s",
                    self.name, self._failures,
                    "" if self._cooldown is None
                    else f"; retrying in {self._cooldown:.0f}s", e,
                )
            else:
                logger.info(
                    "%s: attempt failed (%d/%d before degrade): %s",
                    self.name, self._failures, self._max, e,
                )
            return default
        self._failures = 0
        if self._tripped:
            self._tripped = False
            telemetry.event("guard.recover", name=self.name)
            telemetry.gauge_set("guard.degraded", 0.0, name=self.name)
            logger.info("%s: recovered; re-armed", self.name)
        return result

    def reset(self):
        self.disabled = False
        self._failures = 0
        self._tripped = False
