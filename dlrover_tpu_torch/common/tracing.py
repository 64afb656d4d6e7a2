"""Causal trace spans over the telemetry timeline (Dapper-style).

Equivalent capability: the reference diagnoses "why is host 3 slow"
with the xpu_timer stack (in-process timing hooks -> shm -> exporter)
plus ad-hoc master-side logs; what it never had is a CAUSAL view — one
rendezvous round, checkpoint restore, or master-failover ride-through
rendered as a single cross-host tree. This module adds exactly that on
top of :mod:`dlrover_tpu.common.telemetry`:

- ``span(name, **labels)`` — a context manager that emits a ``span``
  timeline event on exit, carrying ``trace`` / ``span`` / ``parent``
  IDs. Spans nest through a thread-local ambient context, so a child
  opened inside a parent is parented automatically.
- **Cross-process propagation**: :func:`wire_context` snapshots the
  ambient context for an RPC envelope (the :class:`~dlrover_tpu.common.
  rpc.RpcClient` injects it into every call) and :func:`attach` adopts
  it on the server side (the RPC handler wraps dispatch in it), so a
  span opened in the master while serving an agent's request is a child
  of the agent's span — one trace across processes and hosts.
- **Rendering**: :func:`trace_trees` / :func:`format_trace` rebuild and
  print the parent/child forest from a merged job timeline
  (``tools/obs_report.py --trace``).

Span events ride the same bounded per-process event ring as everything
else, which doubles as the flight recorder's payload
(:mod:`dlrover_tpu.common.flight`): the last ~4096 spans/events of a
crashing process are exactly its post-mortem.

Cost model: the ambient context is a thread-local assignment; the event
emission is the usual telemetry hook (one lock + one deque append), and
a no-op when telemetry is disabled. Propagation survives RPC retries
and reconnects for free — the context is captured once per logical
call, not per attempt — and master failover cannot orphan children
because the context lives in the caller, never in master state.

Reserved span-event fields: ``name``, ``trace``, ``span``, ``parent``
(empty string = root), ``dur``, ``status`` ("ok" | "error").
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

from dlrover_tpu_torch.common import telemetry

SPAN_EVENT = "span"

_tls = threading.local()


def _new_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


def current() -> dict | None:
    """The ambient trace context of this thread:
    ``{"trace": ..., "span": ...}`` or None outside any span."""
    return getattr(_tls, "ctx", None)


def wire_context() -> dict | None:
    """Context to inject into an outgoing RPC envelope (a COPY — the
    receiver may hold it past this span's exit)."""
    ctx = current()
    return dict(ctx) if ctx else None


@contextlib.contextmanager
def attach(ctx: dict | None):
    """Adopt a propagated wire context as this thread's ambient parent
    WITHOUT emitting a span event (the server-side half of propagation).
    Malformed/absent contexts are ignored — an old client's 4-field
    envelope must not break dispatch."""
    if not (
        isinstance(ctx, dict) and ctx.get("trace") and ctx.get("span")
    ):
        yield None
        return
    prev = current()
    _tls.ctx = {"trace": str(ctx["trace"]), "span": str(ctx["span"])}
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


class Span:
    """Handle yielded by :func:`span` — mostly for tests/labels."""

    __slots__ = ("name", "trace", "span", "parent", "labels", "start")

    def __init__(self, name, trace, span_id, parent, labels):
        self.name = name
        self.trace = trace
        self.span = span_id
        self.parent = parent
        self.labels = labels
        self.start = time.monotonic()

    def annotate(self, **labels):
        self.labels.update(labels)


@contextlib.contextmanager
def span(name: str, **labels):
    """Open a span: child of the ambient span (same trace), or the root
    of a fresh trace. Emits one ``span`` timeline event on exit with
    the measured duration; an exception marks ``status=error`` and
    propagates."""
    parent = current()
    trace = parent["trace"] if parent else _new_id()
    sid = _new_id()
    prev = parent
    _tls.ctx = {"trace": trace, "span": sid}
    sp = Span(name, trace, sid, parent["span"] if parent else "", labels)
    status = "ok"
    try:
        yield sp
    except BaseException:
        status = "error"
        raise
    finally:
        _tls.ctx = prev
        telemetry.event(
            SPAN_EVENT,
            name=name,
            trace=trace,
            span=sid,
            parent=sp.parent,
            dur=time.monotonic() - sp.start,
            status=status,
            **sp.labels,
        )


# -------------------------------------------------------------------------
# rendering (obs_report --trace)
# -------------------------------------------------------------------------


def span_events(events) -> list[dict]:
    return [e for e in events if e.get("kind") == SPAN_EVENT]


def trace_trees(events) -> list[dict]:
    """Rebuild the span forest from (merged) timeline events.

    Returns one dict per trace, newest-rooted-first::

        {"trace": id, "roots": [node...], "spans": n}
        node = {"event": span_event, "children": [node...]}

    A span whose parent never made it into the ring (evicted, or the
    parent process never flushed) is promoted to a root rather than
    dropped — a partial trace is still evidence.
    """
    by_trace: dict[str, list[dict]] = {}
    for ev in span_events(events):
        if ev.get("trace") and ev.get("span"):
            by_trace.setdefault(ev["trace"], []).append(ev)
    out = []
    for trace, evs in by_trace.items():
        nodes = {
            e["span"]: {"event": e, "children": []} for e in evs
        }
        roots = []
        for e in evs:
            node = nodes[e["span"]]
            parent = nodes.get(e.get("parent") or "")
            if parent is not None and parent is not node:
                parent["children"].append(node)
            else:
                roots.append(node)

        def start_of(node):
            e = node["event"]
            return e.get("t", 0.0) - (e.get("dur") or 0.0)

        def sort_rec(children):
            children.sort(key=start_of)
            for c in children:
                sort_rec(c["children"])

        sort_rec(roots)
        out.append({"trace": trace, "roots": roots, "spans": len(evs)})
    out.sort(
        key=lambda t: max(
            (n["event"].get("t", 0.0) for n in t["roots"]), default=0.0
        ),
        reverse=True,
    )
    return out


def format_trace(events, limit: int = 10) -> str:
    """Text rendering of the span forest: one indented tree per trace,
    each line ``+rel_start  dur  source  name  labels``."""
    trees = trace_trees(events)
    if not trees:
        return "no spans recorded"
    lines = []
    for tree in trees[:limit]:
        t0 = min(
            (
                n["event"].get("t", 0.0) - (n["event"].get("dur") or 0.0)
                for n in tree["roots"]
            ),
            default=0.0,
        )
        lines.append(
            f"trace {tree['trace']}  ({tree['spans']} span"
            f"{'s' if tree['spans'] != 1 else ''})"
        )

        def render(node, depth):
            e = node["event"]
            dur = e.get("dur") or 0.0
            start = e.get("t", 0.0) - dur
            extras = {
                k: v for k, v in e.items()
                if k not in (
                    "seq", "t", "mono", "kind", "source", "name",
                    "trace", "span", "parent", "dur", "status",
                )
            }
            extra_s = " ".join(
                f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in extras.items()
            )
            flag = "" if e.get("status", "ok") == "ok" else " [ERROR]"
            lines.append(
                f"  +{start - t0:8.3f}s {dur * 1e3:9.2f}ms  "
                f"{'  ' * depth}{e.get('name', '?')}"
                f"  <{e.get('source', '?')}>{flag}"
                + (f"  {extra_s}" if extra_s else "")
            )
            for c in node["children"]:
                render(c, depth + 1)

        for root in tree["roots"]:
            render(root, 0)
        lines.append("")
    if len(trees) > limit:
        lines.append(f"... {len(trees) - limit} more trace(s) omitted")
    return "\n".join(lines)
