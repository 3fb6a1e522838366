"""Dependency-free operation tracing: spans, events, a flight recorder.

The reference's only observability is bunyan lines on stdout (reference
main.js:23-28) and our metrics.py is counters and point-gauges — neither
can say *where the time went* inside one operation, or *what the daemon
was doing* in the seconds before chaos killed it.  This module is the
missing layer:

  * **Spans** — named, attributed, monotonic-clocked intervals with
    trace/span/parent ids, propagated across ``await`` boundaries and
    task spawns via :mod:`contextvars` (an ``asyncio.create_task`` copies
    the context, so a repair task's pipeline spans chain to the repair
    span that spawned them).  Span names are a documented contract:
    docs/OBSERVABILITY.md carries the catalog, and checklib's
    span-name-drift rule diffs the code against it.
  * **Events** — instantaneous points (a cache invalidation, a session
    loss) recorded into the same ring with the active trace id.
  * **Flight recorder** — a bounded in-memory ring of recently completed
    spans + events.  Dumped to a file on SIGUSR2 (main.py) and served at
    ``GET /debug/trace?n=`` (metrics.MetricsServer) — the post-incident
    "what was it doing" record that logs alone cannot reconstruct.
  * **Sinks** — every finished sampled span is offered to registered
    sink callables; :func:`registrar_tpu_torch.metrics.instrument_tracing`
    feeds the latency histograms from exactly this hook.
  * **Slow spans** — a span outlasting ``slow_span_ms`` logs a
    warn-level line with its full parent chain, so "this resolve was
    slow" arrives pre-annotated with *what it was part of*.
  * **Log correlation** — :class:`TraceContextFilter` stamps the active
    trace_id/span_id onto every log record it filters; jlog's
    BunyanFormatter renders them when present (and only then — with
    tracing off, not a byte of log output changes).

Everything is opt-in via the ``observability`` config block
(docs/CONFIG.md).  **Default OFF is reference parity**: the module
default is :data:`DISABLED`, whose ``span()`` returns a shared no-op and
whose ``event()`` does nothing — zero allocations, zero new wire
operations, zero new log/metric output (pinned by
tests/test_trace.py's parity tests).

Instrumented code resolves its tracer through :func:`tracer_for`, so a
test (or the chaos harness) can hang a private :class:`Tracer` on one
client/cache (``obj.tracer = Tracer(...)``) without touching the global,
while the daemon configures the process-wide default once
(:func:`set_tracer`) and every subsystem picks it up.

Sampling is head-based: the decision is made once when a trace ROOT is
created (``sample_rate``), and every child span inherits the verdict —
an unsampled trace still propagates ids (log correlation keeps working)
but records nothing and feeds no sinks.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import random
import tempfile
import time
from collections import deque
from typing import Any, Dict, List, Optional

log = logging.getLogger("registrar_tpu_torch.trace")

#: default bound on the flight-recorder ring (spans + events)
DEFAULT_MAX_SPANS = 1024

#: the active span (or None), propagated by asyncio's context copying
_current: contextvars.ContextVar = contextvars.ContextVar(
    "registrar_trace_span", default=None
)

#: ambient attrs stamped onto every span/event created while an
#: :class:`annotate` block is active (or None — the common case costs
#: one contextvar read per span).  Propagates across awaits and task
#: spawns exactly like the current span.
_ambient: contextvars.ContextVar = contextvars.ContextVar(
    "registrar_trace_ambient", default=None
)


class annotate:
    """Stamp extra attrs onto every span and event created inside the
    block — across every nested call layer.

    The SLO harness wraps each availability probe in
    ``annotate(scenario=..., faults=...)`` so the probe's whole span
    tree — ``slo.probe`` down through ``resolve.query`` and the
    ``zk.op`` leaves — carries the active scenario and fault-class
    marks without threading them through the resolver's signatures.  An
    outage pulled out of the flight recorder is then attributable on
    sight.  Explicit attrs passed at the call site win over ambient
    ones on a key collision.  Nesting merges (inner blocks override per
    key); exiting restores the enclosing block's view."""

    __slots__ = ("attrs", "_token")

    def __init__(self, **attrs):
        self.attrs = attrs
        self._token = None

    def __enter__(self) -> "annotate":
        current = _ambient.get()
        merged = {**current, **self.attrs} if current else dict(self.attrs)
        self._token = _ambient.set(merged)
        return self

    def __exit__(self, *_exc) -> bool:
        if self._token is not None:
            _ambient.reset(self._token)
            self._token = None
        return False


class _NoopSpan:
    """The shared do-nothing span a disabled tracer hands out.

    One module-level instance: entering/exiting it is two cheap method
    calls and zero allocations, which is what "default OFF = reference
    parity" costs on every instrumented path.
    """

    __slots__ = ()
    sampled = False
    trace_id = None
    span_id = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *_exc) -> bool:
        return False

    def mark(self, _name: str) -> None:
        pass

    def set_mark(self, _name: str, _seconds: float) -> None:
        pass

    def finish(self, status: str = "ok", **attrs) -> None:
        pass

    def set_attr(self, _key: str, _value) -> None:
        pass


NOOP_SPAN = _NoopSpan()


def current_context():
    """The active span's wire-propagation triple — ``(trace_id,
    parent_span_id, sampled)`` as ``(int, int, int)`` — or None when no
    span is active (or tracing is off, since the no-op span carries no
    ids).  This is THE injection rule for every cross-process boundary:
    the shard protocol's trace-context block and the
    health-check env stamps both serialize exactly this triple, so a
    remote process adopting it chains its spans under the caller's.
    """
    sp = _current.get()
    trace_id = getattr(sp, "trace_id", None)
    if trace_id is None:
        return None
    return (int(trace_id, 16), int(sp.span_id, 16), 1 if sp.sampled else 0)


class Span:
    """One traced interval.  Use as a context manager to also make it
    the *current* span (children parent to it); or keep the handle and
    :meth:`finish` it manually for intervals that end outside the
    creating context (the ZK client's queue/wire op spans end in the
    read loop's frame dispatch, not in the caller's coroutine)."""

    __slots__ = (
        "tracer", "name", "trace_id", "span_id", "parent_id", "parent",
        "attrs", "status", "sampled", "start", "wall_start", "duration_s",
        "marks", "_token", "_done",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        parent: Optional["Span"],
        sampled: bool,
        attrs: Dict[str, Any],
    ):
        self.tracer = tracer
        self.name = name
        self.parent = parent
        self.sampled = sampled
        # ids generated inline (no helper method): span creation sits
        # on the per-resolve hot path the bench holds to <10% overhead,
        # and two extra method calls per span are measurable there.
        rng = tracer._rng
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = f"{rng.getrandbits(64):016x}"
            self.parent_id = None
        self.span_id = f"{rng.getrandbits(64):016x}"
        self.attrs = attrs
        self.status = "ok"
        self.start = time.monotonic()
        self.wall_start = time.time()
        self.duration_s: Optional[float] = None
        #: named offsets (seconds from start) — the queue/wire split.
        #: Lazily allocated: most spans never mark, and this sits on the
        #: per-resolve hot path the bench holds to <10% overhead.
        self.marks: Optional[Dict[str, float]] = None
        self._token = None
        self._done = False

    # -- context-manager activation ---------------------------------------

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, _tb) -> bool:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc is not None:
            self.finish("error", err=repr(exc))
        else:
            self.finish()
        return False  # never swallow

    # -- manual lifecycle --------------------------------------------------

    def mark(self, name: str) -> None:
        """Stamp a named offset (e.g. ``flushed``) on the span."""
        if self.marks is None:
            self.marks = {}
        self.marks[name] = time.monotonic() - self.start

    def set_mark(self, name: str, seconds: float) -> None:
        """Record an externally-measured mark value (seconds).  The
        shard relay span stamps the WORKER's self-reported handling
        time this way — a duration another process measured, not an
        offset on this span's own clock."""
        if self.marks is None:
            self.marks = {}
        self.marks[name] = seconds

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def chain(self) -> List[str]:
        """Span names root-first down to this span (slow-span evidence)."""
        names: List[str] = []
        sp: Optional[Span] = self
        while sp is not None:
            names.append(sp.name)
            sp = sp.parent
        names.reverse()
        return names

    def finish(self, status: str = "ok", **attrs) -> None:
        """End the span: record duration, feed the recorder and sinks.

        Idempotent — a span that already finished (e.g. failed by the
        connection teardown, then seen again by a late reply) is left
        with its first verdict.
        """
        if self._done:
            return
        self._done = True
        self.duration_s = time.monotonic() - self.start
        self.status = status
        if attrs:
            self.attrs.update(attrs)
        if self.sampled:
            # inlined tracer._record_span (hot path, see class docstring)
            tracer = self.tracer
            tracer.spans_recorded += 1
            tracer._ring.append(self)
            for sink in tracer._sinks:
                try:
                    sink(self)
                except Exception:  # noqa: BLE001 - sinks must not break tracing
                    log.exception("span sink raised")
            if tracer.slow_span_ms is not None:
                tracer._check_slow(self)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": "span",
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "time": self.wall_start,
            "duration_ms": (
                round(self.duration_s * 1000.0, 3)
                if self.duration_s is not None
                else None
            ),
            "status": self.status,
            "attrs": dict(self.attrs),
            "marks": (
                {k: round(v * 1000.0, 3) for k, v in self.marks.items()}
                if self.marks
                else {}
            ),
        }


class _RemoteSpan(Span):
    """A wire-adopted parent anchor: a span that LIVES in another
    process, reconstructed here from a propagated ``(trace_id,
    parent_span_id, sampled)`` triple so local spans chain under it.

    Never recorded (``_done`` is born True — the owning process records
    the real span), never finished, zero new ids: entering it only makes
    it the *current* span, so every child created inside inherits the
    remote trace id and parents to the remote span id.  The assembly
    layer (:mod:`registrar_tpu_torch.traceview`) then joins the fragments
    across processes by exactly those ids.
    """

    def __init__(self, tracer, trace_id: int, span_id: int, sampled: bool):
        # Deliberately NOT Span.__init__: the ids come off the wire,
        # nothing here is ever recorded, and the anchor sits on the
        # traced wire hot path (one per adopted request) — so only the
        # slots children/start_span/chain actually read are set, and no
        # clocks are sampled.
        self.tracer = tracer
        self.name = "<remote>"
        self.parent = None
        self.sampled = sampled
        self.trace_id = f"{trace_id & 0xFFFFFFFFFFFFFFFF:016x}"
        self.span_id = f"{span_id & 0xFFFFFFFFFFFFFFFF:016x}"
        self._token = None
        self._done = True  # finish() is a no-op; the remote owner records


class Tracer:
    """One span factory + flight recorder + sink fan-out.

    ``sample_rate`` gates trace roots (children inherit);
    ``slow_span_ms`` (None = off) logs a warn line with the parent chain
    for any sampled span outlasting it; ``max_spans`` bounds the
    recorder ring.  ``rng`` injects determinism for tests.
    """

    enabled = True

    def __init__(
        self,
        sample_rate: float = 1.0,
        slow_span_ms: Optional[float] = None,
        max_spans: int = DEFAULT_MAX_SPANS,
        rng: Optional[random.Random] = None,
    ):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError("sample_rate must be within [0, 1]")
        if max_spans < 1:
            raise ValueError("max_spans must be >= 1")
        self.sample_rate = sample_rate
        self.slow_span_ms = slow_span_ms
        self._rng = rng if rng is not None else random.Random()
        self._ring: deque = deque(maxlen=max_spans)
        self._sinks: List = []
        #: completed sampled spans / recorded events (ring evictions
        #: excluded — the counters keep growing; the ring is bounded)
        self.spans_recorded = 0
        self.events_recorded = 0

    # -- span creation ------------------------------------------------------

    def start_span(self, name: str, **attrs) -> Span:
        parent = _current.get()
        if parent is NOOP_SPAN:
            parent = None
        if parent is not None and parent.tracer is not self:
            # Crossing tracer boundaries (a privately-traced cache under
            # a globally-traced caller): start a fresh root rather than
            # chaining into a span another recorder owns.
            parent = None
        sampled = (
            parent.sampled
            if parent is not None
            else (
                self.sample_rate >= 1.0
                or self._rng.random() < self.sample_rate
            )
        )
        ambient = _ambient.get()
        if ambient:
            attrs = {**ambient, **attrs}
        return Span(self, name, parent, sampled, attrs)

    #: ``span`` is the same method, not a delegating wrapper — one
    #: Python call per span creation is measurable on the traced hot
    #: path (a new span under the current one, context-manager ready).
    span = start_span

    def adopt(self, trace_id: int, parent_span_id: int, sampled: bool):
        """Adopt a wire-propagated context: returns a
        context manager making the REMOTE span the current parent, so
        every span created inside chains under the caller across the
        process boundary.  ``trace_id``/``parent_span_id`` are the u64
        ints off the wire (:func:`current_context`'s triple); the
        remote head-based ``sampled`` verdict is inherited whole — an
        unsampled remote trace propagates ids but records nothing here
        either."""
        return _RemoteSpan(self, trace_id, parent_span_id, bool(sampled))

    def event(self, name: str, **attrs) -> None:
        """Record an instantaneous point into the flight recorder.

        An event inside an *unsampled* trace is dropped — the head-based
        verdict covers the whole trace, spans and events alike (else a
        low sampleRate would still let a churning path's events evict
        the rare sampled spans from the ring).  An event outside any
        trace has no verdict to inherit and always records.
        """
        sp = _current.get()
        trace_id = None
        if isinstance(sp, Span) and sp.tracer is self:
            if not sp.sampled:
                return
            trace_id = sp.trace_id
        ambient = _ambient.get()
        if ambient:
            attrs = {**ambient, **attrs}
        self.events_recorded += 1
        self._ring.append(
            {
                "kind": "event",
                "name": name,
                "time": time.time(),
                "trace_id": trace_id,
                "attrs": attrs,
            }
        )

    # -- sinks / recorder ---------------------------------------------------

    def on_span(self, sink) -> None:
        """Register ``sink(span)`` for every finished sampled span."""
        self._sinks.append(sink)

    def _check_slow(self, span: Span) -> None:
        """Emit the slow-span warn line when ``span`` outlasts the
        threshold.  Recording itself is inlined in :meth:`Span.finish`
        (the ring holds the finished Span; dump() renders — building a
        dict per span would tax every traced hot-path operation to
        serve the rare dump)."""
        if not (
            span.duration_s is not None
            and span.duration_s * 1000.0 >= self.slow_span_ms
        ):
            return
        log.warning(
            "slow span: %s took %.1fms (threshold %.0fms)",
            span.name, span.duration_s * 1000.0, self.slow_span_ms,
            extra={
                "zdata": {
                    "trace_id": span.trace_id,
                    "span_id": span.span_id,
                    "span": span.name,
                    "durationMs": round(span.duration_s * 1000.0, 3),
                    "chain": span.chain(),
                    "attrs": {
                        k: _jsonable(v) for k, v in span.attrs.items()
                    },
                }
            },
        )

    def dump(
        self, n: Optional[int] = None, trace_id: Optional[str] = None
    ) -> Dict[str, Any]:
        """The flight recorder's contents, newest last.

        ``n`` bounds to the most recent n entries (None/<=0 = all);
        ``trace_id`` keeps only one trace's spans and events (the
        OP_TRACE collection path — a worker answers exactly the
        fragment the assembler asked for, not its whole ring)."""
        entries = list(self._ring)
        if trace_id is not None:
            entries = [
                e
                for e in entries
                if (
                    e.trace_id if isinstance(e, Span) else e.get("trace_id")
                ) == trace_id
            ]
        if n is not None and n > 0:
            entries = entries[-n:]
        entries = [
            e.to_dict() if isinstance(e, Span) else e for e in entries
        ]
        return {
            "enabled": True,
            "sample_rate": self.sample_rate,
            "spans_recorded": self.spans_recorded,
            "events_recorded": self.events_recorded,
            "entries": entries,
        }

    def dump_to_file(self, path: Optional[str] = None) -> str:
        """Write the recorder to ``path`` (default: a pid-suffixed file
        in the system temp dir).  Returns the path written."""
        return write_dump(self.dump(), path)


def write_dump(payload: Dict[str, Any], path: Optional[str] = None) -> str:
    """Write an already-snapshotted :meth:`Tracer.dump` payload to
    ``path`` (default: a pid-suffixed file in the system temp dir),
    stamping ``dumped_at``/``pid``.  Returns the path written.

    Split from the snapshot so a caller on the event loop can take the
    snapshot there and hand only this blocking file I/O to a worker
    thread — main.py's SIGUSR2 handler does exactly that (a wedged
    filesystem at ``dumpPath`` must not stall the loop past the session
    timeout; the statefile writer applies the same rule).
    """
    if path is None:
        path = os.path.join(
            tempfile.gettempdir(), f"registrar-trace-{os.getpid()}.json"
        )
    payload["dumped_at"] = time.time()
    payload["pid"] = os.getpid()
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, default=str)
        fh.write("\n")
    return path


class _DisabledTracer:
    """The reference-parity default: every call is a no-op."""

    enabled = False
    sample_rate = 0.0

    def span(self, _name: str, **_attrs) -> _NoopSpan:
        return NOOP_SPAN

    def start_span(self, _name: str, **_attrs) -> _NoopSpan:
        return NOOP_SPAN

    def event(self, _name: str, **_attrs) -> None:
        pass

    def on_span(self, _sink) -> None:
        pass

    def adopt(self, _trace_id: int, _parent_span_id: int, _sampled: bool):
        return NOOP_SPAN

    def dump(
        self,
        _n: Optional[int] = None,
        _trace_id: Optional[str] = None,
    ) -> Dict[str, Any]:
        return {"enabled": False, "entries": []}


DISABLED = _DisabledTracer()

_default = DISABLED


def get_tracer():
    """The process-wide tracer (``DISABLED`` unless configured)."""
    return _default


def set_tracer(tracer) -> None:
    """Install (or, with None, uninstall) the process-wide tracer."""
    global _default
    _default = tracer if tracer is not None else DISABLED


def tracer_for(obj):
    """The tracer an instrumented call should use: the ``tracer``
    attribute hung on ``obj`` (a client, a cache, a health checker) when
    set, else the process-wide default.  THE one resolution rule, so a
    privately-traced object in a test and the daemon's global
    configuration go through identical code."""
    tracer = getattr(obj, "tracer", None)
    return tracer if tracer is not None else _default


def _jsonable(value: Any) -> Any:
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return str(value)


class TraceContextFilter(logging.Filter):
    """Stamps the active trace_id/span_id onto every record it filters.

    Installed on the root handlers by main.py when the ``observability``
    block is present; :class:`registrar_tpu_torch.jlog.BunyanFormatter` renders
    the fields when (and only when) they are set, so with tracing off
    the log output is byte-identical to before.
    """

    def filter(self, record: logging.LogRecord) -> bool:
        sp = _current.get()
        if isinstance(sp, Span):
            record.trace_id = sp.trace_id
            record.span_id = sp.span_id
        return True
