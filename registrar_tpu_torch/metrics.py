"""Opt-in Prometheus-text metrics endpoint.

The reference has **no** metrics surface — bunyan logs only; SURVEY.md §5
notes its Triton/Manta contemporaries exposed counters via node-artedi on
an HTTP port.  This module is that analog for the rebuild: a tiny
dependency-free registry rendering Prometheus text exposition format
0.0.4, served by an asyncio HTTP listener, fed from the
:func:`registrar_tpu_torch.agent.register_plus` event surface and the ZK
client's connection state.

Everything is opt-in via the ``metrics`` config block (docs/CONFIG.md);
without it the daemon behaves exactly like the reference.

    GET /metrics   -> text/plain; version=0.0.4 exposition
    anything else  -> 404

Exported metrics (all prefixed ``registrar_``):

    registrar_registrations_total       registrations completed (incl.
                                        health recovery + heartbeat repair)
    registrar_unregistrations_total     health-driven deregistrations
    registrar_heartbeats_total{status}  znode probes, status="ok"|"failure"
    registrar_health_transitions_total{to}  threshold crossings, to="down"|"up"
    registrar_errors_total              'error' events from any subsystem
    registrar_malformed_frames_total{surface}  malformed peer frames rejected
                                        at a decode boundary (jute, zk
                                        framing/handshake, shard wire)
    registrar_health_down               1 while deregistered by health, else 0
    registrar_znodes_owned              znodes this instance maintains
    registrar_zk_connected              1 while the ZK session is connected
    registrar_uptime_seconds            seconds since instrumentation started
    registrar_session_rebirths_total    fresh in-process sessions after expiry
                                        (surviveSessionExpiry)
    registrar_rebirth_breaker_trips_total  rebirth circuit-breaker trips
                                        (fell back to terminal expiry)
    registrar_drift_total{reason}       reconciler drift detected, by reason
    registrar_drift_repaired_total{reason}  reconciler drift converged
    registrar_reconcile_sweeps_total    reconcile sweeps completed
    registrar_reconcile_sweep_seconds   duration of the last reconcile sweep
    registrar_handoffs_total            handoff shutdowns: session left
                                        alive for a successor
    registrar_drains_total              drain shutdowns (clean unregister)
    registrar_session_resumes_total{outcome}  cross-process session
                                        resumes (reattached|repaired|fresh)
    registrar_config_reloads_total{result}  SIGHUP config reloads
                                        (applied|noop|failed)

:func:`instrument_cache` additionally exposes the
watch-coherent resolve cache (:mod:`registrar_tpu_torch.zkcache`):

    registrar_cache_hits_total / _misses_total / _invalidations_total
    registrar_cache_bypasses_total      lookups served live while degraded
    registrar_cache_degraded_total      transitions into degraded mode
    registrar_cache_evictions_total     maxEntries evictions
    registrar_cache_entries             entries currently cached (gauge)
    registrar_cache_authoritative       1 = coherence-guaranteed (gauge)
    registrar_cache_coherence_lag_seconds[_total|_count]
                                        write→cache-visible lag

:func:`instrument_tracing` feeds real latency **histograms**
(`_bucket`/`_sum`/`_count` series) from the span layer
(:mod:`registrar_tpu_torch.trace`) — only wired when the ``observability``
config block enables tracing, so metric output stays byte-identical
without it:

    registrar_zk_op_seconds{op}         one observation per ZooKeeper
                                        request (queue + wire)
    registrar_resolve_seconds{source}   Binder-view resolves,
                                        source="cached"|"live"
    registrar_health_exec_seconds       health-check command executions
    registrar_reconcile_sweep_seconds   reconcile sweeps (replaces the
                                        last-value gauge of the same
                                        name while tracing is on)

:func:`instrument_slo` exposes the availability-SLO
harness's probe surface (:mod:`registrar_tpu_torch.testing.slo`):

    registrar_slo_probe_total{result}   availability probes, result="ok"|"fail"
    registrar_slo_outage_seconds_total{fault}  probe-observed outage
                                        seconds per owning fault class

The MetricsServer additionally serves:

    GET /status        one JSON snapshot: session id/state, registration
                       epoch + owned znodes with mzxids, health state,
                       cache stats, last drift summary, config
                       fingerprint — the runbook's first stop
                       (docs/OPERATIONS.md "first 5 minutes")
    GET /debug/trace?n=  the flight recorder's most recent n entries
    non-GET on a known path -> 405 with ``Allow: GET``
"""

from __future__ import annotations

import asyncio
import bisect
import json
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

from registrar_tpu_torch import malformed as malformed_mod
from registrar_tpu_torch import reconcile as reconcile_mod
from registrar_tpu_torch import trace as trace_mod

log = logging.getLogger("registrar_tpu_torch.metrics")

_LabelKey = Tuple[Tuple[str, str], ...]


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


class _Metric:
    """One metric family: name, help text, per-labelset values."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._values: Dict[_LabelKey, float] = {}

    def _key(self, labels: Optional[Dict[str, str]]) -> _LabelKey:
        return tuple(sorted((labels or {}).items()))

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(self._key(labels), 0.0)

    def remove(self, labels: Optional[Dict[str, str]] = None) -> None:
        """Drop one label set's series entirely (topology change: a
        resharded-away shard id must stop rendering, not freeze at its
        last value — a phantom ``up 1`` defeats the health signal)."""
        self._values.pop(self._key(labels), None)

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        # Deterministic output: label sets in sorted order.
        for key in sorted(self._values):
            value = self._values[key]
            if key:
                labels = ",".join(
                    f'{k}="{_escape_label(v)}"' for k, v in key
                )
                lines.append(f"{self.name}{{{labels}}} {_format(value)}")
            else:
                lines.append(f"{self.name} {_format(value)}")
        if len(lines) == 2:  # no samples yet: expose an explicit zero
            lines.append(f"{self.name} 0")
        return lines


def _format(value: float) -> str:
    return str(int(value)) if float(value).is_integer() else repr(value)


class Counter(_Metric):
    kind = "counter"

    def inc(
        self, amount: float = 1.0, labels: Optional[Dict[str, str]] = None
    ) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    #: counters backed by a live total are read at scrape time (the
    #: cache's hot path bumps a plain int; an event per lookup would put
    #:  an emitter dispatch inside every DNS answer).  The backing total
    #: must be monotonic — that is the exporter's contract to keep.
    fn: Optional[Callable[[], float]] = None

    def set_function(self, fn: Callable[[], float]) -> None:
        self.fn = fn

    def set_total(
        self, value: float, labels: Optional[Dict[str, str]] = None
    ) -> None:
        """Install a polled cumulative total for one label set — the
        labeled counterpart of :meth:`set_function`, for counters whose
        truth lives in another process (the shard router polls each
        worker's resolves_total).  The caller owns monotonicity (the
        router banks a crashed worker's count before its successor
        restarts from zero); a stale lower value is ignored rather than
        rendered as a counter going backwards."""
        key = self._key(labels)
        if value >= self._values.get(key, 0.0):
            self._values[key] = float(value)

    def render(self) -> List[str]:
        if self.fn is not None:
            self._values[self._key(None)] = float(self.fn())
        return super().render()


class Gauge(_Metric):
    kind = "gauge"

    def set(
        self, value: float, labels: Optional[Dict[str, str]] = None
    ) -> None:
        self._values[self._key(labels)] = float(value)

    #: gauges with a callback are computed at scrape time
    fn: Optional[Callable[[], float]] = None

    def set_function(self, fn: Callable[[], float]) -> None:
        self.fn = fn

    def render(self) -> List[str]:
        if self.fn is not None:
            self.set(self.fn())
        return super().render()


#: default histogram buckets (seconds): spans range from tens of µs
#: (a warm cached resolve) to whole seconds (the settle-delayed
#: registration pipeline), so the ladder covers 100 µs – 10 s.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram(_Metric):
    """Prometheus histogram: cumulative ``_bucket{le=}``, ``_sum``,
    ``_count`` per label set.  The family *name* is the bare metric
    name; only the suffixed series are rendered (standard exposition),
    which is why a histogram can replace a same-named gauge without the
    two ever colliding on a rendered series."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_text: str,
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_text)
        if not buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        #: per-label-set per-bucket counts (non-cumulative internally;
        #: rendered cumulative), plus the +Inf overflow slot at the end
        self._counts: Dict[_LabelKey, List[int]] = {}
        self._sums: Dict[_LabelKey, float] = {}

    def _slot(self, key: _LabelKey) -> List[int]:
        counts = self._counts.get(key)
        if counts is None:
            counts = self._counts[key] = [0] * (len(self.buckets) + 1)
            self._sums.setdefault(key, 0.0)
        return counts

    def preseed(self, labels: Optional[Dict[str, str]] = None) -> None:
        """Create the label set's zero series so alerts built on
        ``rate(..._count)`` see it from the first scrape (the registry's
        pre-seeding convention, same as Counter.inc(0))."""
        self._slot(self._key(labels))

    def observe(
        self, value: float, labels: Optional[Dict[str, str]] = None
    ) -> None:
        key = self._key(labels)
        counts = self._slot(key)
        counts[bisect.bisect_left(self.buckets, value)] += 1
        self._sums[key] = self._sums.get(key, 0.0) + value

    def set_totals(
        self,
        counts: List[int],
        total_sum: float,
        labels: Optional[Dict[str, str]] = None,
    ) -> None:
        """Install polled cumulative per-bucket counts + sum for one
        label set — the histogram counterpart of Counter.set_total, for
        ladders whose truth lives in other processes (the shard router
        polls each worker's DNS latency counts and banks a crashed
        incarnation's).  ``counts`` is the non-cumulative per-bucket
        list incl. the +Inf slot (short lists are zero-padded); same
        monotonic guard — a stale lower snapshot is ignored rather than
        rendered as a histogram going backwards."""
        key = self._key(labels)
        fresh = [int(c) for c in counts]
        if len(fresh) > len(self.buckets) + 1:
            raise ValueError("more bucket counts than bounds")
        fresh.extend([0] * (len(self.buckets) + 1 - len(fresh)))
        if sum(fresh) < sum(self._counts.get(key, ())):
            return
        self._counts[key] = fresh
        self._sums[key] = max(float(total_sum), self._sums.get(key, 0.0))

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        return sum(self._counts.get(self._key(labels), ()))

    def quantile(
        self, q: float, labels: Optional[Dict[str, str]] = None
    ) -> Optional[float]:
        """Bucket-interpolated quantile, the histogram_quantile()
        estimate (bench.py records p50/p95/p99 from exactly this).
        None when the label set has no observations."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be within [0, 1]")
        counts = self._counts.get(self._key(labels))
        total = sum(counts) if counts else 0
        if not total:
            return None
        rank = q * total
        seen = 0
        for i, bucket_count in enumerate(counts):
            seen += bucket_count
            if seen >= rank:
                if i >= len(self.buckets):
                    return self.buckets[-1]  # +Inf bucket: clamp
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                within = rank - (seen - bucket_count)
                return lo + (hi - lo) * (
                    within / bucket_count if bucket_count else 0.0
                )
        return self.buckets[-1]

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for key in sorted(self._counts):
            counts = self._counts[key]
            base = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
            sep = "," if base else ""
            cumulative = 0
            for bound, bucket_count in zip(self.buckets, counts):
                cumulative += bucket_count
                lines.append(
                    f'{self.name}_bucket{{{base}{sep}le="{_format(bound)}"}}'
                    f" {cumulative}"
                )
            cumulative += counts[-1]
            lines.append(
                f'{self.name}_bucket{{{base}{sep}le="+Inf"}} {cumulative}'
            )
            suffix = f"{{{base}}}" if base else ""
            lines.append(
                f"{self.name}_sum{suffix} {_format(self._sums.get(key, 0.0))}"
            )
            lines.append(f"{self.name}_count{suffix} {cumulative}")
        return lines


class MetricsRegistry:
    """Ordered collection of metric families; renders the exposition."""

    def __init__(self) -> None:
        self._metrics: List[_Metric] = []
        self._by_name: Dict[str, _Metric] = {}

    def counter(self, name: str, help_text: str) -> Counter:
        return self._add(Counter(name, help_text))

    def gauge(self, name: str, help_text: str) -> Gauge:
        return self._add(Gauge(name, help_text))

    def histogram(
        self,
        name: str,
        help_text: str,
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._add(Histogram(name, help_text, buckets))

    def _add(self, metric):
        if metric.name in self._by_name:
            raise ValueError(f"duplicate metric {metric.name}")
        self._metrics.append(metric)
        self._by_name[metric.name] = metric
        return metric

    def get(self, name: str) -> Optional[_Metric]:
        return self._by_name.get(name)

    def render(self) -> str:
        out: List[str] = []
        for metric in self._metrics:
            out.extend(metric.render())
        return "\n".join(out) + "\n"


#: total header bytes drained per request before the connection is
#: dropped: 100 lines of up-to-64KiB each (the StreamReader limit) would
#: otherwise let one hostile request make the daemon read ~6 MiB of
#: garbage per connection.
MAX_HEADER_BYTES = 16 * 1024


class MetricsServer:
    """Minimal asyncio HTTP/1.0 server exposing ``GET /metrics`` — plus,
    when providers are wired, ``GET /status`` (one introspection JSON
    snapshot) and ``GET /debug/trace?n=`` (the flight recorder).

    Deliberately tiny: one request per connection, no keep-alive, no TLS —
    the same operational footprint as an artedi/kang listener, meant for a
    loopback or management network (bind 127.0.0.1 by default).

    ``status_provider`` is an async callable returning the /status dict;
    ``trace_provider`` a sync callable ``(n: Optional[int]) -> dict``
    returning the /debug/trace payload; ``trace_tree_provider`` an
    async callable ``(trace_id: str) -> dict`` returning the ASSEMBLED
    cross-process tree for ``GET /debug/trace?id=<trace_id>`` (the
    shard router's OP_TRACE fan-out, or the daemon's own
    single-recorder assembly).  An unwired endpoint answers 404,
    exactly like any unknown path.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        host: str = "127.0.0.1",
        port: int = 0,
        status_provider=None,
        trace_provider=None,
        trace_tree_provider=None,
    ):
        self.registry = registry
        self.host = host
        self.status_provider = status_provider
        self.trace_provider = trace_provider
        self.trace_tree_provider = trace_tree_provider
        self._requested_port = port
        self.port: Optional[int] = None
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> "MetricsServer":
        self._server = await asyncio.start_server(
            self._handle, self.host, self._requested_port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        log.debug("metrics listening on %s:%d", self.host, self.port)
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader, writer) -> None:
        try:
            try:
                request = await asyncio.wait_for(
                    reader.readline(), timeout=5.0
                )
            except (asyncio.TimeoutError, ValueError):
                # ValueError: line exceeded the StreamReader limit (a
                # hostile/garbage request) — drop it, no response owed.
                return
            parts = request.decode("latin-1", "replace").split()
            # Drain headers (bounded in LINES and total BYTES) so
            # well-behaved clients see a clean close instead of a reset,
            # while a hostile request cannot make us read megabytes of
            # headers one near-limit line at a time.
            drained = len(request)
            for _ in range(100):
                try:
                    line = await asyncio.wait_for(
                        reader.readline(), timeout=5.0
                    )
                except ValueError:  # oversized header line
                    return
                if line in (b"\r\n", b"\n", b""):
                    break
                drained += len(line)
                if drained > MAX_HEADER_BYTES:
                    return  # hostile header volume: drop, no response owed
            status, ctype, body, extra = await self._respond(parts)
            writer.write(
                (
                    f"HTTP/1.0 {status}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    f"{extra}"
                    "Connection: close\r\n\r\n"
                ).encode()
                + body
            )
            await writer.drain()
        except (ConnectionError, OSError, asyncio.TimeoutError):
            pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _respond(self, parts: List[str]):
        """Route one request: ``(status, content_type, body, extra_headers)``."""
        method = parts[0] if parts else ""
        target = parts[1] if len(parts) >= 2 else ""
        path, _, query = target.partition("?")
        known = path == "/metrics" or (
            path == "/status" and self.status_provider is not None
        ) or (
            path == "/debug/trace"
            and (
                self.trace_provider is not None
                or self.trace_tree_provider is not None
            )
        )
        if known and method != "GET":
            # The path exists; the method is wrong.  405 with Allow is
            # the contract clients (and security scanners) expect —
            # a 404 here would claim the endpoint doesn't exist.
            return (
                "405 Method Not Allowed",
                "text/plain; charset=utf-8",
                b"method not allowed; try GET\n",
                "Allow: GET\r\n",
            )
        if known and path == "/metrics":
            return (
                "200 OK",
                "text/plain; version=0.0.4; charset=utf-8",
                self.registry.render().encode(),
                "",
            )
        if known and path == "/status":
            try:
                snapshot = await self.status_provider()
                body = json.dumps(snapshot, indent=2, default=str).encode()
                body += b"\n"
            except Exception as err:  # noqa: BLE001 - introspection must answer
                log.exception("status provider raised")
                body = json.dumps({"error": repr(err)}).encode() + b"\n"
            return ("200 OK", "application/json; charset=utf-8", body, "")
        if known and path == "/debug/trace":
            n = None
            trace_id = None
            for kv in query.split("&"):
                key, _, value = kv.partition("=")
                if key == "n":
                    try:
                        n = int(value)
                    except ValueError:
                        pass
                elif key == "id" and value:
                    trace_id = value
            if trace_id is not None:
                # One ASSEMBLED tree instead of the raw ring
                # — cross-process when the provider is the shard
                # router's OP_TRACE fan-out.  No provider = an explicit
                # error, never a silent fallback to the ring dump (the
                # shapes differ; zkcli trace --id would choke on it).
                if self.trace_tree_provider is None:
                    payload = {
                        "error": "trace assembly (?id=) is not wired "
                        "on this listener",
                        "trace_id": trace_id,
                    }
                else:
                    try:
                        payload = await self.trace_tree_provider(trace_id)
                    except Exception as err:  # noqa: BLE001 - introspection must answer
                        log.exception("trace tree provider raised")
                        payload = {"error": repr(err), "trace_id": trace_id}
            elif self.trace_provider is not None:
                payload = self.trace_provider(n)
            else:
                payload = {"error": "no flight recorder wired"}
            body = json.dumps(
                payload, indent=2, default=str
            ).encode() + b"\n"
            return ("200 OK", "application/json; charset=utf-8", body, "")
        return (
            "404 Not Found",
            "text/plain; charset=utf-8",
            b"try GET /metrics\n",
            "",
        )


def instrument(ee, zk, registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Wire a :class:`MetricsRegistry` to the register_plus event surface.

    ``ee`` is the :class:`registrar_tpu_torch.agent.RegistrarEvents` emitter,
    ``zk`` the :class:`registrar_tpu_torch.zk.client.ZKClient`.  Returns the
    registry (creating one when not given).  Call once, before or after
    the initial 'register' event — gauges read live state at scrape time.
    """
    reg = registry if registry is not None else MetricsRegistry()

    registrations = reg.counter(
        "registrar_registrations_total",
        "Registrations completed (initial, health recovery, heartbeat repair)",
    )
    unregistrations = reg.counter(
        "registrar_unregistrations_total",
        "Health-driven deregistrations completed",
    )
    heartbeats = reg.counter(
        "registrar_heartbeats_total",
        "Znode liveness probes by status (ok|failure)",
    )
    transitions = reg.counter(
        "registrar_health_transitions_total",
        "Health-check threshold crossings (to=down|up)",
    )
    errors = reg.counter(
        "registrar_errors_total", "Unexpected errors from any subsystem"
    )
    malformed_frames = reg.counter(
        "registrar_malformed_frames_total",
        "Malformed peer frames rejected at a decode boundary, by surface",
    )
    for surface in malformed_mod.SURFACES:
        # Pre-seed every surface's zero series (the registry convention:
        # alert rate()s must see the series from the first scrape).
        malformed_frames.inc(0, labels={"surface": surface})
    malformed_mod.subscribe(
        lambda surface: malformed_frames.inc(labels={"surface": surface})
    )
    down = reg.gauge(
        "registrar_health_down",
        "1 while the health checker holds this host deregistered",
    )
    znodes = reg.gauge(
        "registrar_znodes_owned", "Znodes this instance maintains"
    )
    connected = reg.gauge(
        "registrar_zk_connected", "1 while the ZooKeeper session is connected"
    )
    uptime = reg.gauge(
        "registrar_uptime_seconds", "Seconds since instrumentation started"
    )
    rebirths = reg.counter(
        "registrar_session_rebirths_total",
        "Fresh ZK sessions established in-process after an expiry "
        "(surviveSessionExpiry)",
    )
    breaker_trips = reg.counter(
        "registrar_rebirth_breaker_trips_total",
        "Session-rebirth circuit breaker trips (fell back to terminal "
        "session expiry)",
    )
    drift = reg.counter(
        "registrar_drift_total",
        "Registration drift detected by the reconciler, by reason",
    )
    drift_repaired = reg.counter(
        "registrar_drift_repaired_total",
        "Registration drift converged by the reconciler, by reason",
    )
    sweeps = reg.counter(
        "registrar_reconcile_sweeps_total", "Reconcile sweeps completed"
    )
    # With tracing on, instrument_tracing (wired FIRST) already owns this
    # family as a real histogram fed from reconcile.sweep spans; the
    # last-value gauge then stands down — including its event handler
    # (a Histogram has no set(), and the span sink is already the data
    # path).  Without it (the default), the gauge renders and updates
    # exactly as before — parity.
    sweep_seconds = reg.get("registrar_reconcile_sweep_seconds")
    if sweep_seconds is None:
        sweep_seconds = reg.gauge(
            "registrar_reconcile_sweep_seconds",
            "Duration of the last reconcile sweep (seconds)",
        )
    sweep_gauge = sweep_seconds if isinstance(sweep_seconds, Gauge) else None
    handoffs = reg.counter(
        "registrar_handoffs_total",
        "Handoff shutdowns: session state persisted, connection "
        "detached with the session (and ephemerals) left alive for a "
        "successor (restart.mode=handoff)",
    )
    drains = reg.counter(
        "registrar_drains_total",
        "Drain shutdowns: znodes unregistered cleanly before exit "
        "(restart.mode=drain)",
    )
    resumes = reg.counter(
        "registrar_session_resumes_total",
        "Cross-process session resume attempts by outcome: reattached "
        "(verified in place, zero NO_NODE), repaired (reattached but "
        "drifted; pipeline re-ran), fresh (state unusable or reattach "
        "refused; normal registration)",
    )
    reloads = reg.counter(
        "registrar_config_reloads_total",
        "SIGHUP config reloads by result (applied|noop|failed)",
    )
    watch_events = reg.counter(
        "registrar_watch_events_total",
        "ZooKeeper watch notifications delivered to this client "
        "(the firehose behind cache invalidation and watch re-arm)",
    )
    write_refusals = reg.counter(
        "registrar_write_refusals_total",
        "ZooKeeper writes refused by reason (read_only = the request "
        "reached a read-only minority/quorum-loss member; retried once "
        "the client fails over)",
    )
    member_role = reg.gauge(
        "registrar_zk_member_role",
        "Info gauge: 1 for the kind of ensemble member the session is "
        "attached to (role=read_write|read_only|disconnected)",
    )

    start = time.monotonic()
    uptime.set_function(lambda: time.monotonic() - start)
    down.set_function(lambda: 1.0 if ee.down else 0.0)
    znodes.set_function(lambda: float(len(ee.znodes)))
    connected.set_function(lambda: 1.0 if zk.connected else 0.0)

    # Pre-seed every documented label set at 0 so each series exists from
    # the first scrape — a counter appearing only on its first increment
    # breaks rate()/absent() queries, and the unlabeled zero placeholder
    # (render fallback) would otherwise vanish once a labeled sample lands.
    for status in ("ok", "failure"):
        heartbeats.inc(0, labels={"status": status})
    for to in ("down", "up"):
        transitions.inc(0, labels={"to": to})
    for reason in reconcile_mod.REASONS:
        drift.inc(0, labels={"reason": reason})
        drift_repaired.inc(0, labels={"reason": reason})
    for outcome in ("reattached", "repaired", "fresh"):
        resumes.inc(0, labels={"outcome": outcome})
    for result in ("applied", "noop", "failed"):
        reloads.inc(0, labels={"result": result})
    for reason in ("read_only",):
        write_refusals.inc(0, labels={"reason": reason})

    member_roles = ("read_write", "read_only", "disconnected")

    def set_member_role(*_a) -> None:
        if zk.connected:
            role = (
                "read_only"
                if getattr(zk, "read_only", False)
                else "read_write"
            )
        else:
            role = "disconnected"
        for r in member_roles:
            member_role.set(1.0 if r == role else 0.0, labels={"role": r})

    set_member_role()

    def on_sweep(summary) -> None:
        sweeps.inc()
        if sweep_gauge is not None:
            sweep_gauge.set(float(summary.get("duration", 0.0)))

    zk.on("session_reborn", lambda *_a: rebirths.inc())
    zk.on("rebirth_breaker_tripped", lambda *_a: breaker_trips.inc())
    zk.on("watch", lambda *_a: watch_events.inc())
    zk.on(
        "write_refused",
        lambda reason: write_refusals.inc(labels={"reason": reason}),
    )
    zk.on("state", set_member_role)
    ee.on("handoff", lambda *_a: handoffs.inc())
    ee.on("drain", lambda *_a: drains.inc())
    ee.on("resume", lambda outcome: resumes.inc(labels={"outcome": outcome}))
    ee.on(
        "configReload",
        lambda result: reloads.inc(labels={"result": result}),
    )
    ee.on("drift", lambda d: drift.inc(labels={"reason": d.reason}))
    ee.on(
        "driftRepaired",
        lambda d: drift_repaired.inc(labels={"reason": d.reason}),
    )
    ee.on("reconcile", on_sweep)
    ee.on("register", lambda *_a: registrations.inc())
    ee.on("unregister", lambda *_a: unregistrations.inc())
    ee.on("heartbeat", lambda *_a: heartbeats.inc(labels={"status": "ok"}))
    ee.on(
        "heartbeatFailure",
        lambda *_a: heartbeats.inc(labels={"status": "failure"}),
    )
    ee.on("fail", lambda *_a: transitions.inc(labels={"to": "down"}))
    ee.on("ok", lambda *_a: transitions.inc(labels={"to": "up"}))
    ee.on("error", lambda *_a: errors.inc())
    return reg


def instrument_cache(cache, registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Expose a :class:`registrar_tpu_torch.zkcache.ZKCache`'s counters.

    The cache's lookup hot path bumps plain ints in ``cache.stats``;
    the registry reads them at scrape time (``Counter.set_function``),
    so instrumentation adds zero cost to a cached DNS answer.  Every
    series exists from the first scrape (pre-seeded via the same
    scrape-time read — the backing stats start at 0).
    """
    reg = registry if registry is not None else MetricsRegistry()
    stats = cache.stats

    def from_stat(metric, key: str) -> None:
        metric.set_function(lambda: stats[key])

    from_stat(reg.counter(
        "registrar_cache_hits_total",
        "Resolve-cache lookups served from memory",
    ), "hits")
    from_stat(reg.counter(
        "registrar_cache_misses_total",
        "Resolve-cache lookups that needed a live ZooKeeper read",
    ), "misses")
    from_stat(reg.counter(
        "registrar_cache_invalidations_total",
        "Cache entries dropped by a fired one-shot watch",
    ), "invalidations")
    from_stat(reg.counter(
        "registrar_cache_bypasses_total",
        "Lookups served live because the cache was degraded "
        "(session down or watch re-arm failed)",
    ), "bypasses")
    from_stat(reg.counter(
        "registrar_cache_degraded_total",
        "Transitions into degraded (non-authoritative) mode",
    ), "degraded_total")
    from_stat(reg.counter(
        "registrar_cache_stale_serves_total",
        "Degraded-mode lookups answered from bounded-age last-known-good "
        "entries (serve-stale, cache.staleMaxAgeS)",
    ), "stale_serves")
    from_stat(reg.counter(
        "registrar_cache_stale_refusals_total",
        "Degraded-mode lookups that crossed the stale-age bound and "
        "flushed the stale world instead of answering from it",
    ), "stale_refusals")
    from_stat(reg.counter(
        "registrar_cache_evictions_total",
        "Entries evicted by the maxEntries bound",
    ), "evictions")
    reg.counter(
        "registrar_cache_coherence_lag_seconds_total",
        "Sum of observed write-to-invalidation-processed lag (the "
        "window in which a cached answer could still be stale; "
        "divide by _count for the mean)",
    ).set_function(lambda: stats["coherence_lag_ms_total"] / 1000.0)
    from_stat(reg.counter(
        "registrar_cache_coherence_lag_count",
        "Number of coherence-lag observations",
    ), "coherence_lag_count")
    entries = reg.gauge(
        "registrar_cache_entries", "Entries currently cached"
    )
    entries.set_function(lambda: float(cache.entries))
    authoritative = reg.gauge(
        "registrar_cache_authoritative",
        "1 while cached answers are coherence-guaranteed, 0 in "
        "degraded (live-read) mode",
    )
    authoritative.set_function(lambda: 1.0 if cache.authoritative else 0.0)
    lag_last = reg.gauge(
        "registrar_cache_coherence_lag_seconds",
        "Last observed write-to-invalidation-processed lag (seconds)",
    )
    lag_last.set_function(lambda: stats["coherence_lag_ms_last"] / 1000.0)
    return reg


def instrument_slo(harness, registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Expose the availability-SLO harness's probe counters.

    ``harness`` is a :class:`registrar_tpu_torch.testing.slo.SLOHarness` (or
    anything with its event surface): ``probe(result)`` fires once per
    availability sample, ``outage(fault, seconds)`` once per attributed
    merged outage window at report time.  Both label sets are
    pre-seeded — results from the two probe verdicts, fault classes
    from the harness's docs/FAULTS.md catalog ids — so every series
    exists from the first scrape (the registry's convention).
    """
    reg = registry if registry is not None else MetricsRegistry()
    probes = reg.counter(
        "registrar_slo_probe_total",
        "Availability probes by result (ok = the live Binder answer "
        "carried the full fleet)",
    )
    for result in ("ok", "fail"):
        probes.inc(0, labels={"result": result})
    outage = reg.counter(
        "registrar_slo_outage_seconds_total",
        "Probe-observed outage seconds by the fault class owning the "
        "merged window (overlapping faults never double-count)",
    )
    for fault in getattr(harness, "fault_ids", ()):
        outage.inc(0, labels={"fault": fault})
    harness.on("probe", lambda result: probes.inc(labels={"result": result}))
    harness.on(
        "outage",
        lambda fault, seconds: outage.inc(seconds, labels={"fault": fault}),
    )
    return reg


def instrument_shards(
    router, registry: Optional[MetricsRegistry] = None
) -> MetricsRegistry:
    """Expose the sharded serve tier's rollup.

    ``router`` is a :class:`registrar_tpu_torch.shard.ShardRouter`: its
    ``poll`` event carries each worker's polled status (resolves, cache
    entries), ``respawn`` fires when a crashed worker is detected, and
    ``reshard`` when the ring changes shape.  Per-shard label sets are
    pre-seeded for the router's current shard ids; counters stay
    monotonic across worker crashes because the router banks a dead
    incarnation's totals (``Counter.set_total``).

    The overload-armor families ride the same events:
    ``registrar_shed_total{reason}`` and ``registrar_queue_depth{shard}``
    from the status polls, ``registrar_admitted_resolve_seconds`` from
    the router's ``admitted`` event (one observation per successfully
    relayed resolve).
    """
    reg = registry if registry is not None else MetricsRegistry()
    resolves = reg.counter(
        "registrar_shard_resolves_total",
        "Resolves served, by shard (rolled up from worker status polls; "
        "monotonic across worker respawns)",
    )
    entries = reg.gauge(
        "registrar_shard_entries",
        "Watch-coherent cache entries currently held, by shard",
    )
    up = reg.gauge(
        "registrar_shard_up",
        "1 while the shard's worker process is serving, 0 while it is "
        "dead or respawning",
    )
    respawns = reg.counter(
        "registrar_shard_respawns_total",
        "Worker crashes detected (each is followed by a respawn while "
        "sibling shards keep serving), by shard",
    )
    reshards = reg.counter(
        "registrar_shard_reshards_total",
        "Ring shape changes (SIGHUP shard-count change with warm "
        "handoff)",
    )
    reshards.inc(0)
    relay = reg.histogram(
        "registrar_shard_relay_seconds",
        "Router relay latency by shard: one observation per "
        "shard.relay span, client frame in to worker reply out; the "
        "span's forwarded/worker marks split it into router-queue, "
        "socket, and worker time",
    )
    # Overload armor rollup.  All three families exist (pre-
    # seeded) whether or not any armor is configured — an un-armored
    # tier legitimately reports zero sheds, and the alert rate() needs
    # the zero series either way.
    from registrar_tpu_torch.shard import SHED_REASONS

    sheds = reg.counter(
        "registrar_shed_total",
        "Requests deliberately rejected by the overload armor, by shed "
        "reason (queue_full = worker admission bound, rate_limited = "
        "the router's per-client token bucket, cold_fill_shed = the "
        "cache's cold-fill concurrency bound, slow_client = a reply "
        "write deadline disconnected a stalled reader); monotonic "
        "across worker respawns",
    )
    for reason in SHED_REASONS:
        sheds.inc(0, labels={"reason": reason})
    queue_depth = reg.gauge(
        "registrar_queue_depth",
        "Resolve requests dispatched and unanswered in the worker, by "
        "shard (the bounded dispatch backlog; at maxQueueDepth new "
        "resolves shed queue_full)",
    )
    admitted = reg.histogram(
        "registrar_admitted_resolve_seconds",
        "Latency of ADMITTED resolves relayed through the router "
        "(shed requests are excluded — this prices exactly the work "
        "the armor let through)",
    )
    admitted.preseed(None)
    # DNS frontend rollup.  Families exist (pre-seeded)
    # whether or not serve.dns is configured — an un-DNS'd tier
    # legitimately reports zero queries, and alert rate()s need the
    # zero series either way (the registry's parity stance).
    from registrar_tpu_torch.dnsfront import QTYPE_NAMES, SERVED_QTYPES

    dns_queries = reg.counter(
        "registrar_dns_queries_total",
        "DNS queries answered at the SO_REUSEPORT frontend, by qtype "
        "and rcode (rolled up from worker status polls; monotonic "
        "across worker respawns)",
    )
    for qt in SERVED_QTYPES:
        for rc in ("NOERROR", "NXDOMAIN", "REFUSED", "SERVFAIL"):
            dns_queries.inc(
                0, labels={"qtype": QTYPE_NAMES[qt], "rcode": rc}
            )
    dns_udp = reg.histogram(
        "registrar_dns_udp_seconds",
        "UDP DNS answer latency at the frontend (packet in to sendto), "
        "aggregated across shard workers (Histogram.set_totals from "
        "the polled per-worker ladders; monotonic across respawns)",
    )
    dns_udp.preseed(None)
    dns_hits = reg.counter(
        "registrar_dns_encode_cache_hits_total",
        "Warm answer-encode-cache template hits (the memcpy-path "
        "answers), tier-wide",
    )
    dns_hits.inc(0)
    dns_misses = reg.counter(
        "registrar_dns_encode_cache_misses_total",
        "Answer-encode-cache misses (full resolve + RR render), "
        "tier-wide",
    )
    dns_misses.inc(0)
    dns_invalidations = reg.counter(
        "registrar_dns_encode_cache_invalidations_total",
        "Pre-rendered answer templates dropped by ZKCache watch "
        "events (the coherence mechanism), tier-wide",
    )
    dns_invalidations.inc(0)
    dns_entries = reg.gauge(
        "registrar_dns_encode_cache_entries",
        "Pre-rendered answer templates currently held, tier-wide",
    )
    seeded: set = set()

    def seed(sid) -> None:
        labels = {"shard": str(sid)}
        resolves.inc(0, labels=labels)
        entries.set(0.0, labels=labels)
        up.set(0.0, labels=labels)
        respawns.inc(0, labels=labels)
        relay.preseed(labels)
        queue_depth.set(0.0, labels=labels)
        seeded.add(sid)

    for sid in getattr(router.ring, "shard_ids", ()):
        seed(sid)

    def resync_shards(*_args) -> None:
        # A reshard changes the label-set topology: new shards get
        # pre-seeded series, and a resharded-away shard's GAUGES are
        # dropped (a phantom up/entries frozen at its last value would
        # misreport a nonexistent shard as healthy forever).  Its
        # counters stay — they are history, not health.
        current = set(router.ring.shard_ids)
        for sid in current - seeded:
            seed(sid)
        for sid in seeded - current:
            entries.remove({"shard": str(sid)})
            up.remove({"shard": str(sid)})
            queue_depth.remove({"shard": str(sid)})
            seeded.discard(sid)

    def on_poll(statuses) -> None:
        down = set(router.shards_down())
        for sid in router.ring.shard_ids:
            up.set(0.0 if sid in down else 1.0,
                   labels={"shard": str(sid)})
        for sid, status in statuses:
            labels = {"shard": str(sid)}
            resolves.set_total(
                router.shard_resolves_total(sid), labels=labels
            )
            entries.set(float(status.get("entries", 0)), labels=labels)
            queue_depth.set(
                float(
                    (status.get("overload") or {}).get("queue_depth", 0)
                ),
                labels=labels,
            )
        # Tier-wide shed rollup: router-side rejects plus every slot's
        # banked + live worker counts (set_total keeps it monotonic
        # across respawns, same contract as resolves).
        for reason, count in router.sheds_total().items():
            sheds.set_total(count, labels={"reason": reason})
        # DNS surface rollup: the router folds every slot's
        # banked + live front stats; the same monotonic contract.
        rollup = (
            router.dns_rollup() if hasattr(router, "dns_rollup") else None
        )
        if rollup:
            for key, count in (rollup.get("queries") or {}).items():
                qt, _, rc = key.partition(" ")
                dns_queries.set_total(
                    count, labels={"qtype": qt, "rcode": rc}
                )
            udp = rollup.get("udp") or {}
            if udp.get("counts"):
                dns_udp.set_totals(udp["counts"], udp.get("sum", 0.0))
            cache_stats = rollup.get("encode_cache") or {}
            dns_hits.set_total(cache_stats.get("hits", 0))
            dns_misses.set_total(cache_stats.get("misses", 0))
            dns_invalidations.set_total(
                cache_stats.get("invalidations", 0)
            )
            dns_entries.set(float(cache_stats.get("entries", 0)))

    router.on("poll", on_poll)
    router.on("admitted", lambda seconds: admitted.observe(seconds))
    router.on(
        "respawn",
        lambda sid: (
            respawns.inc(labels={"shard": str(sid)}),
            up.set(0.0, labels={"shard": str(sid)}),
        ),
    )
    def on_reshard(_old, _new, _moved) -> None:
        reshards.inc()
        resync_shards()

    router.on("reshard", on_reshard)

    # Feed the relay histogram from the router's shard.relay spans.
    # Resolved once, at instrument time: with tracing off
    # the family still exists pre-seeded (alerts see zero series), it
    # just never observes — the registry's parity stance.
    tracer = trace_mod.tracer_for(router)
    if tracer.enabled:
        shard_labels: Dict[str, Dict[str, str]] = {}

        def on_relay_span(span) -> None:
            if span.name != "shard.relay" or span.duration_s is None:
                return
            sid = str(span.attrs.get("shard"))
            labels = shard_labels.get(sid)
            if labels is None:
                labels = shard_labels[sid] = {"shard": sid}
            relay.observe(span.duration_s, labels=labels)

        tracer.on_span(on_relay_span)
    return reg


#: ZooKeeper op label values pre-seeded for registrar_zk_op_seconds —
#: the requests the daemon's own loops issue, so each series exists from
#: the first scrape (the registry's pre-seeding convention).
ZK_OPS_PRESEEDED = (
    "create", "delete", "exists", "getData", "setData", "getChildren2",
    "sync", "multi",
)


def instrument_tracing(
    tracer, registry: Optional[MetricsRegistry] = None
) -> MetricsRegistry:
    """Feed latency histograms from the span layer.

    Subscribes to ``tracer``'s span sink and routes the cataloged span
    names (docs/OBSERVABILITY.md) into Prometheus histograms.  Call
    BEFORE :func:`instrument` on a shared registry: this owns the
    ``registrar_reconcile_sweep_seconds`` family (as a histogram), and
    instrument() then skips its last-value gauge of the same name.

    Only wired when tracing is enabled (the ``observability`` config
    block) — without it, none of these families exist and the metric
    output is byte-identical to pre-tracing builds.
    """
    reg = registry if registry is not None else MetricsRegistry()

    zk_op = reg.histogram(
        "registrar_zk_op_seconds",
        "ZooKeeper request latency (submit to reply dispatched), by op",
    )
    for op in ZK_OPS_PRESEEDED:
        zk_op.preseed({"op": op})
    resolve = reg.histogram(
        "registrar_resolve_seconds",
        "Binder-view resolve latency by source (cached|live)",
    )
    for source in ("cached", "live"):
        resolve.preseed({"source": source})
    health_exec = reg.histogram(
        "registrar_health_exec_seconds",
        "Health-check command execution time",
    )
    health_exec.preseed()
    sweep = reg.histogram(
        "registrar_reconcile_sweep_seconds",
        "Reconcile sweep duration distribution",
    )
    sweep.preseed()

    # Label dicts are interned per distinct value: the sink runs once
    # per finished span on traced hot paths (a cached resolve is ~100µs
    # end to end), and a fresh one-key dict per observation is
    # measurable there.
    op_labels: Dict[str, Dict[str, str]] = {}
    source_labels = {s: {"source": s} for s in ("cached", "live")}

    def on_span(span) -> None:
        if span.duration_s is None:
            return
        name = span.name
        if name == "zk.op":
            op = str(span.attrs.get("op"))
            labels = op_labels.get(op)
            if labels is None:
                labels = op_labels[op] = {"op": op}
            zk_op.observe(span.duration_s, labels=labels)
        elif name == "resolve.query":
            source = str(span.attrs.get("source"))
            labels = source_labels.get(source)
            if labels is None:
                labels = source_labels[source] = {"source": source}
            resolve.observe(span.duration_s, labels=labels)
        elif name == "health.exec":
            health_exec.observe(span.duration_s)
        elif name == "reconcile.sweep":
            sweep.observe(span.duration_s)

    tracer.on_span(on_span)
    return reg
