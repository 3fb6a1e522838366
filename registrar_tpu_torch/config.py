"""Configuration loading and validation.

The config file is the same JSON shape the reference reads (reference
main.js:52-84, README.md "Configuration reference"; sample:
etc/config.coal.json)::

    {
      "adminIp": "10.0.0.5",                   # optional
      "zookeeper": {
        "servers": [{"host": "...", "port": 2181}, ...],
        "timeout": 30000,                      # session timeout, ms
        "connectTimeout": 4000                 # per-attempt dial timeout, ms
      },
      "registration": {
        "domain": "...", "type": "...",
        "aliases": [...], "ttl": 30, "ports": [...],
        "service": {"type": "service",
                    "service": {"srvce": "...", "proto": "...", "port": N,
                                "ttl": N}},
        "heartbeatInterval": 3000              # ms (undocumented upstream,
      },                                       #  honored for parity)
      "healthCheck": {                         # optional; ms-based values
        "command": "...", "interval": 60000, "timeout": 1000,
        "threshold": 5, "period": 300000, "ignoreExitStatus": false,
        "stdoutMatch": {"pattern": "...", "flags": "...", "invert": false}
      },
      "logLevel": "info",                      # optional
      "maxAttempts": 5,                        # heartbeat retry attempts
      "repairHeartbeatMiss": false,            # opt-in extension (no
                                               #  reference analog): re-run
                                               #  registration when a
                                               #  heartbeat finds the znodes
                                               #  gone (SURVEY.md §3.2 note)
      "metrics": {"port": 9090,                # opt-in extension: Prometheus
                  "host": "127.0.0.1"},        #  /metrics endpoint (the
                                               #  node-artedi analog,
                                               #  SURVEY.md §5)
      "surviveSessionExpiry": false,           # opt-in: rebuild a
                                               #  fresh ZK session in-process
                                               #  on expiry instead of exit(1)
      "maxSessionRebirths": 5,                 # rebirth circuit-breaker bound
                                               #  (per 5-minute window)
      "reconcile": {"intervalSeconds": 60,     # opt-in: level-
                    "repair": false},          #  triggered drift reconciler;
                                               #  NOTE: seconds, not ms
      "cache": {"maxEntries": 4096},           # resolve-cache tuning for
                                               #  zkcli serve-view;
                                               #  the daemon ignores it
      "restart": {                             # opt-in: zero-
        "stateFile": "/var/run/registrar/state.json",  # downtime restarts;
        "mode": "handoff",                     #  "handoff" hands the live ZK
        "drainGraceSeconds": 0                 #  session to the successor,
      },                                       #  "drain" unregisters + waits
      "serve": {                               # opt-in: the
        "shards": 4,                           #  namespace-sharded resolve
        "socketPath": "/var/run/registrar/resolve.sock",  # tier for `zkcli
        "attachSpread": "spread"               #  serve-sharded`; the daemon
      }                                        #  ignores the block entirely
    }

All reference keys are camelCase and all durations are milliseconds; this
module translates them into the seconds-based snake_case surface of the
Python modules.  ``maxAttempts`` appears in the reference's sample config
but is read by nothing there (SURVEY.md §2.7 calls it inert) — here it is
wired to the heartbeat retry policy, which is what it was evidently meant
to configure.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from registrar_tpu_torch.retry import HEARTBEAT_RETRY, RetryPolicy


class ConfigError(ValueError):
    """Invalid configuration (parse or validation failure)."""


class ConfigUnreadableError(ConfigError):
    """The config file could not be *read* (missing, permissions, I/O).

    Distinct from semantic invalidity because the right supervisor
    reaction differs: a file that is not there yet (config-agent racing
    the unit at boot) is cured by restarting, while a config that parses
    but can never validate is not — main.py exits 1 for the former and
    EX_CONFIG (78) for the latter.
    """


@dataclass
class ZookeeperConfig:
    servers: List[Tuple[str, int]]
    timeout_ms: int = 30000
    connect_timeout_ms: int = 4000
    chroot: Optional[str] = None
    #: per-operation deadline (``requestTimeout``, ms).  None (the
    #: default) = wait forever, the reference's behavior; when set, a
    #: stalled reply tears the connection down and the op fails with the
    #: retryable OPERATION_TIMEOUT (docs/FAULTS.md).
    request_timeout_ms: Optional[int] = None
    #: ``canBeReadOnly``: allow the client to attach to a
    #: read-only ensemble member during quorum loss / partition so
    #: heartbeat and resolve reads keep answering; writes fail with the
    #: retryable NOT_READONLY until the rw-probe fails the session over.
    #: Default False = reference-exact handshake bytes.
    can_be_read_only: bool = False
    #: ``eventLoop``: "uvloop" swaps the asyncio event loop
    #: for uvloop when (and only when) the package is importable —
    #: import-guarded, falls back to asyncio with a warning, byte-
    #: identical wire behavior either way (parity pinned).  None/
    #: "asyncio" = the stdlib loop, the default.
    event_loop: Optional[str] = None
    #: ``connectRaceStaggerMs``: raced happy-eyeballs connect
    #: passes — candidate k dials this many ms after candidate k-1 and
    #: the first successful read-write handshake wins (losers aborted
    #: cleanly).  None = the serial reference-exact pass.
    connect_race_stagger_ms: Optional[int] = None
    #: ``pingIntervalMs`` / ``deadAfterMs``: override the
    #: keepalive/watchdog schedule (default: ping every negotiated/3,
    #: dead after 2/3 with no frame) for sub-session-timeout failure
    #: detection.  None/None = reference-exact thirds rule.
    ping_interval_ms: Optional[int] = None
    dead_after_ms: Optional[int] = None


@dataclass
class MetricsConfig:
    port: int
    host: str = "127.0.0.1"


@dataclass
class CacheConfig:
    """The ``cache`` block: tuning for the watch-coherent
    resolve cache (:mod:`registrar_tpu_torch.zkcache`).  Consumed by ``zkcli
    serve-view -f`` (the Binder's-eye watch loop); the daemon itself
    never resolves, so its behavior is untouched — absent block =
    feature defaults, reference parity exactly preserved."""

    max_entries: int = 4096
    #: ``staleMaxAgeS`` — **seconds, not milliseconds** (the
    #: name carries the unit, like ``reconcile.intervalSeconds``):
    #: serve-stale bound for degraded mode.  While the cache's session
    #: is down it keeps answering from last-known-good entries for at
    #: most this long (RFC 8767 at the resolver path); past the bound —
    #: or on any authority restoration / terminal expiry — everything
    #: retained is flushed.  None = reference-exact flush-on-degrade;
    #: 0 = fail closed the moment authority is lost.
    stale_max_age_s: Optional[float] = None


@dataclass
class RestartConfig:
    """The ``restart`` block: zero-downtime restart behavior.

    ``mode: "handoff"`` keeps ``stateFile`` current (session id, passwd,
    negotiated timeout, znode manifest — see
    :mod:`registrar_tpu_torch.statefile`) and a SIGTERM detaches the TCP
    connection WITHOUT closing the session, so the ephemerals survive for
    the successor process to reattach; ``mode: "drain"`` unregisters
    cleanly, waits ``drainGraceSeconds``, and exits 0.  Absent block =
    the pre-existing graceful stop (close the session, ephemerals deleted
    immediately) — reference-parity-adjacent default, unchanged."""

    state_file: str
    mode: str = "handoff"
    drain_grace_s: float = 0.0


@dataclass
class OverloadConfig:
    """The ``serve.overload`` block: overload armor for the
    sharded tier.  Every knob is optional and None = that defense off;
    the whole block absent = no armor anywhere, byte-identical to
    today's behavior (reference parity — the reference registrar has no
    serve tier, let alone admission control).

    ``maxQueueDepth``: bound on resolve requests dispatched-but-
    unanswered per worker (excess fast-fails ``SHED:queue_full``).
    ``maxInflightPerConn``: bound on resolve requests in flight per
    worker connection (same shed reason, per-socket).
    ``clientRateLimit``: per-client resolves/second token bucket at the
    router's front socket (``SHED:rate_limited``).
    ``coldFillConcurrency``: bound on concurrent distinct-path cold
    fills in each worker's cache (``SHED:cold_fill_shed``; warm domains
    degrade to bounded-age stale answers instead).
    ``writeDeadlineS``: reply write deadline — a peer that stops
    reading (slow-loris / half-open) is disconnected after this many
    seconds instead of pinning its handler tasks forever."""

    max_queue_depth: Optional[int] = None
    max_inflight_per_conn: Optional[int] = None
    client_rate_limit: Optional[float] = None
    cold_fill_concurrency: Optional[int] = None
    write_deadline_s: Optional[float] = None

    def as_router_kwargs(self) -> Dict[str, Any]:
        """The dict :class:`registrar_tpu_torch.shard.ShardRouter` takes as
        ``overload=`` (spec-key spelling, Nones dropped)."""
        raw = {
            "maxQueueDepth": self.max_queue_depth,
            "maxInflightPerConn": self.max_inflight_per_conn,
            "clientRateLimit": self.client_rate_limit,
            "coldFillConcurrency": self.cold_fill_concurrency,
            "writeDeadlineS": self.write_deadline_s,
        }
        return {k: v for k, v in raw.items() if v is not None}


@dataclass
class DnsConfig:
    """The ``serve.dns`` block: the real-DNS frontend over
    the sharded tier (:mod:`registrar_tpu_torch.dnsfront`).  Presence of the
    block turns it ON: every shard worker binds one SO_REUSEPORT UDP
    socket (plus a TCP listener for TC-bit retries) on ``host:port``.
    ``port: 0`` means the router allocates a free port once at start
    (every worker must share it for the kernel fan-out).  Absent block
    = no DNS sockets anywhere, the tier's behavior untouched.

    ``udpPayloadMax``: EDNS answer-size ceiling we honor (default 1232).
    ``negativeTtl``: NXDOMAIN/NODATA SOA-minimum TTL, seconds — defaults
    to the cache's coherence bound (5 s), never believe an absence
    longer than the tier itself would.
    ``staleTtl``: how long (seconds) a front whose ZKCache lost
    authority keeps answering from pre-rendered templates (RFC 8767
    serve-stale, default 30); ``0`` fails closed — templates drop the
    moment authority is lost.
    ``maxPending`` / ``rateLimit``: the PR-17 armor mapped onto DNS —
    pending cold-resolve bound and queries/second token bucket; over
    either, the front answers REFUSED (never silence).  Warm
    encode-cache hits bypass both."""

    host: str = "127.0.0.1"
    port: int = 0
    udp_payload_max: Optional[int] = None
    negative_ttl: Optional[float] = None
    stale_ttl: Optional[float] = None
    max_pending: Optional[int] = None
    rate_limit: Optional[float] = None

    def as_spec(self) -> Dict[str, Any]:
        """The dict a worker spec carries as ``dns`` (spec-key
        spelling, Nones dropped)."""
        raw = {
            "host": self.host,
            "port": self.port,
            "udpPayloadMax": self.udp_payload_max,
            "negativeTtl": self.negative_ttl,
            "staleTtl": self.stale_ttl,
            "maxPending": self.max_pending,
            "rateLimit": self.rate_limit,
        }
        return {k: v for k, v in raw.items() if v is not None}


@dataclass
class ServeConfig:
    """The ``serve`` block: the namespace-sharded resolve
    tier (:mod:`registrar_tpu_torch.shard`), run standalone by ``zkcli
    serve-sharded -f config``.  ``shards`` worker processes each own a
    consistent-hash slice of the domain space; ``socketPath`` is the
    router's front unix socket (worker sockets are suffixed onto it);
    ``attachSpread`` is the watch-load placement hint handed to each
    worker's ZK client (``"spread"`` → worker k of n gets
    ``spread:k-of-n``; ``"follower"`` / ``"any"`` pass through);
    ``overload`` is the opt-in overload armor
    (:class:`OverloadConfig`).  The daemon itself never resolves and
    ignores the block — absent block = today's in-process behavior,
    reference parity untouched."""

    shards: int
    socket_path: str
    attach_spread: str = "spread"
    overload: Optional[OverloadConfig] = None
    dns: Optional[DnsConfig] = None


@dataclass
class ObservabilityConfig:
    """The ``observability`` block: operation tracing.

    Presence of the block turns tracing ON (spans, the flight recorder,
    latency histograms, trace-correlated log records, the SIGUSR2 dump).
    Absent block = tracing off, byte-identical log/metric output to the
    untraced daemon — reference parity exactly preserved."""

    sample_rate: float = 1.0
    #: slow-span warn threshold, ms (None = never warn).  The default
    #: sits above the registration pipeline's mandated 1 s settle floor
    #: so a healthy registration does not warn on every run.
    slow_span_ms: Optional[float] = 1500.0
    flight_recorder_spans: int = 1024
    #: SIGUSR2 dump target (None = pid-suffixed file in the temp dir)
    dump_path: Optional[str] = None


@dataclass
class ReconcileConfig:
    """The ``reconcile`` block: the level-triggered registration
    reconciler (:mod:`registrar_tpu_torch.reconcile`).  NOTE the unit
    departure: ``intervalSeconds`` is SECONDS (the name carries the
    unit), unlike the reference-derived millisecond keys."""

    interval_s: float = 60.0
    repair: bool = False


#: top-level keys the daemon understands (reference keys + extensions);
#: anything else is reported in Config.unknown_keys so the mainline can
#: warn about probable typos ("healthcheck" vs "healthCheck") without
#: breaking the reference's ignore-unknown-keys behavior.
KNOWN_TOP_LEVEL_KEYS = frozenset(
    {
        "adminIp", "zookeeper", "registration", "healthCheck", "logLevel",
        "maxAttempts", "repairHeartbeatMiss", "metrics",
        "surviveSessionExpiry", "maxSessionRebirths", "reconcile", "cache",
        "restart", "observability", "serve",
    }
)


@dataclass
class Config:
    zookeeper: ZookeeperConfig
    registration: Dict[str, Any]
    admin_ip: Optional[str] = None
    health_check: Optional[Dict[str, Any]] = None  # seconds-based kwargs
    log_level: Optional[str] = None
    heartbeat_interval_s: float = 3.0
    heartbeat_retry: RetryPolicy = field(default_factory=lambda: HEARTBEAT_RETRY)
    repair_heartbeat_miss: bool = False
    metrics: Optional[MetricsConfig] = None
    #: opt-in session lifecycle supervisor: survive expiry by
    #: building a fresh session in-process instead of exit(1)
    survive_session_expiry: bool = False
    #: rebirth circuit-breaker bound (None = client default, 5 / 5 min)
    max_session_rebirths: Optional[int] = None
    #: opt-in level-triggered reconciler
    reconcile: Optional[ReconcileConfig] = None
    #: resolve-cache tuning for zkcli serve-view (None = defaults)
    cache: Optional[CacheConfig] = None
    #: opt-in zero-downtime restart behavior (None = today's
    #: graceful stop: close the session, ephemerals deleted at once)
    restart: Optional[RestartConfig] = None
    #: opt-in operation tracing (None = no spans, no flight
    #: recorder, no trace-correlated log fields — reference parity)
    observability: Optional[ObservabilityConfig] = None
    #: opt-in namespace-sharded resolve tier for zkcli serve-sharded
    #: (None = no tier — the daemon ignores it either way)
    serve: Optional[ServeConfig] = None
    #: unrecognized top-level keys (ignored, like the reference — but
    #: surfaced so the daemon can warn about probable typos)
    unknown_keys: Tuple[str, ...] = ()
    #: the file this config was loaded from (None when parsed from a
    #: dict) — the SIGHUP reload re-reads it
    source_path: Optional[str] = None


def parse_config(raw: Mapping[str, Any]) -> Config:
    if not isinstance(raw, Mapping):
        raise ConfigError("config must be a JSON object")

    zk_raw = raw.get("zookeeper")
    if not isinstance(zk_raw, Mapping):
        raise ConfigError("config.zookeeper must be an object")
    servers_raw = zk_raw.get("servers")
    if not isinstance(servers_raw, list) or not servers_raw:
        raise ConfigError("config.zookeeper.servers must be a non-empty array")
    servers: List[Tuple[str, int]] = []
    for i, s in enumerate(servers_raw):
        if (
            not isinstance(s, Mapping)
            or not isinstance(s.get("host"), str)
            or not isinstance(s.get("port"), int)
            or isinstance(s.get("port"), bool)
        ):
            raise ConfigError(
                f"config.zookeeper.servers[{i}] must be {{host, port}}"
            )
        servers.append((s["host"], s["port"]))
    chroot = zk_raw.get("chroot")
    if chroot is not None:
        # Same validation ZKClient applies at startup (zk.protocol
        # check_path), so the -n pre-flight and the daemon agree on what
        # is acceptable.
        from registrar_tpu_torch.zk.protocol import check_path

        if not isinstance(chroot, str):
            raise ConfigError(
                "config.zookeeper.chroot must be an absolute znode path"
            )
        try:
            check_path(chroot)
        except ValueError as e:
            raise ConfigError(f"config.zookeeper.chroot: {e}") from e
        if chroot == "/":
            chroot = None
    can_be_read_only = zk_raw.get("canBeReadOnly", False)
    if not isinstance(can_be_read_only, bool):
        raise ConfigError("config.zookeeper.canBeReadOnly must be a boolean")
    event_loop = zk_raw.get("eventLoop")
    if event_loop is not None and event_loop not in ("asyncio", "uvloop"):
        raise ConfigError(
            'config.zookeeper.eventLoop must be "asyncio" or "uvloop"'
        )
    zookeeper = ZookeeperConfig(
        servers=servers,
        timeout_ms=_ms(zk_raw, "timeout", 30000),
        connect_timeout_ms=_ms(zk_raw, "connectTimeout", 4000),
        chroot=chroot,
        request_timeout_ms=_optional_ms(zk_raw, "requestTimeout"),
        can_be_read_only=can_be_read_only,
        event_loop=event_loop,
        connect_race_stagger_ms=_optional_ms(zk_raw, "connectRaceStaggerMs"),
        ping_interval_ms=_optional_ms(zk_raw, "pingIntervalMs"),
        dead_after_ms=_optional_ms(zk_raw, "deadAfterMs"),
    )

    registration = raw.get("registration")
    if not isinstance(registration, Mapping):
        raise ConfigError("config.registration must be an object")
    registration = dict(registration)

    # Back-compat shim: top-level adminIp hoisted into the registration
    # (reference main.js:146-147).
    admin_ip = registration.get("adminIp") or raw.get("adminIp")
    if admin_ip is not None and not isinstance(admin_ip, str):
        raise ConfigError("config.adminIp must be a string")

    heartbeat_interval_s = (
        _ms(registration, "heartbeatInterval", 3000) / 1000.0
    )
    registration.pop("heartbeatInterval", None)
    registration.pop("adminIp", None)

    health_check = None
    hc_raw = raw.get("healthCheck")
    if hc_raw is not None:
        if not isinstance(hc_raw, Mapping):
            raise ConfigError("config.healthCheck must be an object")
        if not isinstance(hc_raw.get("command"), str) or not hc_raw["command"]:
            raise ConfigError("config.healthCheck.command must be a string")
        threshold = hc_raw.get("threshold", 5)
        if (
            not isinstance(threshold, int)
            or isinstance(threshold, bool)
            or threshold < 1
        ):
            # Validated here (not only in HealthCheck.__init__) so a typo
            # like "threshold": "5" fails the -n pre-flight with EX_CONFIG
            # instead of killing the health consumer task at runtime.
            raise ConfigError(
                "config.healthCheck.threshold must be a positive integer"
            )
        health_check = {
            "command": hc_raw["command"],
            "interval": _ms(hc_raw, "interval", 60000) / 1000.0,
            "timeout": _ms(hc_raw, "timeout", 1000) / 1000.0,
            "period": _ms(hc_raw, "period", 300000) / 1000.0,
            "threshold": threshold,
            "ignore_exit_status": bool(hc_raw.get("ignoreExitStatus", False)),
        }
        if hc_raw.get("stdoutMatch") is not None:
            sm = hc_raw["stdoutMatch"]
            # Validate with the exact code the checker runs (pattern
            # compiles, flags supported, shape right), so a config that
            # passes -n can never throw when the daemon builds the checker.
            from registrar_tpu_torch.health import _compile_stdout_match

            if (
                not isinstance(sm, Mapping)
                or not isinstance(sm.get("pattern"), str)
                or not sm["pattern"]  # "" would silently disable matching
            ):
                raise ConfigError(
                    "config.healthCheck.stdoutMatch must be "
                    "{pattern, flags?, invert?} with a non-empty pattern"
                )
            if "invert" in sm and not isinstance(sm["invert"], bool):
                # "false" (a string) is truthy — it would silently flip
                # the match and declare a healthy service down
                raise ConfigError(
                    "config.healthCheck.stdoutMatch.invert must be a boolean"
                )
            if "flags" in sm and not isinstance(sm["flags"], str):
                raise ConfigError(
                    "config.healthCheck.stdoutMatch.flags must be a string"
                )
            try:
                _compile_stdout_match(sm)
            except (ValueError, TypeError, re.error) as e:
                raise ConfigError(
                    f"config.healthCheck.stdoutMatch: {e}"
                ) from e
            health_check["stdout_match"] = sm

    log_level = raw.get("logLevel")
    if log_level is not None and not isinstance(log_level, str):
        raise ConfigError("config.logLevel must be a string")

    max_attempts = raw.get("maxAttempts")
    if max_attempts is not None and (
        not isinstance(max_attempts, int)
        or isinstance(max_attempts, bool)
        or max_attempts < 1
    ):
        raise ConfigError("config.maxAttempts must be a positive integer")
    heartbeat_retry = (
        RetryPolicy(
            max_attempts=max_attempts,
            initial_delay=HEARTBEAT_RETRY.initial_delay,
            max_delay=HEARTBEAT_RETRY.max_delay,
        )
        if max_attempts is not None
        else HEARTBEAT_RETRY
    )

    repair = raw.get("repairHeartbeatMiss", False)
    if not isinstance(repair, bool):
        raise ConfigError("config.repairHeartbeatMiss must be a boolean")

    survive = raw.get("surviveSessionExpiry", False)
    if not isinstance(survive, bool):
        raise ConfigError("config.surviveSessionExpiry must be a boolean")

    max_rebirths = raw.get("maxSessionRebirths")
    if max_rebirths is not None and (
        not isinstance(max_rebirths, int)
        or isinstance(max_rebirths, bool)
        or max_rebirths < 1
    ):
        raise ConfigError("config.maxSessionRebirths must be a positive integer")

    reconcile = None
    rec_raw = raw.get("reconcile")
    if rec_raw is not None:
        if not isinstance(rec_raw, Mapping):
            raise ConfigError("config.reconcile must be an object")
        interval = rec_raw.get("intervalSeconds", 60)
        if (
            not isinstance(interval, (int, float))
            or isinstance(interval, bool)
            or not math.isfinite(interval)
            or interval <= 0
        ):
            raise ConfigError(
                "config.reconcile.intervalSeconds must be a positive "
                "number (seconds)"
            )
        rec_repair = rec_raw.get("repair", False)
        if not isinstance(rec_repair, bool):
            raise ConfigError("config.reconcile.repair must be a boolean")
        reconcile = ReconcileConfig(
            interval_s=float(interval), repair=rec_repair
        )

    cache = None
    cache_raw = raw.get("cache")
    if cache_raw is not None:
        if not isinstance(cache_raw, Mapping):
            raise ConfigError("config.cache must be an object")
        max_entries = cache_raw.get("maxEntries", 4096)
        if (
            not isinstance(max_entries, int)
            or isinstance(max_entries, bool)
            or max_entries < 1
        ):
            raise ConfigError(
                "config.cache.maxEntries must be a positive integer"
            )
        stale_max_age = cache_raw.get("staleMaxAgeS")
        if stale_max_age is not None and (
            not isinstance(stale_max_age, (int, float))
            or isinstance(stale_max_age, bool)
            or not math.isfinite(stale_max_age)
            or stale_max_age < 0
        ):
            raise ConfigError(
                "config.cache.staleMaxAgeS must be a non-negative number "
                "of seconds"
            )
        cache = CacheConfig(
            max_entries=max_entries,
            stale_max_age_s=(
                None if stale_max_age is None else float(stale_max_age)
            ),
        )

    restart = None
    restart_raw = raw.get("restart")
    if restart_raw is not None:
        if not isinstance(restart_raw, Mapping):
            raise ConfigError("config.restart must be an object")
        state_file = restart_raw.get("stateFile")
        if not isinstance(state_file, str) or not state_file:
            raise ConfigError(
                "config.restart.stateFile must be a non-empty path"
            )
        mode = restart_raw.get("mode", "handoff")
        if mode not in ("handoff", "drain"):
            raise ConfigError(
                'config.restart.mode must be "handoff" or "drain"'
            )
        grace = restart_raw.get("drainGraceSeconds", 0)
        if (
            not isinstance(grace, (int, float))
            or isinstance(grace, bool)
            or not math.isfinite(grace)
            or grace < 0
        ):
            raise ConfigError(
                "config.restart.drainGraceSeconds must be a non-negative "
                "number (seconds)"
            )
        restart = RestartConfig(
            state_file=state_file, mode=mode, drain_grace_s=float(grace)
        )

    observability = None
    obs_raw = raw.get("observability")
    if obs_raw is not None:
        if not isinstance(obs_raw, Mapping):
            raise ConfigError("config.observability must be an object")
        sample_rate = obs_raw.get("sampleRate", 1.0)
        if (
            not isinstance(sample_rate, (int, float))
            or isinstance(sample_rate, bool)
            or not math.isfinite(sample_rate)
            or not 0.0 <= sample_rate <= 1.0
        ):
            raise ConfigError(
                "config.observability.sampleRate must be a number in [0, 1]"
            )
        slow_span = obs_raw.get("slowSpanMs", 1500)
        if slow_span is not None and (
            not isinstance(slow_span, (int, float))
            or isinstance(slow_span, bool)
            or not math.isfinite(slow_span)
            or slow_span <= 0
        ):
            raise ConfigError(
                "config.observability.slowSpanMs must be a positive number "
                "(ms) or null to disable slow-span warnings"
            )
        recorder_spans = obs_raw.get("flightRecorderSpans", 1024)
        if (
            not isinstance(recorder_spans, int)
            or isinstance(recorder_spans, bool)
            or recorder_spans < 1
        ):
            raise ConfigError(
                "config.observability.flightRecorderSpans must be a "
                "positive integer"
            )
        dump_path = obs_raw.get("dumpPath")
        if dump_path is not None and (
            not isinstance(dump_path, str) or not dump_path
        ):
            raise ConfigError(
                "config.observability.dumpPath must be a non-empty path"
            )
        observability = ObservabilityConfig(
            sample_rate=float(sample_rate),
            slow_span_ms=float(slow_span) if slow_span is not None else None,
            flight_recorder_spans=recorder_spans,
            dump_path=dump_path,
        )

    serve = None
    serve_raw = raw.get("serve")
    if serve_raw is not None:
        if not isinstance(serve_raw, Mapping):
            raise ConfigError("config.serve must be an object")
        shards = serve_raw.get("shards")
        if (
            not isinstance(shards, int)
            or isinstance(shards, bool)
            or shards < 1
        ):
            raise ConfigError(
                "config.serve.shards must be a positive integer"
            )
        socket_path = serve_raw.get("socketPath")
        if not isinstance(socket_path, str) or not socket_path:
            raise ConfigError(
                "config.serve.socketPath must be a non-empty path"
            )
        attach_spread = serve_raw.get("attachSpread", "spread")
        if attach_spread not in ("any", "follower", "spread"):
            raise ConfigError(
                'config.serve.attachSpread must be "any", "follower", '
                'or "spread"'
            )
        overload = None
        overload_raw = serve_raw.get("overload")
        if overload_raw is not None:
            if not isinstance(overload_raw, Mapping):
                raise ConfigError("config.serve.overload must be an object")

            def _overload_int(key: str, value) -> Optional[int]:
                if value is None:
                    return None
                if (
                    not isinstance(value, int)
                    or isinstance(value, bool)
                    or value < 1
                ):
                    raise ConfigError(
                        f"config.serve.overload.{key} must be a "
                        "positive integer"
                    )
                return value

            def _overload_num(key: str, value) -> Optional[float]:
                if value is None:
                    return None
                if (
                    not isinstance(value, (int, float))
                    or isinstance(value, bool)
                    or value <= 0
                ):
                    raise ConfigError(
                        f"config.serve.overload.{key} must be a "
                        "positive number"
                    )
                return float(value)

            overload = OverloadConfig(
                max_queue_depth=_overload_int(
                    "maxQueueDepth", overload_raw.get("maxQueueDepth")
                ),
                max_inflight_per_conn=_overload_int(
                    "maxInflightPerConn",
                    overload_raw.get("maxInflightPerConn"),
                ),
                client_rate_limit=_overload_num(
                    "clientRateLimit", overload_raw.get("clientRateLimit")
                ),
                cold_fill_concurrency=_overload_int(
                    "coldFillConcurrency",
                    overload_raw.get("coldFillConcurrency"),
                ),
                write_deadline_s=_overload_num(
                    "writeDeadlineS", overload_raw.get("writeDeadlineS")
                ),
            )
        dns = None
        dns_raw = serve_raw.get("dns")
        if dns_raw is not None:
            if not isinstance(dns_raw, Mapping):
                raise ConfigError("config.serve.dns must be an object")
            dns_host = dns_raw.get("host", "127.0.0.1")
            if not isinstance(dns_host, str) or not dns_host:
                raise ConfigError("config.serve.dns.host must be a string")
            dns_port = dns_raw.get("port", 0)
            if (
                not isinstance(dns_port, int)
                or isinstance(dns_port, bool)
                or not 0 <= dns_port < 65536
            ):
                raise ConfigError(
                    "config.serve.dns.port must be a port number "
                    "(0 = allocate at start)"
                )

            def _dns_int(key: str, value) -> Optional[int]:
                if value is None:
                    return None
                if (
                    not isinstance(value, int)
                    or isinstance(value, bool)
                    or value < 1
                ):
                    raise ConfigError(
                        f"config.serve.dns.{key} must be a positive integer"
                    )
                return value

            def _dns_num(key: str, value) -> Optional[float]:
                if value is None:
                    return None
                if (
                    not isinstance(value, (int, float))
                    or isinstance(value, bool)
                    or value <= 0
                ):
                    raise ConfigError(
                        f"config.serve.dns.{key} must be a positive number"
                    )
                return float(value)

            udp_payload_max = _dns_int(
                "udpPayloadMax", dns_raw.get("udpPayloadMax")
            )
            if udp_payload_max is not None and udp_payload_max < 512:
                raise ConfigError(
                    "config.serve.dns.udpPayloadMax must be >= 512 "
                    "(the pre-EDNS UDP ceiling)"
                )
            stale_ttl = dns_raw.get("staleTtl")
            if stale_ttl is not None:
                # Unlike the other dns numbers, 0 is meaningful here:
                # "no serve-stale window, fail closed on authority loss".
                if (
                    not isinstance(stale_ttl, (int, float))
                    or isinstance(stale_ttl, bool)
                    or stale_ttl < 0
                ):
                    raise ConfigError(
                        "config.serve.dns.staleTtl must be a "
                        "non-negative number"
                    )
                stale_ttl = float(stale_ttl)
            dns = DnsConfig(
                host=dns_host,
                port=dns_port,
                udp_payload_max=udp_payload_max,
                negative_ttl=_dns_num(
                    "negativeTtl", dns_raw.get("negativeTtl")
                ),
                stale_ttl=stale_ttl,
                max_pending=_dns_int("maxPending", dns_raw.get("maxPending")),
                rate_limit=_dns_num("rateLimit", dns_raw.get("rateLimit")),
            )
        serve = ServeConfig(
            shards=shards,
            socket_path=socket_path,
            attach_spread=attach_spread,
            overload=overload,
            dns=dns,
        )

    metrics = None
    metrics_raw = raw.get("metrics")
    if metrics_raw is not None:
        if not isinstance(metrics_raw, Mapping):
            raise ConfigError("config.metrics must be an object")
        port = metrics_raw.get("port")
        if (
            not isinstance(port, int)
            or isinstance(port, bool)
            or not 0 < port < 65536
        ):
            raise ConfigError("config.metrics.port must be a port number")
        host = metrics_raw.get("host", "127.0.0.1")
        if not isinstance(host, str) or not host:
            raise ConfigError("config.metrics.host must be a string")
        metrics = MetricsConfig(port=port, host=host)

    return Config(
        zookeeper=zookeeper,
        registration=registration,
        admin_ip=admin_ip,
        health_check=health_check,
        log_level=log_level,
        heartbeat_interval_s=heartbeat_interval_s,
        heartbeat_retry=heartbeat_retry,
        repair_heartbeat_miss=repair,
        metrics=metrics,
        survive_session_expiry=survive,
        max_session_rebirths=max_rebirths,
        reconcile=reconcile,
        cache=cache,
        restart=restart,
        observability=observability,
        serve=serve,
        unknown_keys=tuple(
            sorted(set(raw) - KNOWN_TOP_LEVEL_KEYS)
        ),
    )


def load_config(path: str) -> Config:
    """Read + parse the JSON config at ``path`` (reference main.js:57-62)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
    except OSError as e:
        raise ConfigUnreadableError(
            f"unable to read configuration {path}: {e}"
        ) from e
    except json.JSONDecodeError as e:
        raise ConfigError(f"unable to parse configuration {path}: {e}") from e
    cfg = parse_config(raw)
    cfg.source_path = path
    return cfg


def _optional_ms(obj: Mapping[str, Any], key: str) -> Optional[int]:
    """:func:`_ms` for keys with no default at all: absent (or JSON null)
    means the feature is off, never a fallback number."""
    if obj.get(key) is None:
        return None
    return _ms(obj, key, obj[key])  # default unreachable: key is present


def _ms(obj: Mapping[str, Any], key: str, default: int) -> int:
    value = obj.get(key, default)
    if (
        not isinstance(value, (int, float))
        or isinstance(value, bool)
        or not math.isfinite(value)
        or value <= 0
    ):
        raise ConfigError(f"config {key} must be a positive number (ms)")
    return int(value)
