"""Availability-SLO fleet simulator: measure the nines, not just convergence.

Every robustness layer in this tree (netem toxics, session rebirth,
handoff restarts, reconcile repair) is proven by *eventual convergence*
tests; an operator's question is "how many nines, and how fast do we
recover per fault class?"  This module turns the accumulated fault machinery into a measured availability
envelope:

  * **Fleet** — N in-process registrars (the tests/test_soak.py fleet
    shape: one :class:`~registrar_tpu_torch.zk.client.ZKClient` per member
    against one :class:`~registrar_tpu_torch.testing.server.ZKServer`, or —
    ``ensemble=`` > 1 — a quorum
    :class:`~registrar_tpu_torch.testing.server.ZKEnsemble` with real leader
    elections), each member connected through its own per-backend
    :class:`~registrar_tpu_torch.testing.netem.ChaosProxy` so member network
    faults and ensemble faults compose.
  * **Prober** — a continuously-polling resolver samples the Binder
    answer at a fixed cadence over BOTH read paths: live
    (:func:`registrar_tpu_torch.binderview.resolve` against a direct client)
    and cached (through :class:`~registrar_tpu_torch.zkcache.ZKCache`).  A
    probe is **ok** iff the live answer carries every member of the
    fleet; the cached answer is additionally compared against the live
    one to count **stale** serves.  Each probe runs inside an
    ``slo.probe`` span carrying the active scenario/fault marks
    (:func:`registrar_tpu_torch.trace.annotate`), so a failing probe's trace
    id points straight into the flight recorder.
  * **Scenarios** — seeded, named churn traces keyed to the
    docs/FAULTS.md fault-class catalog (``id:`` rows; checklib's
    ``fault-id-drift`` rule diffs the two): deploy waves (drain +
    re-register), crash loops (session force-expired with a
    SIGKILL-shaped stale handoff state — the successor's seeded resume
    is refused and it registers fresh), health-check flaps, expiry
    storms, and per-member netem blackhole episodes long enough to
    expire the session.
  * **SLO math** — pure functions over the probe timeline (no fleet
    needed; unit-tested in tests/test_slo.py): availability and nines,
    outage-window extraction and merging (overlapping faults never
    double-count downtime), and per-fault MTTD/MTTR attribution keyed
    to the injection timestamps.

The runner is :func:`run_trace`: it drives a named trace end to end and
returns the SLO report (availability, nines, per-fault MTTD/MTTR).

Metrics: :func:`registrar_tpu_torch.metrics.instrument_slo` exposes
``registrar_slo_probe_total{result}`` and
``registrar_slo_outage_seconds_total{fault}`` from the harness's event
surface (``probe`` per sample, ``outage`` per attributed window).
"""

from __future__ import annotations

import asyncio
import logging
import math
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

from registrar_tpu_torch import binderview, traceview
from registrar_tpu_torch import metrics as metrics_mod
from registrar_tpu_torch import trace as trace_mod
from registrar_tpu_torch.events import EventEmitter, spawn_owned
from registrar_tpu_torch.registration import register, unregister
from registrar_tpu_torch.retry import RetryPolicy
from registrar_tpu_torch.testing.netem import DOWN, UP, Blackhole, ChaosProxy, proxy_fleet
from registrar_tpu_torch.testing.server import ZKEnsemble, ZKServer
from registrar_tpu_torch.zk.client import SessionExpiredError, ZKClient
from registrar_tpu_torch.zkcache import ZKCache

log = logging.getLogger("registrar_tpu_torch.testing.slo")

#: The fault-class catalog (docs/FAULTS.md "Fault classes", the ``id:``
#: column).  Every scenario injects through :meth:`SLOHarness.inject`
#: with one of these literals; checklib's ``fault-id-drift`` rule diffs
#: the injection sites against the doc table in both directions.
FAULT_IDS = (
    "deploy-wave",
    "crash-loop",
    "health-flap",
    "expiry-storm",
    "netem-episode",
    # ensemble fault classes (need ensemble= > 1)
    "leader-kill",
    "quorum-loss",
    "rolling-upgrade",
    "partition-minority",
    # sharded serve tier fault classes (need shards= > 0)
    "shard-kill",
    "reshard-wave",
    # overload armor (need shards= > 0)
    "overload-storm",
)

#: nines(1.0) would be infinite; the cap keeps a flawless short trace
#: reportable (and honest: a 5 s trace cannot demonstrate nine nines).
MAX_NINES = 9.0


# ---------------------------------------------------------------------------
# SLO math: pure functions over probe timelines (unit-tested, no fleet)
# ---------------------------------------------------------------------------


class Probe:
    """One availability sample: ``t`` (harness clock, seconds), ``ok``
    (the live answer carried the full fleet), ``missing`` (how many
    members the answer lacked), and the probe span's ``trace_id`` (the
    flight-recorder pointer for a failing sample)."""

    __slots__ = ("t", "ok", "missing", "trace_id")

    def __init__(
        self,
        t: float,
        ok: bool,
        missing: int = 0,
        trace_id: Optional[str] = None,
    ):
        self.t = t
        self.ok = ok
        self.missing = missing
        self.trace_id = trace_id

    def __repr__(self) -> str:
        state = "ok" if self.ok else f"fail(-{self.missing})"
        return f"Probe({self.t:.3f}, {state})"


class FaultEvent:
    """One injected fault: identity (catalog ``fault`` id + member),
    its injection/clear stamps, and the probe-derived verdicts filled in
    by :func:`attribute` — ``detected_at`` (first failing probe at or
    after injection) and ``recovered_at`` (first ok probe after
    detection).  MTTD/MTTR are both measured **from injection**, the
    operator's clock."""

    __slots__ = (
        "fault", "member", "injected_at", "cleared_at",
        "detected_at", "recovered_at",
    )

    def __init__(self, fault: str, member: Optional[int], injected_at: float):
        self.fault = fault
        self.member = member
        self.injected_at = injected_at
        self.cleared_at: Optional[float] = None
        self.detected_at: Optional[float] = None
        self.recovered_at: Optional[float] = None

    @property
    def mttd_s(self) -> Optional[float]:
        if self.detected_at is None:
            return None
        return self.detected_at - self.injected_at

    @property
    def mttr_s(self) -> Optional[float]:
        if self.recovered_at is None:
            return None
        return self.recovered_at - self.injected_at

    def __repr__(self) -> str:
        return (
            f"FaultEvent({self.fault!r}, member={self.member}, "
            f"injected_at={self.injected_at:.3f})"
        )


def availability(probes: Sequence[Probe]) -> float:
    """Fraction of ok probes.  Raises on an empty timeline — a prober
    that never sampled must read as a broken run, not as 100%."""
    if not probes:
        raise ValueError("no probes: availability is unmeasured, not 1.0")
    ok = sum(1 for p in probes if p.ok)
    return ok / len(probes)


def nines(avail: float) -> float:
    """Availability as "nines": 0.999 -> 3.0, capped at MAX_NINES."""
    if not 0.0 <= avail <= 1.0:
        raise ValueError("availability must be within [0, 1]")
    if avail >= 1.0:
        return MAX_NINES
    return min(max(0.0, round(-math.log10(1.0 - avail), 3)), MAX_NINES)


def outage_windows(
    probes: Sequence[Probe], end: Optional[float] = None
) -> List[Tuple[float, float]]:
    """Half-open ``(start, end)`` windows where the probe stream saw
    failure: a window opens at the first failing probe and closes at
    the next ok probe.  A trailing failure closes at ``end`` (default:
    the last probe's stamp) — an unrecovered outage still has a
    measurable duration."""
    windows: List[Tuple[float, float]] = []
    start = None
    for p in probes:
        if not p.ok and start is None:
            start = p.t
        elif p.ok and start is not None:
            windows.append((start, p.t))
            start = None
    if start is not None:
        close = end if end is not None else probes[-1].t
        windows.append((start, max(close, start)))
    return windows


def merge_windows(
    windows: Sequence[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """Sort and coalesce overlapping/adjacent windows, so downtime from
    overlapping fault classes is counted once."""
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(windows):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def total_outage_s(windows: Sequence[Tuple[float, float]]) -> float:
    return sum(end - start for start, end in merge_windows(windows))


def attribute(
    faults: Sequence[FaultEvent], probes: Sequence[Probe]
) -> None:
    """Fill ``detected_at``/``recovered_at`` on every fault event from
    the probe timeline.

    Detection is the first failing probe at or after the injection —
    bounded at ``cleared_at`` when the fault was cleared: a fault whose
    whole outage fell between two probe ticks is reported *undetected*
    (shorter than the cadence can observe), never credited with a later
    unrelated scenario's failure.  Recovery is the first ok probe after
    detection.  When two faults overlap, each still gets its own
    MTTD/MTTR measured from its own injection stamp — the later fault
    "detects" immediately (the outage is already observable) and both
    recover at the same ok probe; only the merged-window *downtime* is
    deduplicated (see :func:`window_owner`)."""
    for fault in faults:
        horizon = (
            fault.cleared_at if fault.cleared_at is not None else math.inf
        )
        fault.detected_at = next(
            (
                p.t
                for p in probes
                if fault.injected_at <= p.t <= horizon and not p.ok
            ),
            None,
        )
        if fault.detected_at is not None:
            fault.recovered_at = next(
                (p.t for p in probes if p.t > fault.detected_at and p.ok),
                None,
            )


def window_owner(
    window: Tuple[float, float], faults: Sequence[FaultEvent]
) -> Optional[FaultEvent]:
    """The fault that OWNS a merged outage window: the earliest-injected
    fault whose detection..recovery interval overlaps it.  One window,
    one owner — overlapping fault classes never double-count downtime
    (``registrar_slo_outage_seconds_total`` sums to the merged total)."""
    start, end = window
    owner = None
    for fault in faults:
        if fault.detected_at is None:
            continue
        recovered = (
            fault.recovered_at if fault.recovered_at is not None else end
        )
        if fault.detected_at < end and recovered > start:
            if owner is None or fault.injected_at < owner.injected_at:
                owner = fault
    return owner


def _round_stats(values: List[float]) -> Dict[str, Optional[float]]:
    if not values:
        return {"mean": None, "max": None}
    return {
        "mean": round(sum(values) / len(values), 4),
        "max": round(max(values), 4),
    }


def fault_summary(
    faults: Sequence[FaultEvent],
    probes: Sequence[Probe],
    end: Optional[float] = None,
) -> Tuple[Dict[str, Dict[str, Any]], List[Tuple[float, float]]]:
    """Per-fault-class rollup + the merged outage windows.

    Each class reports its injected/detected counts, MTTD/MTTR mean and
    max (seconds, from injection), and the downtime attributed to the
    windows it owns.  Calls :func:`attribute` on the way."""
    attribute(faults, probes)
    windows = merge_windows(outage_windows(probes, end))
    per: Dict[str, Dict[str, Any]] = {}
    mttds: Dict[str, List[float]] = {}
    mttrs: Dict[str, List[float]] = {}
    for fault in faults:
        entry = per.setdefault(
            fault.fault,
            {"injected": 0, "detected": 0, "outage_s": 0.0},
        )
        entry["injected"] += 1
        if fault.detected_at is not None:
            entry["detected"] += 1
            mttds.setdefault(fault.fault, []).append(fault.mttd_s)
            if fault.mttr_s is not None:
                mttrs.setdefault(fault.fault, []).append(fault.mttr_s)
    for window in windows:
        owner = window_owner(window, faults)
        if owner is not None:
            per[owner.fault]["outage_s"] = round(
                per[owner.fault]["outage_s"] + (window[1] - window[0]), 4
            )
    for fid, entry in per.items():
        stats = _round_stats(mttds.get(fid, []))
        entry["mttd_s_mean"], entry["mttd_s_max"] = stats["mean"], stats["max"]
        stats = _round_stats(mttrs.get(fid, []))
        entry["mttr_s_mean"], entry["mttr_s_max"] = stats["mean"], stats["max"]
    return per, windows


# ---------------------------------------------------------------------------
# The fleet harness
# ---------------------------------------------------------------------------

#: members reconnect fast: the harness measures recovery, and the
#: production-shaped 1-90 s envelope would make every scenario read as
#: its backoff, not its detection bound
_MEMBER_RECONNECT = RetryPolicy(
    max_attempts=float("inf"), initial_delay=0.05, max_delay=0.4,
    jitter="decorrelated",
)

#: lever recovery tuning (``levers=True``): with raced connects and
#: the tightened ping schedule doing the detection, the residual
#: reconnect backoff IS the recovery latency — a 10-60 ms decorrelated
#: envelope keeps retry pressure bounded without letting the backoff
#: dominate any MTTR row.
_LEVER_RECONNECT = RetryPolicy(
    max_attempts=float("inf"), initial_delay=0.01, max_delay=0.06,
    jitter="decorrelated",
)

#: registration retry for members (re)registering under harness faults:
#: transient failures (CONNECTION_LOSS through a healing proxy, a
#: NOT_READONLY from a minority member, an election-window drop) are the
#: thing being measured — the member must keep trying through them, at
#: harness cadence rather than the production 1-90 s envelope
_REGISTER_RETRY = RetryPolicy(
    max_attempts=80, initial_delay=0.05, max_delay=0.3,
    jitter="decorrelated",
)

#: the levered registration retry.  A (re)registration that
#: collides with an election window fails once and then sleeps the
#: backoff — with a 40 ms election, a 50-300 ms draw IS the leader-kill
#: MTTR row, so the levers pull the envelope down to election scale.
_LEVER_REGISTER_RETRY = RetryPolicy(
    max_attempts=200, initial_delay=0.01, max_delay=0.05,
    jitter="decorrelated",
)


class _Member:
    """One fleet member: its proxies (one per ensemble member — a single
    list entry against a standalone server), client, and registration."""

    __slots__ = ("idx", "hostname", "admin_ip", "proxies", "client", "znodes")

    def __init__(self, idx: int, hostname: str, admin_ip: str):
        self.idx = idx
        self.hostname = hostname
        self.admin_ip = admin_ip
        self.proxies: List[ChaosProxy] = []
        self.client: Optional[ZKClient] = None
        self.znodes: List[str] = []

    @property
    def proxy(self) -> Optional[ChaosProxy]:
        return self.proxies[0] if self.proxies else None


class SLOHarness(EventEmitter):
    """Seeded fleet + prober + fault injection (module docstring).

    Events: ``probe(result)`` per sample (``"ok"``/``"fail"``) and
    ``outage(fault, seconds)`` per attributed window at report time —
    :func:`registrar_tpu_torch.metrics.instrument_slo` turns these into the
    ``registrar_slo_*`` counters.

    ``repair=False`` injects every fault but withholds the recovery
    actions (no member ever restarts or re-registers) — the
    deliberately broken run that proves the probe
    actually detects outages (a measurable nines drop).
    """

    def __init__(
        self,
        members: int = 5,
        seed: int = 0,
        probe_interval: float = 0.02,
        session_timeout_ms: int = 800,
        repair: bool = True,
        domain: str = "slo.fleet.us",
        tracer: Optional[trace_mod.Tracer] = None,
        ensemble: int = 1,
        election_ms: float = 150.0,
        shards: int = 0,
        levers: bool = False,
    ):
        """``ensemble``: > 1 runs the fleet against an
        N-member :class:`ZKEnsemble` with a real leader/quorum protocol
        — each fleet member fronts every ensemble member with its own
        ChaosProxy, clients are ``can_be_read_only`` with seeded connect
        order, and the ensemble fault classes (leader-kill, quorum-loss,
        rolling-upgrade, partition-minority) become injectable.
        ``election_ms`` sizes the leader-election window the failover
        MTTR must ride through.

        ``shards``: > 0 additionally runs a sharded serve
        tier (:class:`registrar_tpu_torch.shard.ShardRouter` + worker
        processes) against the same backends and gives the prober a
        third leg: a set of static **slice-probe domains** chosen to
        cover every shard's slice is polled through the tier each
        sample, so a shard's outage (and only that shard's) shows up in
        the availability math.  The shard fault classes (shard-kill,
        reshard-wave) become injectable; with ``repair=False`` the
        router's crash→respawn supervision is withheld (the recovery
        action under test).

        ``levers``: turn on the availability levers — raced connects (no serial dead-host scan on
        failover), the tightened ping/dead-after schedule (link death
        detected in ~0.1 s rather than negotiated-timeout fractions),
        stale-while-revalidate in the probe-side :class:`ZKCache`, a
        harness-scale reconnect floor, and spread watch attach across
        the ensemble.  ``False`` (the default) is reference-exact: the
        lever-free client/cache behavior, bit for bit; one seed run
        both ways shows whether the levers measurably beat it."""
        super().__init__()
        if members < 2:
            raise ValueError("a fleet needs at least 2 members")
        self.n_members = members
        self.seed = seed
        self.rng = random.Random(seed)
        self.probe_interval = probe_interval
        self.session_timeout_ms = session_timeout_ms
        self.repair = repair
        self.domain = domain
        self.n_ensemble = ensemble
        self.election_ms = election_ms
        self.levers = levers
        self.fault_ids = FAULT_IDS
        self.tracer = (
            tracer
            if tracer is not None
            else trace_mod.Tracer(sample_rate=1.0, max_spans=8192)
        )
        #: latency histograms fed from the probe spans (the tracing
        #: machinery: registrar_resolve_seconds by source) plus the
        #: registrar_slo_* counters
        self.registry = metrics_mod.instrument_tracing(self.tracer)
        metrics_mod.instrument_slo(self, self.registry)

        self.server: Optional[ZKServer] = None
        self.ensemble: Optional[ZKEnsemble] = None
        self.members: List[_Member] = []
        self.live_client: Optional[ZKClient] = None
        self.cache_client: Optional[ZKClient] = None
        self.cache: Optional[ZKCache] = None
        #: sharded serve tier (shards > 0)
        self.n_shards = shards
        self.router = None
        self.shard_client = None
        self._slice_client: Optional[ZKClient] = None
        self._shard_dir: Optional[str] = None
        #: slice-probe domain -> its single host's admin ip (the
        #: expected A answer; static, never touched by fleet scenarios)
        self.slice_expected: Dict[str, str] = {}
        #: per-slice-domain shard-leg probe failures (the sibling-
        #: never-blips assertions diff snapshots of this)
        self.slice_errors: Dict[str, int] = {}
        self.shard_probes = 0
        #: the DNS frontend leg (rides the shard tier): real
        #: UDP A queries against the workers' SO_REUSEPORT socket, one
        #: slice domain per sample round-robin, fresh source port each
        #: time so samples hash across the whole worker group
        self.dns_probes = 0
        self.dns_errors = 0
        #: the serve tier's overload armor — installed by
        #: _start_shard_tier iff repair is on; None IS the detection
        #: proof's lever (repair=False runs the same storm unarmored)
        self.shard_overload: Optional[Dict[str, Any]] = None

        self.probes: List[Probe] = []
        self.faults: List[FaultEvent] = []
        #: (fault_id, segment_start, segment_end) per scenario run
        self.segments: List[Tuple[str, float, float]] = []
        self.scenario: Optional[str] = None
        self.stale_probes = 0
        self.cached_probes = 0
        self._tasks: set = set()
        self._stop_probing = asyncio.Event()
        self._started_at: Optional[float] = None
        self._finished_at: Optional[float] = None

    # -- clock --------------------------------------------------------------

    def now(self) -> float:
        return asyncio.get_running_loop().time()

    # -- lifecycle ----------------------------------------------------------

    def _registration(self) -> Dict[str, Any]:
        return {
            "domain": self.domain,
            "type": "load_balancer",
            "service": {
                "type": "service",
                "service": {"srvce": "_http", "proto": "_tcp", "port": 80},
            },
        }

    def _zk_addresses(self) -> List[Tuple[str, int]]:
        """Every live-or-restartable backend address (the stable
        ensemble servers list, or the standalone server's)."""
        if self.ensemble is not None:
            return list(self.ensemble.addresses)
        return [self.server.address]

    def _any_server(self) -> ZKServer:
        """A live server to drive test controls (force-expiry) through —
        shared session table, so any ensemble member works."""
        if self.ensemble is not None:
            live = self.ensemble.live
            if not live:
                raise RuntimeError("no live ensemble member")
            return live[0]
        return self.server

    def _lever_kwargs(self, member: Optional[_Member] = None) -> Dict[str, Any]:
        """The client levers, or ``{}`` when ``levers`` is off
        (reference-exact: the ZKClient keys stay absent, so the connect
        path and ping schedule are bit-identical to a lever-free client).

        Members get the full set: raced connects with a 40 ms stagger,
        a 40 ms ping / 100 ms dead-after watchdog (their 200 ms lever
        sessions make the reference ~67/133 ms schedule the bound), and
        — in ensemble mode — a spread attach slot so watch load never
        piles onto one member.  Probe clients get raced connects only:
        their 8 s sessions die by TCP reset (they are unproxied), so
        the watchdog lever has nothing to detect there."""
        if not self.levers:
            return {}
        kwargs: Dict[str, Any] = {"connect_race_stagger_ms": 40}
        if member is not None:
            kwargs["ping_interval_ms"] = 40
            kwargs["dead_after_ms"] = 100
            if self.n_ensemble > 1:
                kwargs["attach_preference"] = (
                    f"spread:{member.idx % self.n_ensemble}"
                    f"-of-{self.n_ensemble}"
                )
        return kwargs

    def _reconnect_policy(self) -> RetryPolicy:
        return _LEVER_RECONNECT if self.levers else _MEMBER_RECONNECT

    def _register_retry(self) -> RetryPolicy:
        return _LEVER_REGISTER_RETRY if self.levers else _REGISTER_RETRY

    def _make_client(self, member: _Member) -> ZKClient:
        return ZKClient(
            [p.address for p in member.proxies],
            timeout_ms=self.session_timeout_ms,
            connect_timeout_ms=300,
            connect_pass_timeout_ms=self.session_timeout_ms,
            reconnect_policy=self._reconnect_policy(),
            # Ensemble mode: attach read-only during quorum loss (reads
            # keep serving; writes retry through NOT_READONLY), fail
            # over fast when a read-write member returns, and keep the
            # connect-order shuffle seed-deterministic per fleet member.
            can_be_read_only=self.ensemble is not None,
            rng=random.Random(self.rng.randrange(2**32)),
            **self._lever_kwargs(member),
        )

    def _probe_client(self) -> ZKClient:
        client = ZKClient(
            self._zk_addresses(),
            timeout_ms=8000,
            connect_timeout_ms=300,
            connect_pass_timeout_ms=2000,
            reconnect_policy=self._reconnect_policy(),
            can_be_read_only=self.ensemble is not None,
            rng=random.Random(self.rng.randrange(2**32)),
            **self._lever_kwargs(),
        )
        client.rw_probe_interval_s = 0.1
        return client

    async def start(self) -> "SLOHarness":
        if self.n_ensemble > 1:
            self.ensemble = await ZKEnsemble(
                self.n_ensemble, election_ms=self.election_ms
            ).start()
        else:
            self.server = await ZKServer().start()
        backends = self._zk_addresses()
        for i in range(self.n_members):
            member = _Member(i, f"slo{i}", f"10.9.{i // 256}.{i % 256}")
            member.proxies = await proxy_fleet(backends, rng=self.rng)
            member.client = await self._make_client(member).connect()
            member.znodes = await register(
                member.client, self._registration(),
                admin_ip=member.admin_ip, hostname=member.hostname,
                settle_delay=0,
            )
            self.members.append(member)
        self.live_client = await self._probe_client().connect()
        self.cache_client = await self._probe_client().connect()
        self.live_client.tracer = self.tracer
        # The SWR lever: through a blip the cached leg keeps
        # answering bounded-age last-known-good instead of falling to
        # live reads against the same dead link — observable in the
        # report's staleness/levers stats, deliberately NOT in
        # availability (the probe's ok verdict rides the live leg).
        self.cache = ZKCache(
            self.cache_client,
            stale_max_age_s=30.0 if self.levers else None,
        )
        self.cache.tracer = self.tracer
        if self.n_shards > 0:
            await self._start_shard_tier()
        self._started_at = self.now()
        spawn_owned(self._probe_loop(), self._tasks)
        return self

    async def _start_shard_tier(self) -> None:
        """Stand up the sharded serve tier: a router + worker
        processes against the (unproxied) backends, plus one static
        single-host slice-probe domain per shard slice — chosen off the
        deterministic ring, so every shard's slice is observable and a
        killed shard's outage is attributable to exactly its slice."""
        import os
        import tempfile

        from registrar_tpu_torch.shard import (
            HashRing, ShardClient, ShardRouter,
        )

        # Deterministic slice coverage: walk candidate names until every
        # shard owns at least one (the ring is a pure function of the
        # shard ids, so this converges the same way in every run).
        ring = HashRing(range(self.n_shards))
        chosen: List[str] = []
        covered: set = set()
        for i in range(256):
            name = f"slice{i}.shard.slo.us"
            owner = ring.owner(name)
            if owner not in covered or len(chosen) < self.n_shards + 1:
                chosen.append(name)
                covered.add(owner)
            if len(covered) == self.n_shards and len(chosen) >= (
                self.n_shards + 1
            ):
                break
        # This client OWNS the slice hosts' ephemerals, so it must
        # outlive the whole run (closing it would delete them).
        self._slice_client = await self._probe_client().connect()
        for i, name in enumerate(chosen):
            ip = f"10.8.0.{i}"
            await register(
                self._slice_client,
                {
                    "domain": name,
                    "type": "load_balancer",
                    "service": {
                        "type": "service",
                        "service": {
                            "srvce": "_http", "proto": "_tcp",
                            "port": 80,
                        },
                    },
                },
                admin_ip=ip, hostname=f"slice{i}", settle_delay=0,
            )
            self.slice_expected[name] = ip
            self.slice_errors[name] = 0
        self._shard_dir = tempfile.mkdtemp(prefix="sloshard")
        # Overload armor, repair-gated like the respawn
        # below: the armored run degrades under the storm scenario
        # (bounded queues, explicit sheds, stale answers); the
        # repair=False run faces the SAME seeded storm with every
        # defense withheld — the collapse the detection proof measures.
        # Sizing: per-conn inflight does the shedding (6 per storm
        # connection) and the global depth is the backstop, sized so
        # the router's own relay channel (the probes' path) never hits
        # it; the rate limit is far above probe cadence on purpose —
        # the storm drives workers directly, and a probe must never be
        # the client that gets limited.
        if self.repair:
            self.shard_overload = {
                # Lever mode sizes the backstop so the storm's backlog
                # sheds at the STORM's connections (per-conn inflight)
                # before the global bound starts refusing the probes'
                # own relay channel — the reference depth stays 96.
                "maxQueueDepth": 160 if self.levers else 96,
                "maxInflightPerConn": 6,
                "clientRateLimit": 1000.0,
                "coldFillConcurrency": 4,
                "writeDeadlineS": 0.4,
            }
        self.router = ShardRouter(
            self._zk_addresses(),
            self.n_shards,
            os.path.join(self._shard_dir, "resolve.sock"),
            attach_spread="spread" if self.ensemble is not None else "any",
            timeout_ms=self.session_timeout_ms,
            poll_interval_s=0.5,
            # Lever mode: crash detect + readiness poll at
            # 10 ms — the respawn MTTR's fixed overhead — instead of
            # the reference 50 ms cadence.
            supervise_interval_s=0.01 if self.levers else 0.05,
            # The DNS frontend rides the same workers: every
            # probe sample sends a REAL A query over UDP, so "the tier
            # is up" means the packet path answers, not just the unix
            # relay.  Port 0: the harness must never collide with a
            # developer's own 5300.
            dns={"host": "127.0.0.1", "port": 0},
            # Worker disconnect/degrade warnings are the simulator
            # working as intended (SLO_VERBOSE=1 restores them).
            worker_log_level=(
                None if os.environ.get("SLO_VERBOSE") == "1" else "ERROR"
            ),
            # Cross-process tracing: workers record at 100%
            # so a failing slice probe's trace id resolves to a FULL
            # tree — probe span → shard.relay → the owning worker's
            # resolve subtree — in the worst-outage report.
            worker_trace={"sampleRate": 1.0, "maxSpans": 4096},
            overload=self.shard_overload,
        )
        self.router.tracer = self.tracer
        # With repair withheld, a crashed worker stays dead — the
        # respawn IS the recovery action the detection proof disables.
        self.router.respawn_enabled = self.repair
        await self.router.start()
        self.shard_client = await ShardClient(
            self.router.socket_path
        ).connect()
        for name in self.slice_expected:
            await self.shard_client.resolve(name, "A")

    async def stop(self) -> None:
        self._stop_probing.set()
        for task in list(self._tasks):
            task.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        if self.cache is not None:
            self.cache.close()
        if self.shard_client is not None:
            await self.shard_client.close()
        if self.router is not None:
            await self.router.stop()
        if self._shard_dir is not None:
            import shutil

            shutil.rmtree(self._shard_dir, ignore_errors=True)
        for client in (
            self.live_client, self.cache_client, self._slice_client
        ):
            if client is not None and not client.closed:
                await client.close()
        for member in self.members:
            if member.client is not None and not member.client.closed:
                await member.client.close()
            for proxy in member.proxies:
                await proxy.stop()
        if self.ensemble is not None:
            await self.ensemble.stop()
        if self.server is not None:
            await self.server.stop()

    async def __aenter__(self) -> "SLOHarness":
        return await self.start()

    async def __aexit__(self, *_exc) -> None:
        await self.stop()

    # -- fault bookkeeping --------------------------------------------------

    @property
    def expected(self) -> set:
        return {m.admin_ip for m in self.members}

    def inject(self, fault: str, member: Optional[int] = None) -> FaultEvent:
        """Record (and trace) a fault-class injection.  Every scenario
        routes through here with a docs/FAULTS.md catalog literal, which
        is what the ``fault-id-drift`` rule machine-checks."""
        if fault not in self.fault_ids:
            raise ValueError(f"unknown fault class {fault!r} (FAULT_IDS)")
        event = FaultEvent(fault, member, self.now())
        self.faults.append(event)
        self.tracer.event(
            "slo.fault", fault=fault, member=member,
            scenario=self.scenario,
        )
        log.debug("inject %s member=%s at %.3f", fault, member,
                  event.injected_at)
        return event

    def clear(self, event: FaultEvent) -> None:
        event.cleared_at = self.now()

    def _active_faults(self) -> str:
        return ",".join(
            f.fault for f in self.faults if f.cleared_at is None
        )

    # -- the prober ---------------------------------------------------------

    async def _probe_loop(self) -> None:
        while not self._stop_probing.is_set():
            try:
                await self._probe_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - the prober must outlive faults
                log.exception("probe iteration failed")
            try:
                await asyncio.wait_for(
                    self._stop_probing.wait(), timeout=self.probe_interval
                )
            except asyncio.TimeoutError:
                pass

    async def _probe_once(self) -> None:
        expected = self.expected
        with trace_mod.annotate(
            scenario=self.scenario, faults=self._active_faults()
        ):
            with self.tracer.span("slo.probe") as span:
                t = self.now()
                live_set: set = set()
                try:
                    res = await binderview.resolve(
                        self.live_client, self.domain, "A"
                    )
                    live_set = {a.data for a in res.answers}
                except asyncio.CancelledError:
                    raise
                except Exception as err:  # noqa: BLE001 - a failed read IS a failed probe
                    span.set_attr("err", repr(err))
                ok = live_set == expected
                span.set_attr("result", "ok" if ok else "fail")
                try:
                    cres = await binderview.resolve(
                        self.cache, self.domain, "A"
                    )
                    self.cached_probes += 1
                    if {a.data for a in cres.answers} != live_set:
                        self.stale_probes += 1
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 - cached failure counts as stale
                    self.cached_probes += 1
                    self.stale_probes += 1
                if self.shard_client is not None:
                    # The two tier legs run concurrently: they share no
                    # state, and adding the DNS exchange's latency on
                    # top of the slice sweep's would quantize every
                    # outage window up by the serial sum.
                    shard_ok, dns_ok = await asyncio.gather(
                        self._probe_shards(), self._probe_dns(),
                    )
                    span.set_attr("shard_ok", shard_ok)
                    span.set_attr("dns_ok", dns_ok)
                    ok = ok and shard_ok and dns_ok
        self.probes.append(
            Probe(t, ok, len(expected - live_set), span.trace_id)
        )
        self.emit("probe", "ok" if ok else "fail")

    async def _probe_shards(self) -> bool:
        """The sharded-tier probe leg: every slice-probe domain must
        answer its static host through the tier.  Per-domain failures
        are counted (the sibling-never-blips assertions), and any
        failure fails the sample — a shard's slice being down IS fleet
        downtime once real DNS fronts this tier."""
        async def one(name: str, expected_ip: str) -> bool:
            try:
                res = await self.shard_client.resolve(name, "A")
                return {a.data for a in res.answers} == {expected_ip}
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - a failed read IS a failed probe
                return False

        # Concurrently — the slices are independent by construction, and
        # a sequential sweep would quantize every outage window up by
        # the whole sweep's latency.
        names = list(self.slice_expected)
        results = await asyncio.gather(
            *(one(n, self.slice_expected[n]) for n in names)
        )
        shard_ok = True
        for name, good in zip(names, results):
            if not good:
                self.slice_errors[name] += 1
                shard_ok = False
        self.shard_probes += 1
        return shard_ok

    async def _probe_dns(self) -> bool:
        """The DNS frontend probe leg: one real UDP A query
        per sample against the workers' shared SO_REUSEPORT socket,
        round-robin over the slice domains.  A fresh source port each
        sample means the kernel's 4-tuple hash spreads samples across
        the whole worker group over time, so no single worker's DNS
        path can rot unobserved.  The answer must be NOERROR with the
        slice's static host — a REFUSED shed, a timeout, or a wrong
        answer IS fleet downtime: this leg is what "real DNS fronts
        this tier" changes about the availability math."""
        from registrar_tpu_torch import dnsfront

        names = list(self.slice_expected)
        if not names:
            return True
        name = names[self.dns_probes % len(names)]
        expected_ip = self.slice_expected[name]
        self.dns_probes += 1
        packet = dnsfront.build_query(
            (self.dns_probes & 0xFFFF) or 1, name,
            dnsfront.QTYPE_A, rd=True, edns_size=1232,
        )
        # Two attempts, matching what any real resolver does with a
        # dropped UDP exchange — and each retry is a fresh source port,
        # so the kernel rehashes it to a (likely) different worker.
        # 0.2 s per attempt: orders of magnitude above a healthy
        # exchange (sub-ms on loopback) but short enough that a
        # dead-air sample doesn't stall the probe cadence and quantize
        # the measured outage windows up by its own timeout.
        good = False
        for _attempt in range(2):
            try:
                data = await dnsfront.query_udp(
                    self.router.dns["host"], self.router.dns["port"],
                    packet, timeout=0.2,
                )
                resp = dnsfront.decode_response(data)
                good = (
                    (data[3] & 0x0F) == dnsfront.RCODE_NOERROR
                    and any(
                        rtype == "A" and text == expected_ip
                        for _n, rtype, _ttl, text in resp.answers
                    )
                )
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - a failed exchange IS a failed probe
                good = False
            if good:
                break
        if not good:
            self.dns_errors += 1
        return good

    async def wait_healthy(self, timeout: float = 8.0) -> None:
        """Block until the prober sees a full fleet again (scenario
        barrier: the next scenario starts from health, so its fault
        class owns its own windows)."""
        deadline = self.now() + timeout
        while True:
            if self.probes and self.probes[-1].ok:
                return
            if self.now() >= deadline:
                raise RuntimeError(
                    f"fleet never reconverged after {self.scenario!r} "
                    f"(last probe: {self.probes[-1] if self.probes else None})"
                )
            await asyncio.sleep(self.probe_interval)

    # -- member recovery actions --------------------------------------------

    async def _connect_fresh(self, client: ZKClient) -> ZKClient:
        try:
            return await client.connect()
        except SessionExpiredError:
            # A seeded resume the server refused (the session died with
            # the "crashed" predecessor): the client has already reset
            # to a fresh-session handshake — connect again, exactly the
            # successor-daemon fallback (main._attempt_resume).
            return await client.connect()

    async def _restart_member(
        self, member: _Member, resume: Optional[Tuple[int, bytes]] = None
    ) -> None:
        """Bring a member back with a fresh process's client.

        ``resume`` is the SIGKILL-shaped stale-statefile path: the
        "successor" offers the dead session's (id, passwd) the way a
        leftover handoff state file would; the server refuses it and
        the member falls back to a fresh registration."""
        if member.client is not None and not member.client.closed:
            await member.client.close()
        client = self._make_client(member)
        if resume is not None:
            client.seed_session(
                resume[0], resume[1],
                negotiated_timeout_ms=self.session_timeout_ms,
            )
        member.client = await self._connect_fresh(client)
        member.znodes = await register(
            member.client, self._registration(),
            admin_ip=member.admin_ip, hostname=member.hostname,
            settle_delay=0, retry_policy=self._register_retry(),
        )

    def _live_members(self) -> List[_Member]:
        return [
            m
            for m in self.members
            if m.client is not None and m.client.connected
        ]

    def _pick_member(self) -> Optional[_Member]:
        """A member whose client is still alive — with repair disabled,
        earlier scenarios leave corpses behind, and injecting into a
        corpse would be a no-op the attribution then mis-reads."""
        candidates = self._live_members()
        if not candidates:
            return None
        return candidates[self.rng.randrange(len(candidates))]

    # -- scenarios (one per docs/FAULTS.md fault class) ---------------------

    async def run_scenario(self, fault_id: str, **kwargs) -> None:
        """Run one named scenario, bracket its probe segment, and (with
        repair on) wait for reconvergence before returning."""
        methods = {
            "deploy-wave": self._scenario_deploy_wave,
            "crash-loop": self._scenario_crash_loop,
            "health-flap": self._scenario_health_flap,
            "expiry-storm": self._scenario_expiry_storm,
            "netem-episode": self._scenario_netem_episode,
            "leader-kill": self._scenario_leader_kill,
            "quorum-loss": self._scenario_quorum_loss,
            "rolling-upgrade": self._scenario_rolling_upgrade,
            "partition-minority": self._scenario_partition_minority,
            "shard-kill": self._scenario_shard_kill,
            "reshard-wave": self._scenario_reshard_wave,
            "overload-storm": self._scenario_overload_storm,
        }
        ensemble_only = {
            "leader-kill", "quorum-loss", "rolling-upgrade",
            "partition-minority",
        }
        sharded_only = {"shard-kill", "reshard-wave", "overload-storm"}
        if fault_id not in methods:
            raise ValueError(f"unknown scenario {fault_id!r}")
        if fault_id in ensemble_only and self.ensemble is None:
            raise ValueError(
                f"scenario {fault_id!r} needs ensemble= > 1"
            )
        if fault_id in sharded_only and self.router is None:
            raise ValueError(
                f"scenario {fault_id!r} needs shards= > 0"
            )
        self.scenario = fault_id
        started = self.now()
        try:
            await methods[fault_id](**kwargs)
            if self.repair:
                await self.wait_healthy()
        finally:
            self.segments.append((fault_id, started, self.now()))
            self.scenario = None

    async def _scenario_deploy_wave(
        self, wave: Optional[int] = None, down_s: float = 0.1
    ) -> None:
        """A rolling deploy using drain restarts: each member leaves DNS
        (clean unregister), the process "exits", and a successor
        re-registers — the bounded per-member gap drain mode promises
        (handoff mode's zero-gap restart is proven by
        tests/test_restart_e2e.py; this measures the drain envelope)."""
        count = wave if wave is not None else max(2, self.n_members // 2)
        live = self._live_members()
        order = self.rng.sample(live, min(count, len(live)))
        for member in order:
            event = self.inject("deploy-wave", member=member.idx)
            await unregister(member.client, member.znodes)
            await member.client.close()
            await asyncio.sleep(down_s)
            if self.repair:
                await self._restart_member(member)
                self.clear(event)

    async def _scenario_crash_loop(
        self, crashes: int = 2, restart_delay: float = 0.15
    ) -> None:
        """SIGKILL shape, in a loop: the session is force-expired out
        from under the member (ephemerals vanish at once, like a host
        dying with its supervisor), a stale handoff state survives, and
        the successor's seeded resume is refused — it registers fresh,
        exactly the degraded statefile fallback of docs/OPERATIONS.md's
        restart fault rows."""
        member = self._pick_member()
        if member is None:
            return  # nobody left to crash (repair disabled earlier)
        for _ in range(crashes):
            event = self.inject("crash-loop", member=member.idx)
            stale = (member.client.session_id, member.client.session_passwd)
            await self._any_server().expire_session(member.client.session_id)
            await asyncio.sleep(restart_delay)
            if not self.repair:
                break  # the member stays dead; looping adds nothing
            await self._restart_member(member, resume=stale)
            self.clear(event)
            await self.wait_healthy()

    async def _scenario_health_flap(
        self, flaps: int = 3, down_s: float = 0.1, up_s: float = 0.08
    ) -> None:
        """Health-check flapping: the agent's fail->deregister /
        ok->re-register transitions, at the znode level — the member
        leaves DNS deliberately and comes back on "recovery"."""
        member = self._pick_member()
        if member is None:
            return  # nobody left to flap (repair disabled earlier)
        for _ in range(flaps):
            event = self.inject("health-flap", member=member.idx)
            await unregister(member.client, member.znodes)
            await asyncio.sleep(down_s)
            if not self.repair:
                break  # the member stays deregistered; no more flaps
            member.znodes = await register(
                member.client, self._registration(),
                admin_ip=member.admin_ip, hostname=member.hostname,
                settle_delay=0,
            )
            self.clear(event)
            await self.wait_healthy()
            await asyncio.sleep(up_s)

    async def _scenario_expiry_storm(
        self, victims: Optional[int] = None, restart_delay: float = 0.15
    ) -> None:
        """Several members' sessions expired at once (an ensemble-side
        purge): the fleet-wide recovery runs concurrently, the way a
        reborn fleet's jittered pipelines would."""
        count = victims if victims is not None else max(2, self.n_members // 2)
        live = self._live_members()
        chosen = self.rng.sample(live, min(count, len(live)))
        events = []
        for member in chosen:
            events.append(self.inject("expiry-storm", member=member.idx))
            await self._any_server().expire_session(member.client.session_id)
        await asyncio.sleep(restart_delay)
        if self.repair:
            await asyncio.gather(
                *(self._restart_member(m) for m in chosen)
            )
            for event in events:
                self.clear(event)

    async def _scenario_netem_episode(
        self, episodes: int = 1, blackhole_s: Optional[float] = None
    ) -> None:
        """A per-member network fault episode: the member's proxy goes
        total-void (Blackhole both directions + connection drop) long
        enough for the server to expire the unreachable session; the
        link then heals and the member re-registers."""
        hold = (
            blackhole_s
            if blackhole_s is not None
            else 2.2 * self.session_timeout_ms / 1000.0
        )
        member = self._pick_member()
        if member is None:
            return  # nobody left to blackhole (repair disabled earlier)
        for _ in range(episodes):
            event = self.inject("netem-episode", member=member.idx)
            for proxy in member.proxies:
                proxy.add(Blackhole(), direction=UP)
                proxy.add(Blackhole(), direction=DOWN)
                proxy.drop_connections()
            await asyncio.sleep(hold)
            for proxy in member.proxies:
                proxy.clear()
            if self.repair:
                await self._restart_member(member)
                self.clear(event)
                await self.wait_healthy()

    # -- ensemble scenarios (need ensemble= > 1) -------------------

    async def _scenario_leader_kill(
        self, kills: int = 1, down_s: float = 0.3
    ) -> None:
        """SIGKILL-shaped leader death **mid-registration**: a fleet
        member deregisters (the observable outage the probes time), the
        ensemble leader is killed while the member's re-registration is
        in flight, and the write rides the election + failover — retried
        through connection drops and NOT_READONLY until the new leader
        commits it.  MTTR covers deregistration -> election -> commit."""
        for _ in range(kills):
            member = self._pick_member()
            leader_idx = self.ensemble.leader_index
            if member is None or leader_idx is None:
                return  # no live fleet member / no leader to kill
            event = self.inject("leader-kill", member=leader_idx)
            await unregister(member.client, member.znodes)
            member.znodes = []
            reregister = asyncio.ensure_future(
                register(
                    member.client, self._registration(),
                    admin_ip=member.admin_ip, hostname=member.hostname,
                    settle_delay=0, retry_policy=self._register_retry(),
                )
            )
            await asyncio.sleep(0)  # the pipeline is now in flight
            await self.ensemble.kill(leader_idx)
            # The leader stays dead for down_s: the re-registration must
            # ride the election + failover, not race an instant restart.
            await asyncio.sleep(down_s)
            try:
                member.znodes = await reregister
            except Exception:
                reregister.cancel()
                raise
            if self.repair:
                await self.ensemble.restart(leader_idx)
                self.clear(event)
                await self.wait_healthy()
            else:
                return  # the leader stays dead

    async def _scenario_quorum_loss(self, hold_s: float = 0.6) -> None:
        """Kill members down to a minority: the survivors degrade to
        read-only (fleet writes refuse with NOT_READONLY; resolves keep
        answering through the ro member), sessions freeze (no leader =
        no expiry), and when the members return writes resume without
        operator action — the registrations were never lost."""
        size = self.ensemble.size
        running = set(self.ensemble.live)
        live = [
            i for i, m in enumerate(self.ensemble.servers)
            if m is not None and m in running
        ]
        majority = size // 2 + 1
        victims = live[: max(0, len(live) - (majority - 1))]
        if not victims:
            return
        event = self.inject("quorum-loss")
        for i in victims:
            await self.ensemble.kill(i)
        await asyncio.sleep(hold_s)
        if not self.repair:
            return  # quorum never returns
        for i in victims:
            await self.ensemble.restart(i)
        self.clear(event)
        await self.wait_healthy()

    async def _scenario_rolling_upgrade(self, pause_s: float = 0.25) -> None:
        """Restart every ensemble member one at a time (quorum held
        throughout): the fleet's sessions fail over member to member and
        the polling resolver should see no gap at all."""
        event = self.inject("rolling-upgrade")
        for i in range(self.ensemble.size):
            await self.ensemble.kill(i)
            await asyncio.sleep(pause_s)
            if not self.repair:
                return  # the "upgrade" wedges after the first member
            await self.ensemble.restart(i)
            await asyncio.sleep(pause_s)
        self.clear(event)
        await self.wait_healthy()

    async def _scenario_partition_minority(self, hold_s: float = 0.6) -> None:
        """Partition one member away from the majority: it degrades to
        read-only with a frozen view while the majority keeps serving
        writes; healing the partition catches it back up."""
        size = self.ensemble.size
        minority = size - 1
        event = self.inject("partition-minority", member=minority)
        self.ensemble.partition(
            [list(range(size - 1)), [minority]]
        )
        await asyncio.sleep(hold_s)
        if not self.repair:
            return  # the partition never heals
        self.ensemble.heal_partition()
        self.clear(event)
        await self.wait_healthy()

    # -- sharded serve tier scenarios (need shards= > 0) -----------

    def _slice_domains_of(self, shard_id: int) -> List[str]:
        return [
            name
            for name in self.slice_expected
            if self.router.ring.owner(name) == shard_id
        ]

    async def _wait_slices_healthy(
        self,
        domains: List[str],
        respawns_before: Optional[int] = None,
        timeout: float = 12.0,
    ) -> None:
        """Block until ``domains`` answer through the tier again — the
        shard scenarios' reconvergence barrier.  With
        ``respawns_before`` given, first wait for the router's respawn
        to land (a kill propagates asynchronously: clearing the fault
        on a probe round that simply raced ahead of the supervisor
        would close the attribution window before the outage even
        started)."""
        deadline = self.now() + timeout
        while (
            respawns_before is not None
            and self.router.respawns_total() <= respawns_before
        ):
            if self.now() >= deadline:
                raise RuntimeError("shard respawn never happened")
            await asyncio.sleep(0.01)
        while True:
            healthy = True
            for name in domains:
                try:
                    res = await self.shard_client.resolve(name, "A")
                    if {a.data for a in res.answers} != {
                        self.slice_expected[name]
                    }:
                        healthy = False
                except Exception:  # noqa: BLE001 - still recovering
                    healthy = False
            if healthy:
                return
            if self.now() >= deadline:
                raise RuntimeError(
                    "sharded tier never reconverged "
                    f"(slice errors: {self.slice_errors})"
                )
            await asyncio.sleep(self.probe_interval)

    async def _scenario_shard_kill(self, kills: int = 1) -> None:
        """SIGKILL one shard worker: its slice fails until the router's
        respawn + warm refill lands (the MTTR the probes measure), and —
        asserted, not just hoped — sibling shards' slices never blip.
        With repair withheld the respawn never comes and the slice
        stays dark (the detection proof's nines drop)."""
        for _ in range(kills):
            victim = self.router.ring.owner(
                next(iter(self.slice_expected))
            )
            victims = self._slice_domains_of(victim)
            siblings = [
                name
                for name in self.slice_expected
                if name not in victims
            ]
            sibling_errs = {
                name: self.slice_errors[name] for name in siblings
            }
            respawns_before = self.router.respawns_total()
            event = self.inject("shard-kill", member=victim)
            self.router.kill_worker(victim)
            if not self.repair:
                return  # the worker stays dead (respawn withheld)
            await self._wait_slices_healthy(victims, respawns_before)
            self.clear(event)
            await self.wait_healthy()
            blipped = {
                name: self.slice_errors[name] - before
                for name, before in sibling_errs.items()
                if self.slice_errors[name] != before
            }
            if blipped:
                raise RuntimeError(
                    f"sibling slices blipped during shard-kill: {blipped}"
                )

    async def _scenario_reshard_wave(self, hold_s: float = 0.15) -> None:
        """Reshard the tier up one shard and back down mid-traffic: the
        warm handoff + ring-flip ordering must keep every slice
        answering — ZERO shard-probe errors across the whole wave is
        asserted (this is the zero-downtime scenario; it never shows up
        in MTTD/MTTR because a correct reshard is never detected as an
        outage)."""
        errs_before = dict(self.slice_errors)
        event = self.inject("reshard-wave")
        if not self.repair:
            # The broken run: earlier withheld recoveries leave dead
            # slices whose steady-state errors are not this wave's —
            # there is nothing honest to reshard or assert here.
            await asyncio.sleep(hold_s)
            return
        await self.router.reshard(self.n_shards + 1)
        await asyncio.sleep(hold_s)
        await self.router.reshard(self.n_shards)
        await asyncio.sleep(hold_s)
        self.clear(event)
        await self.wait_healthy()
        blipped = {
            name: self.slice_errors[name] - before
            for name, before in errs_before.items()
            if self.slice_errors[name] != before
        }
        if blipped:
            raise RuntimeError(
                f"reshard-wave was not zero-error: {blipped}"
            )

    async def _scenario_overload_storm(
        self,
        storm_s: float = 1.5,
        clients: int = 6,
        pipeline: int = 36,
    ) -> None:
        """Seeded heavy-tailed storm far past the tier's capacity:
        Zipf warm traffic, a flash crowd on one slice,
        never-exists churn, malformed frames, and slow-loris/half-open
        clients — all over the real direct-client paths, while the
        probes keep flying.  With armor on (the overload config
        _start_shard_tier installs iff repair) the tier must DEGRADE,
        not collapse — asserted: every queue-depth sample stays under
        the configured bound, no worker dies, the storm was actually
        refused work (sheds > 0) and every refusal carried an explicit
        shed reason with ZERO timeouts, and the write deadline cut the
        slow-loris connections loose.  With repair=False the SAME seed
        hits an unarmored tier and whatever happens to the probes is
        the honest answer — the detection proof's collapse."""
        from registrar_tpu_torch.testing import workload

        storm = workload.StormWorkload(
            self.router.socket_path,
            list(self.slice_expected),
            # Derived from the harness seed: a repair=False run faces
            # the SAME storm with the armor withheld.
            seed=(self.seed ^ 0x17AC0CE) & 0xFFFFFFFF,
            duration_s=storm_s,
            clients=clients,
            pipeline=pipeline,
            # 20 000 shed replies of 32 bytes: 640 KB, more than the
            # kernel, the loris's reader and the worker's transport
            # absorb (up to about 470 KB) before the write deadline can
            # fire.
            loris_frames=20000,
        )
        event = self.inject("overload-storm")
        if not self.repair:
            # Unarmored: no admission control, no bounds, no deadline.
            # The storm's queued cold fills and pinned handler tasks
            # outlive the storm window itself; nothing here recovers
            # deliberately, so the event is never cleared.
            await storm.run()
            return
        respawns_before = self.router.respawns_total()
        bound = self.shard_overload["maxQueueDepth"]
        peak_depth = 0
        stop_sampling = asyncio.Event()

        async def sample_depth() -> None:
            # Rides OP_STATUS — satellite 2's priority lane, exercised
            # live: the sampler must keep answering while resolves shed.
            nonlocal peak_depth
            while not stop_sampling.is_set():
                status = await self.router.status()
                for entry in status["shards"].values():
                    peak_depth = max(
                        peak_depth, int(entry.get("queue_depth") or 0)
                    )
                try:
                    await asyncio.wait_for(stop_sampling.wait(), 0.15)
                except asyncio.TimeoutError:
                    pass

        sampler = asyncio.get_running_loop().create_task(sample_depth())
        try:
            report = await storm.run()
        finally:
            stop_sampling.set()
            await sampler
        self.clear(event)
        await self.wait_healthy()
        problems = []
        if report.sheds_total == 0:
            problems.append("the storm never overloaded the tier (0 sheds)")
        if report.timeouts_total:
            problems.append(
                f"{report.timeouts_total} storm requests timed out — a "
                "shed must be an explicit fast refusal, never silence"
            )
        if peak_depth > bound:
            problems.append(
                f"queue depth {peak_depth} exceeded the configured "
                f"bound {bound}"
            )
        if self.router.respawns_total() != respawns_before:
            problems.append("a worker died under the storm")
        if report.loris["conns"] and not report.loris["disconnected"]:
            problems.append(
                "no slow-loris client was disconnected (write-deadline "
                "armor never engaged)"
            )
        if problems:
            raise RuntimeError(
                "overload-storm armor failed: " + "; ".join(problems)
            )
        log.info(
            "overload-storm envelope: peak_depth=%d %s",
            peak_depth, report.summary(),
        )

    # -- the report ---------------------------------------------------------

    async def settle(self, seconds: float = 0.2) -> None:
        """Trailing ok probes so the last scenario's windows close."""
        await asyncio.sleep(seconds)

    def report(self, trace_name: str = "custom") -> Dict[str, Any]:
        """Stop probing and roll the timeline up into the SLO report.

        Emits one ``outage`` event per attributed merged window (the
        ``registrar_slo_outage_seconds_total{fault}`` feed), so call it
        exactly once per run."""
        self._stop_probing.set()
        self._finished_at = self.now()
        end = self._finished_at
        per_fault, windows = fault_summary(self.faults, self.probes, end)
        # Per-class availability over the UNION of that class's probe
        # segments — a trace may run the same scenario more than once
        # (the full trace does), and the class's number must cover all
        # of its runs, not just the last.
        segment_probes: Dict[str, List[Probe]] = {}
        for fid, start_t, end_t in self.segments:
            segment_probes.setdefault(fid, []).extend(
                p for p in self.probes if start_t <= p.t <= end_t
            )
        for fid, probes in segment_probes.items():
            if fid in per_fault and probes:
                avail = availability(probes)
                per_fault[fid]["availability"] = round(avail, 6)
                per_fault[fid]["nines"] = nines(avail)
        for window in windows:
            owner = window_owner(window, self.faults)
            if owner is not None:
                self.emit("outage", owner.fault, window[1] - window[0])
        overall = availability(self.probes) if self.probes else 0.0
        worst = max(
            windows, key=lambda w: w[1] - w[0], default=None
        )
        worst_info = None
        if worst is not None:
            owner = window_owner(worst, self.faults)
            trace_ids = [
                p.trace_id
                for p in self.probes
                if worst[0] <= p.t <= worst[1]
                and not p.ok
                and p.trace_id is not None
            ]
            worst_info = {
                "start_s": round(worst[0] - self._started_at, 4),
                "duration_s": round(worst[1] - worst[0], 4),
                "fault": owner.fault if owner is not None else None,
                "trace_ids": trace_ids[:5],
            }
        hist = self.registry.get("registrar_resolve_seconds")
        staleness = {
            "stale_cached_probes": self.stale_probes,
            "cached_probes": self.cached_probes,
            "stale_ratio": round(
                self.stale_probes / self.cached_probes, 6
            ) if self.cached_probes else None,
            "cache_coherence_lag_ms_last": self.cache.stats[
                "coherence_lag_ms_last"
            ] if self.cache is not None else None,
        }
        for source in ("cached", "live"):
            for q in (0.50, 0.95, 0.99):
                value = hist.quantile(q, {"source": source})
                staleness[
                    f"resolve_{source}_p{int(q * 100)}_ms"
                ] = round(value * 1000.0, 4) if value is not None else None
        # Lever attribution: how often each availability
        # lever actually fired this run — race wins across the fleet's
        # (current) clients, watchdog suspicions, the cache's SWR
        # serves/refusals, and the recovery-tuning profile in force.
        # Reported with levers OFF too (all-zero by construction), so
        # a levers-on and a levers-off report have one shape.
        clients = [
            m.client for m in self.members if m.client is not None
        ] + [
            c
            for c in (
                self.live_client, self.cache_client, self._slice_client
            )
            if c is not None
        ]
        policy = self._reconnect_policy()
        levers = {
            "enabled": self.levers,
            "raced_connects": {
                "race_wins": sum(c.race_stats["wins"] for c in clients),
            },
            "failure_detector": {
                "suspicions": sum(c.watchdog_drops for c in clients),
            },
            "swr_cache": {
                "stale_serves": (
                    self.cache.stats["stale_serves"]
                    if self.cache is not None
                    else 0
                ),
                "stale_refusals": (
                    self.cache.stats["stale_refusals"]
                    if self.cache is not None
                    else 0
                ),
            },
            "recovery_tuning": {
                "session_timeout_ms": self.session_timeout_ms,
                "election_ms": (
                    self.election_ms if self.n_ensemble > 1 else None
                ),
                "reconnect_floor_ms": round(policy.initial_delay * 1000.0, 1),
                "reconnect_cap_ms": round(policy.max_delay * 1000.0, 1),
                "attach": (
                    "spread"
                    if self.levers and self.n_ensemble > 1
                    else "any"
                ),
            },
        }
        mttr_all = [f.mttr_s for f in self.faults if f.mttr_s is not None]
        mttd_all = [f.mttd_s for f in self.faults if f.mttd_s is not None]
        measured = sum(
            1
            for entry in per_fault.values()
            if entry["detected"] and entry["mttr_s_mean"] is not None
        )
        downtime = round(total_outage_s(windows), 4)
        gate_metrics = {
            "availability_pct": round(overall * 100.0, 4),
            "downtime_s_total": downtime,
            "worst_outage_s": (
                worst_info["duration_s"] if worst_info is not None else 0.0
            ),
            "mttr_s_mean": _round_stats(mttr_all)["mean"],
            "mttd_s_mean": _round_stats(mttd_all)["mean"],
            "fault_classes_measured": measured,
        }
        return {
            "trace": trace_name,
            "seed": self.seed,
            "repair": self.repair,
            "members": self.n_members,
            "ensemble": {
                "members": self.n_ensemble,
                "election_ms": (
                    self.election_ms if self.n_ensemble > 1 else None
                ),
                "elections": (
                    self.ensemble.state.elections
                    if self.ensemble is not None
                    else 0
                ),
            },
            "shards": {
                "shards": self.n_shards,
                "slice_domains": len(self.slice_expected),
                "slice_probes": self.shard_probes,
                "slice_errors": sum(self.slice_errors.values()),
                "dns_probes": self.dns_probes,
                "dns_errors": self.dns_errors,
                "respawns": (
                    self.router.respawns_total()
                    if self.router is not None
                    else 0
                ),
                "reshards": (
                    self.router.reshards
                    if self.router is not None
                    else 0
                ),
            },
            "probe_interval_ms": round(self.probe_interval * 1000.0, 1),
            "duration_s": round(end - self._started_at, 3),
            "probes": {
                "total": len(self.probes),
                "ok": sum(1 for p in self.probes if p.ok),
                "fail": sum(1 for p in self.probes if not p.ok),
            },
            "availability": round(overall, 6),
            "nines": nines(overall) if self.probes else 0.0,
            "faults": per_fault,
            "outages": {
                "windows": len(windows),
                "downtime_s_total": downtime,
                "worst": worst_info,
            },
            "staleness": staleness,
            "levers": levers,
            "gate_metrics": gate_metrics,
        }

    async def collect_worst_trace(self, report: Dict[str, Any]) -> None:
        """Upgrade the report's worst-outage entry from trace IDS to
        the assembled cross-process trace TREE.

        Picks the first failing probe's trace id inside the worst
        window and assembles one tree across every process that saw it
        — the harness's own recorder (probe spans, fleet zk.ops) plus,
        in shards mode, the router's relay spans and each worker's
        resolve subtree via ``OP_TRACE``.  Call between :meth:`report`
        and :meth:`stop` (the workers must still be alive to hand over
        their fragments; spans a dead worker took with it surface under
        ``<missing parent>``, which is the point).  No-op when the run
        had no outage.
        """
        worst = (report.get("outages") or {}).get("worst")
        if not worst or not worst.get("trace_ids"):
            return
        trace_id = worst["trace_ids"][0]
        if self.router is not None:
            # The router shares this harness's tracer (and process), so
            # the fan-out already folds the probe spans in alongside
            # every worker's fragment.
            tree = await self.router.collect_trace(trace_id)
        else:
            tree = traceview.assemble(
                self.tracer.dump(trace_id=trace_id).get("entries", []),
                trace_id,
            )
        worst["trace_tree"] = tree


# ---------------------------------------------------------------------------
# Named traces
# ---------------------------------------------------------------------------

#: The trace matrix.  ``quick`` runs every fault class once, ~8 s wall;
#: ``full`` is the long soak: a bigger fleet, repeated episodes.
TRACES: Dict[str, Dict[str, Any]] = {
    "quick": {
        "members": 5,
        "probe_interval": 0.02,
        "session_timeout_ms": 800,
        "pause_s": 0.5,
        # The quick trace runs against a real 3-member ensemble: every
        # fault class recovers through leader/follower members, and the
        # leader-failover scenario is among them.
        "ensemble": 3,
        "election_ms": 120.0,
        # Lever overrides (``levers=True``; without it the envelope
        # above applies): 200 ms sessions
        # bound the SERVER side of failure detection — a dead member's
        # ephemerals clear in 0.2 s instead of 0.8 — the 40 ms election
        # window shrinks every leader failover the fleet rides, and the
        # 15 ms probe cadence resolves the sub-100 ms outages the
        # levers leave behind (a 20 ms cadence would quantize them).
        "levers": {
            "session_timeout_ms": 200,
            "election_ms": 35.0,
            "probe_interval": 0.01,
            # Recovery-path knobs ONLY are retuned below: the deploy
            # pipeline's stop->start gap and the supervisor's restart
            # delay are the operator's own machinery, which the levers
            # are allowed to make fast.  Fault-SEVERITY knobs are
            # byte-identical to the reference rows above — health-flap
            # down time, the netem 2.2x-session blackhole formula,
            # partition/quorum holds, the leader's 0.3 s death, and the
            # storm's length/shape all stay put (a lever that shrinks
            # the fault instead of the recovery proves nothing).
            "scenarios": (
                ("deploy-wave", {"wave": 2, "down_s": 0.02}),
                ("crash-loop", {"crashes": 2, "restart_delay": 0.03}),
                ("health-flap", {"flaps": 2, "down_s": 0.1}),
                ("expiry-storm", {"victims": 3, "restart_delay": 0.03}),
                ("netem-episode", {"episodes": 1}),
                ("leader-kill", {"kills": 1, "down_s": 0.3}),
                ("rolling-upgrade", {"pause_s": 0.15}),
                ("partition-minority", {"hold_s": 0.4}),
                ("quorum-loss", {"hold_s": 0.4}),
                ("shard-kill", {"kills": 1}),
                ("reshard-wave", {"hold_s": 0.15}),
                ("overload-storm", {"storm_s": 1.5}),
            ),
        },
        # The quick trace also fronts the backends with a 2-shard serve
        # tier: every scenario's probes now include the
        # sharded resolve path, and the shard fault classes land in the
        # gated envelope (shard-kill measured; reshard-wave asserted
        # zero-error, so it never owns an outage window).
        "shards": 2,
        "scenarios": (
            ("deploy-wave", {"wave": 2, "down_s": 0.1}),
            ("crash-loop", {"crashes": 2, "restart_delay": 0.12}),
            ("health-flap", {"flaps": 2, "down_s": 0.1}),
            ("expiry-storm", {"victims": 3, "restart_delay": 0.12}),
            ("netem-episode", {"episodes": 1}),
            ("leader-kill", {"kills": 1, "down_s": 0.3}),
            ("rolling-upgrade", {"pause_s": 0.15}),
            ("partition-minority", {"hold_s": 0.4}),
            ("quorum-loss", {"hold_s": 0.4}),
            ("shard-kill", {"kills": 1}),
            ("reshard-wave", {"hold_s": 0.15}),
            ("overload-storm", {"storm_s": 1.5}),
        ),
    },
    "full": {
        "members": 10,
        "probe_interval": 0.05,
        "session_timeout_ms": 1500,
        "pause_s": 1.5,
        "ensemble": 3,
        "election_ms": 150.0,
        # The soak keeps its production-shaped 1.5 s sessions and its
        # reference scenario knobs; the levers there are the
        # client-side ones (raced connects, ping schedule, SWR) plus a
        # halved election window.
        "levers": {"election_ms": 75.0},
        "shards": 3,
        "scenarios": (
            ("deploy-wave", {"wave": 6, "down_s": 0.15}),
            ("crash-loop", {"crashes": 4, "restart_delay": 0.2}),
            ("health-flap", {"flaps": 4, "down_s": 0.15}),
            ("expiry-storm", {"victims": 5, "restart_delay": 0.2}),
            ("netem-episode", {"episodes": 2}),
            ("leader-kill", {"kills": 2, "down_s": 0.3}),
            ("rolling-upgrade", {"pause_s": 0.3}),
            ("partition-minority", {"hold_s": 0.8}),
            ("quorum-loss", {"hold_s": 0.8}),
            ("shard-kill", {"kills": 2}),
            ("reshard-wave", {"hold_s": 0.3}),
            ("overload-storm", {"storm_s": 2.0, "clients": 8}),
            ("deploy-wave", {"wave": 6, "down_s": 0.15}),
            ("expiry-storm", {"victims": 5, "restart_delay": 0.2}),
        ),
    },
}


async def run_trace(
    trace: str = "quick",
    seed: Optional[int] = None,
    repair: bool = True,
    scenarios: Optional[Sequence[Tuple[str, Dict[str, Any]]]] = None,
    levers: bool = False,
) -> Dict[str, Any]:
    """Drive one named trace end to end and return the SLO report.

    ``levers`` turns on the harness availability levers AND
    applies the trace's ``"levers"`` timing overrides (tighter
    sessions/election/cadence); ``False`` runs the lever-free
    envelope — same seed, so the two can be diffed."""
    if trace not in TRACES:
        raise ValueError(f"unknown trace {trace!r} (have {sorted(TRACES)})")
    params = dict(TRACES[trace])
    overrides = params.pop("levers", None)
    if levers and overrides:
        params.update(overrides)
    if seed is None:
        seed = random.randrange(2**32)
    harness = SLOHarness(
        members=params["members"],
        seed=seed,
        probe_interval=params["probe_interval"],
        session_timeout_ms=params["session_timeout_ms"],
        repair=repair,
        ensemble=params.get("ensemble", 1),
        election_ms=params.get("election_ms", 150.0),
        shards=params.get("shards", 0),
        levers=levers,
    )
    await harness.start()
    try:
        for fault_id, kwargs in (
            scenarios if scenarios is not None else params["scenarios"]
        ):
            await harness.run_scenario(fault_id, **kwargs)
            # Steady-state gap between scenarios: the availability
            # denominator includes healthy operation (a trace that is
            # 100% fault time measures the faults, not the service),
            # and the next scenario's windows start from health.
            await harness.settle(params.get("pause_s", 0.5))
        await harness.settle(max(0.2, 5 * params["probe_interval"]))
        report = harness.report(trace_name=trace)
        # Before stop(): the workers must still be alive to hand their
        # trace fragments over — the worst-outage entry
        # carries one ASSEMBLED cross-process tree, not just trace ids.
        await harness.collect_worst_trace(report)
        return report
    finally:
        await harness.stop()
