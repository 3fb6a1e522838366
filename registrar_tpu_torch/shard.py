"""Namespace-sharded serve tier: near-linear multi-core resolve scaling.

One asyncio loop caps the cached resolve path at the single-core ceiling
(BENCH_BASELINE ``cached_resolve_qps_50_instances``) no matter how many
cores the box has.  This module partitions the DNS namespace across
worker *processes* the same way a ``PartitionSpec`` partitions an array
(the one transferable idea from the related sharding
material): each :class:`ShardWorker` owns a slice of the domain space —
its own event loop, its own ZooKeeper session, its own watch-coherent
:class:`~registrar_tpu_torch.zkcache.ZKCache` — and, against a multi-member
ensemble, attaches its watch load to a *distinct* follower
(``attach_preference``), so read capacity scales with both cores and
ensemble size.

Topology::

    client ──UDS──> ShardRouter ──UDS──> ShardWorker[k]   (relay path)
    client ──UDS──────────────────────> ShardWorker[k]    (direct path)

The parent :class:`ShardRouter` consistent-hashes domains across N
workers (:class:`HashRing`, deterministic BLAKE2 points — stable across
process restarts), supervises them (a crashed worker is respawned while
its siblings keep serving their slices), and fronts them over a
length-prefixed unix-domain-socket resolve protocol sized for the future
DNS frontend:

  * **the router never copies answers** — a worker serializes each
    :class:`~registrar_tpu_torch.binderview.Resolution` exactly once, and the
    router forwards those bytes verbatim (it parses only the fixed
    reply header to demultiplex);
  * **the router never caches** — a worker's answer is watch-coherent
    because its cache armed watches with the read; a second cache in
    the router would re-open exactly the arm-then-read window ZKCache
    closes (docs/DESIGN.md "Sharded serve tier");
  * **the ring is a performance hint, not a correctness boundary** —
    any worker answers any domain correctly (ZKCache is read-through),
    so a request that races a reshard to the old owner still gets the
    right answer.  That is what makes resharding zero-error, and it is
    the same property SO_REUSEPORT will lean on when the DNS frontend
    lands (the kernel, like the ring, only balances);
  * smart clients (the future DNS data plane, bench.py) fetch the ring
    (``OP_RING``) and talk to workers directly — the router stays the
    control plane + supervisor, exactly the SO_REUSEPORT shape.

Resharding is a first-class operation: a SIGHUP shard-count change
(``zkcli serve-sharded``) moves only ~K/N of K warm domains (consistent
hashing), and the warm set of every domain that changes owner is handed
to the new owner *by name* (``OP_DUMP`` → ``OP_WARM``): the new owner
pre-resolves each handed-off domain through its own session **before**
the ring flips, so a reshard never cold-starts the tier.  Names, not
cached bytes, are what move — an imported entry would be watch-orphaned
(its one-shot watches live on the departing worker's dying session),
which would silently break the coherence bound; a pre-resolve arms
fresh watches with the read, exactly like any other fill.

Wire protocol (all integers big-endian)::

    frame   := len:u32  payload
    request := req_id:u32  op:u8  [trace_ctx]  body
    reply   := req_id:u32  status:u8  [worker_us:u32]  body
                                                # status 0 = OK, 1 = error

    OP_RESOLVE  body = flags:u8 (bit0: live read)  qlen:u8  qtype  name
                reply body = compact JSON {"a": [[name, rtype, ttl,
                data], ...], "ad": [...]} (answers / additionals)
    OP_STATUS   reply body = per-worker status JSON (router: aggregate)
    OP_RING     (router only) reply = {"generation", "shards": [{"shard",
                "socket"}, ...]}
    OP_DUMP     (worker) reply = {"warm": [[name, qtype], ...]}
    OP_WARM     (worker) body = {"names": [[name, qtype], ...]};
                pre-resolves each, reply = {"warmed": N}
    OP_TRACE    body = {"trace_id": hex, "n"?: int}; worker reply = its
                flight recorder filtered to that trace (+ shard, pid);
                router reply = the ASSEMBLED cross-process tree
                (:mod:`registrar_tpu_torch.traceview`)

**Trace-context extension.**  The :data:`TRACE_FLAG` bit on
the op byte gates a fixed ``trace_id:u64 + parent_span_id:u64 +
sampled:u8`` block between header and body — with tracing off not a
bit moves and every frame is byte-identical to the untraced format (pinned
by the golden parity test).  Clients inject the ambient span's context
(:func:`registrar_tpu_torch.trace.current_context`), the router adopts it as
the parent of its ``shard.relay`` span and re-injects THAT span's
context toward the owning worker, and the worker adopts in turn so its
``resolve.query``/``cache.fill``/``zk.op`` subtree chains under the
relay — one trace id from resolver to znode.  A reply to a traced
request carries the same flag bit on the status byte gating a
``worker_us:u32`` block: the REMOTE PEER's self-reported handling time
(a worker reports its dispatch; the router, answering its own front
socket, reports the whole relay window), stamped on the requester's
span as the ``worker`` mark — so the router's relay span splits into
router-queue (the ``forwarded`` mark), socket, and worker time, the
sharded analog of the zk.op span's queue-vs-wire split.

Used by ``zkcli serve-sharded -f config`` (config block ``serve:
{shards, socketPath, attachSpread}``; absent block = today's in-process
behavior), benchmarked by bench.py (``sharded_resolve_qps_*``,
``reshard_warm_handoff_ms``), fault-injected by the SLO harness
(``shard-kill`` / ``reshard-wave``), and rolled up into metrics by
:func:`registrar_tpu_torch.metrics.instrument_shards`.
"""

from __future__ import annotations

import asyncio
import bisect
import hashlib
import json
import logging
import os
import signal
import socket
import struct
import subprocess
import sys
import time
from contextlib import nullcontext
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from registrar_tpu_torch import binderview, dnsfront, malformed, trace, traceview
from registrar_tpu_torch.binderview import Answer, Resolution
from registrar_tpu_torch.events import EventEmitter, spawn_owned
from registrar_tpu_torch.retry import RetryPolicy, is_transient
from registrar_tpu_torch.zk.client import ZKClient, connect_with_backoff
from registrar_tpu_torch.zkcache import (
    CacheOverloadError, DEFAULT_MAX_ENTRIES, ZKCache,
)

log = logging.getLogger("registrar_tpu_torch.shard")

#: shared reusable no-op context manager (nullcontext is reentrant and
#: stateless) — the untraced request path pays no per-request allocation
NULLCTX = nullcontext()

OP_RESOLVE = 1
OP_STATUS = 2
OP_RING = 3
OP_DUMP = 4
OP_WARM = 5
OP_TRACE = 6

STATUS_OK = 0
STATUS_ERR = 1

#: high bit of the op byte (request) / status byte (reply): a
#: trace-context block (request) or worker_us block (reply) follows the
#: header.  A bit, not a new frame layout, so tracing-off frames stay
#: byte-identical to the untraced wire format (module docstring).
TRACE_FLAG = 0x80

#: request/reply fixed header past the length prefix: req_id:u32 + op/status:u8
_HDR = struct.Struct(">IB")

#: the optional trace-context block: trace_id:u64 parent_span_id:u64 sampled:u8
_TRACE_CTX = struct.Struct(">QQB")

#: the optional traced-reply block: the worker's handling time in µs
_WORKER_US = struct.Struct(">I")

#: frame size bound — an answer set is a few KiB; anything bigger is a
#: protocol error, not a legitimate resolution (guards readexactly from
#: a corrupt length prefix commanding a gigabyte allocation)
MAX_FRAME = 4 << 20

#: virtual nodes per shard on the ring: enough for ±small-percent slice
#: balance at single-digit shard counts while keeping ring construction
#: trivially cheap (N*vnodes 8-byte points)
DEFAULT_VNODES = 64

#: worker spawn → socket-answering readiness budget (interpreter start +
#: ZK connect + bind); generous because CI boxes cold-start Python slowly
READY_TIMEOUT_S = 20.0

#: staleness bound for a worker's last-known-good fallback answers —
#: DNS-TTL scale (the tier's default answer TTL is 30 s; an answer that
#: age is one Binder would still be serving from its own cache)
DEFAULT_MAX_STALE_S = 30.0


class ShardError(Exception):
    """A sharded-tier request failed (worker down, protocol error)."""


#: wire marker for a deliberate overload reject: the STATUS_ERR body is
#: ``SHED:<reason>[ <detail>]``.  A prefix on the existing error body —
#: not a new status code — so every armor-unaware peer (and the router's
#: verbatim error forwarding) carries it unchanged, while armor-aware
#: clients can tell "the tier refused fast" from "the tier broke".
SHED_PREFIX = b"SHED:"

#: the shed-reason taxonomy (docs/OPERATIONS.md "Overload"): the label
#: vocabulary of registrar_shed_total and the first word of every
#: SHED: reject body.  queue_full = worker admission (dispatch backlog
#: or per-connection in-flight bound), rate_limited = the router's
#: per-client token bucket, cold_fill_shed = ZKCache's bounded cold-fill
#: concurrency, slow_client = a reply write deadline expired (slow-loris
#: / half-open peer disconnected).
SHED_REASONS = ("queue_full", "rate_limited", "cold_fill_shed", "slow_client")


class ShardShedError(ShardError):
    """A request the overload armor deliberately rejected (fast-fail —
    the reply came back immediately, it did NOT time out).  ``reason``
    is one of :data:`SHED_REASONS`; callers that want to degrade (serve
    stale, back off, retry elsewhere) can catch this narrower class
    while plain :class:`ShardError` keeps meaning "broken"."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(
            f"shed [{reason}]{' ' + detail if detail else ''}"
        )

    def payload(self) -> bytes:
        return shed_body(self.reason, self.detail)


def shed_body(reason: str, detail: str = "") -> bytes:
    """The wire body of a shed reject (STATUS_ERR + this)."""
    out = SHED_PREFIX + reason.encode("ascii")
    if detail:
        out += b" " + detail.encode("utf-8", "replace")
    return out


def shed_reason(body) -> Optional[str]:
    """The shed reason inside a STATUS_ERR body, or None if the error
    is not a shed reject (the client-side classifier)."""
    raw = bytes(body)
    if not raw.startswith(SHED_PREFIX):
        return None
    return (
        raw[len(SHED_PREFIX):].split(b" ", 1)[0].decode("ascii", "replace")
    )


def _opt_int(raw) -> Optional[int]:
    """An optional spec knob: None stays None (unbounded), anything
    else must coerce to int — a typo'd bound must fail the spawn, not
    silently disable the armor it claimed to configure."""
    return None if raw is None else int(raw)


# ---------------------------------------------------------------------------
# Consistent hashing
# ---------------------------------------------------------------------------


def _point(key: str) -> int:
    """Deterministic 64-bit ring coordinate.  BLAKE2, not ``hash()``:
    Python string hashing is salted per process, and the ring MUST be
    stable across process restarts (a restarted router that re-derived a
    different ring would orphan every worker's warm slice)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring over shard ids.

    ``vnodes`` virtual points per shard: adding or removing one shard
    moves only ~K/N of K keys (the resharding bound bench.py and
    tests/test_shard.py pin), and the points are pure functions of the
    shard id — two processes building a ring over the same ids agree on
    every owner.
    """

    def __init__(self, shard_ids: Iterable[int], vnodes: int = DEFAULT_VNODES):
        self.shard_ids = tuple(sorted(shard_ids))
        if not self.shard_ids:
            raise ValueError("a ring needs at least one shard")
        self.vnodes = vnodes
        points: List[Tuple[int, int]] = []
        for sid in self.shard_ids:
            for v in range(vnodes):
                points.append((_point(f"shard:{sid}#{v}"), sid))
        points.sort()
        self._hashes = [p[0] for p in points]
        self._owners = [p[1] for p in points]

    def owner(self, name: str) -> int:
        """The shard id owning ``name`` (domains are case-normalized by
        the resolve path before they get here)."""
        h = _point(name)
        i = bisect.bisect_right(self._hashes, h)
        if i == len(self._hashes):
            i = 0
        return self._owners[i]

    def moved(self, other: "HashRing", names: Iterable[str]) -> List[str]:
        """The subset of ``names`` whose owner differs under ``other`` —
        the resharding movement set (deterministic, so the bound tests
        pin is a fact, not a distribution)."""
        return [n for n in names if self.owner(n) != other.owner(n)]


# ---------------------------------------------------------------------------
# Framing + resolution serialization
# ---------------------------------------------------------------------------


def pack_frame(req_id: int, code: int, body) -> bytes:
    """One wire frame: length prefix + header + body."""
    return (
        struct.pack(">I", _HDR.size + len(body))
        + _HDR.pack(req_id, code)
        + bytes(body)
    )


def split_traced(frame, op: int):
    """Split an incoming request's optional trace-context block:
    ``(op, ctx, body)``.  A flagged frame too short for the block is a
    protocol error raised as :class:`ShardError` — the caller answers
    STATUS_ERR; it must never become a dead handler task that leaves
    the requester waiting forever."""
    if not op & TRACE_FLAG:
        return op, None, memoryview(frame)[_HDR.size:]
    if len(frame) < _HDR.size + _TRACE_CTX.size:
        malformed.note("shard")
        raise ShardError(
            f"traced frame too short for context block ({len(frame)})"
        )
    ctx = _TRACE_CTX.unpack_from(frame, _HDR.size)
    body = memoryview(frame)[_HDR.size + _TRACE_CTX.size:]
    return op & ~TRACE_FLAG & 0xFF, ctx, body


async def _answer_protocol_error(writer, req_id: int, err: Exception) -> None:
    """Answer a malformed frame with STATUS_ERR — shared by the worker
    and the router so the two peers' protocol-error behavior can never
    drift (a dead handler task would leave the requester, whose future
    has no timeout, waiting forever)."""
    try:
        writer.write(pack_frame(req_id, STATUS_ERR, repr(err).encode()))
        await writer.drain()
    except (ConnectionError, OSError):
        pass


def stamp_traced_reply(status: int, reply, t0: float) -> Tuple[int, bytes]:
    """The traced-reply extension, one copy for every hop: flag the
    status byte and prepend this peer's self-reported handling time
    (µs since ``t0``).  Gated by the caller on the REQUEST having
    carried context, so untraced peers never see the flag."""
    us = min(int((time.monotonic() - t0) * 1e6), 0xFFFFFFFF)
    return status | TRACE_FLAG, _WORKER_US.pack(us) + bytes(reply)


def pack_request(
    req_id: int, op: int, body, trace_ctx: Optional[Tuple] = None
) -> bytes:
    """One request frame.  Without ``trace_ctx`` this is byte-for-byte
    :func:`pack_frame` — the tracing-off parity the golden wire test
    pins; with a ``(trace_id, parent_span_id, sampled)`` int triple the
    op byte's :data:`TRACE_FLAG` bit gates the fixed context block
    between header and body."""
    if trace_ctx is None:
        return pack_frame(req_id, op, body)
    return (
        struct.pack(">I", _HDR.size + _TRACE_CTX.size + len(body))
        + _HDR.pack(req_id, op | TRACE_FLAG)
        + _TRACE_CTX.pack(*trace_ctx)
        + bytes(body)
    )


def pack_resolve(name: str, qtype: str = "A", live: bool = False) -> bytes:
    """An OP_RESOLVE request body."""
    qb = qtype.encode("ascii")
    return bytes((1 if live else 0, len(qb))) + qb + name.encode("utf-8")


def resolve_name(body) -> str:
    """The domain inside an OP_RESOLVE body — all the router ever parses
    of a resolve request (it hashes the name and forwards the body).

    Rejects malformed bodies as :class:`ShardError` — the single
    contract class the relay path answers with STATUS_ERR (a hostile
    qtype length must bound-check against the body, not silently slice
    past it)."""
    if len(body) < 2:
        malformed.note("shard")
        raise ShardError(f"resolve body too short ({len(body)} bytes)")
    qlen = body[1]
    if 2 + qlen > len(body):
        malformed.note("shard")
        raise ShardError(
            f"resolve qtype length {qlen} overruns body ({len(body)} bytes)"
        )
    try:
        return bytes(body[2 + qlen:]).decode("utf-8")
    except UnicodeDecodeError as err:
        malformed.note("shard")
        raise ShardError(f"resolve name not UTF-8: {err}") from err


def encode_resolution(res: Resolution) -> bytes:
    """Serialize a Resolution ONCE, worker-side; the router and direct
    clients forward/parse these bytes without the worker's involvement."""
    return json.dumps(
        {
            "a": [[a.name, a.rtype, a.ttl, a.data] for a in res.answers],
            "ad": [[a.name, a.rtype, a.ttl, a.data] for a in res.additionals],
        },
        separators=(",", ":"),
    ).encode("utf-8")


def decode_resolution(body) -> Resolution:
    raw = json.loads(bytes(body).decode("utf-8"))
    return Resolution(
        answers=[Answer(*row) for row in raw.get("a", ())],
        additionals=[Answer(*row) for row in raw.get("ad", ())],
    )


async def _read_frame(reader: asyncio.StreamReader) -> Optional[bytes]:
    """One length-prefixed frame, or None on clean EOF at a boundary."""
    try:
        head = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    (size,) = struct.unpack(">I", head)
    if size < _HDR.size or size > MAX_FRAME:
        malformed.note("shard")
        raise ShardError(f"bad frame length {size}")
    try:
        return await reader.readexactly(size)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None


class Channel:
    """One multiplexed request/reply connection (client→router and
    router→worker both ride this): requests carry a channel-local req_id
    and replies resolve the matching future, so any number of requests
    can be in flight and replies may land out of order (a worker
    dispatches each request as its own task — a cold live fill never
    head-of-line-blocks warm answers behind it)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self._next_id = 0
        self._pending: Dict[int, asyncio.Future] = {}
        self._closed = False
        self._reader_task = asyncio.get_running_loop().create_task(
            self._read_loop()
        )

    @classmethod
    async def open(cls, socket_path: str) -> "Channel":
        reader, writer = await asyncio.open_unix_connection(socket_path)
        return cls(reader, writer)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def pending(self) -> int:
        return len(self._pending)

    async def _read_loop(self) -> None:
        try:
            while True:
                frame = await _read_frame(self._reader)
                if frame is None:
                    break
                req_id, status = _HDR.unpack_from(frame)
                fut = self._pending.pop(req_id, None)
                if fut is not None and not fut.done():
                    # The body is a view into this frame's buffer: the
                    # relay path writes it back out without a copy.
                    fut.set_result((status, memoryview(frame)[_HDR.size:]))
        except asyncio.CancelledError:
            raise  # close() cancelled us; finally still fails the waiters
        except (ShardError, OSError):
            pass
        finally:
            self._fail_pending(ShardError("shard connection lost"))
            self._closed = True

    def _fail_pending(self, err: Exception) -> None:
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(err)
                # Mark retrieved: a waiter whose task was cancelled (a
                # probe torn down mid-flight) never awaits this future,
                # and the GC warning would point at the wrong culprit.
                fut.exception()

    async def request(
        self,
        op: int,
        body,
        trace_ctx: Optional[Tuple] = None,
        span=None,
    ) -> Tuple[int, memoryview]:
        """Send one request; await ``(status, body_view)``.

        ``trace_ctx`` (a :func:`registrar_tpu_torch.trace.current_context`
        triple) rides the op byte's trace extension; ``span`` (the
        caller's relay span) gets the ``forwarded`` mark when the frame
        clears our buffer and the ``worker`` mark from the traced
        reply's worker_us block.  The block is stripped here either
        way, so callers always see the plain ``(status, body)``.
        """
        if self._closed:
            raise ShardError("shard connection closed")
        self._next_id = (self._next_id + 1) & 0xFFFFFFFF
        req_id = self._next_id
        fut = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        try:
            self._writer.write(pack_request(req_id, op, body, trace_ctx))
            await self._writer.drain()
        except (ConnectionError, OSError) as err:
            self._pending.pop(req_id, None)
            raise ShardError(f"shard write failed: {err!r}") from err
        if span is not None:
            span.mark("forwarded")
        try:
            status, reply = await fut
        finally:
            self._pending.pop(req_id, None)
        if status & TRACE_FLAG:
            if len(reply) < _WORKER_US.size:
                # Same hazard split_traced guards on the request side:
                # a malformed peer must surface as the documented
                # ShardError, never a stray struct.error (which the
                # relay path would not catch — a dead handler task).
                raise ShardError(
                    f"traced reply too short for worker_us block "
                    f"({len(reply)})"
                )
            (worker_us,) = _WORKER_US.unpack_from(reply)
            reply = reply[_WORKER_US.size:]
            status &= ~TRACE_FLAG & 0xFF
            if span is not None:
                span.set_mark("worker", worker_us / 1e6)
        return status, reply

    async def drain_pending(self, timeout: float = 2.0) -> None:
        """Wait (bounded) for in-flight requests to finish — the reshard
        retirement barrier, so a departing worker is never torn down
        under a relay that already chose it."""
        deadline = time.monotonic() + timeout
        while self._pending and time.monotonic() < deadline:
            await asyncio.sleep(0.01)

    async def close(self) -> None:
        self._closed = True
        self._reader_task.cancel()
        try:
            await self._reader_task
        except asyncio.CancelledError:
            pass
        try:
            self._writer.close()
        except Exception:  # noqa: BLE001 - teardown best effort
            pass
        self._fail_pending(ShardError("shard connection closed"))


# ---------------------------------------------------------------------------
# The worker process
# ---------------------------------------------------------------------------

#: a worker rides out ensemble blips like the daemon does; the cache
#: degrades to live reads while down and resumes cold-but-authoritative.
#: Reconnects are AGGRESSIVE compared to the agent's 1-90 s envelope:
#: every disconnected second is serve-path downtime for this worker's
#: whole slice, and the herd is bounded by the shard count (a handful of
#: read sessions, not a fleet of registrants)
_WORKER_RECONNECT = RetryPolicy(
    max_attempts=float("inf"), initial_delay=0.05, max_delay=2.0,
    jitter="decorrelated",
)


class ShardWorker:
    """One shard: a self-contained, process-spawnable serve unit.

    Owns its event loop (one per process), one ZooKeeper session
    (attached per ``attach`` — against an ensemble, a *distinct*
    follower via ``spread:<k-of-n>``), one watch-coherent ZKCache over
    that session, and one unix-socket listener speaking the frame
    protocol.  ``serve()`` runs until ``stop()`` (SIGTERM in the spawned
    process).

    The worker also keeps a bounded **warm set** — the (name, qtype)
    pairs it has resolved, in LRU order, each with its last successfully
    serialized answer — which is what moves during a reshard (module
    docstring: names move, bytes don't).

    **Stale-while-unreachable** (scoped to the serve
    tier): when a cached resolve fails on a *transient connectivity*
    error (the session mid-reconnect, an ensemble member bouncing —
    exactly :func:`registrar_tpu_torch.retry.is_transient`'s verdict), the
    worker answers the last-known-good serialization instead, bounded
    by ``maxStaleS`` (default :data:`DEFAULT_MAX_STALE_S`).  DNS TTLs
    already tolerate bounded staleness — Binder semantics — and a
    worker mid-blip serving yesterday's answer set beats SERVFAIL for
    every domain in its slice.  Explicit live reads (``flags`` bit 0)
    never serve stale, and a record older than the bound fails
    truthfully.
    """

    def __init__(self, spec: Dict):
        self.spec = spec
        self.shard_id = int(spec["shard"])
        self.socket_path = spec["socket"]
        self.max_entries = int(spec.get("maxEntries") or DEFAULT_MAX_ENTRIES)
        self.zk: Optional[ZKClient] = None
        self.cache: Optional[ZKCache] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._tasks: set = set()
        self._stop = asyncio.Event()
        self.started_at = time.time()
        self.resolves_total = 0
        self.errors_total = 0
        self.stale_serves = 0
        #: staleness bound for the last-known-good fallback (seconds)
        self.max_stale_s = float(
            spec.get("maxStaleS") or DEFAULT_MAX_STALE_S
        )
        # -- overload armor (every knob None = unbounded, the
        # pre-armor behavior — config absent means not a byte changes) --
        #: bound on resolve requests dispatched-but-unanswered across
        #: the whole worker (the dispatch backlog satellite 1 bounds)
        self.max_queue_depth = _opt_int(spec.get("maxQueueDepth"))
        #: bound on resolve requests in flight per connection (the
        #: per-connection in-flight map satellite 1 bounds)
        self.max_inflight_per_conn = _opt_int(spec.get("maxInflightPerConn"))
        #: reply write deadline (seconds): a peer that stops reading is
        #: disconnected rather than allowed to pin its handler tasks
        self.write_deadline_s = (
            float(spec["writeDeadlineS"])
            if spec.get("writeDeadlineS") is not None
            else None
        )
        #: bound on concurrent cold fills, threaded into ZKCache
        self.cold_fill_concurrency = _opt_int(spec.get("coldFillConcurrency"))
        #: resolve requests currently dispatched and unanswered
        self.queue_depth = 0
        #: deliberate rejects by reason (docs/OPERATIONS.md taxonomy)
        self.sheds: Dict[str, int] = {r: 0 for r in SHED_REASONS}
        #: LRU warm set: (name, qtype) -> (last-good serialized answer,
        #: monotonic stamp); dict order = recency
        self.warm: Dict[Tuple[str, str], Tuple[bytes, float]] = {}
        #: per-instance tracer override; None = the process
        #: default — the spawned worker installs one from spec["trace"]
        self.tracer = None
        #: DNS frontend: spec["dns"] present = this worker
        #: binds an SO_REUSEPORT UDP socket + TCP listener on the
        #: shared host:port at start(); absent = no DNS, byte-identical
        #: behavior to a worker without a DNS frontend.
        self.dns_spec = spec.get("dns")
        self.dns: Optional[dnsfront.DnsFront] = None

    def _make_client(self) -> ZKClient:
        spec = self.spec
        return ZKClient(
            [(h, int(p)) for h, p in spec["servers"]],
            timeout_ms=int(spec.get("timeoutMs") or 30000),
            connect_timeout_ms=int(spec.get("connectTimeoutMs") or 4000),
            chroot=spec.get("chroot"),
            request_timeout_ms=spec.get("requestTimeoutMs"),
            reconnect_policy=_WORKER_RECONNECT,
            # A pure reader: keep serving through a read-only minority
            # member during quorum loss.
            can_be_read_only=bool(spec.get("canBeReadOnly", True)),
            attach_preference=spec.get("attach", "any"),
        )

    async def start(self) -> "ShardWorker":
        # Session first, socket second: an answering socket IS the
        # readiness signal the router's respawn bound is built on.
        self.zk = self._make_client()
        await connect_with_backoff(self.zk)
        self.cache = ZKCache(
            self.zk,
            max_entries=self.max_entries,
            fill_concurrency=self.cold_fill_concurrency,
        )
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        self._server = await asyncio.start_unix_server(
            self._on_connection, path=self.socket_path
        )
        if self.dns_spec:
            # The DNS presence: every worker binds the SAME
            # host:port with SO_REUSEPORT — the kernel fans queries out
            # across the sibling workers, and any worker answers any
            # domain (the ring is a warmth hint, not a correctness
            # boundary), so no router hop exists on this path at all.
            self.dns = dnsfront.DnsFront(
                self._dns_resolve,
                host=self.dns_spec.get("host", "127.0.0.1"),
                port=int(self.dns_spec.get("port") or 0),
                source=self.cache,
                udp_payload_max=int(
                    self.dns_spec.get("udpPayloadMax")
                    or dnsfront.DEFAULT_UDP_PAYLOAD_MAX
                ),
                negative_ttl=float(
                    self.dns_spec.get("negativeTtl")
                    or dnsfront.DEFAULT_NEGATIVE_TTL
                ),
                # `or`-defaulting would turn an explicit 0 (fail closed
                # on authority loss) back into the 30 s default.
                stale_ttl=(
                    float(self.dns_spec["staleTtl"])
                    if self.dns_spec.get("staleTtl") is not None
                    else dnsfront.DEFAULT_STALE_TTL
                ),
                max_entries=self.max_entries,
                max_pending=_opt_int(self.dns_spec.get("maxPending")),
                rate_limit=(
                    float(self.dns_spec["rateLimit"])
                    if self.dns_spec.get("rateLimit") is not None
                    else None
                ),
            )
            await self.dns.start()
        log.info(
            "shard %d serving on %s (session 0x%x via %s)%s",
            self.shard_id, self.socket_path, self.zk.session_id,
            self.zk.connected_server,
            (
                f" + dns {self.dns.host}:{self.dns.port}"
                if self.dns is not None
                else ""
            ),
        )
        return self

    async def serve(self) -> None:
        await self._stop.wait()

    def stop(self) -> None:
        self._stop.set()

    async def close(self) -> None:
        if self.dns is not None:
            await self.dns.close()
            self.dns = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for task in list(self._tasks):
            task.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        if self.cache is not None:
            self.cache.close()
        if self.zk is not None and not self.zk.closed:
            await self.zk.close()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    # -- request handling ---------------------------------------------------

    async def _on_connection(self, reader, writer) -> None:
        # Per-connection in-flight count, shared (mutably) with the
        # handler tasks this connection spawns.
        conn = {"inflight": 0}
        try:
            while True:
                frame = await _read_frame(reader)
                if frame is None:
                    return
                req_id, op = _HDR.unpack_from(frame)
                reason = self._admission_check(op, conn)
                if reason is not None:
                    # Fast-fail shed: answered inline from the read
                    # loop, never dispatched, normally never drained —
                    # a shed reply must not queue behind the very
                    # backlog it is refusing to join (and must never
                    # look like a timeout; the requester's future
                    # resolves now).
                    self.sheds[reason] += 1
                    writer.write(
                        pack_frame(
                            req_id, STATUS_ERR,
                            shed_body(reason, f"shard {self.shard_id}"),
                        )
                    )
                    transport = writer.transport
                    if (
                        self.write_deadline_s is not None
                        and transport is not None
                        and transport.get_write_buffer_size() > 65536
                    ):
                        # A peer that floods requests but never reads
                        # replies grows the reject buffer without bound
                        # — the slow-loris shape the admitted path's
                        # drain deadline can't see (sheds outnumber
                        # admissions by orders of magnitude under a
                        # flood).  Once the buffer is past the
                        # transport's high-water mark, drain under the
                        # same deadline; a well-behaved bursty reader
                        # drains in microseconds, a non-reader gets
                        # disconnected here.
                        try:
                            await asyncio.wait_for(
                                writer.drain(), self.write_deadline_s
                            )
                        except asyncio.TimeoutError:
                            self.sheds["slow_client"] += 1
                            log.warning(
                                "shard %d: shed backlog write stalled "
                                "> %.1fs; disconnecting slow client",
                                self.shard_id, self.write_deadline_s,
                            )
                            transport.abort()
                            return
                    continue
                # Each admitted request is its own task: a cold fill
                # awaiting the wire must not head-of-line-block the
                # warm answers pipelined behind it (replies demux by
                # req_id).  Control ops (OP_STATUS/OP_RING/OP_TRACE...)
                # skip admission entirely — the priority lane: they are
                # never shed and never wait behind a saturated resolve
                # backlog, because that backlog is bounded and anything
                # beyond the bound was refused above.
                if op & ~TRACE_FLAG & 0xFF == OP_RESOLVE:
                    conn["inflight"] += 1
                    self.queue_depth += 1
                    spawn_owned(
                        self._handle_admitted(frame, writer, conn),
                        self._tasks,
                    )
                else:
                    spawn_owned(self._handle(frame, writer), self._tasks)
        except (ShardError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - teardown best effort
                pass

    def _admission_check(self, op: int, conn: Dict) -> Optional[str]:
        """The admission decision for one incoming frame: a shed reason,
        or None for admitted.  Only OP_RESOLVE is ever shed."""
        if op & ~TRACE_FLAG & 0xFF != OP_RESOLVE:
            return None
        if (
            self.max_inflight_per_conn is not None
            and conn["inflight"] >= self.max_inflight_per_conn
        ):
            return "queue_full"
        if (
            self.max_queue_depth is not None
            and self.queue_depth >= self.max_queue_depth
        ):
            return "queue_full"
        return None

    async def _handle_admitted(self, frame: bytes, writer, conn: Dict) -> None:
        released = False

        def release() -> None:
            # The admission slot covers the resolve WORK, not the reply
            # flush: it must be free before the reply bytes can reach
            # the peer, or a well-behaved serial client races its own
            # slot (reply arrives, next request sent, worker's
            # decrement still parked behind the drain's loop yield) and
            # gets spuriously shed at maxInflightPerConn=1.  _handle
            # calls this right before writing; the finally covers every
            # early-exit path exactly once.
            nonlocal released
            if not released:
                released = True
                conn["inflight"] -= 1
                self.queue_depth -= 1

        try:
            await self._handle(frame, writer, release)
        finally:
            release()

    async def _handle(self, frame: bytes, writer, release=None) -> None:
        req_id, op = _HDR.unpack_from(frame)
        try:
            op, ctx, body = split_traced(frame, op)
        except ShardError as err:
            self.errors_total += 1
            await _answer_protocol_error(writer, req_id, err)
            return
        t0 = time.monotonic() if ctx is not None else 0.0
        try:
            # Adopt the wire context: this request's
            # resolve.query/cache.fill/zk.op subtree chains under the
            # router's relay span (or the direct caller's span) across
            # the process boundary.  A disabled tracer's adopt() is the
            # shared no-op span; the untraced path never even resolves
            # the tracer.
            with (
                trace.tracer_for(self).adopt(*ctx)
                if ctx is not None
                else NULLCTX
            ):
                reply = await self._dispatch(op, body)
            status = STATUS_OK
        except asyncio.CancelledError:
            raise
        except ShardShedError as err:
            # A deliberate overload reject (counted at the shed site),
            # not a failure: the SHED: body travels the plain error
            # rail, so every peer back to the client sees the reason.
            reply = err.payload()
            status = STATUS_ERR
        except Exception as err:  # noqa: BLE001 - one bad request != the worker
            self.errors_total += 1
            reply = repr(err).encode()
            status = STATUS_ERR
        if ctx is not None:
            # Traced reply extension: this worker's handling time, the
            # relay span's "worker" mark.
            status, reply = stamp_traced_reply(status, reply, t0)
        if release is not None:
            release()
        try:
            writer.write(pack_frame(req_id, status, reply))
            if self.write_deadline_s is None:
                await writer.drain()
            else:
                # Slow-loris armor: a peer that stops reading keeps the
                # transport's send buffer full and would park THIS task
                # (and its in-flight slot) on drain() forever.  Bound
                # the wait and abort the transport — the connection
                # handler's finally cleans up; in-flight accounting
                # unwinds through _handle_admitted's finally.
                await asyncio.wait_for(
                    writer.drain(), self.write_deadline_s
                )
        except asyncio.TimeoutError:
            self.sheds["slow_client"] += 1
            log.warning(
                "shard %d: reply write stalled > %.1fs; disconnecting "
                "slow client", self.shard_id, self.write_deadline_s,
            )
            transport = writer.transport
            if transport is not None:
                transport.abort()
        except (ConnectionError, OSError):
            pass  # requester went away; nothing owed

    async def _dispatch(self, op: int, body: memoryview) -> bytes:
        if op == OP_RESOLVE:
            return await self._resolve(body)
        if op == OP_STATUS:
            return json.dumps(self.status()).encode()
        if op == OP_DUMP:
            return json.dumps(
                {"warm": [list(pair) for pair in self.warm]}
            ).encode()
        if op == OP_WARM:
            names = json.loads(bytes(body).decode())["names"]
            for name, qtype in names:
                try:
                    res = await binderview.resolve(self.cache, name, qtype)
                    self._touch(name, qtype, encode_resolution(res))
                except Exception:  # noqa: BLE001 - warming is best-effort
                    log.warning("warm fill failed for %s (%s)", name, qtype)
            return json.dumps({"warmed": len(names)}).encode()
        if op == OP_TRACE:
            req = json.loads(bytes(body).decode()) if len(body) else {}
            dump = trace.tracer_for(self).dump(
                req.get("n"), trace_id=req.get("trace_id")
            )
            # Stamp the fragment's origin: the assembler labels each
            # span with the process it came from.
            dump["shard"] = self.shard_id
            dump["pid"] = os.getpid()
            return json.dumps(dump, default=str).encode()
        raise ShardError(f"unknown op {op}")

    async def _resolve(self, body: memoryview) -> bytes:
        if len(body) < 2:
            malformed.note("shard")
            raise ShardError(f"resolve body too short ({len(body)} bytes)")
        live = bool(body[0] & 1)
        qlen = body[1]
        if 2 + qlen > len(body):
            malformed.note("shard")
            raise ShardError(
                f"resolve qtype length {qlen} overruns body "
                f"({len(body)} bytes)"
            )
        try:
            qtype = bytes(body[2 : 2 + qlen]).decode("ascii")
            name = bytes(body[2 + qlen :]).decode("utf-8").rstrip(".").lower()
        except UnicodeDecodeError as err:
            malformed.note("shard")
            raise ShardError(f"resolve body not decodable: {err}") from err
        if live:
            res = await binderview.resolve(self.zk, name, qtype)
            self.resolves_total += 1
            return encode_resolution(res)
        try:
            res = await binderview.resolve(self.cache, name, qtype)
        except CacheOverloadError as err:
            # Cold-fill stampede shed: prefer stale over collapse — a
            # warm domain whose entry was churned out answers its
            # bounded-age last-known-good bytes instead of joining the
            # fill queue; a genuinely cold domain fails fast with the
            # explicit shed reason (never a timeout).
            self.sheds["cold_fill_shed"] += 1
            payload = self._stale_payload(name, qtype)
            if payload is None:
                raise ShardShedError("cold_fill_shed", str(err)) from err
            self.stale_serves += 1
            self.resolves_total += 1
            return payload
        except Exception as err:  # noqa: BLE001 - classified right below
            payload = self._stale_payload(name, qtype)
            if payload is None or not is_transient(err):
                raise
            # Stale-while-unreachable (class docstring): a transient
            # backend blip answers the bounded-age last-known-good
            # serialization instead of failing the whole slice.
            self.stale_serves += 1
            self.resolves_total += 1
            return payload
        self.resolves_total += 1
        payload = encode_resolution(res)
        self._touch(name, qtype, payload)
        return payload

    async def _dns_resolve(self, name: str, qtype: str):
        """The DnsFront's resolver hook: the same cache-backed resolve
        the unix-socket path uses, with overload classified into the
        DNS shed vocabulary (REFUSED, counted by reason in the front —
        NOT double-counted into the tier's ``sheds`` rollup; the DNS
        surface has its own metric family)."""
        try:
            return await binderview.resolve(self.cache, name, qtype)
        except CacheOverloadError as err:
            raise dnsfront.DnsRefused("cold_fill_shed") from err

    def _stale_payload(self, name: str, qtype: str) -> Optional[bytes]:
        entry = self.warm.get((name, qtype))
        if entry is None:
            return None
        payload, stamp = entry
        if time.monotonic() - stamp > self.max_stale_s:
            return None
        return payload

    def _touch(self, name: str, qtype: str, payload: bytes) -> None:
        key = (name, qtype)
        self.warm.pop(key, None)
        self.warm[key] = (payload, time.monotonic())
        while len(self.warm) > self.max_entries:
            self.warm.pop(next(iter(self.warm)))

    def status(self) -> Dict:
        cache = self.cache
        zk = self.zk
        return {
            "shard": self.shard_id,
            "pid": os.getpid(),
            "uptime_s": round(time.time() - self.started_at, 1),
            "resolves_total": self.resolves_total,
            "errors_total": self.errors_total,
            "stale_serves": self.stale_serves,
            "overload": {
                "queue_depth": self.queue_depth,
                "max_queue_depth": self.max_queue_depth,
                "max_inflight_per_conn": self.max_inflight_per_conn,
                "sheds": dict(self.sheds),
                "fill_sheds": (
                    int(self.cache.stats.get("fill_sheds", 0))
                    if self.cache is not None
                    else 0
                ),
            },
            "dns": self.dns.stats() if self.dns is not None else None,
            "warm": len(self.warm),
            "entries": cache.entries if cache is not None else 0,
            "authoritative": (
                cache.authoritative if cache is not None else False
            ),
            "hit_rate": round(cache.hit_rate(), 4) if cache else 0.0,
            "coherence_lag_ms_last": (
                round(cache.stats["coherence_lag_ms_last"], 3)
                if cache is not None
                else None
            ),
            "session": {
                "id": f"0x{zk.session_id:x}" if zk is not None else None,
                "connected": bool(zk is not None and zk.connected),
                "readOnly": bool(zk is not None and zk.read_only),
                "server": (
                    f"{zk.connected_server[0]}:{zk.connected_server[1]}"
                    if zk is not None and zk.connected_server
                    else None
                ),
            },
        }


async def _worker_main(spec: Dict) -> int:
    tcfg = spec.get("trace")
    if tcfg:
        # The router's observability config rides the spec: the worker
        # installs its own process-wide tracer so the instrumented
        # cache/client paths (resolve.query, cache.fill, zk.op) record
        # into a per-process flight recorder OP_TRACE can hand back.
        trace.set_tracer(
            trace.Tracer(
                sample_rate=float(tcfg.get("sampleRate", 1.0)),
                slow_span_ms=tcfg.get("slowSpanMs"),
                max_spans=int(
                    tcfg.get("maxSpans") or trace.DEFAULT_MAX_SPANS
                ),
            )
        )
    worker = ShardWorker(spec)
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, worker.stop)
    await worker.start()
    try:
        await worker.serve()
    finally:
        await worker.close()
    return 0


def worker_entry(argv: Sequence[str]) -> int:
    """``python -m registrar_tpu_torch.shard '<json spec>'`` — the spawned
    worker process's whole life."""
    logging.basicConfig(
        level=os.environ.get("SHARD_LOG_LEVEL", "WARNING"),
        format="%(asctime)s shard %(levelname)s %(message)s",
        stream=sys.stderr,
    )
    spec = json.loads(argv[0])
    return asyncio.run(_worker_main(spec))


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------


def _dns_merge(base: Dict, live: Optional[Dict]) -> Dict:
    """Accumulate one worker's live DNS stats onto banked totals.

    Counters add (queries, latency ladder, encode-cache counters,
    sheds); ``entries`` and ``port`` are point-in-time and the live
    value wins.  Shared by crash banking (bank = merge(bank, dying
    incarnation)) and the tier rollup (fold every slot's total)."""
    live = live or {}
    budp = base.get("udp") or {}
    out = {
        "port": live.get("port", base.get("port")),
        "queries": dict(base.get("queries") or {}),
        "udp": {
            "counts": list(budp.get("counts") or []),
            "sum": float(budp.get("sum") or 0.0),
        },
        "encode_cache": dict(base.get("encode_cache") or {}),
        "sheds": dict(base.get("sheds") or {}),
    }
    for key, val in (live.get("queries") or {}).items():
        out["queries"][key] = out["queries"].get(key, 0) + int(val)
    lcounts = (live.get("udp") or {}).get("counts") or []
    counts = out["udp"]["counts"]
    if len(counts) < len(lcounts):
        counts.extend([0] * (len(lcounts) - len(counts)))
    for i, val in enumerate(lcounts):
        counts[i] += int(val)
    out["udp"]["sum"] += float((live.get("udp") or {}).get("sum") or 0.0)
    for key, val in (live.get("encode_cache") or {}).items():
        if key == "entries":
            out["encode_cache"][key] = int(val)
        else:
            out["encode_cache"][key] = (
                out["encode_cache"].get(key, 0) + int(val)
            )
    for key, val in (live.get("sheds") or {}).items():
        out["sheds"][key] = out["sheds"].get(key, 0) + int(val)
    return out


class _WorkerHandle:
    """Router-side bookkeeping for one shard slot."""

    __slots__ = (
        "shard_id", "seq", "socket_path", "proc", "chan", "up",
        "up_since", "respawns", "resolves_base", "sheds_base",
        "dns_base", "last_status",
    )

    def __init__(self, shard_id: int, seq: int, socket_path: str):
        self.shard_id = shard_id
        self.seq = seq
        self.socket_path = socket_path
        self.proc: Optional[subprocess.Popen] = None
        self.chan: Optional[Channel] = None
        self.up = False
        self.up_since: Optional[float] = None
        self.respawns = 0
        #: resolves accumulated by previous incarnations — a respawned
        #: worker restarts its counter at zero, and the rolled-up
        #: registrar_shard_resolves_total must stay monotonic
        self.resolves_base = 0
        #: same banking for the shed counters (registrar_shed_total is
        #: a counter too; a respawn must not rewind it)
        self.sheds_base: Dict[str, int] = {r: 0 for r in SHED_REASONS}
        #: and for the DNS surface's counters (queries, the latency
        #: ladder, encode-cache hits) — every registrar_dns_* family
        #: must stay monotonic across worker respawns
        self.dns_base: Dict = {}
        self.last_status: Dict = {}

    def resolves_total(self) -> int:
        return self.resolves_base + int(
            self.last_status.get("resolves_total", 0)
        )

    def sheds_total(self) -> Dict[str, int]:
        """Per-reason request sheds across every incarnation of this
        slot (the cache's per-FILL ``fill_sheds`` stat stays a status
        detail — different unit, one request can shed several fills)."""
        sheds = (self.last_status.get("overload") or {}).get("sheds") or {}
        return {
            r: self.sheds_base[r] + int(sheds.get(r, 0))
            for r in SHED_REASONS
        }

    def queue_depth(self) -> int:
        return int(
            (self.last_status.get("overload") or {}).get("queue_depth", 0)
        )

    def dns_total(self) -> Dict:
        """This slot's cumulative DNS stats across every incarnation."""
        return _dns_merge(self.dns_base, self.last_status.get("dns"))


class ShardRouter(EventEmitter):
    """Parent of the sharded serve tier: spawns N :class:`ShardWorker`
    processes, consistent-hashes domains across them, supervises them
    (crash → respawn while siblings keep serving), fronts them on
    ``socket_path``, and owns resharding (:meth:`reshard`).

    Events (consumed by :func:`registrar_tpu_torch.metrics.instrument_shards`):
    ``respawn`` (shard_id), ``reshard`` (old_count, new_count, moved),
    ``poll`` (list of per-shard status dicts), ``admitted`` (seconds —
    one per successfully relayed resolve, the admitted-latency
    histogram's feed).
    """

    def __init__(
        self,
        servers: Sequence[Tuple[str, int]],
        shards: int,
        socket_path: str,
        *,
        attach_spread: str = "spread",
        chroot: Optional[str] = None,
        max_entries: Optional[int] = None,
        timeout_ms: int = 30000,
        connect_timeout_ms: int = 4000,
        request_timeout_ms: Optional[int] = None,
        vnodes: int = DEFAULT_VNODES,
        poll_interval_s: float = 1.0,
        supervise_interval_s: float = 0.05,
        python: Optional[str] = None,
        worker_log_level: Optional[str] = None,
        worker_trace: Optional[Dict] = None,
        overload: Optional[Dict] = None,
        dns: Optional[Dict] = None,
    ):
        super().__init__()
        if shards < 1:
            raise ValueError("shards must be >= 1")
        if attach_spread not in ("any", "follower", "spread"):
            raise ValueError(
                'attach_spread must be "any", "follower", or "spread"'
            )
        self.servers = [(h, int(p)) for h, p in servers]
        self.shards = shards
        self.socket_path = socket_path
        self.attach_spread = attach_spread
        self.chroot = chroot
        self.max_entries = max_entries
        self.timeout_ms = timeout_ms
        self.connect_timeout_ms = connect_timeout_ms
        self.request_timeout_ms = request_timeout_ms
        self.vnodes = vnodes
        self.poll_interval_s = poll_interval_s
        #: crash-detection + readiness-poll cadence: the
        #: respawn MTTR's fixed overhead is one detect interval plus
        #: one readiness interval — availability-tuned deployments (the
        #: SLO harness's lever mode) drop it to 0.01 s; the default is
        #: 0.05 s.
        if supervise_interval_s <= 0:
            raise ValueError("supervise_interval_s must be > 0")
        self.supervise_interval_s = supervise_interval_s
        self.python = python or sys.executable
        #: stderr log level for spawned workers (SHARD_LOG_LEVEL env;
        #: None = inherit — the SLO harness quiets its workers with it)
        self.worker_log_level = worker_log_level
        #: spec["trace"] block for spawned workers: e.g.
        #: {"sampleRate": 1.0, "maxSpans": 2048}; None = workers trace
        #: nothing: no cross-process tracing
        self.worker_trace = worker_trace
        #: overload-armor knobs (config ``serve.overload``):
        #: {"maxQueueDepth", "maxInflightPerConn", "clientRateLimit",
        #: "coldFillConcurrency", "writeDeadlineS"} — worker-side knobs
        #: ride each spawn spec, clientRateLimit is enforced HERE (a
        #: per-front-connection token bucket).  None = no armor, byte-
        #: identical specs and relays to an un-armored tier.
        self.overload = dict(overload) if overload else None
        #: DNS frontend config (config ``serve.dns``):
        #: spec-key spelling ({"host", "port", "udpPayloadMax",
        #: "negativeTtl", "maxPending", "rateLimit"}).  A port of 0 is
        #: resolved to a concrete free port HERE, once — every worker
        #: must bind the SAME port for the SO_REUSEPORT kernel fan-out.
        #: None = no DNS sockets, byte-identical specs to a tier
        #: without DNS.
        self.dns = dict(dns) if dns else None
        #: the TCP socket that keeps an allocated DNS port from any
        #: outgoing connection until :meth:`stop`, so that a worker's
        #: first bind and every respawn find it free (never listening,
        #: so every connection lands on a worker).  None for a port the
        #: operator configured: that port is the operator's.
        self._dns_reservation: Optional[socket.socket] = None
        if self.dns and not self.dns.get("port"):
            self._dns_reservation = dnsfront.reserve_port(
                self.dns.get("host", "127.0.0.1")
            )
            self.dns["port"] = self._dns_reservation.getsockname()[1]
        #: the router's own deliberate rejects (rate_limited lives here;
        #: worker reasons roll up from status polls + crash banking)
        self._sheds: Dict[str, int] = {r: 0 for r in SHED_REASONS}
        #: per-instance tracer override for the router's OWN spans
        #: (shard.relay, shard.trace_collect); None = process default
        self.tracer = None
        #: crash → respawn supervision; the SLO harness's repair-disabled
        #: runs turn this off (a withheld recovery action)
        self.respawn_enabled = True
        self.ring = HashRing(range(shards), vnodes=vnodes)
        self.generation = 0
        self.reshards = 0
        self.started_at: Optional[float] = None
        self.last_transition: Dict[str, Dict] = {}
        self._workers: Dict[int, _WorkerHandle] = {}
        self._seq = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._tasks: set = set()
        self._stopping = False
        self._reshard_lock = asyncio.Lock()

    # -- spawning -----------------------------------------------------------

    def _spec(self, shard_id: int, shards: int, socket_path: str) -> Dict:
        attach = self.attach_spread
        if attach == "spread":
            attach = f"spread:{shard_id}-of-{shards}"
        spec = {
            "socket": socket_path,
            "shard": shard_id,
            "shards": shards,
            "servers": [[h, p] for h, p in self.servers],
            "chroot": self.chroot,
            "attach": attach,
            "maxEntries": self.max_entries,
            "timeoutMs": self.timeout_ms,
            "connectTimeoutMs": self.connect_timeout_ms,
            "requestTimeoutMs": self.request_timeout_ms,
            "trace": self.worker_trace,
        }
        if self.overload:
            # Worker-side armor knobs only when configured: an un-armored
            # router's spec stays byte-identical to the un-armored format.
            for key in (
                "maxQueueDepth", "maxInflightPerConn",
                "coldFillConcurrency", "writeDeadlineS",
            ):
                if self.overload.get(key) is not None:
                    spec[key] = self.overload[key]
        if self.dns:
            # Every worker gets the SAME (already-concrete) host:port —
            # SO_REUSEPORT is the fan-out.
            spec["dns"] = dict(self.dns)
        return spec

    def _spawn_proc(self, spec: Dict) -> subprocess.Popen:
        env = dict(os.environ)
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        )
        env["PYTHONPATH"] = (
            pkg_root + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH")
            else pkg_root
        )
        if self.worker_log_level is not None:
            env["SHARD_LOG_LEVEL"] = self.worker_log_level
        return subprocess.Popen(
            [self.python, "-m", "registrar_tpu_torch.shard", json.dumps(spec)],
            env=env,
            stdout=subprocess.DEVNULL,
            stderr=None,  # worker logs land on the router's stderr
            start_new_session=True,
        )

    async def _wait_ready(self, handle: _WorkerHandle) -> None:
        deadline = time.monotonic() + READY_TIMEOUT_S
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline:
            if handle.proc is not None and handle.proc.poll() is not None:
                raise ShardError(
                    f"shard {handle.shard_id} exited rc="
                    f"{handle.proc.returncode} before becoming ready"
                )
            try:
                chan = await Channel.open(handle.socket_path)
            except (OSError, ConnectionError) as err:
                last_err = err
                await asyncio.sleep(self.supervise_interval_s)
                continue
            try:
                status, body = await asyncio.wait_for(
                    chan.request(OP_STATUS, b""), timeout=2.0
                )
            except (ShardError, asyncio.TimeoutError) as err:
                last_err = err
                await chan.close()
                await asyncio.sleep(self.supervise_interval_s)
                continue
            if status != STATUS_OK:
                await chan.close()
                raise ShardError(
                    f"shard {handle.shard_id} refused status: "
                    f"{bytes(body)!r}"
                )
            handle.chan = chan
            handle.last_status = json.loads(bytes(body).decode())
            handle.up = True
            handle.up_since = time.time()
            return
        raise ShardError(
            f"shard {handle.shard_id} never became ready "
            f"({last_err!r})"
        )

    async def _start_worker(self, shard_id: int, shards: int) -> _WorkerHandle:
        self._seq += 1
        socket_path = f"{self.socket_path}.{self._seq}"
        handle = _WorkerHandle(shard_id, self._seq, socket_path)
        handle.proc = self._spawn_proc(
            self._spec(shard_id, shards, socket_path)
        )
        try:
            await self._wait_ready(handle)
        except BaseException:
            # A worker that missed its readiness window is still a live
            # process (its connect backoff retries forever) — reap it,
            # or every failed spawn leaks an orphan holding a session.
            await self._retire_worker(handle)
            raise
        return handle

    async def _retire_worker(self, handle: _WorkerHandle) -> None:
        if handle.chan is not None:
            await handle.chan.drain_pending()
            await handle.chan.close()
            handle.chan = None
        handle.up = False
        proc = handle.proc
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                await asyncio.to_thread(proc.wait, 5)
            except subprocess.TimeoutExpired:
                proc.kill()
                await asyncio.to_thread(proc.wait)
        try:
            # A SIGTERMed worker unlinks its own socket; a SIGKILLed
            # (or never-ready) one cannot — reap the file either way.
            os.unlink(handle.socket_path)
        except OSError:
            pass

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "ShardRouter":
        started = await asyncio.gather(
            *(
                self._start_worker(sid, self.shards)
                for sid in range(self.shards)
            ),
            return_exceptions=True,
        )
        failures = [h for h in started if isinstance(h, BaseException)]
        if failures:
            for h in started:
                if isinstance(h, _WorkerHandle):
                    await self._retire_worker(h)
            self._release_dns_port()
            raise failures[0]
        for handle in started:
            self._workers[handle.shard_id] = handle
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        self._server = await asyncio.start_unix_server(
            self._on_connection, path=self.socket_path
        )
        self.started_at = time.time()
        self._mark("serve", "started")
        spawn_owned(self._supervise_loop(), self._tasks)
        log.info(
            "shard router serving %d shards on %s", self.shards,
            self.socket_path,
        )
        return self

    async def stop(self) -> None:
        self._stopping = True
        for task in list(self._tasks):
            task.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for handle in list(self._workers.values()):
            await self._retire_worker(handle)
        self._workers.clear()
        self._release_dns_port()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    def _release_dns_port(self) -> None:
        if self._dns_reservation is not None:
            self._dns_reservation.close()
            self._dns_reservation = None

    async def __aenter__(self) -> "ShardRouter":
        return await self.start()

    async def __aexit__(self, *_exc) -> None:
        await self.stop()

    def _mark(self, kind: str, state: str) -> None:
        self.last_transition[kind] = {"state": state, "at": time.time()}

    # -- supervision --------------------------------------------------------

    def kill_worker(self, shard_id: int) -> None:
        """SIGKILL one worker process (test/SLO fault injection — the
        ``shard-kill`` fault class; supervision respawns it)."""
        handle = self._workers.get(shard_id)
        if handle is None or handle.proc is None:
            raise ValueError(f"no worker for shard {shard_id}")
        handle.proc.kill()

    async def _supervise_loop(self) -> None:
        next_poll = 0.0
        while not self._stopping:
            await asyncio.sleep(self.supervise_interval_s)
            for handle in list(self._workers.values()):
                proc = handle.proc
                if (
                    handle.up
                    and proc is not None
                    and proc.poll() is not None
                ):
                    # Crashed: bank its counters (and CLEAR the dead
                    # incarnation's last status in the same breath —
                    # banking without clearing would double-count its
                    # resolves on every later read), drop the dead
                    # channel, reap its socket file, and (policy
                    # allowing) respawn — siblings keep serving their
                    # slices throughout.
                    handle.up = False
                    handle.resolves_base = handle.resolves_total()
                    handle.sheds_base = handle.sheds_total()
                    handle.dns_base = handle.dns_total()
                    handle.last_status = {}
                    if handle.chan is not None:
                        await handle.chan.close()
                        handle.chan = None
                    try:
                        os.unlink(handle.socket_path)
                    except OSError:
                        pass  # a SIGKILLed worker never unlinked it
                    log.warning(
                        "shard %d died (rc=%s)%s", handle.shard_id,
                        proc.returncode,
                        "; respawning" if self.respawn_enabled else "",
                    )
                    self._mark("serve", f"shard{handle.shard_id}-died")
                    self.emit("respawn", handle.shard_id)
                    if self.respawn_enabled:
                        spawn_owned(self._respawn(handle), self._tasks)
            now = time.monotonic()
            if now >= next_poll:
                next_poll = now + self.poll_interval_s
                await self._poll_statuses()

    async def _respawn(self, handle: _WorkerHandle) -> None:
        handle.respawns += 1
        handle.last_status = {}
        # Retry until the slot is live again (or moved on): a single
        # failed attempt must not abandon the shard forever — the
        # readiness window can miss during exactly the ensemble outage
        # the tier is supposed to serve through, and the supervise
        # loop's crash detection only fires for UP slots.
        delay = 0.5
        while True:
            current = self._workers.get(handle.shard_id)
            if current is not handle or self._stopping:
                return  # slot resharded away / router stopping
            try:
                fresh = await self._start_worker(
                    handle.shard_id, len(self.ring.shard_ids)
                )
                break
            except (ShardError, OSError) as err:
                log.error(
                    "shard %d respawn failed (retrying in %.1fs): %r",
                    handle.shard_id, delay, err,
                )
                await asyncio.sleep(delay)
                delay = min(delay * 2, 10.0)
        # Keep the slot's history (respawns, banked counters); adopt the
        # fresh incarnation's process/socket/channel.
        current = self._workers.get(handle.shard_id)
        if current is not handle or self._stopping:
            await self._retire_worker(fresh)  # slot moved on (reshard)
            return
        handle.proc = fresh.proc
        handle.seq = fresh.seq
        handle.socket_path = fresh.socket_path
        handle.chan = fresh.chan
        handle.last_status = fresh.last_status
        handle.up = True
        handle.up_since = fresh.up_since
        self._mark("serve", f"shard{handle.shard_id}-respawned")

    async def _poll_statuses(self) -> None:
        statuses = []
        for handle in list(self._workers.values()):
            if handle.chan is None:
                continue
            try:
                # Bounded: a frozen worker (alive, not scheduling) must
                # not wedge supervision — or GET /status, which rides
                # this — for every healthy sibling.
                status, body = await asyncio.wait_for(
                    handle.chan.request(OP_STATUS, b""), timeout=2.0
                )
            except (ShardError, asyncio.TimeoutError):
                continue
            if status == STATUS_OK:
                handle.last_status = json.loads(bytes(body).decode())
                statuses.append((handle.shard_id, handle.last_status))
        if statuses:
            self.emit("poll", statuses)

    # -- resharding ---------------------------------------------------------

    async def reshard(self, new_shards: int) -> Dict:
        """Change the shard count without cold-starting the tier.

        Consistent hashing bounds movement to ~K/N of the K warm
        domains; every moving domain is pre-resolved by its NEW owner
        (warm handoff by name) before the ring flips, and departing
        workers drain their in-flight replies before retirement — a
        resolver polling right through the reshard sees zero errors
        (pinned by tests/test_shard.py and bench.py's
        ``reshard_warm_handoff_ms`` measurement).
        """
        if new_shards < 1:
            raise ValueError("shards must be >= 1")
        async with self._reshard_lock:
            t0 = time.monotonic()
            old_ids = set(self.ring.shard_ids)
            new_ids = set(range(new_shards))
            if new_ids == old_ids:
                return {"moved": 0, "duration_ms": 0.0,
                        "shards": new_shards}
            # 1. Arrivals first: spawn new slots while the old ring keeps
            #    serving everything.  A partial arrival failure retires
            #    the siblings that DID come up (they are not in
            #    self._workers yet, so nothing else could ever reap
            #    them) and aborts the reshard — the old ring keeps
            #    serving untouched.
            arrivals = await asyncio.gather(
                *(
                    self._start_worker(sid, new_shards)
                    for sid in sorted(new_ids - old_ids)
                ),
                return_exceptions=True,
            )
            failures = [
                h for h in arrivals if isinstance(h, BaseException)
            ]
            if failures:
                for h in arrivals:
                    if isinstance(h, _WorkerHandle):
                        await self._retire_worker(h)
                raise failures[0]
            for handle in arrivals:
                self._workers[handle.shard_id] = handle
            new_ring = HashRing(new_ids, vnodes=self.vnodes)
            # 2. Warm handoff: every worker dumps its warm names; names
            #    whose owner changes are pre-resolved by the new owner
            #    (fresh watches armed with the read — see module
            #    docstring for why bytes never move).
            moves: Dict[int, List[List[str]]] = {}
            for handle in list(self._workers.values()):
                if handle.chan is None or handle.shard_id not in old_ids:
                    continue
                try:
                    status, body = await handle.chan.request(OP_DUMP, b"")
                except ShardError:
                    continue  # a dead worker's slice re-warms on demand
                if status != STATUS_OK:
                    continue
                for name, qtype in json.loads(bytes(body).decode())["warm"]:
                    new_owner = new_ring.owner(name)
                    if new_owner != handle.shard_id:
                        moves.setdefault(new_owner, []).append(
                            [name, qtype]
                        )
            moved = sum(len(v) for v in moves.values())
            warm_jobs = []
            for owner_id, names in moves.items():
                target = self._workers.get(owner_id)
                if target is None or target.chan is None:
                    continue
                warm_jobs.append(
                    target.chan.request(
                        OP_WARM, json.dumps({"names": names}).encode()
                    )
                )
            if warm_jobs:
                await asyncio.gather(*warm_jobs, return_exceptions=True)
            # 3. Flip — atomic between awaits; every relay from here on
            #    routes by the new ring.
            self.ring = new_ring
            self.shards = new_shards
            self.generation += 1
            self.reshards += 1
            # 4. Departures last, after their in-flight replies drain.
            for sid in sorted(old_ids - new_ids):
                handle = self._workers.pop(sid, None)
                if handle is not None:
                    await self._retire_worker(handle)
            duration_ms = (time.monotonic() - t0) * 1000.0
            self._mark("serve", f"resharded-{len(old_ids)}to{new_shards}")
            self.emit("reshard", len(old_ids), new_shards, moved)
            log.info(
                "resharded %d -> %d shards: %d warm domains moved in "
                "%.1f ms", len(old_ids), new_shards, moved, duration_ms,
            )
            return {
                "moved": moved,
                "duration_ms": duration_ms,
                "shards": new_shards,
            }

    # -- the front socket ---------------------------------------------------

    async def _on_connection(self, reader, writer) -> None:
        tasks: set = set()
        # Per-client token bucket: one bucket per front
        # connection, resolves only — control ops (status, ring, trace)
        # are the priority lane and are never rate limited.  Burst =
        # one second's refill, so a well-behaved client never notices.
        rate = float((self.overload or {}).get("clientRateLimit") or 0)
        tokens = rate
        last = time.monotonic()
        try:
            while True:
                frame = await _read_frame(reader)
                if frame is None:
                    return
                if rate > 0:
                    req_id, op = _HDR.unpack_from(frame)
                    if op & ~TRACE_FLAG & 0xFF == OP_RESOLVE:
                        now = time.monotonic()
                        tokens = min(rate, tokens + (now - last) * rate)
                        last = now
                        if tokens < 1.0:
                            # Fast-fail from the read loop, like the
                            # worker's admission reject: the client
                            # hears "rate_limited" now, not a timeout.
                            self._sheds["rate_limited"] += 1
                            writer.write(
                                pack_frame(
                                    req_id, STATUS_ERR,
                                    shed_body(
                                        "rate_limited",
                                        f"limit {rate:g}/s per client",
                                    ),
                                )
                            )
                            continue
                        tokens -= 1.0
                spawn_owned(self._serve_frame(frame, writer), tasks)
        except (ShardError, ConnectionError, OSError):
            pass
        finally:
            for task in tasks:
                task.cancel()
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - teardown best effort
                pass

    async def _serve_frame(self, frame: bytes, writer) -> None:
        req_id, op = _HDR.unpack_from(frame)
        try:
            op, ctx, body = split_traced(frame, op)
        except ShardError as err:
            await _answer_protocol_error(writer, req_id, err)
            return
        t0 = time.monotonic() if ctx is not None else 0.0
        if op == OP_RESOLVE:
            status, reply = await self._relay_resolve(body, ctx)
        elif op == OP_RING:
            status, reply = STATUS_OK, json.dumps(self.ring_info()).encode()
        elif op == OP_STATUS:
            status, reply = STATUS_OK, json.dumps(
                await self.status()
            ).encode()
        elif op == OP_TRACE:
            status, reply = await self._serve_trace(body)
        else:
            status, reply = STATUS_ERR, f"unknown op {op}".encode()
        if ctx is not None:
            # The traced-reply contract holds on EVERY hop: each peer
            # reports ITS handling time (for the router that spans
            # queue + socket + worker — the relay span's whole window),
            # so a traced client of the front socket gets its "worker"
            # mark exactly as a direct client of a worker does.
            status, reply = stamp_traced_reply(status, reply, t0)
        try:
            writer.write(pack_frame(req_id, status, reply))
            await writer.drain()
        except (ConnectionError, OSError):
            pass

    async def _serve_trace(self, body: memoryview):
        """OP_TRACE on the front socket: the ASSEMBLED cross-process
        tree (the same view GET /debug/trace?id= serves, reachable
        without a metrics listener)."""
        try:
            req = json.loads(bytes(body).decode()) if len(body) else {}
            trace_id = req.get("trace_id")
            if not trace_id:
                return STATUS_ERR, b"trace_id required"
            tree = await self.collect_trace(trace_id)
        except (ValueError, ShardError) as err:
            return STATUS_ERR, repr(err).encode()
        return STATUS_OK, json.dumps(tree, default=str).encode()

    async def _relay_resolve(self, body: memoryview, ctx=None):
        """Forward one resolve to its owner and hand back the worker's
        reply bytes untouched (the router never copies answers — the
        body view below is a slice of the worker's reply frame).

        With tracing on, the hop is a ``shard.relay`` span: adopted
        from the client's wire context (``ctx``), re-injected toward
        the worker so its subtree chains under the relay, and marked
        with the router-queue/socket/worker split (module docstring).
        """
        try:
            name = resolve_name(body).rstrip(".").lower()
        except ShardError as err:
            return STATUS_ERR, f"bad resolve request: {err!r}".encode()
        owner = self.ring.owner(name)
        handle = self._workers.get(owner)
        tracer = trace.tracer_for(self)
        if not tracer.enabled:
            # Tracing off here: forward the peer's context untouched —
            # a traced client still joins the worker's fragments even
            # through an untraced router (pass-through, no relay span).
            return await self._relay_to(handle, body, ctx, None)
        with tracer.adopt(*ctx) if ctx is not None else NULLCTX:
            with tracer.span("shard.relay", shard=owner, domain=name) as sp:
                fwd = (
                    int(sp.trace_id, 16),
                    int(sp.span_id, 16),
                    1 if sp.sampled else 0,
                )
                return await self._relay_to(handle, body, fwd, sp)

    async def _relay_to(self, handle, body, ctx, span):
        """THE one copy of the relay's error contract (down shard /
        dead channel → STATUS_ERR), shared by the traced and untraced
        paths.  A failing hop is evidence: the errored relay span says
        exactly which shard's slice refused, even when no worker
        fragment exists."""
        if handle is None or handle.chan is None:
            if span is not None:
                span.finish("error", err="shard down")
            return STATUS_ERR, b"shard down"
        t0 = time.monotonic()
        try:
            status, reply = await handle.chan.request(
                OP_RESOLVE, body, trace_ctx=ctx, span=span
            )
        except ShardError as err:
            if span is not None:
                span.finish("error", err=repr(err))
            return STATUS_ERR, repr(err).encode()
        if status == STATUS_OK:
            # One observation per ADMITTED resolve: the
            # registrar_admitted_resolve_seconds histogram's feed — a
            # shed request (refused by us or by the worker) never lands
            # here, so the histogram prices exactly the work the armor
            # let through.
            self.emit("admitted", time.monotonic() - t0)
        return status, reply

    def ring_info(self) -> Dict:
        return {
            "generation": self.generation,
            "vnodes": self.vnodes,
            "shards": [
                {
                    "shard": handle.shard_id,
                    "socket": handle.socket_path,
                    "up": handle.up,
                }
                for handle in sorted(
                    self._workers.values(), key=lambda h: h.shard_id
                )
                if handle.shard_id in self.ring.shard_ids
            ],
        }

    # -- rollup -------------------------------------------------------------

    def respawns_total(self) -> int:
        """Worker crashes detected (and, policy allowing, respawned)
        across every shard slot since start."""
        return sum(h.respawns for h in self._workers.values())

    def shard_resolves_total(self, shard_id: int) -> int:
        """Cumulative resolves served by a shard slot across every
        incarnation of its worker (the metrics rollup's monotonic
        source)."""
        handle = self._workers.get(shard_id)
        return handle.resolves_total() if handle is not None else 0

    def sheds_total(self) -> Dict[str, int]:
        """Deliberate rejects by reason, tier-wide: the router's own
        (rate_limited) plus every worker slot's rollup, monotonic
        across worker respawns (registrar_shed_total's source)."""
        out = dict(self._sheds)
        for handle in self._workers.values():
            for reason, count in handle.sheds_total().items():
                out[reason] += count
        return out

    def shard_queue_depth(self, shard_id: int) -> int:
        """The shard worker's last-polled resolve dispatch backlog
        (registrar_queue_depth's source)."""
        handle = self._workers.get(shard_id)
        return handle.queue_depth() if handle is not None else 0

    def dns_rollup(self) -> Optional[Dict]:
        """Tier-wide DNS stats: every slot's cumulative total folded
        into one dict (queries by "QTYPE RCODE", the UDP latency
        ladder, encode-cache counters, sheds) — monotonic across
        respawns; the registrar_dns_* families' source.  None when the
        DNS frontend is not configured."""
        if self.dns is None:
            return None
        out: Dict = {}
        entries = 0
        for handle in self._workers.values():
            total = handle.dns_total()
            # entries is a point-in-time gauge per worker: SUM across
            # the tier (the merge's live-wins rule is for one slot).
            entries += int((total.get("encode_cache") or {}).get(
                "entries", 0
            ))
            out = _dns_merge(out, total)
        out.setdefault("encode_cache", {})["entries"] = entries
        out["port"] = self.dns.get("port")
        return out

    def shards_down(self) -> List[int]:
        return sorted(
            sid
            for sid in self.ring.shard_ids
            if not (
                self._workers.get(sid) is not None
                and self._workers[sid].up
            )
        )

    async def status(self) -> Dict:
        """The router's ``GET /status`` snapshot: per-shard session /
        entries / coherence lag rolled up, plus the uptime_s +
        last_transition stamps the MTTR-from-status contract
        expects."""
        await self._poll_statuses()
        down = self.shards_down()
        shards: Dict[str, Dict] = {}
        for handle in sorted(
            self._workers.values(), key=lambda h: h.shard_id
        ):
            st = handle.last_status
            shards[str(handle.shard_id)] = {
                "up": handle.up,
                "pid": handle.proc.pid if handle.proc else None,
                "socket": handle.socket_path,
                "respawns": handle.respawns,
                "resolves_total": handle.resolves_total(),
                "queue_depth": handle.queue_depth(),
                "sheds": handle.sheds_total(),
                "dns": handle.dns_total() if self.dns is not None else None,
                "entries": st.get("entries", 0),
                "warm": st.get("warm", 0),
                "authoritative": st.get("authoritative", False),
                "coherence_lag_ms_last": st.get("coherence_lag_ms_last"),
                "session": st.get("session", {}),
            }
        return {
            "serve": {
                "socketPath": self.socket_path,
                "shards": self.shards,
                "generation": self.generation,
                "reshards": self.reshards,
                "attachSpread": self.attach_spread,
                "respawns_total": self.respawns_total(),
                "overload": self.overload,
                "sheds_total": self.sheds_total(),
                "dns": self.dns,
            },
            "degraded": bool(down),
            "shards_down": down,
            "shards": shards,
            "uptime_s": (
                round(time.time() - self.started_at, 1)
                if self.started_at
                else None
            ),
            "last_transition": dict(self.last_transition),
        }

    async def collect_trace(self, trace_id: str) -> Dict:
        """Assemble ONE cross-process tree for ``trace_id``.

        Fans an ``OP_TRACE`` query to every worker, merges the
        fragments with the router's own flight recorder (which in-
        process callers like the SLO harness share, so their spans fold
        in automatically), and reconstructs the parent tree via
        :mod:`registrar_tpu_torch.traceview`.  A dead or frozen worker cannot
        hand over its fragment; its absence is recorded in ``sources``
        and any span whose parent lived there surfaces under the
        ``<missing parent>`` node — a crashed worker must not silently
        erase its subtree.  ``GET /debug/trace?id=`` and ``zkcli trace
        --id`` ride this.
        """
        tracer = trace.tracer_for(self)
        entries: List[Dict] = []
        sources: List[Dict] = []

        def take(raw_entries, proc: str) -> int:
            count = 0
            for raw in raw_entries:
                entry = dict(raw)
                entry.setdefault("proc", proc)
                entries.append(entry)
                count += 1
            return count

        with tracer.span("shard.trace_collect", trace_id=trace_id) as sp:
            own = tracer.dump(trace_id=trace_id)
            sources.append(
                {
                    "proc": "router",
                    "pid": os.getpid(),
                    "entries": take(own.get("entries", ()), "router"),
                }
            )
            req = json.dumps({"trace_id": trace_id}).encode()

            async def query(handle) -> Dict:
                proc = f"shard{handle.shard_id}"
                if handle.chan is None:
                    return {"proc": proc, "error": "worker down"}
                try:
                    status, reply = await asyncio.wait_for(
                        handle.chan.request(OP_TRACE, req), timeout=2.0
                    )
                except (ShardError, asyncio.TimeoutError) as err:
                    return {"proc": proc, "error": repr(err)}
                if status != STATUS_OK:
                    return {
                        "proc": proc,
                        "error": bytes(reply).decode("utf-8", "replace"),
                    }
                return {"proc": proc, "dump": json.loads(bytes(reply))}

            # Concurrent fan-out: the per-worker queries are independent
            # pipelined channel requests, so N frozen workers cost ONE
            # 2 s window, not 2 s × N of serialized /debug/trace stall.
            answers = await asyncio.gather(
                *(
                    query(handle)
                    for handle in sorted(
                        self._workers.values(), key=lambda h: h.shard_id
                    )
                )
            )
            for answer in answers:
                dump = answer.pop("dump", None)
                if dump is not None:
                    answer["pid"] = dump.get("pid")
                    answer["entries"] = take(
                        dump.get("entries", ()), answer["proc"]
                    )
                sources.append(answer)
            sp.set_attr("entries", len(entries))
        tree = traceview.assemble(entries, trace_id)
        tree["sources"] = sources
        return tree


# ---------------------------------------------------------------------------
# Clients
# ---------------------------------------------------------------------------


def _raise_reply_error(reply) -> None:
    """Raise the client-side class for one STATUS_ERR reply: a SHED:
    body (any hop's deliberate overload reject — the router forwards
    worker error bodies verbatim) becomes :class:`ShardShedError` with
    its reason; anything else stays plain :class:`ShardError`."""
    reason = shed_reason(reply)
    text = bytes(reply).decode("utf-8", "replace")
    if reason is not None and reason in SHED_REASONS:
        detail = text[len(SHED_PREFIX) + len(reason):].strip()
        raise ShardShedError(reason, detail)
    raise ShardError(text)


class ShardClient:
    """Resolve through the router's front socket (the simple path: one
    connection, the router relays to owners)."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self._chan: Optional[Channel] = None
        #: serializes the lazy reconnect: N concurrent requests racing a
        #: dropped channel must share ONE reopen, not leak N-1 channels
        #: (each with a live reader task) to the last-write-wins store
        self._reopen_lock: Optional[asyncio.Lock] = None

    async def connect(self) -> "ShardClient":
        self._reopen_lock = asyncio.Lock()
        self._chan = await Channel.open(self.socket_path)
        return self

    async def close(self) -> None:
        if self._chan is not None:
            await self._chan.close()
            self._chan = None

    async def __aenter__(self) -> "ShardClient":
        return await self.connect()

    async def __aexit__(self, *_exc) -> None:
        await self.close()

    async def _request(
        self, op: int, body, trace_ctx: Optional[Tuple] = None
    ) -> memoryview:
        if self._chan is None or self._chan.closed:
            if self._reopen_lock is None:
                self._reopen_lock = asyncio.Lock()
            async with self._reopen_lock:
                if self._chan is None or self._chan.closed:
                    self._chan = await Channel.open(self.socket_path)
        status, reply = await self._chan.request(
            op, body, trace_ctx=trace_ctx
        )
        if status != STATUS_OK:
            _raise_reply_error(reply)
        return reply

    async def resolve(
        self, name: str, qtype: str = "A", live: bool = False
    ) -> Resolution:
        # Inject the ambient span's context: a traced caller
        # (the SLO prober, a future DNS frontend) joins its span tree
        # to the router's relay and the worker's resolve subtree.  With
        # no active span this is None and the frame is byte-identical
        # to the untraced format.
        return decode_resolution(
            await self._request(
                OP_RESOLVE,
                pack_resolve(name, qtype, live),
                trace_ctx=trace.current_context(),
            )
        )

    async def trace_tree(self, trace_id: str) -> Dict:
        """The assembled cross-process tree for ``trace_id`` (the
        router's OP_TRACE fan-out)."""
        return json.loads(
            bytes(
                await self._request(
                    OP_TRACE, json.dumps({"trace_id": trace_id}).encode()
                )
            ).decode()
        )

    async def ring(self) -> Dict:
        return json.loads(bytes(await self._request(OP_RING, b"")).decode())

    async def status(self) -> Dict:
        return json.loads(
            bytes(await self._request(OP_STATUS, b"")).decode()
        )


class ShardDirectClient:
    """The SO_REUSEPORT-shaped data plane: fetch the ring once from the
    router, then talk to every worker directly — no middleman in the
    request path (what the DNS frontend will do, and what bench.py
    measures for the scaling matrix).  Re-fetch via :meth:`refresh`
    after a reshard."""

    def __init__(self, router_socket: str):
        self.router_socket = router_socket
        self.generation: Optional[int] = None
        self._ring: Optional[HashRing] = None
        self._chans: Dict[int, Channel] = {}
        self._sockets: Dict[int, str] = {}
        #: serializes per-shard channel opens: N concurrent resolves
        #: racing a cold (or dropped) channel must share ONE open — each
        #: leaked loser would keep a live reader task forever (same
        #: hazard ShardClient's _reopen_lock guards)
        self._chan_locks: Dict[int, asyncio.Lock] = {}

    async def connect(self) -> "ShardDirectClient":
        await self.refresh()
        return self

    async def refresh(self) -> None:
        async with ShardClient(self.router_socket) as rc:
            info = await rc.ring()
        await self._close_chans()
        self.generation = info["generation"]
        self._sockets = {
            entry["shard"]: entry["socket"] for entry in info["shards"]
        }
        self._ring = HashRing(
            self._sockets.keys(), vnodes=info.get("vnodes", DEFAULT_VNODES)
        )

    async def _close_chans(self) -> None:
        chans, self._chans = self._chans, {}
        for chan in chans.values():
            await chan.close()

    async def close(self) -> None:
        await self._close_chans()

    async def __aenter__(self) -> "ShardDirectClient":
        return await self.connect()

    async def __aexit__(self, *_exc) -> None:
        await self.close()

    def owner(self, name: str) -> int:
        return self._ring.owner(name.rstrip(".").lower())

    async def channel(self, shard_id: int) -> Channel:
        chan = self._chans.get(shard_id)
        if chan is None or chan.closed:
            lock = self._chan_locks.setdefault(shard_id, asyncio.Lock())
            async with lock:
                chan = self._chans.get(shard_id)
                if chan is None or chan.closed:
                    chan = await Channel.open(self._sockets[shard_id])
                    self._chans[shard_id] = chan
        return chan

    async def resolve(
        self, name: str, qtype: str = "A", live: bool = False
    ) -> Resolution:
        chan = await self.channel(self.owner(name))
        # Same injection rule as ShardClient: the direct data plane
        # skips the router, so the worker's subtree parents straight
        # under the caller's ambient span (what the DNS frontend will
        # do — its query id maps onto this trace id).
        status, reply = await chan.request(
            OP_RESOLVE,
            pack_resolve(name, qtype, live),
            trace_ctx=trace.current_context(),
        )
        if status != STATUS_OK:
            _raise_reply_error(reply)
        return decode_resolution(reply)


if __name__ == "__main__":
    sys.exit(worker_entry(sys.argv[1:]))
