"""Asyncio ZooKeeper client — the rebuild's L1 transport.

Replaces the reference's zkplus dependency (reference lib/zk.js,
package.json:21) with a from-scratch client speaking the public ZooKeeper
3.4 wire protocol.  The surface mirrors what the upper layers of the
reference actually use (SURVEY.md §1 L1): ``put``, ``create`` (with
ephemeral-plus semantics), ``unlink``, ``mkdirp``, ``stat``, ``get``,
``get_children``, ``close``, events ``connect`` / ``close`` /
``session_expired``, plus the application-level ``heartbeat`` that the
reference monkey-patches onto the client (lib/zk.js:47-59).

Connection/session model:

  * :func:`create_zk_client` retries the initial connect forever with
    exponential backoff 1 s -> 90 s, logging each attempt and emitting
    ``attempt`` events (reference lib/zk.js:88-119).  Cancel the task to
    abort (the analog of the reference's ``retry.stop()``).
  * After a drop, the client reconnects with the same (session_id, passwd),
    re-arming watches via SetWatches.  If the server no longer knows the
    session it emits ``session_expired`` — the daemon's policy is to exit
    and let the supervisor restart it (reference main.js:141-144).
  * Session lifecycle supervisor (opt-in
    ``survive_session_expiry``): instead of the terminal
    ``session_expired``, an expiry resets the client to a fresh-session
    handshake (session_id 0, blank passwd, zxid 0) and the normal
    jittered reconnect machinery establishes a *new* session in-process,
    announced via ``session_reborn``.  The old session's ephemerals are
    gone — re-running the registration pipeline is the orchestrator's
    job (agent.py consumes the event).  A ``max_session_rebirths``-per-
    :data:`REBIRTH_WINDOW_S` circuit breaker guards against expiry
    storms (a flapping ensemble, a mis-sized session timeout): when it
    trips, the client falls back to the reference-exact terminal
    ``session_expired`` so the supervisor restart path still exists.
    Default off: expiry is terminal, byte-identical to the reference.
  * Network-fault armor: optional per-operation deadlines
    (``request_timeout_ms`` -> :class:`OperationTimeoutError`, connection
    torn down because a FIFO pipeline cannot skip a reply), a bounded
    whole-pass connect budget (``connect_pass_timeout_ms``), a liveness
    watchdog whose keepalive drain is itself deadline-bounded (a peer
    that stops *reading* must not wedge the watchdog), and jittered
    reconnect backoff by default (retry.RECONNECT_RETRY).  All proven
    against deterministic wire faults in
    :mod:`registrar_tpu_torch.testing.netem` (tests/test_netem.py).
  * Ensemble awareness: ``can_be_read_only`` opts into
    attaching to a read-only member (minority partition / quorum loss)
    so reads and heartbeats keep serving while writes fail with the
    retryable ``NOT_READONLY``; a background ``isro`` probe fails the
    session over the moment a read-write member reappears.  Unexpected
    disconnects open a ``zk.failover`` span (old member -> new member,
    including any leader-election wait), and the connect-order shuffle
    is seedable (``rng=``) for deterministic failover tests.
  * ``ephemeral_plus`` creates (zkplus's flag, used at
    reference lib/register.js:157) are ephemeral creates that transparently
    mkdirp a missing parent.  Intentional divergence, documented: this
    client does NOT silently re-create ephemerals on session re-establishment
    — re-registration is the orchestrator's job (lib/index.js re-registers,
    and main.js exits on expiry), so hiding it in the transport would mask
    real failures.
"""

from __future__ import annotations

import asyncio
import logging
import random
import re
import time
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Tuple

from registrar_tpu_torch import trace
from registrar_tpu_torch.events import EventEmitter
from registrar_tpu_torch.retry import (
    CONNECT_RETRY,
    HEARTBEAT_RETRY,
    RECONNECT_RETRY,
    RetryPolicy,
    call_with_backoff,
)
from registrar_tpu_torch.zk import protocol as proto
from registrar_tpu_torch import malformed
from registrar_tpu_torch.zk.framing import MAX_FRAME, FrameReader
from registrar_tpu_torch.zk.jute import Reader, Writer
from registrar_tpu_torch.zk.protocol import (
    CreateFlag,
    Err,
    OpCode,
    OPEN_ACL_UNSAFE,
    Stat,
    ZKError,
    check_path,
)

log = logging.getLogger("registrar_tpu_torch.zk.client")

#: Sliding window (seconds) for the session-rebirth circuit breaker: more
#: than ``max_session_rebirths`` fresh sessions within it means expiry is
#: systemic (flapping ensemble, mis-sized session timeout) and in-process
#: recovery is just churning DNS — fall back to the reference's terminal
#: ``session_expired`` so the supervisor restart path takes over.
REBIRTH_WINDOW_S = 300.0

#: default ``max_session_rebirths`` (per :data:`REBIRTH_WINDOW_S`)
DEFAULT_MAX_SESSION_REBIRTHS = 5

#: op code -> span label for the ``zk.op`` spans; an op not
#: listed is traced under its numeric code, so a new op can never
#: silently vanish from the histograms
_OP_NAMES = {
    OpCode.CREATE: "create",
    OpCode.DELETE: "delete",
    OpCode.EXISTS: "exists",
    OpCode.GET_DATA: "getData",
    OpCode.SET_DATA: "setData",
    OpCode.GET_ACL: "getAcl",
    OpCode.SET_ACL: "setAcl",
    OpCode.GET_CHILDREN: "getChildren",
    OpCode.GET_CHILDREN2: "getChildren2",
    OpCode.SYNC: "sync",
    OpCode.CHECK: "check",
    OpCode.MULTI: "multi",
    OpCode.CLOSE_SESSION: "closeSession",
}


async def four_letter_word(
    host: str, port: int, word: bytes, timeout: float = 0.5
) -> bytes:
    """One connection-less admin "four letter word" probe (``isro``,
    ``srvr``, ``mntr``, ...): connect, write the 4 ASCII bytes, read the
    text answer, close.  The ONE copy of the probe dance — the client's
    rw-hunt and zkcli's role reporting both ride it.  Raises
    OSError/asyncio.TimeoutError on an unreachable or silent member.
    """
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout
    )
    try:
        writer.write(word)
        await writer.drain()
        return await asyncio.wait_for(reader.read(1 << 16), timeout)
    finally:
        writer.close()


def _parse_attach_preference(pref: str) -> Optional[Tuple[int, int]]:
    """Validate an ``attach_preference`` and extract the spread slot.

    Returns ``(k, n)`` for ``"spread:<k>-of-<n>"`` (k in [0, n)), None
    for ``"any"`` / ``"follower"``; raises ValueError on anything else —
    a typo'd hint must fail at construction, not silently mean "any".
    """
    if pref in ("any", "follower"):
        return None
    m = re.fullmatch(r"spread:(\d+)-of-(\d+)", pref or "")
    if m is None:
        raise ValueError(
            f"attach_preference must be 'any', 'follower', or "
            f"'spread:<k>-of-<n>' (got {pref!r})"
        )
    k, n = int(m.group(1)), int(m.group(2))
    if n < 1 or not 0 <= k < n:
        raise ValueError(
            f"attach_preference spread slot out of range: {pref!r}"
        )
    return (k, n)


_ROLE_RANK = {"follower": 0, "standalone": 1, "leader": 3}


async def _probe_roles(
    order: "List[Tuple[str, int]]", timeout: float
) -> "List[Tuple[str, int]]":
    """Stable-partition a candidate order by replication role, probed
    off each member's ``srvr`` 4lw concurrently: followers first, the
    leader last, unknown/unreachable members in place (rank 2 — ahead
    of the leader: an unanswered probe usually means a member mid-
    restart, still a better watch host than the leader).  Never raises:
    the hint must not make an unreachable ensemble less reachable."""

    async def role_rank(host: str, port: int) -> int:
        try:
            raw = await four_letter_word(host, port, b"srvr", timeout)
        except (OSError, ValueError, asyncio.TimeoutError):
            return 2
        for line in raw.decode("latin-1", "replace").splitlines():
            if line.startswith("Mode: "):
                return _ROLE_RANK.get(line[len("Mode: "):].strip(), 2)
        return 2

    ranks = await asyncio.gather(
        *(role_rank(h, p) for h, p in order)
    )
    return [
        server
        for _rank, _i, server in sorted(
            (rank, i, server)
            for i, (rank, server) in enumerate(zip(ranks, order))
        )
    ]


class ZKClient(EventEmitter):
    """One logical ZooKeeper session over a sequence of TCP connections.

    Events: ``connect`` (session (re)established), ``close`` (transport
    lost or client closed), ``session_expired`` (server disowned our
    session), ``state`` (every transition, with the state string).
    """

    def __init__(
        self,
        servers: Sequence[Tuple[str, int]],
        timeout_ms: int = 30000,
        connect_timeout_ms: int = 4000,
        reconnect: bool = True,
        reconnect_policy: Optional[RetryPolicy] = None,
        chroot: Optional[str] = None,
        request_timeout_ms: Optional[int] = None,
        connect_pass_timeout_ms: Optional[int] = None,
        survive_session_expiry: bool = False,
        max_session_rebirths: Optional[int] = None,
        can_be_read_only: bool = False,
        rng: Optional[random.Random] = None,
        attach_preference: str = "any",
        connect_race_stagger_ms: Optional[int] = None,
        ping_interval_ms: Optional[int] = None,
        dead_after_ms: Optional[int] = None,
    ):
        """``request_timeout_ms``: per-operation deadline.  When set, every
        awaited reply is bounded; on expiry the connection is torn down
        (ZooKeeper answers FIFO — one reply cannot be skipped without
        desynchronizing every later one, so the only safe recovery is a
        fresh connection) and the op raises
        :class:`OperationTimeoutError`, which
        :func:`registrar_tpu_torch.retry.is_transient` classifies as retryable.
        Default None = wait forever (reference behavior), leaving stall
        detection to the session watchdog alone.

        ``connect_pass_timeout_ms``: bound on ONE whole pass of
        :meth:`connect` over the server list.  Without it, each candidate
        gets ``connect_timeout_ms`` and a long list of blackholed servers
        can stall a reconnect far past the session timeout; the default
        bound is the session timeout itself (``timeout_ms``).

        ``survive_session_expiry``: opt into the in-process session
        lifecycle supervisor (module docstring) — expiry resets to a
        fresh-session handshake and the reconnect machinery builds a new
        session, announced via ``session_reborn``, instead of the
        terminal ``session_expired``.  ``max_session_rebirths`` bounds
        rebirths per :data:`REBIRTH_WINDOW_S` (default
        :data:`DEFAULT_MAX_SESSION_REBIRTHS`); past it the breaker trips
        (``rebirth_breaker_tripped`` event) and expiry is terminal
        again.

        ``can_be_read_only`` (the Apache client's
        ``canBeReadOnly``, config ``zookeeper.canBeReadOnly``): opt into
        attaching to a read-only ensemble member (one partitioned to a
        minority, or riding out quorum loss) when no read-write member
        answers.  Reads and the heartbeat's EXISTS sweep keep working
        there; writes fail with the retryable ``NOT_READONLY`` (surfaced
        as the ``write_refused`` event) while a background probe polls
        the other members' ``isro`` 4lw and fails the session over the
        moment a read-write member appears (``rw_probe_interval_s``).
        Default False: the reference-exact wire bytes, and read-only
        members refuse us at the handshake.

        ``rng`` seeds the connect-order shuffle (and nothing else), so
        ensemble failover tests and chaos storms are deterministic per
        CHAOS_SEED; default is the module RNG (reference behavior).

        ``attach_preference``: a connect-ORDER hint so a
        fleet of read-heavy clients (the sharded serve tier's workers)
        spreads its watch load across ensemble members instead of
        piling onto whichever member the shuffle favors:

          * ``"any"`` — the default: seeded shuffle, reference-exact
            behavior;
          * ``"follower"`` — shuffle first (``rng`` still honored),
            then probe each candidate's ``srvr`` 4lw concurrently and
            stable-partition the order so followers come first and the
            leader last (watch fan-out belongs on followers; the leader
            has writes to order).  Probe failures leave a candidate in
            place — the hint never makes an unreachable ensemble less
            reachable;
          * ``"spread:<k>-of-<n>"`` — worker k of n starts its pass at
            a deterministic rotation of the CONFIGURED server order
            (``rng`` is deliberately ignored: distinct workers must
            land on distinct members, which a per-process shuffle would
            undo).  Later candidates still serve as failover targets.

        It is a *hint*: reachability always wins over preference.

        ``connect_race_stagger_ms`` (RFC 8305's staggered
        "happy eyeballs" applied to the ensemble): when set, a connect
        pass races candidates — attempt k starts ``stagger`` ms after
        attempt k-1 (or immediately once an earlier attempt fails), and
        the FIRST successful read-write handshake wins while the losers
        are aborted cleanly (a loser that minted its own fresh session
        sends CLOSE_SESSION before hanging up, so raced fresh connects
        never orphan sessions).  A dead-or-blackholed first candidate
        therefore costs ~one stagger, not a full ``connect_timeout_ms``.
        Default None: the serial reference-exact pass.

        ``ping_interval_ms`` / ``dead_after_ms``: override
        the keepalive/watchdog schedule.  The defaults are the Apache
        client's thirds rule — ping every negotiated/3, declare the
        server dead after 2/3 of the negotiated timeout with no frame —
        which ties blackhole detection to the session timeout.  Setting
        these detects a silent server in a fraction of that (the
        connection drops early and the reconnect machinery races to a
        healthy member while the session is still very much alive).
        ``dead_after_ms`` is floored at the effective ping interval.
        Default None/None: the reference-exact schedule."""
        super().__init__()
        servers = list(servers)
        if not servers:
            raise ValueError("servers must be non-empty")
        for host, port in servers:
            if not isinstance(host, str) or not isinstance(port, int):
                raise ValueError("servers must be (host, port) pairs")
        self.servers = servers
        # Validated-path cache, scoped to this client so its hot entries
        # (the instance's own znode paths, re-validated every heartbeat
        # sweep) can never be evicted by other clients' traffic — or by
        # the test server, which validates untrusted peer paths uncached
        # (see protocol.PathCache).
        self._path_cache = proto.PathCache()
        # Chroot: every path this client sends is prefixed with it and
        # every path the server returns (created paths, watch events) has
        # it stripped — the standard "host:port/app" suffix semantics of
        # the Apache client.  The chroot node itself must already exist
        # (like real clients, nothing is auto-created).
        if chroot in (None, "", "/"):
            self.chroot = ""
        else:
            check_path(chroot)
            self.chroot = chroot
        self.requested_timeout_ms = timeout_ms
        self.connect_timeout_ms = connect_timeout_ms
        self.request_timeout_ms = request_timeout_ms
        self.connect_pass_timeout_ms = connect_pass_timeout_ms
        self.reconnect = reconnect
        # Default reconnects use decorrelated jitter (RECONNECT_RETRY): a
        # fleet dropped by an ensemble restart must not retry in lockstep.
        self.reconnect_policy = reconnect_policy or RECONNECT_RETRY
        self.survive_session_expiry = survive_session_expiry
        self.can_be_read_only = can_be_read_only
        #: seeds the connect-order shuffle only (None = module RNG)
        self._rng = rng if rng is not None else random
        #: connect-order hint ("any" | "follower" | "spread:<k>-of-<n>")
        self.attach_preference = attach_preference
        self._attach_spread = _parse_attach_preference(attach_preference)
        if connect_race_stagger_ms is not None and connect_race_stagger_ms < 0:
            raise ValueError("connect_race_stagger_ms must be >= 0")
        for name, value in (
            ("ping_interval_ms", ping_interval_ms),
            ("dead_after_ms", dead_after_ms),
        ):
            if value is not None and value <= 0:
                raise ValueError(f"{name} must be > 0")
        #: None = serial reference pass; >=0 = raced connects (stagger)
        self.connect_race_stagger_ms = connect_race_stagger_ms
        #: None/None = the reference thirds-rule keepalive schedule
        self.ping_interval_ms = ping_interval_ms
        self.dead_after_ms = dead_after_ms
        #: raced-connect outcome (satellite: zkcli status / GET /status):
        #: wins counts passes the raced path decided; last_* describe the
        #: most recent pass (winning member, candidates dialed, losers
        #: aborted).  All zero/None under the serial reference path.
        self.race_stats = {
            "wins": 0,
            "last_winner": None,
            "last_candidates": 0,
            "last_aborted": 0,
        }
        #: seconds the last unexpected teardown -> reconnect took; None
        #: until the first failover completes
        self.last_failover_s: Optional[float] = None
        self._failover_started_at: Optional[float] = None
        #: connections dropped by the liveness watchdog / stalled-drain
        #: detector (the failure detector's suspicion count)
        self.watchdog_drops = 0
        #: True while the session is attached to a read-only member
        #: (ConnectResponse read_only flag); reads serve, writes refuse
        self.read_only = False
        #: cadence of the isro sweep hunting a read-write member while
        #: attached read-only (the Apache client's pingRwTimeout start)
        self.rw_probe_interval_s = 1.0
        #: rw member found by the probe — tried first on the next connect
        self._prefer_rw: Optional[Tuple[str, int]] = None
        self._rw_probe_task: Optional[asyncio.Task] = None
        #: open ``zk.failover`` span while the session is between
        #: members (unexpected teardown -> next successful connect)
        self._failover_span = None
        if max_session_rebirths is not None and max_session_rebirths < 1:
            raise ValueError("max_session_rebirths must be >= 1")
        self.max_session_rebirths = (
            max_session_rebirths
            if max_session_rebirths is not None
            else DEFAULT_MAX_SESSION_REBIRTHS
        )
        #: total fresh sessions established in-process after an expiry
        self.rebirths = 0
        #: monotonic stamps of recent rebirths (circuit-breaker window)
        self._rebirth_times: Deque[float] = deque()
        #: an expiry was absorbed; the next successful connect is a rebirth
        self._rebirth_pending = False
        #: a cross-process handoff resume is staged (seed_session); a
        #: refused reattach then degrades to a fresh-session handshake
        #: instead of the terminal session_expired
        self._resume_pending = False

        self.session_id = 0
        self.session_passwd = b"\x00" * 16
        self.negotiated_timeout_ms = timeout_ms
        self.last_zxid = 0
        #: (host, port) the session is currently attached through (the
        #: server list is shuffled on connect, so callers reporting "where
        #: am I connected" must read this, not servers[0])
        self.connected_server: Optional[Tuple[str, int]] = None

        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._xid = 0
        self._pending: Deque[Tuple[int, asyncio.Future]] = deque()
        self._corked: Optional[List[bytes]] = None
        self._read_task: Optional[asyncio.Task] = None
        self._ping_task: Optional[asyncio.Task] = None
        self._reconnect_task: Optional[asyncio.Task] = None
        self._closed = False
        self._connected = False
        self._last_response = 0.0  # monotonic time of last server frame
        # one-shot watches to re-arm after reconnect: kind -> set of paths
        self._watch_paths = {"data": set(), "exist": set(), "child": set()}
        self._watch_emitter = EventEmitter()
        # credentials added via add_auth, replayed on every (re)connect the
        # way the Apache client replays its authInfo list
        self._auths: List[Tuple[str, bytes]] = []
        #: per-instance tracer override; None = the process
        #: default via trace.tracer_for — a disabled default makes every
        #: tracing branch below a no-op
        self.tracer = None
        #: in-flight ``zk.op`` spans by xid (only populated while a
        #: tracer is enabled; emptied by reply dispatch and teardown)
        self._op_spans: dict = {}
        #: xids posted since the last drain — their spans get the
        #: ``flushed`` mark (the queue/wire split) when the drain lands
        self._unflushed: List[int] = []

    # -- state --------------------------------------------------------------

    @property
    def connected(self) -> bool:
        return self._connected

    @property
    def closed(self) -> bool:
        return self._closed

    def __str__(self) -> str:
        hosts = ",".join(f"{h}:{p}" for h, p in self.servers)
        return f"ZKClient({hosts}, session=0x{self.session_id:x})"

    # -- connection management ----------------------------------------------

    def seed_session(
        self,
        session_id: int,
        passwd: bytes,
        negotiated_timeout_ms: Optional[int] = None,
        last_zxid: int = 0,
    ) -> None:
        """Stage a cross-process session resume (handoff).

        The next :meth:`connect` offers ``(session_id, passwd)`` to the
        server exactly as an in-process reconnect would, reattaching the
        predecessor's live session — its ephemerals never flickered.  If
        the server refuses (the session expired in the gap), the client
        resets to a fresh-session handshake and stays OPEN: the refusing
        attempt raises :class:`SessionExpiredError`, and the caller's
        retry loop establishes a brand-new session on the next attempt —
        never the terminal ``session_expired``.  Callers detect the
        outcome by comparing ``client.session_id`` to the seed after the
        connect lands (``resume_refused`` also fires on refusal).

        ``last_zxid`` seeds the ConnectRequest's ``last_zxid_seen``, so a
        server behind the predecessor's view refuses the reattach the
        same way it would refuse a too-new in-process reconnect.
        """
        if self._connected or self._closed:
            raise RuntimeError("seed_session requires a fresh, open client")
        if not isinstance(passwd, bytes) or len(passwd) != 16:
            raise ValueError("session passwd must be exactly 16 bytes")
        self.session_id = session_id
        self.session_passwd = passwd
        self.last_zxid = last_zxid
        if negotiated_timeout_ms is not None:
            # The predecessor's negotiated value sizes the watchdog and
            # ping cadence correctly from the first connection.
            self.negotiated_timeout_ms = negotiated_timeout_ms
        self._resume_pending = True

    async def detach(self) -> None:
        """Close the transport WITHOUT closing the session (handoff).

        The inverse of :meth:`close`: no CLOSE_SESSION is sent, so the
        server keeps the session — and every ephemeral it owns — alive
        for the rest of the negotiated timeout, long enough for a
        successor process to reattach it via :meth:`seed_session`.  The
        client object itself is finished (no reconnects, operations fail
        closed), exactly like close() from the caller's point of view.
        """
        if self._closed:
            return
        self._closed = True
        if self._reconnect_task:
            self._reconnect_task.cancel()
        self._abort_failover_span()
        await self._teardown(expected=True)

    async def _connect_order(self) -> List[Tuple[str, int]]:
        """Candidate order for one connect pass, per
        ``attach_preference`` (constructor docstring): seeded shuffle
        ("any"), shuffle + role-probed follower-first ("follower"), or
        a deterministic rotation of the configured order ("spread") so
        worker k of n starts at a distinct member."""
        order = list(self.servers)
        if self._attach_spread is not None:
            k, n = self._attach_spread
            # No shuffle: determinism IS the feature (two workers with
            # different slots must not converge by shuffle luck).
            start = (k * len(order)) // n % len(order)
            return order[start:] + order[:start]
        self._rng.shuffle(order)
        if self.attach_preference == "follower" and len(order) > 1:
            order = await _probe_roles(
                order, timeout=min(0.5, self.connect_timeout_ms / 1000.0)
            )
        return order

    async def connect(self) -> "ZKClient":
        """Connect (or reconnect) to the first reachable server.

        Single pass over the server list in random order; raises on total
        failure.  The WHOLE pass is bounded by ``connect_pass_timeout_ms``
        (default: the session timeout), not just each candidate by
        ``connect_timeout_ms`` — a long list of slow or blackholed servers
        must not stall one reconnect attempt past the point where the
        session it is trying to save has already expired.  Use
        :func:`create_zk_client` for the reference's infinite-backoff
        behavior.

        With ``can_be_read_only``, read-write members are preferred: a
        member that answers the handshake read-only is noted and the
        pass keeps looking; only when no read-write member answered is
        the read-only fallback reattached (degraded: reads serve, writes
        refuse until the rw-probe finds a majority member).
        """
        if self._closed:
            raise ZKError(Err.SESSION_EXPIRED, None)
        last_err: Optional[Exception] = None
        order = await self._connect_order()
        prefer, self._prefer_rw = self._prefer_rw, None
        if prefer is not None and prefer in order:
            # The rw-probe found a read-write member: leave read-only
            # mode for it deterministically, not by shuffle luck.
            order.remove(prefer)
            order.insert(0, prefer)
        pass_timeout_ms = (
            self.connect_pass_timeout_ms
            if self.connect_pass_timeout_ms is not None
            else self.requested_timeout_ms
        )
        deadline = time.monotonic() + pass_timeout_ms / 1000.0
        if self.connect_race_stagger_ms is not None:
            # staggered raced connects — opt-in; the serial
            # reference-exact pass below runs when the knob is absent.
            return await self._connect_raced(order, deadline)
        ro_fallback: Optional[Tuple[str, int]] = None
        for host, port in order:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                await self._connect_one(
                    host, port, max_wait=remaining, allow_read_only=False
                )
                return self
            except _ReadOnlyMember:
                # Keep hunting for a read-write member; come back to
                # this one only if the whole pass finds none.
                if ro_fallback is None:
                    ro_fallback = (host, port)
                log.debug("%s:%d is read-only; continuing the pass", host, port)
            except SessionExpiredError:
                raise
            except asyncio.CancelledError:
                raise
            except Exception as err:  # noqa: BLE001 - try next server
                last_err = err
                log.debug("connect to %s:%d failed: %r", host, port, err)
        if ro_fallback is not None:
            remaining = deadline - time.monotonic()
            try:
                await self._connect_one(
                    ro_fallback[0], ro_fallback[1],
                    max_wait=max(remaining, 0.05), allow_read_only=True,
                )
                return self
            except SessionExpiredError:
                raise
            except asyncio.CancelledError:
                raise
            except Exception as err:  # noqa: BLE001 - fall through to raise
                last_err = err
        raise (
            last_err
            if last_err
            else ConnectionError("no servers within the connect pass budget")
        )

    async def _connect_raced(
        self, order: List[Tuple[str, int]], deadline: float
    ) -> "ZKClient":
        """Happy-eyeballs connect pass (RFC 8305 shape).

        Candidates start ``connect_race_stagger_ms`` apart (a failure
        releases the next immediately); the first successful read-write
        handshake wins and every other attempt is aborted.  A loser that
        completed a handshake on a session OTHER than the winner's (a
        fresh client races fresh-session handshakes, each minting its
        own) best-effort sends CLOSE_SESSION before hanging up, so the
        race never strands orphan sessions on the ensemble.  A read-only
        handshake is HELD open as the fallback while the race keeps
        hunting read-write — adopted directly if nothing better lands
        (one dial cheaper than the serial pass's re-dial)."""
        stagger_s = self.connect_race_stagger_ms / 1000.0
        pending = list(order)
        tasks: Dict[asyncio.Task, Tuple[str, int]] = {}
        attempted = 0
        last_err: Optional[Exception] = None
        #: held read-only fallback: (host, port, reader, writer, resp)
        ro_held: Optional[tuple] = None
        #: completed-but-unadopted handshakes needing loser cleanup
        losers: List[tuple] = []
        adopted = False

        def spawn() -> None:
            nonlocal attempted
            host, port = pending.pop(0)
            remaining = deadline - time.monotonic()
            task = asyncio.create_task(
                self._dial_handshake(host, port, max_wait=remaining)
            )
            tasks[task] = (host, port)
            attempted += 1

        try:
            spawn()
            next_spawn = time.monotonic() + stagger_s
            while tasks:
                timeout = deadline - time.monotonic()
                if pending:
                    timeout = min(timeout, next_spawn - time.monotonic())
                done, _ = await asyncio.wait(
                    set(tasks),
                    timeout=max(timeout, 0.0),
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if not done:
                    if time.monotonic() >= deadline:
                        break
                    if pending:
                        spawn()
                        next_spawn = time.monotonic() + stagger_s
                    continue
                winner: Optional[tuple] = None
                for task in done:
                    host, port = tasks.pop(task)
                    if task.cancelled():
                        continue
                    try:
                        reader, writer, resp = task.result()
                    except SessionExpiredError:
                        raise
                    except Exception as err:  # noqa: BLE001 - next candidate
                        last_err = err
                        log.debug(
                            "raced connect to %s:%d failed: %r",
                            host, port, err,
                        )
                        # A fast failure frees the slot: the next
                        # candidate starts now, not at the stagger mark.
                        next_spawn = time.monotonic()
                        continue
                    if resp.read_only:
                        if ro_held is None:
                            # ADOPT the session the handshake minted (the
                            # serial pass does the same — see _connect_one's
                            # orphan rationale) and keep the live transport
                            # as the fallback while the race keeps hunting.
                            self.session_id = resp.session_id
                            self.session_passwd = resp.passwd
                            self.negotiated_timeout_ms = resp.timeout_ms
                            ro_held = (host, port, reader, writer, resp)
                        else:
                            losers.append((reader, writer, resp))
                        continue
                    if winner is None:
                        winner = (host, port, reader, writer, resp)
                    else:
                        losers.append((reader, writer, resp))
                if winner is not None:
                    host, port, reader, writer, resp = winner
                    if ro_held is not None:
                        losers.append(ro_held[2:])
                        ro_held = None
                    adopted = True
                    self.race_stats["wins"] += 1
                    self.race_stats["last_winner"] = f"{host}:{port}"
                    self.race_stats["last_candidates"] = attempted
                    await self._adopt_connection(host, port, reader, writer, resp)
                    return self
                while (
                    pending
                    and time.monotonic() >= next_spawn
                    and time.monotonic() < deadline
                ):
                    spawn()
                    next_spawn = time.monotonic() + stagger_s
            if ro_held is not None:
                # No read-write member answered: degrade onto the held
                # read-only handshake (reads serve; the rw-probe loop
                # fails over the moment quorum returns).
                host, port, reader, writer, resp = ro_held
                ro_held = None
                adopted = True
                self.race_stats["wins"] += 1
                self.race_stats["last_winner"] = f"{host}:{port}"
                self.race_stats["last_candidates"] = attempted
                await self._adopt_connection(host, port, reader, writer, resp)
                return self
            raise (
                last_err
                if last_err
                else ConnectionError("no servers within the connect pass budget")
            )
        finally:
            for task in tasks:
                task.cancel()
            if tasks:
                stragglers = await asyncio.gather(
                    *tasks, return_exceptions=True
                )
                losers.extend(
                    r for r in stragglers if isinstance(r, tuple)
                )
            if ro_held is not None and not adopted:
                losers.append(ro_held[2:])
            if losers:
                keep = self.session_id if adopted else 0
                self.race_stats["last_aborted"] = len(losers)
                await self._abort_losers(losers, keep_session=keep)
            elif adopted:
                self.race_stats["last_aborted"] = 0

    async def _abort_losers(
        self, losers: List[tuple], keep_session: int
    ) -> None:
        """Close out raced handshakes that lost.

        A loser attached to the SAME session as the winner (a reconnect
        race: every attempt offered our existing session) just drops its
        transport — CLOSE_SESSION there would kill the session the
        winner is using.  A loser on a DIFFERENT session (fresh-session
        races mint one per handshake) closes it first, so the ensemble
        never accumulates orphans that, under quorum loss, could not
        even expire."""
        for reader, writer, resp in losers:
            try:
                if resp.session_id != keep_session:
                    writer.write(
                        proto.encode_request(1, OpCode.CLOSE_SESSION)
                    )
                    await asyncio.wait_for(writer.drain(), timeout=0.25)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - best-effort cleanup
                pass
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _connect_one(
        self,
        host: str,
        port: int,
        max_wait: Optional[float] = None,
        allow_read_only: bool = True,
    ) -> None:
        reader, writer, resp = await self._dial_handshake(
            host, port, max_wait=max_wait
        )
        if resp.read_only and not allow_read_only:
            # A read-only member while the pass is still hunting for a
            # read-write one: drop the TRANSPORT only (no CLOSE_SESSION
            # — the session stays alive server-side, exactly like a
            # reconnect) and let connect() note the fallback.  ADOPT the
            # session the handshake just established/attached first: a
            # fresh client that hunted past N read-only members would
            # otherwise mint a new session per refused handshake —
            # orphans that, under quorum loss (leader-only expiry),
            # could never be reaped.  The fallback (or the next pass)
            # reattaches this same session instead.
            self.session_id = resp.session_id
            self.session_passwd = resp.passwd
            self.negotiated_timeout_ms = resp.timeout_ms
            writer.close()
            raise _ReadOnlyMember()
        await self._adopt_connection(host, port, reader, writer, resp)

    async def _dial_handshake(
        self,
        host: str,
        port: int,
        max_wait: Optional[float] = None,
    ) -> Tuple[asyncio.StreamReader, asyncio.StreamWriter,
               "proto.ConnectResponse"]:
        """Dial one candidate and run the ConnectRequest handshake.

        State-free with respect to the client's connection fields: the
        returned transport has NOT been installed (no read loop, no ping
        loop, session fields untouched) — :meth:`_adopt_connection`
        does that for whichever handshake the caller picks.  Shared
        byte-for-byte by the serial pass and the raced pass, so the two
        connect modes cannot drift apart on the wire."""
        per_step = self.connect_timeout_ms / 1000.0
        # The pass budget is CUMULATIVE across the dial/handshake steps: a
        # server that trickles — dial completes just in time, then the
        # header, then never the payload — must not get a fresh allowance
        # per step, or one candidate overshoots the whole-pass bound by
        # the number of steps (see connect()).
        deadline = None if max_wait is None else time.monotonic() + max_wait

        def step_timeout() -> float:
            if deadline is None:
                return per_step
            return min(per_step, max(deadline - time.monotonic(), 0.001))

        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), step_timeout()
        )
        try:
            req = proto.ConnectRequest(
                protocol_version=0,
                last_zxid_seen=self.last_zxid,
                timeout_ms=self.requested_timeout_ms,
                session_id=self.session_id,
                passwd=self.session_passwd,
                # The 3.4 wire flag: without it a read-only member
                # refuses the handshake outright (and with the default
                # can_be_read_only=False the bytes stay reference-exact).
                read_only=self.can_be_read_only,
            )
            w = Writer()
            req.write(w)
            writer.write(proto.frame(w.to_bytes()))
            await asyncio.wait_for(writer.drain(), step_timeout())
            hdr = await asyncio.wait_for(reader.readexactly(4), step_timeout())
            length = int.from_bytes(hdr, "big", signed=True)
            if length < 0 or length > MAX_FRAME:
                # A garbage length prefix here is pre-session: nothing
                # to resynchronize against, so drop the connection (the
                # reconnect loop owns the retry).
                malformed.note("zk_client")
                raise ConnectionError(f"bad handshake frame length {length}")
            payload = await asyncio.wait_for(
                reader.readexactly(length), step_timeout()
            )
            resp = proto.ConnectResponse.read(Reader(payload))
        except BaseException:
            # BaseException, not Exception: a raced attempt that loses
            # gets CancelledError mid-handshake and must still close its
            # half-open socket.
            writer.close()
            raise

        if resp.session_id == 0 or resp.timeout_ms <= 0:
            # Server refused to (re)attach the session: it has expired.
            writer.close()
            self._emit_expired()
            raise SessionExpiredError()
        return reader, writer, resp

    async def _adopt_connection(
        self,
        host: str,
        port: int,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        resp: "proto.ConnectResponse",
    ) -> None:
        """Install a successful handshake as THE connection: session
        fields, read/ping loops, auth replay, watch re-arm, events."""
        reattached = self.session_id == resp.session_id and self.session_id != 0
        # NOT consumed yet: the handshake tail below (auth replay, watch
        # re-arm) still awaits, and a drop there aborts this attempt —
        # the flag must survive so the NEXT attempt (which will reattach
        # the fresh session, session_id != 0 now) still announces the
        # rebirth.  Consuming early silently loses session_reborn and
        # the agent never re-registers (a live session with no
        # registration — the outage this feature exists to prevent).
        reborn = self._rebirth_pending
        self.session_id = resp.session_id
        self.session_passwd = resp.passwd
        self.negotiated_timeout_ms = resp.timeout_ms
        self.connected_server = (host, port)
        self.read_only = bool(resp.read_only)
        self._reader = reader
        self._writer = writer
        self._connected = True
        self._last_response = time.monotonic()
        self._read_task = asyncio.create_task(self._read_loop())
        self._ping_task = asyncio.create_task(self._ping_loop())
        await self._replay_auths()
        if reattached or reborn:
            # A reborn session re-arms its watch registrations too: the
            # listeners are still alive and SetWatches with zxid 0 makes
            # the server deliver (conservatively) any transition the
            # watched paths saw, so no watcher silently goes dead across
            # the session boundary.
            await self._rearm_watches()
        log.debug(
            "connected to %s:%d session=0x%x timeout=%dms%s",
            host, port, self.session_id, self.negotiated_timeout_ms,
            " (read-only)" if self.read_only else "",
        )
        if self._failover_started_at is not None:
            # The whole between-members window (teardown -> this
            # handshake), surfaced via GET /status for the "why was
            # recovery slow" runbook question.
            self.last_failover_s = time.monotonic() - self._failover_started_at
            self._failover_started_at = None
        if self._failover_span is not None:
            # Failover complete: the span's duration is the whole
            # between-members window (including any election wait).
            sp, self._failover_span = self._failover_span, None
            sp.set_attr("to", f"{host}:{port}")
            sp.set_attr("read_only", self.read_only)
            sp.finish()
        self.emit(
            "state", "connected_read_only" if self.read_only else "connected"
        )
        self.emit("connect")
        if self.read_only:
            # Degraded attach: serve reads here while a background isro
            # sweep hunts for a read-write member to fail writes over to
            # (the Apache client's "Majority server found" probe).
            # Started only now — after the handshake tail (auth replay,
            # watch re-arm) — and the loop sleeps before its first poll,
            # so the probe's teardown can never race the connect it
            # rides on.
            self._rw_probe_task = asyncio.create_task(self._rw_probe_loop())
        if self._resume_pending:
            # Consumed only on full success, like the rebirth marker
            # above: a drop in the handshake tail leaves the next
            # attempt still counting as the staged resume.
            self._resume_pending = False
            log.warning(
                "session 0x%x resumed across a process boundary "
                "(handoff state file)", self.session_id,
            )
            trace.tracer_for(self).event(
                "zk.session_resumed", session=f"0x{self.session_id:x}"
            )
            self.emit("session_resumed", self.session_id)
        if reborn:
            self._rebirth_pending = False  # consumed only on full success
            self.rebirths += 1
            log.warning(
                "session reborn: fresh session 0x%x established in-process "
                "(rebirth %d)", self.session_id, self.rebirths,
            )
            trace.tracer_for(self).event(
                "zk.session_reborn",
                session=f"0x{self.session_id:x}", rebirth=self.rebirths,
            )
            self.emit("session_reborn", self.session_id)

    async def _replay_auths(self) -> None:
        """Re-send stored credentials on a fresh connection.

        Auth state is per-connection server-side, so every (re)connect must
        replay it before any ACL-guarded operation runs (the Apache client
        does the same with its authInfo list in primeConnection).

        A credential the server rejects (AUTH_FAILED) is dropped from the
        stored list: the server hangs up after answering AUTH_FAILED, and
        replaying the same rejected credential on every reconnect would
        turn the reconnect loop into a permanent connect/reject cycle.
        Subsequent ACL-guarded operations then fail with NO_AUTH, which is
        visible to the caller (the Apache client instead parks the whole
        session in a terminal AUTH_FAILED state; keeping the session
        usable for the un-authed surface suits a daemon whose core
        registration traffic never uses ACLs)."""
        rejected = []
        for scheme, auth in self._auths:
            try:
                await self._submit(
                    proto.XID_AUTH,
                    OpCode.AUTH,
                    proto.AuthPacket(type=0, scheme=scheme, auth=auth),
                )
            except ZKError as err:
                log.warning("replaying %s auth failed: %s", scheme, err)
                if err.code == Err.AUTH_FAILED:
                    rejected.append((scheme, auth))
                    self.emit("auth_failed", scheme)
        for cred in rejected:
            self._auths.remove(cred)
            log.error(
                "dropped rejected %s credential; ACL-guarded ops will fail "
                "with NO_AUTH until add_auth() succeeds again", cred[0],
            )

    async def _rearm_watches(self) -> None:
        if not any(self._watch_paths.values()):
            return
        body = proto.SetWatches(
            relative_zxid=self.last_zxid,
            data_watches=sorted(map(self._abs, self._watch_paths["data"])),
            exist_watches=sorted(map(self._abs, self._watch_paths["exist"])),
            child_watches=sorted(map(self._abs, self._watch_paths["child"])),
        )
        try:
            await self._submit(
                proto.XID_SET_WATCHES, OpCode.SET_WATCHES, body
            )
        except ZKError as err:
            log.warning("re-arming watches failed: %s", err)
            # Watch-dependent consumers (the zkcache invalidation layer)
            # must know their coherence signal may now be broken on this
            # connection: a cache serving entries whose watches never got
            # re-armed would serve stale answers forever.
            self.emit("watch_rearm_failed", err)

    async def close(self) -> None:
        """Gracefully end the session (ephemerals are dropped server-side)."""
        if self._closed:
            return
        self._closed = True
        if self._reconnect_task:
            self._reconnect_task.cancel()
        self._abort_failover_span()
        if self._connected:
            try:
                await asyncio.wait_for(
                    self._submit(self._next_xid(), OpCode.CLOSE_SESSION, None),
                    timeout=2.0,
                )
            except Exception:  # noqa: BLE001 - best-effort close
                pass
        await self._teardown(expected=True)

    async def _teardown(self, expected: bool) -> None:
        was_connected = self._connected
        self._connected = False
        self.read_only = False
        for task in (self._read_task, self._ping_task, self._rw_probe_task):
            if task is not None and task is not asyncio.current_task():
                task.cancel()
        self._rw_probe_task = None
        if self._writer is not None:
            try:
                transport = getattr(self._writer, "transport", None)
                if not expected and transport is not None:
                    # Abort, don't close: close() flushes the send buffer
                    # first, and on a connection being torn down *because*
                    # the peer stopped reading that flush never completes —
                    # connection_lost never fires and every coroutine
                    # parked in drain() stays parked forever.  abort()
                    # discards the buffer and wakes them with a
                    # ConnectionResetError immediately.
                    transport.abort()
                else:
                    self._writer.close()
            except Exception:  # noqa: BLE001
                pass
            self._writer = None
            self._reader = None
        err = ZKError(Err.CONNECTION_LOSS)
        while self._pending:
            _, fut = self._pending.popleft()
            if not fut.done():
                fut.set_exception(err)
        if self._op_spans:
            # Replies that will never come: close their spans with the
            # same verdict their futures just got.
            for sp in self._op_spans.values():
                sp.finish("error", err=Err.CONNECTION_LOSS)
            self._op_spans.clear()
        self._unflushed.clear()
        if was_connected:
            self.emit("state", "disconnected")
            self.emit("close")
        if not expected and not self._closed and self.reconnect:
            if was_connected and self._failover_started_at is None:
                # Failover clock: closed by the next successful
                # _adopt_connection (last_failover_s).
                self._failover_started_at = time.monotonic()
            tr = trace.tracer_for(self)
            if tr.enabled and was_connected and self._failover_span is None:
                # The session is now between members: one zk.failover
                # span covers the whole gap — teardown, reconnect
                # attempts, any leader-election wait — and closes on the
                # next successful handshake (old member -> new member).
                old = self.connected_server
                self._failover_span = tr.start_span(
                    "zk.failover",
                    **{"from": f"{old[0]}:{old[1]}" if old else "?"},
                )
            if self._reconnect_task is None or self._reconnect_task.done():
                self._reconnect_task = asyncio.create_task(self._reconnect_loop())

    def _abort_failover_span(self) -> None:
        """Close an open ``zk.failover`` span on a terminal path (client
        closed / session expired for good): the failover never landed."""
        if self._failover_span is not None:
            sp, self._failover_span = self._failover_span, None
            sp.finish("error")

    async def _rw_probe_loop(self) -> None:
        """While attached to a read-only member, poll the other members'
        ``isro`` admin word and fail over the moment one answers ``rw``
        (quorum returned, or the partition healed).  The teardown path
        is the ordinary unexpected-disconnect machinery, so the session
        reattaches through the preferred read-write member with watches
        re-armed — writes resume without operator action.
        """
        try:
            while self._connected and self.read_only and not self._closed:
                await asyncio.sleep(self.rw_probe_interval_s)
                if not (self._connected and self.read_only):
                    return
                found = await self._find_rw_server()
                if found is not None:
                    log.warning(
                        "read-write member %s:%d available; failing over "
                        "from read-only %s", found[0], found[1],
                        self.connected_server,
                    )
                    self._prefer_rw = found
                    await self._teardown(expected=False)
                    return
        except asyncio.CancelledError:
            raise

    async def _find_rw_server(self) -> Optional[Tuple[str, int]]:
        """First server in the list (excluding the one we're on) whose
        ``isro`` probe answers ``rw``; None when none does."""
        for host, port in self.servers:
            if (host, port) == self.connected_server:
                continue
            try:
                answer = await four_letter_word(host, port, b"isro")
                if answer.startswith(b"rw"):
                    return (host, port)
            except asyncio.CancelledError:
                raise
            except (OSError, asyncio.TimeoutError):
                continue
        return None

    async def _reconnect_loop(self) -> None:
        try:
            await call_with_backoff(
                self.connect,
                self.reconnect_policy,
                on_backoff=lambda n, delay, err: log.warning(
                    "reconnect attempt %d failed (%r); retrying in %.1fs",
                    n, err, delay,
                ),
                # A terminally expired/closed session cannot be resurrected
                # by retrying — but a SURVIVED expiry leaves the client
                # open (session reset to 0 by _emit_expired), and the next
                # attempt performs the fresh-session handshake, so only
                # _closed gates here.
                retryable=lambda err: not self._closed,
            )
        except SessionExpiredError:
            pass  # _emit_expired already fired
        except asyncio.CancelledError:
            # close() cancelled us; re-raise so the task finishes as
            # *cancelled* instead of silently completing (nothing awaits
            # it, but a swallowed cancel here would mask a stuck close).
            raise
        except Exception:  # noqa: BLE001
            log.exception("reconnect loop gave up")
            # The failover this span was timing never landed (a finite
            # reconnect policy exhausted); leaving it open would hold a
            # forever-pending span in the recorder.
            self._abort_failover_span()

    def _emit_expired(self) -> None:
        """The server disowned our session: rebirth or terminal expiry.

        With ``survive_session_expiry`` (and the circuit breaker not
        tripped) the client resets to a fresh-session handshake — the
        caller still raises :class:`SessionExpiredError` for the attempt
        in flight, but the client stays open and the reconnect loop's
        next attempt connects with session_id 0, establishing a new
        session (``session_reborn`` fires from _connect_one).  Otherwise:
        the reference-exact terminal path — closed + ``session_expired``.
        """
        if self._resume_pending and not self._closed:
            # A staged handoff resume the server refused: the session
            # died between the predecessor's detach and now.  Not a
            # rebirth (this client never held a session), not terminal —
            # reset to the fresh-session handshake and let the caller's
            # retry loop register from scratch, the documented fallback.
            self._resume_pending = False
            self.session_id = 0
            self.session_passwd = b"\x00" * 16
            self.last_zxid = 0
            log.warning(
                "handoff session resume refused by the server (session "
                "expired); falling back to a fresh session"
            )
            self.emit("state", "resume_refused")
            self.emit("resume_refused")
            return
        if self.survive_session_expiry and not self._closed:
            now = time.monotonic()
            while (
                self._rebirth_times
                and now - self._rebirth_times[0] > REBIRTH_WINDOW_S
            ):
                self._rebirth_times.popleft()
            if len(self._rebirth_times) < self.max_session_rebirths:
                self._rebirth_times.append(now)
                old = self.session_id
                self.session_id = 0
                self.session_passwd = b"\x00" * 16
                self.last_zxid = 0
                self._rebirth_pending = True
                log.warning(
                    "session 0x%x expired; rebuilding a fresh session "
                    "in-process (surviveSessionExpiry)", old,
                )
                trace.tracer_for(self).event(
                    "zk.session_lost", session=f"0x{old:x}"
                )
                self.emit("state", "session_lost")
                return
            log.error(
                "session rebirth circuit breaker tripped (%d rebirths in "
                "%.0fs); falling back to terminal session_expired",
                len(self._rebirth_times), REBIRTH_WINDOW_S,
            )
            self.emit("rebirth_breaker_tripped", len(self._rebirth_times))
        self._closed = True
        self._abort_failover_span()
        trace.tracer_for(self).event(
            "zk.session_expired", session=f"0x{self.session_id:x}"
        )
        self.emit("state", "session_expired")
        self.emit("session_expired")

    # -- path validation ------------------------------------------------------

    def _check_path(self, path: str) -> str:
        """Validate through this client's PathCache — the ONE place the
        cache is wired in, so a new op cannot silently fall back to
        uncached validation."""
        return check_path(path, self._path_cache)

    # -- chroot mapping -------------------------------------------------------

    def _abs(self, path: str) -> str:
        """Client path -> server path (prefix the chroot)."""
        if not self.chroot:
            return path
        return self.chroot if path == "/" else self.chroot + path

    def _rel(self, path: str) -> str:
        """Server path -> client path (strip the chroot)."""
        if not self.chroot:
            return path
        if path == self.chroot:
            return "/"
        if path.startswith(self.chroot + "/"):
            return path[len(self.chroot):]
        return path  # outside the chroot (shouldn't happen)

    # -- wire I/O -----------------------------------------------------------

    def _next_xid(self) -> int:
        self._xid += 1
        return self._xid

    async def _read_loop(self) -> None:
        # Bulk-buffered framing (registrar_tpu_torch/zk/framing.py): one
        # transport read per TCP burst, then dispatch every complete
        # frame carved zero-copy out of the receive chunks.  Liveness is
        # stamped once per burst, not per frame — the watchdog's
        # granularity is seconds, and a 10k-reply sweep cost 10k clock
        # reads.
        frames = FrameReader(self._reader)
        try:
            while True:
                if not await frames.fill():
                    raise ConnectionError("connection closed by server")
                self._last_response = time.monotonic()
                for payload in frames.carve():
                    self._dispatch_frame(payload)
        except asyncio.CancelledError:
            raise
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as err:
            log.debug("connection lost: %r", err)
            await self._teardown(expected=False)
        except Exception:  # noqa: BLE001 - malformed frame: treat as conn loss
            log.exception("protocol error on connection; tearing down")
            await self._teardown(expected=False)

    def _dispatch_frame(self, payload) -> None:
        # Header unpacked in place (no ReplyHeader dataclass, no Reader
        # for error/ping frames): this runs once per received frame.
        xid, zxid, err = proto.unpack_reply_header(payload)
        if zxid > 0:
            self.last_zxid = zxid
        if xid == proto.XID_NOTIFICATION:
            event = proto.WatcherEvent.read(
                Reader(payload, proto.REPLY_HDR_SIZE)
            )
            self._on_watch_event(event)
            return
        if xid == proto.XID_PING:
            # Pings are fire-and-forget (no _pending entry); their replies
            # matter only as liveness, recorded in _last_response by the
            # read loop.
            return
        if self._op_spans:
            sp = self._op_spans.pop(xid, None)
            if sp is not None:
                if err != Err.OK:
                    sp.finish("error", err=err)
                else:
                    sp.finish()
        if not self._pending:
            log.warning("unmatched reply xid=%d", xid)
            return
        expected_xid, fut = self._pending.popleft()
        if expected_xid != xid:
            # FIFO pairing is broken: the connection is permanently
            # desynchronized.  Raise so _read_loop tears it down and the
            # reconnect machinery takes over (a fresh connection resets the
            # xid stream); limping on would turn every later op into a
            # mismatched zombie reply.
            if not fut.done():
                fut.set_exception(ZKError(Err.CONNECTION_LOSS))
            raise ConnectionError(
                f"xid mismatch: expected {expected_xid} got {xid}"
            )
        if fut.done():
            return
        if err != Err.OK:
            if err == Err.NOT_READONLY:
                # A write reached a read-only (minority) member: the
                # caller gets the retryable error; observers (metrics:
                # registrar_write_refusals_total) get the event.
                self.emit("write_refused", "read_only")
            fut.set_exception(ZKError(err))
        else:
            fut.set_result(Reader(payload, proto.REPLY_HDR_SIZE))

    #: which client-side watch registrations each event type consumes
    #: (matching real ZK: data/exist watches fire on created/deleted/
    #: dataChanged; child watches fire on childrenChanged and deleted).
    _EVENT_CLEARS = {
        proto.EventType.NODE_CREATED: ("data", "exist"),
        proto.EventType.NODE_DATA_CHANGED: ("data", "exist"),
        proto.EventType.NODE_DELETED: ("data", "exist", "child"),
        proto.EventType.NODE_CHILDREN_CHANGED: ("child",),
    }

    def _on_watch_event(self, event: proto.WatcherEvent) -> None:
        if event.type == proto.EventType.NONE:
            # Server-side session event (e.g. expiry notification).
            return
        if self.chroot:
            # Server notifications carry absolute paths; listeners (and the
            # re-arm bookkeeping) live in client coordinates.
            event = proto.WatcherEvent(
                type=event.type, state=event.state, path=self._rel(event.path)
            )
        for kind in self._EVENT_CLEARS.get(event.type, ()):
            self._watch_paths[kind].discard(event.path)
        self.emit("watch", event)
        self._watch_emitter.emit(event.path, event)

    def _post(self, xid: int, op: int, body, tr=None) -> asyncio.Future:
        """Queue one request on the wire without awaiting anything.

        The pipelining primitive: callers fan out many posts back to back
        (one buffered write each), drain once, then await the futures —
        avoiding a Task per operation for large fan-outs like the
        heartbeat's stat sweep.  ``tr`` lets a pipelined burst resolve
        the tracer once instead of per post (10k lookups per 10k-node
        sweep otherwise)."""
        if not self._connected or self._writer is None:
            raise ZKError(Err.CONNECTION_LOSS)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending.append((xid, fut))
        if tr is None:
            tr = trace.tracer_for(self)
        if tr.enabled and xid > 0:
            # One span per request, split submit -> flushed -> reply
            # (queue time vs wire time).  Reserved xids (auth replay,
            # SetWatches, pings) stay untraced: they are connection
            # plumbing, not operations the caller issued.
            self._op_spans[xid] = tr.start_span(
                "zk.op", op=_OP_NAMES.get(op, str(op)), xid=xid
            )
            self._unflushed.append(xid)
        encoded = proto.encode_request(xid, op, body)
        if self._corked is not None:
            self._corked.append(encoded)
        else:
            self._writer.write(encoded)
        return fut

    def _mark_flushed(self) -> None:
        """Stamp the queue->wire boundary on every span posted since the
        last drain (called right after a drain() completes: the bytes
        are out of our buffer, the remaining wait is the server+wire)."""
        if self._unflushed:
            for xid in self._unflushed:
                sp = self._op_spans.get(xid)
                if sp is not None:
                    sp.mark("flushed")
            self._unflushed.clear()

    def _cork(self) -> None:
        """Hold posted frames in a local list instead of writing each one.

        ``transport.write`` eagerly issues a send() syscall per call when
        its buffer is empty, so a 1000-post pipeline burst costs a
        thousand syscalls; corking joins the burst into one write (one
        or a few segments).  Callers must :meth:`_uncork` in a finally.
        """
        if self._corked is None:
            self._corked = []

    def _uncork(self) -> None:
        chunks, self._corked = self._corked, None
        if chunks and self._writer is not None:
            self._writer.write(b"".join(chunks))

    async def _post_pipeline(
        self, requests: Iterable[Tuple[int, object]]
    ) -> Tuple[List[asyncio.Future], Optional[BaseException]]:
        """Cork-post a burst of ``(op, record)`` requests with one drain.

        The pipelining skeleton shared by :meth:`mkdirp`,
        :meth:`get_many`, and the heartbeat sweep.  Returns the reply
        futures (FIFO, one per request) plus the not-connected ZKError
        raised while posting, if any — by then earlier posts hold
        pending futures the read loop will resolve (to CONNECTION_LOSS
        on teardown), so callers must gather the futures first and then
        decide how to rank the returned error against gathered ones.
        """
        futs: List[asyncio.Future] = []
        post_err: Optional[BaseException] = None
        tr = trace.tracer_for(self)
        try:
            self._cork()
            try:
                for op, body in requests:
                    futs.append(self._post(self._next_xid(), op, body, tr))
            finally:
                self._uncork()
            if futs and self._writer is not None:
                await self._writer.drain()
                self._mark_flushed()
        except (ConnectionError, OSError):
            await self._teardown(expected=False)
        except ZKError as e:  # not connected: fail after draining futs
            post_err = e
        return futs, post_err

    async def _submit(self, xid: int, op: int, body) -> Optional[Reader]:
        fut = self._post(xid, op, body)
        try:
            await self._writer.drain()
            self._mark_flushed()
        except (ConnectionError, OSError):
            await self._teardown(expected=False)
        return await self._await_reply(fut)

    async def _call(self, op: int, body) -> Reader:
        return await self._submit(self._next_xid(), op, body)

    async def _await_reply(self, awaitable):
        """Bound one awaited reply (or a gathered burst of them) by the
        per-operation deadline.

        On expiry the connection is torn down before raising: ZooKeeper
        answers strictly FIFO, so a reply cannot be skipped — if op N's
        answer never comes, neither does N+1's, and the only way to
        recover the pipeline is a fresh connection (which also resolves
        every other pending future to CONNECTION_LOSS).  The caller gets
        :class:`OperationTimeoutError`, which
        :func:`registrar_tpu_torch.retry.is_transient` marks retryable.
        """
        if self.request_timeout_ms is None:
            return await awaitable
        try:
            return await asyncio.wait_for(
                awaitable, self.request_timeout_ms / 1000.0
            )
        except asyncio.TimeoutError:
            log.warning(
                "no reply within request_timeout (%d ms); dropping connection",
                self.request_timeout_ms,
            )
            await self._teardown(expected=False)
            raise OperationTimeoutError() from None

    async def _gather_replies(self, futs: Sequence[asyncio.Future]) -> List:
        """Deadline-bounded collection of a pipelined burst's reply
        futures (one shared deadline for the whole burst: the replies
        ride one FIFO connection, so the burst is one wire operation
        from the deadline's point of view).

        FIFO makes the LAST future the barrier: replies resolve in
        submission order, and a teardown fails every pending future at
        once — so when ``futs[-1]`` is done, all are.  Waiting on that
        one future costs one done-callback instead of the one-per-future
        a ``gather`` would register (10k registrations per 10k-znode
        sweep).  Exceptions are retrieved from every future on
        every path, including the timeout teardown, so no "exception was
        never retrieved" noise can escape."""
        if not futs:
            return []
        try:
            await self._await_reply(asyncio.wait([futs[-1]]))
        except OperationTimeoutError:
            # _await_reply already tore the connection down, which
            # resolved every pending future to CONNECTION_LOSS; mark
            # them retrieved before surfacing the deadline.
            for fut in futs:
                if fut.done() and not fut.cancelled():
                    fut.exception()
            raise
        out: List = []
        for fut in futs:
            err = fut.exception()
            out.append(fut.result() if err is None else err)
        return out

    def _ping_schedule(self) -> Tuple[float, float]:
        """(ping interval, dead-after) seconds for the current session.

        The default is the Apache client's thirds rule off the
        NEGOTIATED timeout: ping every third, declare the server dead
        after two-thirds of silence.  ``ping_interval_ms`` /
        ``dead_after_ms`` override each half independently (the
        sub-session-timeout failure detection); an overridden dead-after
        is floored at the effective interval so the watchdog can never
        fire between its own pings."""
        if self.ping_interval_ms is not None:
            interval = self.ping_interval_ms / 1000.0
        else:
            interval = max(self.negotiated_timeout_ms / 3000.0, 0.02)
        if self.dead_after_ms is not None:
            dead_after = max(self.dead_after_ms / 1000.0, interval)
        else:
            dead_after = max(
                self.negotiated_timeout_ms * 2 / 3000.0, 2 * interval
            )
        return interval, dead_after

    async def _ping_loop(self) -> None:
        """Session keepalive + server-liveness watchdog.

        Pings every timeout/3.  If the server has produced *no* frame for
        more than 2/3 of the session timeout — TCP alive but unresponsive —
        the connection is torn down so the reconnect machinery can find a
        working server before the session expires (the same policy as the
        Apache ZooKeeper client's readTimeout).  Both knobs are tunable:
        :meth:`_ping_schedule`."""
        interval, dead_after = self._ping_schedule()
        try:
            while self._connected:
                await asyncio.sleep(interval)
                if not self._connected:
                    return
                if time.monotonic() - self._last_response > dead_after:
                    log.warning(
                        "no server response in %.1fs; dropping connection",
                        dead_after,
                    )
                    self.watchdog_drops += 1
                    await self._teardown(expected=False)
                    return
                try:
                    # Fire-and-forget: the reply (whenever it arrives)
                    # refreshes _last_response via _dispatch_frame; awaiting
                    # it here would wedge the watchdog behind the very
                    # stall it exists to detect.
                    if self._writer is not None:
                        self._writer.write(
                            proto.encode_request(proto.XID_PING, OpCode.PING)
                        )
                        # drain() itself can block indefinitely: a peer
                        # that stops READING (slow-loris) fills the kernel
                        # send buffer, the transport buffer rises past its
                        # high-water mark, and an unbounded drain parks
                        # the watchdog behind the exact stall it exists to
                        # detect (the pre-fix wedge; regression test:
                        # tests/test_netem.py drain-wedge).  Bound it by
                        # what is left of the dead-after budget, then
                        # declare the connection dead ourselves.
                        budget = dead_after - (
                            time.monotonic() - self._last_response
                        )
                        await asyncio.wait_for(
                            self._writer.drain(), timeout=max(budget, 0.01)
                        )
                except asyncio.TimeoutError:
                    log.warning(
                        "send buffer stalled for the remaining dead-after "
                        "budget (peer stopped reading); dropping connection",
                    )
                    self.watchdog_drops += 1
                    await self._teardown(expected=False)
                    return
                except (ConnectionError, OSError):
                    await self._teardown(expected=False)
                    return
        except asyncio.CancelledError:
            raise

    # -- znode operations (the reference's call surface) ---------------------

    async def create(
        self,
        path: str,
        data: bytes = b"",
        flags: int = CreateFlag.PERSISTENT,
        acls=None,
    ) -> str:
        """Create a znode; returns the created path."""
        self._check_path(path)
        r = await self._call(
            OpCode.CREATE,
            proto.CreateRequest(
                path=self._abs(path),
                data=data,
                acls=list(acls) if acls is not None else list(OPEN_ACL_UNSAFE),
                flags=flags,
            ),
        )
        return self._rel(proto.CreateResponse.read(r).path)

    async def create_ephemeral_plus(self, path: str, data: bytes = b"") -> str:
        """Ephemeral create that transparently creates missing parents.

        The zkplus 'ephemeral_plus' flag used by the reference's
        registerEntries stage (lib/register.js:156-158).  The registration
        pipeline mkdirps parents beforehand, so the fallback here only
        triggers when racing a concurrent cleanup.
        """
        try:
            return await self.create(path, data, CreateFlag.EPHEMERAL)
        except ZKError as err:
            if err.code != Err.NO_NODE:
                raise
        parent = path.rsplit("/", 1)[0] or "/"
        await self.mkdirp(parent)
        return await self.create(path, data, CreateFlag.EPHEMERAL)

    async def put(self, path: str, data: bytes) -> Stat:
        """Set a node's data, creating it (persistent) when missing.

        zkplus ``put`` semantics, used for the persistent service record
        (reference lib/register.js:62).
        """
        self._check_path(path)
        try:
            return await self.set_data(path, data)
        except ZKError as err:
            if err.code != Err.NO_NODE:
                raise
        parent = path.rsplit("/", 1)[0] or "/"
        await self.mkdirp(parent)
        try:
            await self.create(path, data, CreateFlag.PERSISTENT)
        except ZKError as err:
            if err.code != Err.NODE_EXISTS:
                raise
            return await self.set_data(path, data)  # lost the create race
        return (await self.stat(path))

    async def set_data(
        self, path: str, data: bytes, version: int = -1
    ) -> Stat:
        """Plain setData: NO_NODE if absent, BAD_VERSION on mismatch.

        Unlike :meth:`put` (zkplus semantics: create-if-missing), this is
        the raw ZooKeeper op — the right primitive for conditional writes.
        """
        self._check_path(path)
        r = await self._call(
            OpCode.SET_DATA,
            proto.SetDataRequest(
                path=self._abs(path), data=data, version=version
            ),
        )
        return proto.SetDataResponse.read(r).stat

    async def unlink(self, path: str, version: int = -1) -> None:
        """Delete a znode (zkplus name, reference lib/register.js:87)."""
        self._check_path(path)
        await self._call(
            OpCode.DELETE,
            proto.DeleteRequest(path=self._abs(path), version=version),
        )

    async def stat(self, path: str, watch: bool = False) -> Stat:
        """Stat a znode; raises NO_NODE when absent (heartbeat primitive)."""
        self._check_path(path)
        try:
            r = await self._call(
                OpCode.EXISTS,
                proto.ExistsRequest(path=self._abs(path), watch=watch),
            )
        except ZKError as err:
            if watch and err.code == Err.NO_NODE:
                self._watch_paths["exist"].add(path)
            raise
        if watch:
            self._watch_paths["data"].add(path)
        return proto.ExistsResponse.read(r).stat

    async def exists(self, path: str, watch: bool = False) -> Optional[Stat]:
        """Like :meth:`stat` but returns None instead of raising NO_NODE."""
        try:
            return await self.stat(path, watch=watch)
        except ZKError as err:
            if err.code == Err.NO_NODE:
                return None
            raise

    async def get(self, path: str, watch: bool = False) -> Tuple[bytes, Stat]:
        self._check_path(path)
        r = await self._call(
            OpCode.GET_DATA,
            proto.GetDataRequest(path=self._abs(path), watch=watch),
        )
        if watch:
            self._watch_paths["data"].add(path)
        resp = proto.GetDataResponse.read(r)
        return (resp.data or b"", resp.stat)

    async def get_many(
        self, paths: Iterable[str], watch: bool = False
    ) -> List[Optional[Tuple[bytes, Stat]]]:
        """Pipelined getData fan-out: one corked write, one drain, replies
        collected in order.  Returns one entry per path — ``(data, stat)``,
        or None where the node does not exist (NO_NODE is an expected
        answer for a fan-out over a changing tree, e.g. the Binder-view
        resolver reading a service's instances while members churn); any
        other error propagates.

        ``watch=True`` leaves a one-shot data watch on every path that
        exists (like real getData, NO_NODE leaves nothing behind — the
        zkcache refill path relies on that asymmetry and negative-caches
        only through explicit exists-watches).
        """
        paths = list(paths)
        for p in paths:
            self._check_path(p)
        futs, post_err = await self._post_pipeline(
            (
                OpCode.GET_DATA,
                proto.GetDataRequest(path=self._abs(p), watch=watch),
            )
            for p in paths
        )
        results = await self._gather_replies(futs)
        out: List[Optional[Tuple[bytes, Stat]]] = []
        for path, res in zip(paths, results):
            if isinstance(res, ZKError) and res.code == Err.NO_NODE:
                out.append(None)
                continue
            if isinstance(res, BaseException):
                raise res
            if watch:
                self._watch_paths["data"].add(path)
            resp = proto.GetDataResponse.read(res)
            out.append((resp.data or b"", resp.stat))
        if post_err is not None:
            raise post_err
        return out

    async def read_node(
        self, path: str, watch: bool = False
    ) -> Optional[Tuple[bytes, Stat, List[str]]]:
        """Read a node's data AND children in one pipelined flush.

        The Binder-view resolver's first two waits — ``get(path)`` then
        ``get_children(path)`` — ride one FIFO connection anyway, so
        corking them into a single write/drain saves a full round trip on
        every resolve (and every zkcache miss).  Returns ``(data, stat,
        children)``, or None when the node does not exist — including the
        narrow race where another session deletes it between the two
        server-side ops (the getData succeeded, the getChildren saw
        NO_NODE; the armed data watch then fires NODE_DELETED, so a cache
        holding the None is still invalidated).

        ``watch=True`` arms one-shot data + child watches on success,
        exactly as ``get(watch=True)`` + ``get_children(watch=True)``
        would; NO_NODE leaves nothing armed (negative caching is the
        caller's job, via :meth:`exists` and its exists-watch).
        """
        self._check_path(path)
        abs_path = self._abs(path)
        futs, post_err = await self._post_pipeline(
            (
                (
                    OpCode.GET_DATA,
                    proto.GetDataRequest(path=abs_path, watch=watch),
                ),
                (
                    OpCode.GET_CHILDREN2,
                    proto.GetChildrenRequest(path=abs_path, watch=watch),
                ),
            )
        )
        results = await self._gather_replies(futs)
        if post_err is not None or len(results) != 2:
            # Not connected mid-post: earlier futures (if any) were
            # gathered above so the read loop owes nothing; surface the
            # posting error.
            raise post_err if post_err is not None else ZKError(
                Err.CONNECTION_LOSS
            )
        data_res, child_res = results
        for res in (data_res, child_res):
            if isinstance(res, BaseException) and not (
                isinstance(res, ZKError) and res.code == Err.NO_NODE
            ):
                raise res
        if isinstance(data_res, ZKError) or isinstance(child_res, ZKError):
            # Absent (or deleted mid-burst).  When the getData half
            # succeeded, the server DID arm its data watch; record it so
            # a reconnect's SetWatches re-arm keeps parity with the
            # server-side state (the pending NODE_DELETED event resolves
            # both sides).
            if watch and not isinstance(data_res, ZKError):
                self._watch_paths["data"].add(path)
            return None
        if watch:
            self._watch_paths["data"].add(path)
            self._watch_paths["child"].add(path)
        data = proto.GetDataResponse.read(data_res)
        children = proto.GetChildren2Response.read(child_res).children
        return (data.data or b"", data.stat, children)

    async def get_children(self, path: str, watch: bool = False) -> List[str]:
        self._check_path(path)
        r = await self._call(
            OpCode.GET_CHILDREN2,
            proto.GetChildrenRequest(path=self._abs(path), watch=watch),
        )
        if watch:
            self._watch_paths["child"].add(path)
        return proto.GetChildren2Response.read(r).children

    async def mkdirp(self, path: str) -> None:
        """Create ``path`` and any missing ancestors (persistent, empty).

        Pipelined: one create per ancestor posted back-to-back on the
        single FIFO connection, one drain, replies collected in order.
        The server applies them in submission order, so each create sees
        its parent already made (or NODE_EXISTS) — the znode outcome is
        identical to the sequential walk at one round trip of latency
        instead of one per component (the registration pipeline's
        stage-3 hot path, 4-6 components per domain).  NODE_EXISTS is
        ignored per component; the first other error propagates (a
        failed ancestor cascades NO_NODE onto its descendants, so the
        root cause is the error reported).
        """
        self._check_path(path)
        if path == "/":
            return

        def requests():
            current = ""
            for comp in path.strip("/").split("/"):
                current += "/" + comp
                yield (
                    OpCode.CREATE,
                    proto.CreateRequest(
                        path=self._abs(current),
                        data=b"",
                        acls=list(OPEN_ACL_UNSAFE),
                        flags=CreateFlag.PERSISTENT,
                    ),
                )

        futs, post_err = await self._post_pipeline(requests())
        first_err: Optional[BaseException] = post_err
        for res in await self._gather_replies(futs):
            if (
                isinstance(res, BaseException)
                and not (isinstance(res, ZKError) and res.code == Err.NODE_EXISTS)
                and first_err is None
            ):
                first_err = res
        if first_err is not None:
            raise first_err

    def watch(self, path: str, listener) -> None:
        """Register a listener for one-shot watch events on ``path``."""
        self._watch_emitter.on(path, listener)

    def unwatch(self, path: str, listener) -> None:
        """Remove a listener previously registered with :meth:`watch`."""
        self._watch_emitter.off(path, listener)

    def forget_watches(self, path: str) -> None:
        """Drop ``path`` from the re-arm bookkeeping (client-side only).

        The server-side one-shot watch, if still armed, fires once more
        and is then gone; what this prevents is the reconnect-time
        SetWatches re-arm resurrecting a registration nobody listens to.
        Used by cache eviction, where the entry is gone and a future
        event for the path would be a harmless no-op invalidation.
        """
        for kind in self._watch_paths.values():
            kind.discard(path)

    # -- transactions / sync (full ZooKeeper 3.4 surface) --------------------

    async def sync(self, path: str) -> str:
        """Flush the server's commit pipeline for ``path`` (read barrier).

        A follower answers reads from possibly-stale local state; sync
        forces it to catch up with the leader first.  Beyond the reference's
        surface (zkplus never exposed it) — useful before read-backs in
        multi-server deployments.
        """
        self._check_path(path)
        r = await self._call(
            OpCode.SYNC, proto.SyncRequest(path=self._abs(path))
        )
        return self._rel(proto.SyncResponse.read(r).path)

    async def multi(self, ops: Sequence[Tuple[int, object]]) -> List[object]:
        """Atomically apply a transaction of :class:`Op` operations.

        Returns per-op results (created path str, :class:`Stat`, or None for
        delete/check).  On abort nothing is applied and :class:`MultiError`
        is raised carrying per-op error codes.  Beyond the reference's
        surface; enables e.g. atomic unregistration
        (:func:`registrar_tpu_torch.registration.unregister` ``atomic=True``).
        """
        import dataclasses

        ops = list(ops)
        if not ops:
            return []
        for _, record in ops:
            self._check_path(record.path)
        if self.chroot:
            ops = [
                (t, dataclasses.replace(rec, path=self._abs(rec.path)))
                for t, rec in ops
            ]
        r = await self._call(OpCode.MULTI, proto.MultiRequest(ops=ops))
        resp = proto.MultiResponse.read(r)
        if any(isinstance(res, proto.ErrorResult) for res in resp.results):
            raise MultiError([res.err for res in resp.results])
        out: List[object] = []
        for res in resp.results:
            if isinstance(res, proto.CreateResponse):
                out.append(self._rel(res.path))
            elif isinstance(res, proto.SetDataResponse):
                out.append(res.stat)
            else:
                out.append(None)
        return out

    # -- auth / ACLs (full ZooKeeper 3.4 surface) ----------------------------

    async def add_auth(self, scheme: str, auth: bytes) -> None:
        """Authenticate this session's connection (``addauth`` in zkCli.sh).

        For the digest scheme ``auth`` is ``b"user:password"`` — the server
        hashes it and matches ACL ids of the form
        :func:`registrar_tpu_torch.zk.protocol.digest_auth_id`.  The credential is
        remembered and replayed automatically after every reconnect.  Raises
        ``ZKError(AUTH_FAILED)`` (and the server drops the connection) for an
        unknown scheme or malformed credential.  Beyond the reference's
        surface: zkplus never exposed auth, and the reference creates every
        node world-writable (lib/register.js never passes ACLs).
        """
        if not isinstance(scheme, str) or not scheme:
            raise ValueError("scheme must be a non-empty string")
        await self._submit(
            proto.XID_AUTH,
            OpCode.AUTH,
            proto.AuthPacket(type=0, scheme=scheme, auth=auth),
        )
        if (scheme, auth) not in self._auths:
            self._auths.append((scheme, auth))

    async def get_acl(self, path: str) -> Tuple[List[proto.ACL], Stat]:
        """Read a node's ACL list and stat (aversion lives in the stat)."""
        self._check_path(path)
        r = await self._call(
            OpCode.GET_ACL, proto.GetACLRequest(path=self._abs(path))
        )
        resp = proto.GetACLResponse.read(r)
        return (resp.acls, resp.stat)

    async def set_acl(
        self, path: str, acls: Sequence[proto.ACL], version: int = -1
    ) -> Stat:
        """Replace a node's ACL list.

        ``version`` is compared against the node's **aversion** (not the data
        version); pass -1 to skip the check.  Requires ADMIN permission on
        the node.
        """
        self._check_path(path)
        r = await self._call(
            OpCode.SET_ACL,
            proto.SetACLRequest(
                path=self._abs(path), acls=list(acls), version=version
            ),
        )
        return proto.SetACLResponse.read(r).stat

    # -- application heartbeat (reference lib/zk.js:21-59) -------------------

    async def heartbeat(
        self, nodes: Iterable[str], retry: Optional[RetryPolicy] = None
    ) -> None:
        """Probe liveness of owned znodes: parallel stat with bounded retry.

        Retry policy: 5 attempts, exponential 1 s -> 30 s (reference
        lib/zk.js:37-43).  Raises the final error when all attempts fail.
        Note this is an *application-level* probe of the znodes; the session
        keepalive pings are handled inside the client (reference README:56-58
        makes the same distinction).

        One-group front of :meth:`heartbeat_many` — the per-group
        contract (pipelined EXISTS flush, NO_NODE retried through the
        bounded policy, :class:`OwnershipError`/SESSION_EXPIRED fatal)
        lives there in ONE copy.
        """
        err = (await self.heartbeat_many([nodes], retry=retry))[0]
        if err is not None:
            raise err

    async def heartbeat_many(
        self,
        groups: Sequence[Iterable[str]],
        retry: Optional[RetryPolicy] = None,
        on_outcome=None,
    ) -> List[Optional[BaseException]]:
        """Coalesced heartbeat: several services' owned-znode sweeps in
        ONE pipelined EXISTS flush per attempt.

        ``groups`` is one node list per service; the return value is one
        entry per group — None on success, or the exception a solo
        :meth:`heartbeat` over that group would have raised.  Per-group
        behavior is contract-identical to N independent heartbeat calls
        sharing a deterministic retry schedule: a NO_NODE in group A
        burns A's attempts only, group B's sweep neither waits for nor
        fails with it; OwnershipError and SESSION_EXPIRED are final
        immediately (non-retryable); transient wire errors retry every
        still-undecided group together.  What coalescing changes is
        only the wire shape: all groups' EXISTS requests ride one
        corked write + one drain + one shared reply deadline
        (:meth:`_gather_replies`) instead of one flush per service.

        ``on_outcome(index, err_or_none)`` fires the moment a group's
        verdict is final — so a healthy service is released after the
        first attempt while a failing one is still riding the backoff
        schedule (the agent's coalescer resolves per-service futures
        from it).
        """
        groups = [list(g) for g in groups]
        for g in groups:
            for n in g:
                self._check_path(n)
        policy = retry or HEARTBEAT_RETRY
        pending = object()  # sentinel: group not yet decided
        outcomes: List[object] = [pending] * len(groups)

        def settle(i: int, err: Optional[BaseException]) -> None:
            outcomes[i] = err
            if on_outcome is not None:
                on_outcome(i, err)

        delays = policy.schedule()
        attempt = 0
        while True:
            live = [i for i, o in enumerate(outcomes) if o is pending]
            if not live:
                break
            errs = await self._exists_sweep(groups, live)
            retrying = False
            for i in live:
                err = errs[i]
                if err is None:
                    settle(i, None)
                    continue
                # An expired session cannot heartbeat its way back:
                # retrying just burns the bounded attempts while the
                # daemon should already be exiting for its supervisor
                # restart.  A foreign-owned ephemeral is just as
                # un-retryable — the other session holds it until IT
                # dies.  Everything else keeps the reference's
                # retry-all behavior.
                fatal = isinstance(err, OwnershipError) or (
                    isinstance(err, ZKError)
                    and err.code == Err.SESSION_EXPIRED
                )
                if fatal or attempt + 1 >= policy.max_attempts:
                    settle(i, err)
                else:
                    retrying = True
            if not retrying:
                break
            await asyncio.sleep(next(delays))
            attempt += 1
        return list(outcomes)  # type: ignore[arg-type]

    async def _exists_sweep(self, groups, idxs) -> dict:
        """One corked EXISTS flush over ``groups[i] for i in idxs``;
        returns ``{i: first error for that group, or None}``.

        Pipelined: post every exists request (buffered writes), one
        drain, then collect replies in order — no per-node Task, so a
        10k-znode sweep is one scheduling round, not ten thousand.  The
        ownership check rides the same replies: the
        EXISTS stats already carry each node's ``ephemeralOwner``, and a
        bare existence probe passed forever on an ephemeral held by a
        FOREIGN session — a zombie predecessor's stale znode, or a
        hijacking duplicate registering our hostname.  Persistent nodes
        (the service record, owner 0) are exempt.  Decoded via
        :func:`protocol.stat_owner_from_reply` — one field, no Stat
        dataclass per reply (docs/PERF.md).
        """
        flat: List[str] = []
        bounds = []  # (group index, start, end) into flat
        for i in idxs:
            start = len(flat)
            flat.extend(groups[i])
            bounds.append((i, start, len(flat)))
        try:
            futs, post_err = await self._post_pipeline(
                (
                    OpCode.EXISTS,
                    proto.ExistsRequest(path=self._abs(n), watch=False),
                )
                for n in flat
            )
            results = await self._gather_replies(futs)
        except asyncio.CancelledError:
            raise
        except Exception as sweep_err:  # noqa: BLE001 - timeout/conn loss
            return {i: sweep_err for i in idxs}
        if post_err is not None:
            # Posts after the failure point never got futures; their
            # groups fail with the posting error, ranked after any real
            # replies the earlier posts collected.
            results = results + [post_err] * (len(flat) - len(results))
        out = {}
        for i, start, end in bounds:
            err: Optional[BaseException] = None
            for res in results[start:end]:
                if isinstance(res, BaseException):
                    err = res
                    break
            if err is None:
                for node, res in zip(groups[i], results[start:end]):
                    try:
                        owner = proto.stat_owner_from_reply(res)
                    except Exception as decode_err:  # noqa: BLE001
                        err = decode_err  # malformed stat: same verdict
                        break  # as the old full-decode path
                    if owner and owner != self.session_id:
                        err = OwnershipError(node, owner, self.session_id)
                        break
            out[i] = err
        return out


class Op:
    """Operation constructors for :meth:`ZKClient.multi`."""

    @staticmethod
    def create(
        path: str,
        data: bytes = b"",
        flags: int = CreateFlag.PERSISTENT,
        acls=None,
    ) -> Tuple[int, proto.CreateRequest]:
        return (
            OpCode.CREATE,
            proto.CreateRequest(
                path=path,
                data=data,
                acls=list(acls) if acls is not None else list(OPEN_ACL_UNSAFE),
                flags=flags,
            ),
        )

    @staticmethod
    def delete(path: str, version: int = -1) -> Tuple[int, proto.DeleteRequest]:
        return (OpCode.DELETE, proto.DeleteRequest(path=path, version=version))

    @staticmethod
    def set_data(
        path: str, data: bytes, version: int = -1
    ) -> Tuple[int, proto.SetDataRequest]:
        return (
            OpCode.SET_DATA,
            proto.SetDataRequest(path=path, data=data, version=version),
        )

    @staticmethod
    def check(path: str, version: int) -> Tuple[int, proto.CheckVersionRequest]:
        return (
            OpCode.CHECK,
            proto.CheckVersionRequest(path=path, version=version),
        )


class MultiError(ZKError):
    """An aborted transaction: ``results`` holds each op's error code
    (the failing op's real code; RUNTIME_INCONSISTENCY for the rest)."""

    def __init__(self, results: List[int]):
        self.results = results
        first = next(
            (
                code for code in results
                if code not in (Err.OK, Err.RUNTIME_INCONSISTENCY)
            ),
            results[0] if results else Err.SYSTEM_ERROR,
        )
        super().__init__(first)


class _ReadOnlyMember(Exception):
    """Internal connect-pass signal: the handshake landed on a read-only
    member while the pass was still hunting for a read-write one.  Never
    escapes :meth:`ZKClient.connect` (the member is kept as the pass's
    fallback)."""


class SessionExpiredError(ZKError):
    def __init__(self) -> None:
        super().__init__(Err.SESSION_EXPIRED)


class OwnershipError(ZKError):
    """An owned znode's ephemeral is held by a FOREIGN session.

    Raised by the heartbeat sweep: the node exists —
    so a bare existence probe reads it as alive forever — but its
    ``ephemeralOwner`` is not our session, meaning this registrar does
    not control its lifetime (a zombie predecessor's stale znode, an
    operator's hand-made node, a duplicate instance claiming the same
    hostname).  Not retryable (the foreign session holds the node until
    it dies), and deliberately never "repaired" by deleting the node:
    two live claimants for one hostname is an operator problem — see
    docs/DESIGN.md "Why repair never steals".
    """

    def __init__(self, path: str, owner: int, session_id: int):
        self.owner = owner
        self.session = session_id
        super().__init__(Err.RUNTIME_INCONSISTENCY, path)
        # Repeatable diagnosis beats the generic code string: name both
        # sessions in the message operators will grep for.
        self.args = (
            f"{path} ephemeral is owned by foreign session 0x{owner:x} "
            f"(ours: 0x{session_id:x})",
        )


class OperationTimeoutError(ZKError):
    """A per-operation deadline (``request_timeout_ms``) expired.

    The connection was already torn down when this is raised (FIFO
    pipeline — see :meth:`ZKClient._await_reply`), so the session is on
    its way back up via the reconnect machinery; retrying the operation
    is the right move (:func:`registrar_tpu_torch.retry.is_transient` → True).
    """

    def __init__(self) -> None:
        super().__init__(Err.OPERATION_TIMEOUT)


async def create_zk_client(
    servers: Sequence[Tuple[str, int]],
    timeout_ms: int = 30000,
    connect_timeout_ms: int = 4000,
    on_attempt=None,
    retry_policy: Optional[RetryPolicy] = None,
    chroot: Optional[str] = None,
    request_timeout_ms: Optional[int] = None,
    survive_session_expiry: bool = False,
    max_session_rebirths: Optional[int] = None,
    can_be_read_only: bool = False,
    rng: Optional[random.Random] = None,
    attach_preference: str = "any",
    connect_race_stagger_ms: Optional[int] = None,
    ping_interval_ms: Optional[int] = None,
    dead_after_ms: Optional[int] = None,
) -> ZKClient:
    """Create and connect a client, retrying forever (reference lib/zk.js:62-127).

    The reference wraps zkplus connect in backoff with failAfter(Infinity)
    and exponential 1 s -> 90 s, logging attempt 0 at info, attempts < 5 at
    warn, then error, and re-emitting 'attempt' events.  Here
    ``on_attempt(number, delay, err)`` receives the same information; abort
    by cancelling the awaiting task (the analog of ``retry.stop()``).
    """
    client = ZKClient(
        servers,
        timeout_ms=timeout_ms,
        connect_timeout_ms=connect_timeout_ms,
        reconnect_policy=retry_policy,  # None -> jittered RECONNECT_RETRY
        chroot=chroot,
        request_timeout_ms=request_timeout_ms,
        survive_session_expiry=survive_session_expiry,
        max_session_rebirths=max_session_rebirths,
        can_be_read_only=can_be_read_only,
        rng=rng,
        attach_preference=attach_preference,
        connect_race_stagger_ms=connect_race_stagger_ms,
        ping_interval_ms=ping_interval_ms,
        dead_after_ms=dead_after_ms,
    )
    return await connect_with_backoff(
        client, on_attempt=on_attempt, retry_policy=retry_policy
    )


async def connect_with_backoff(
    client: ZKClient,
    on_attempt=None,
    retry_policy: Optional[RetryPolicy] = None,
) -> ZKClient:
    """The reference's infinite-backoff initial connect, over an existing
    (possibly :meth:`ZKClient.seed_session`-staged) client.

    Split out of :func:`create_zk_client` for the handoff-resume path:
    the successor constructs and seeds the client itself, but
    the retry/backoff/logging envelope must be the daemon's usual one —
    including the case where the seeded reattach is refused mid-pass (the
    client resets to a fresh handshake and the NEXT attempt here builds
    the new session; ``SessionExpiredError`` is retryable for an open
    client).
    """

    def backoff_log(number: int, delay: float, err: Exception) -> None:
        level = (
            logging.INFO if number == 0
            else logging.WARNING if number < 5
            else logging.ERROR
        )
        log.log(
            level,
            "zookeeper: connection attempted (failed): attempt=%d delay=%.1fs err=%r",
            number, delay, err,
        )
        if on_attempt is not None:
            on_attempt(number, delay, err)

    await call_with_backoff(
        client.connect,
        retry_policy or CONNECT_RETRY,
        on_backoff=backoff_log,
        # A refused handoff resume raises SessionExpiredError but leaves
        # the client OPEN and reset to a fresh handshake: retry.  Only a
        # closed client (terminal expiry, close()) is unrecoverable.
        retryable=lambda err: not client.closed,
    )
    log.info("ZK: connected: %s", client)
    return client
