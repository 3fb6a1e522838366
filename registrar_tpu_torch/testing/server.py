"""An in-process ZooKeeper server for hermetic tests.

The reference's integration tests require a live ZooKeeper at
127.0.0.1:2181 (reference test/helper.js:57-62) — the single biggest
testing gap called out in SURVEY.md §4.  This module closes it: a real
asyncio TCP server speaking the ZooKeeper 3.4 client protocol (the same
subset our client uses), with genuine session semantics:

  * session establishment with timeout negotiation (clamped to
    [min_session_timeout, max_session_timeout]),
  * ephemeral nodes deleted when their owner session expires or closes,
  * session reattachment by (session_id, passwd) within the timeout,
  * one-shot watches (data / exists / children) with NodeCreated /
    NodeDeleted / NodeDataChanged / NodeChildrenChanged notifications,
  * zxid ordering across all write ops,
  * a real leader/follower replication protocol for ensembles:
    quorum-gated writes ordered by the elected leader, elections
    with a configurable window, read-only minority mode behind the 3.4
    ``read_only`` handshake flag, committed-backlog catch-up for
    rejoining members, and leader-only session expiry (see
    :class:`_SharedState` and :class:`ZKEnsemble`).

Because the client under test talks to this server over an actual socket,
the full wire path (framing, jute encoding, xid bookkeeping, watch
dispatch) is exercised, not mocked.  Tests can also force failures:
:meth:`ZKServer.expire_session`, :meth:`ZKServer.drop_connections`, and
the state-corruption controls :meth:`ZKServer.corrupt_node`
(out-of-band payload overwrite) and :meth:`ZKServer.seize_node`
(ephemeralOwner rewrite) that mint the drift classes the reconciler
sweeps for.

Run standalone for manual end-to-end runs of the daemon:

    python -m registrar_tpu_torch.testing.server --port 21811
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

from registrar_tpu_torch.events import spawn_owned
from registrar_tpu_torch.zk import protocol as proto
from registrar_tpu_torch.zk.framing import FrameReader
from registrar_tpu_torch.zk.jute import Reader, Writer
from registrar_tpu_torch.zk.protocol import Err, EventType, KeeperState, OpCode, Stat
from registrar_tpu_torch.zk.quota import (
    LIMITS_LEAF,
    QUOTA_ROOT,
    STATS_LEAF,
    format_quota,
    parse_quota,
)

log = logging.getLogger("registrar_tpu_torch.testing.server")


def _now_ms() -> int:
    return int(time.time() * 1000)


@dataclass
class ZNode:
    data: bytes = b""
    ephemeral_owner: int = 0
    children: Dict[str, "ZNode"] = field(default_factory=dict)
    czxid: int = 0
    mzxid: int = 0
    pzxid: int = 0
    ctime: int = 0
    mtime: int = 0
    version: int = 0
    cversion: int = 0
    aversion: int = 0
    acls: List[proto.ACL] = field(
        default_factory=lambda: list(proto.OPEN_ACL_UNSAFE)
    )

    def stat(self) -> Stat:
        return Stat(
            czxid=self.czxid,
            mzxid=self.mzxid,
            ctime=self.ctime,
            mtime=self.mtime,
            version=self.version,
            cversion=self.cversion,
            aversion=self.aversion,
            ephemeral_owner=self.ephemeral_owner,
            data_length=len(self.data),
            num_children=len(self.children),
            pzxid=self.pzxid,
        )

    def stat_packed(self) -> bytes:
        """The 68-byte wire Stat packed straight from the node fields —
        no :class:`Stat` dataclass intermediate (the EXISTS/GET_DATA
        reply fast lane under 1k–10k-znode sweeps).
        Byte-identity with ``self.stat()._packed()`` is pinned by
        tests/test_wire_golden.py."""
        return proto.pack_stat(
            self.czxid,
            self.mzxid,
            self.ctime,
            self.mtime,
            self.version,
            self.cversion,
            self.aversion,
            self.ephemeral_owner,
            len(self.data),
            len(self.children),
            self.pzxid,
        )


@dataclass
class Session:
    session_id: int
    passwd: bytes
    timeout_ms: int
    last_heard: float
    ephemerals: Set[str] = field(default_factory=set)
    conn: Optional["_Connection"] = None
    closed: bool = False
    # (scheme, id) identities granted via addauth on the *current*
    # connection — real ZK scopes auth to the connection, not the session,
    # so these are cleared when the carrying connection goes away.
    auth_ids: Set[Tuple[str, str]] = field(default_factory=set)

    @property
    def connected(self) -> bool:
        return self.conn is not None


#: sentinel returned by the sync GET_DATA fast lane when the request
#: must route through the async ``_dispatch`` (quota-stats refresh)
_SLOW_PATH = object()

#: quota subtree prefix (reads under it may rewrite the stats node)
_QUOTA_PREFIX = QUOTA_ROOT + "/"

#: Reply-batching caps: flush at least every this-many queued replies —
#: or this many queued bytes (a burst of big getData answers must not
#: buffer unboundedly; the per-reply drain this batching replaced was
#: also the memory backpressure) — even mid-burst (ZKServer._serve).
_MAX_QUEUED = 256

#: How long :meth:`ZKServer.stop` lets closing connections flush to their
#: peers before it aborts them.
_STOP_FLUSH_S = 0.5
_MAX_QUEUED_BYTES = 1 << 20


def _event_frame(ev_type: int, path: str) -> bytes:
    """The framed watcher-notification packet — the ONE encoder for both
    single-target sends and the fan-out path."""
    w = Writer()
    proto.ReplyHeader(
        xid=proto.XID_NOTIFICATION, zxid=-1, err=Err.OK
    ).write(w)
    proto.WatcherEvent(
        type=ev_type, state=KeeperState.SYNC_CONNECTED, path=path
    ).write(w)
    return proto.frame(w.to_bytes())


class _Connection:
    """One client TCP connection (carries at most one session)."""

    def __init__(self, server: "ZKServer", reader, writer):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.session: Optional[Session] = None
        self.closed = False
        peer = writer.get_extra_info("peername")
        self.peer_ip: Optional[str] = peer[0] if peer else None
        self._outbuf: List[bytes] = []
        self._outbytes = 0  # staged bytes (see queue_full)
        # Serializes writer.drain(): the serve loop and a watch fan-out
        # from another connection's task can drain concurrently, and
        # StreamWriter only supports multiple simultaneous drain waiters
        # on Python >= 3.11 (FlowControlMixin asserted a single waiter
        # before that).
        self._drain_lock = asyncio.Lock()

    def queue(self, payload: bytes) -> None:
        """Stage a reply for the next :meth:`flush`.

        The request loop queues replies while more pipelined requests
        are already buffered and flushes once per input burst — one
        send() syscall for a whole heartbeat sweep instead of one per
        reply.  Order with watch events is preserved because every path
        that emits a frame (send, send_event) drains this queue first.
        """
        framed = proto.frame(payload)
        self._outbuf.append(framed)
        self._outbytes += len(framed)

    def queue_full(self) -> bool:
        """True when the staged replies hit either batching cap — the
        request loop must flush even though the input burst continues."""
        return (
            len(self._outbuf) >= _MAX_QUEUED
            or self._outbytes >= _MAX_QUEUED_BYTES
        )

    def _write_out(self) -> None:
        """Join and write everything queued, counting packets_sent.

        ``packets_sent`` means *written to the transport* (real ZK's
        ``packetSent()`` increments when the packet leaves the outgoing
        queue, not on TCP delivery): counting here — the single point
        both the flush and fan-out paths funnel through — keeps frames
        on connections that die mid-burst counted, where the previous
        count-after-drain scheme leaked them (a closed connection's
        drain returned early and dropped its in-flight tally).
        """
        chunks, self._outbuf = self._outbuf, []
        self._outbytes = 0
        if not chunks:
            return
        try:
            self.writer.write(b"".join(chunks))
            self.server.packets_sent += len(chunks)
        except (ConnectionError, OSError):
            pass  # the follow-up drain() surfaces the loss and closes

    async def flush(self) -> None:
        if self.closed:
            self._outbuf.clear()
            self._outbytes = 0
            return
        self._write_out()
        await self.drain()

    async def send(self, payload: bytes) -> None:
        if self.closed:
            return
        self.queue(payload)
        await self.flush()

    def post_framed(self, framed: bytes) -> None:
        """Synchronously write an already-framed packet (behind any queued
        replies, preserving per-connection order); the caller awaits
        :meth:`drain` afterwards.  Lets a watch-event fan-out write every
        watcher back-to-back without interleaved awaits."""
        if self.closed:
            return
        self._outbuf.append(framed)
        self._write_out()

    async def drain(self) -> None:
        """Await transport flow control (accounting happens at
        :meth:`_write_out` — see its docstring for the packets_sent
        semantics)."""
        if self.closed:
            return
        async with self._drain_lock:
            try:
                await self.writer.drain()
            except (ConnectionError, OSError):
                await self.close()

    async def send_event(self, ev_type: int, path: str) -> None:
        self.post_framed(_event_frame(ev_type, path))
        await self.drain()

    async def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self.session is not None and self.session.conn is self:
            # Connection gone; the session lingers until its timeout, but
            # auth is per-connection (real ZK keeps authInfo on the cnxn) —
            # a reattaching client must replay addauth.
            self.session.conn = None
            self.session.auth_ids.clear()
        try:
            self.writer.close()
        except Exception:
            pass


# Watch kind -> which event types clear it.
_WATCH_DATA = "data"
_WATCH_EXIST = "exist"
_WATCH_CHILD = "child"

#: admin "four letter word" commands answered on the client port, like real
#: ZooKeeper (operator runbooks probe ensemble health with `ruok`/`srvr`/
#: `mntr` — e.g. the checks the reference's README pairs with zkCli.sh).
_FOUR_LETTER_WORDS = frozenset(
    w.encode()
    for w in (
        "ruok", "srvr", "stat", "mntr", "cons", "dump", "wchs", "isro",
        "wchc", "wchp", "envi", "conf",
    )
)

_SERVER_VERSION = "3.4.14-registrar-tpu-testing"

#: state-changing (quorum) opcodes gated by the replication write gate:
#: a read-only member answers them NOT_READONLY, a mid-election member
#: drops the connection.  SYNC is quorum-bound too — it flushes the
#: leader's pipeline, which a partitioned minority cannot reach.
_QUORUM_OPS = frozenset(
    (
        OpCode.CREATE, OpCode.DELETE, OpCode.SET_DATA, OpCode.SET_ACL,
        OpCode.MULTI, OpCode.SYNC,
    )
)


class _SharedState:
    """Replicated state an ensemble's members hold in common.

    Real ZooKeeper members replicate the znode tree, session table, and
    zxid via ZAB; an in-process ensemble models the *converged* result by
    letting every member operate on one state object (the tests all run
    in a single event loop, so each request applies atomically — the same
    linearizable history ZAB would produce).  Watches live here too: a
    write through member A must notify a watcher connected to member B,
    exactly as in a real ensemble.

    Members configured with ``apply_delay_ms`` opt out of instant
    convergence on the *read* side: their read view freezes at the
    pre-commit state when another member commits, and catches up on
    sync()/own-write/quiescence (see ZKServer.apply_delay_ms) — the
    stale-follower-read behavior sync() exists to fence.

    The replication *protocol* sits on top of the replicated
    state: one elected leader orders and commits writes (ZAB-style zxid
    ordering through :meth:`ZKServer._next_zxid`, which also appends to
    the committed-backlog ``log``), and a write is only admitted while
    the serving member can reach a leader holding **quorum**
    (``ensemble_size // 2 + 1`` live members in its partition group).  A
    member cut off from quorum degrades to ZooKeeper's read-only mode:
    its read view freezes (majority commits are invisible across a
    partition), the ``read_only`` handshake flag gates which clients may
    attach, and writes answer ``Err.NOT_READONLY``.  Elections take
    ``election_ms`` (members are ``looking`` and drop writers meanwhile,
    like real followers that lost their leader); only the leader expires
    sessions, so a quorum-less ensemble keeps every session — and its
    ephemerals — frozen until quorum returns, exactly the property the
    registrar fleet's "writes resume without operator action" recovery
    depends on.
    """

    def __init__(self) -> None:
        self.root = ZNode(czxid=0, ctime=_now_ms(), mtime=_now_ms())
        self.zxid = 0
        self.sessions: Dict[int, Session] = {}
        self.next_session = int(time.time()) << 24
        # path -> set of connections, per watch kind
        self.watches: Dict[str, Dict[str, Set[_Connection]]] = {
            _WATCH_DATA: {},
            _WATCH_EXIST: {},
            _WATCH_CHILD: {},
        }
        #: live members, so a commit through one can freeze the stale read
        #: view of members configured with an apply delay (see
        #: ZKServer.apply_delay_ms)
        self.members: Set["ZKServer"] = set()
        #: monotonic time of the newest commit — drives lagging members'
        #: quiescence-based catch-up
        self.last_commit = 0.0
        #: members currently configured with apply_delay_ms > 0.  Kept as
        #: a count (recomputed on membership/lag changes, which are rare)
        #: so the per-commit freeze scan in _next_zxid is skipped entirely
        #: in the common no-lag case — the write hot path must not pay for
        #: a feature no member uses.
        self.lag_members = 0
        #: path -> zxid of its newest create, recorded only while a member
        #: is configured to lag and cleared once every member has caught
        #: up.  Lets _catch_up detect a node created *and deleted* within
        #: a lag window: the stale/live diff shows nothing, but a real
        #: follower applying the backlog would still fire the armed
        #: exists watch's NODE_CREATED.
        self.lag_creates: Dict[str, int] = {}
        # -- replication protocol; inert for standalone
        # -- servers, configured by ZKEnsemble ---------------------------
        #: configured member count (NOT live count: quorum arithmetic is
        #: over the configured ensemble, like real ZK's QuorumMaj)
        self.ensemble_size = 1
        #: writes need a leader that can reach this many live members
        self.quorum = 1
        #: election duration (ms): leader death -> new leader serving
        self.election_ms = 0.0
        #: the elected leader, or None (mid-election / quorum lost)
        self.leader: Optional["ZKServer"] = None
        #: monotonic deadline of the pending election; None = no pending
        self.election_due: Optional[float] = None
        #: monotonic stamp of the current election's start (MTTR math)
        self.election_started: Optional[float] = None
        #: completed elections (test/4lw observability)
        self.elections = 0
        #: member-connectivity partition groups as sets of server_ids;
        #: None = fully connected (set via ZKEnsemble.partition)
        self.groups: Optional[List[Set[int]]] = None
        #: committed-transaction backlog: (zxid, op, path) per commit,
        #: bounded — a rejoining member whose departure point fell off
        #: the tail must take a full snapshot instead of a diff replay
        #: (ZKEnsemble(backlog_max=...) sizes it)
        self.log: Deque[Tuple[int, str, str]] = deque(maxlen=512)
        ensure_system_nodes(self.root)

    def recount_lag(self) -> None:
        self.lag_members = sum(
            1 for m in self.members if m.apply_delay_ms > 0
        )

    # -- quorum / election ----------------------------------------

    def _group_ids(self, server_id: int) -> Optional[Set[int]]:
        """The partition group containing ``server_id`` (None = all)."""
        if self.groups is None:
            return None
        for group in self.groups:
            if server_id in group:
                return group
        return {server_id}  # unlisted member: isolated

    def reachable(self, member: "ZKServer") -> List["ZKServer"]:
        """Live members ``member`` can talk to (its partition group)."""
        group = self._group_ids(member.server_id)
        return [
            m for m in self.members
            if group is None or m.server_id in group
        ]

    def _quorum_candidates(self) -> List["ZKServer"]:
        return [
            m for m in self.members if len(self.reachable(m)) >= self.quorum
        ]

    def reevaluate(self) -> None:
        """Recompute leadership and roles after a membership or
        partition change.

        A live leader that still reaches quorum keeps the crown (a
        rejoining follower never forces an election, like real ZK); a
        dead or isolated leader starts an election over the members that
        can still assemble quorum, completing after ``election_ms``
        (the sweep loops drive completion; 0 = instant).  With no quorum
        anywhere, every member degrades to read-only and the election
        stays parked until membership changes again.
        """
        lead = self.leader
        if (
            lead is not None
            and lead in self.members
            and len(self.reachable(lead)) >= self.quorum
        ):
            self.election_due = None
            self._assign_roles(lead)
            return
        self.leader = None
        candidates = self._quorum_candidates()
        if not candidates:
            # No quorum anywhere: park the election, everyone read-only.
            self.election_due = None
            self.election_started = None
            self._assign_roles(None)
            return
        now = time.monotonic()
        if self.election_due is None:
            self.election_started = now
            self.election_due = now + self.election_ms / 1000.0
            for member in self.members:
                member._set_role(
                    "looking" if member in candidates else "read-only"
                )
        if self.election_ms <= 0 or now >= self.election_due:
            self.complete_election()

    def complete_election(self) -> None:
        """Elect the most-caught-up candidate (highest applied zxid,
        ties to the lowest server_id — real ZK's epoch/zxid/sid order)."""
        self.election_due = None
        candidates = self._quorum_candidates()
        if not candidates:
            self._assign_roles(None)
            return
        leader = max(
            candidates, key=lambda m: (m._view_zxid(), -m.server_id)
        )
        self.elections += 1
        elapsed = (
            time.monotonic() - self.election_started
            if self.election_started is not None
            else 0.0
        )
        self.election_started = None
        log.debug(
            "member %d elected leader (election %d, %.0f ms)",
            leader.server_id, self.elections, elapsed * 1000.0,
        )
        self._assign_roles(leader)

    def _assign_roles(self, leader: Optional["ZKServer"]) -> None:
        self.leader = leader
        in_quorum = (
            set(self.reachable(leader)) if leader is not None else set()
        )
        for member in self.members:
            if member in in_quorum:
                member._set_role(
                    "leader" if member is leader else "follower"
                )
            else:
                member._set_role("read-only")


def ensure_system_nodes(root: ZNode) -> None:
    zk = root.children.setdefault("zookeeper", ZNode(ctime=_now_ms()))
    zk.children.setdefault("quota", ZNode(ctime=_now_ms()))


def _clone_tree(node: ZNode) -> ZNode:
    """Deep point-in-time copy of a znode subtree (a lagging member's
    frozen read view).  Immutable payloads (bytes) are shared; structure,
    stats, and ACL lists are copied."""
    return ZNode(
        data=node.data,
        ephemeral_owner=node.ephemeral_owner,
        children={k: _clone_tree(v) for k, v in node.children.items()},
        czxid=node.czxid,
        mzxid=node.mzxid,
        pzxid=node.pzxid,
        ctime=node.ctime,
        mtime=node.mtime,
        version=node.version,
        cversion=node.cversion,
        aversion=node.aversion,
        acls=list(node.acls),
    )


class ZKServer:
    """Single-node in-process ZooKeeper (see module docstring)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        min_session_timeout_ms: int = 100,
        max_session_timeout_ms: int = 60_000,
        tick_ms: int = 50,
        snapshot: Optional["ZKServer"] = None,
        shared: Optional[_SharedState] = None,
        server_id: int = 0,
        apply_delay_ms: int = 0,
    ):
        """``snapshot``: adopt another (stopped) server's tree, sessions,
        and zxid — models a real ensemble surviving a member restart, so
        rolling-restart scenarios (client reattaches, ephemerals survive)
        are testable.  Session expiry countdowns restart from now.

        ``shared``: join a live ensemble's replicated state (see
        :class:`ZKEnsemble`); mutually exclusive with ``snapshot``.

        ``apply_delay_ms``: model a lagging follower.  When > 0, a commit
        made through any *other* member freezes this member's read view
        at the pre-commit state; reads served here stay stale until the
        member catches up — on ``sync()`` through it (the client-visible
        barrier real ZooKeeper's sync provides), on a write it serves
        itself (ZooKeeper's read-your-writes guarantee: a follower applies
        a commit before acking it to the issuing client), or once the
        commit stream has been quiescent for ``apply_delay_ms`` (the
        sweeper's batch catch-up; under continuous churn the member stays
        behind, as a saturated real follower would).  Watches still fire
        from the replicated state, which may notify a client of a change
        its next read does not show yet — the same reordering a real
        follower's event pipeline can exhibit.  See ZKEnsemble.set_lag.
        """
        self.host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self.min_session_timeout_ms = min_session_timeout_ms
        self.max_session_timeout_ms = max_session_timeout_ms
        self.tick_ms = tick_ms
        self.server_id = server_id
        #: the member's replication role, reported by the srvr/mntr admin
        #: words and enforced by the write gate: "standalone" (no
        #: ensemble), "leader" / "follower" (in quorum), "read-only"
        #: (minority / quorum lost), "looking" (mid-election).  Assigned
        #: by _SharedState.reevaluate for ensemble members.
        self.mode = "standalone"
        self._is_ensemble_member = shared is not None
        if snapshot is not None and shared is not None:
            raise ValueError("snapshot= and shared= are mutually exclusive")
        if snapshot is not None:
            if snapshot._server is not None:
                raise ValueError(
                    "snapshot donor must be stopped first (its tree and "
                    "sessions are adopted by reference)"
                )
            if snapshot._is_ensemble_member:
                # The donor's state is the ensemble's live shared state;
                # adopting it would alias a running ensemble (and the watch
                # reset below would wipe the live members' watch tables).
                raise ValueError(
                    "cannot adopt an ensemble member as a snapshot donor; "
                    "use ZKEnsemble.restart() to rejoin the ensemble"
                )
            self._state = snapshot._state
            # The donor is stopped, so every watch-holding connection is
            # dead; start from a clean watch table.
            self._state.watches = {
                _WATCH_DATA: {},
                _WATCH_EXIST: {},
                _WATCH_CHILD: {},
            }
            self._adopted_sessions = True
            for sess in self.sessions.values():
                sess.conn = None
        elif shared is not None:
            self._state = shared
        else:
            self._state = _SharedState()
        self._server: Optional[asyncio.AbstractServer] = None
        self._sweeper: Optional[asyncio.Task] = None
        self._conns: Set[_Connection] = set()
        #: every accepted connection's transport, until it is collected:
        #: a closed connection's transport lives on while it flushes.
        self._transports: "weakref.WeakSet[asyncio.BaseTransport]" = (
            weakref.WeakSet()
        )
        # Fire-and-forget fan-out tasks (lag-watch reconciliation).  The
        # event loop only weak-references running tasks, so a discarded
        # create_task() handle can be garbage-collected mid-flight; this
        # set owns them until done, and stop() cancels stragglers.
        self._bg_tasks: Set[asyncio.Task] = set()
        #: number of sessions expired by the sweeper (test observability)
        self.expired_count = 0
        #: connections refused because the client had seen a newer zxid
        #: than this member's view (test observability)
        self.refused_count = 0
        #: handshakes refused because this member is read-only and the
        #: client did not offer the read_only flag (test observability)
        self.refused_ro = 0
        #: handshakes refused because this member was mid-election
        #: ("looking"; test observability — distinct from refused_count's
        #: newer-zxid refusals)
        self.refused_looking = 0
        #: write requests answered NOT_READONLY while read-only
        self.writes_refused = 0
        #: write connections dropped mid-election ("looking")
        self.election_drops = 0
        #: commits this member ordered while leader (ZAB observability)
        self.commits = 0
        #: writes this member forwarded to the leader while follower
        self.forwarded_writes = 0
        #: catch-up bookkeeping: committed-backlog txns replayed on
        #: rejoin/catch-up, and full-snapshot restores (backlog truncated
        #: past the member's departure point)
        self.catchup_replayed = 0
        self.catchup_snapshots = 0
        #: soft-quota violations logged by this member (test observability)
        self.quota_warnings = 0
        #: request/reply counters surfaced via the 4lw admin commands.
        #: packets_sent counts frames *written* to the transport (real
        #: ZK's packetSent(), incremented as the packet leaves the
        #: outgoing queue), not frames the peer provably received.
        self.packets_received = 0
        self.packets_sent = 0
        # While a multi transaction applies, watch events queue here so the
        # apply loop never awaits (no other connection's request can
        # interleave with a half-applied transaction); flushed on commit.
        self._deferred_events: Optional[List[tuple]] = None
        #: when True, requests are read but never answered (still counted as
        #: session liveness) — simulates a wedged-but-connected server for
        #: client watchdog tests
        self.freeze = False
        #: replication lag (see __init__ docstring); mutable at runtime
        self.apply_delay_ms = apply_delay_ms
        #: frozen stale read view while behind; None = caught up
        self._lag_root: Optional[ZNode] = None
        #: the zxid the frozen view corresponds to (stamped on replies
        #: while lagging); meaningful only when _lag_root is not None
        self._lag_zxid = 0
        #: watches armed against the stale view — each may guard a
        #: transition that already committed, so catch-up must deliver
        #: the missed event (real ZK fires it when the follower applies
        #: the txn); list of (kind, path, conn)
        self._lag_watches: List[Tuple[str, str, _Connection]] = []

    # -- replicated state (delegates to _SharedState so ensemble members
    # -- converge by construction; standalone servers own a private one) ----

    @property
    def root(self) -> ZNode:
        return self._state.root

    @root.setter
    def root(self, value: ZNode) -> None:
        self._state.root = value

    @property
    def zxid(self) -> int:
        return self._state.zxid

    @zxid.setter
    def zxid(self, value: int) -> None:
        self._state.zxid = value

    @property
    def sessions(self) -> Dict[int, Session]:
        return self._state.sessions

    @sessions.setter
    def sessions(self, value: Dict[int, Session]) -> None:
        self._state.sessions = value

    @property
    def _next_session(self) -> int:
        return self._state.next_session

    @_next_session.setter
    def _next_session(self, value: int) -> None:
        self._state.next_session = value

    @property
    def _watches(self) -> Dict[str, Dict[str, Set["_Connection"]]]:
        return self._state.watches

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "ZKServer":
        if getattr(self, "_adopted_sessions", False):
            # Expiry countdowns restart when service resumes, not at
            # construction — a gap between __init__ and start() must not
            # expire adopted sessions.
            now = time.monotonic()
            for sess in self.sessions.values():
                sess.last_heard = now
            self._adopted_sessions = False
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self._requested_port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._state.members.add(self)
        self._state.recount_lag()
        if self._is_ensemble_member:
            # Joining member: roles recompute (a live leader keeps the
            # crown; a quorum-less ensemble may become electable again).
            self._state.reevaluate()
        self._sweeper = asyncio.create_task(self._sweep_loop())
        log.debug("ZKServer listening on %s:%d", self.host, self.port)
        return self

    def _spawn(self, coro) -> "asyncio.Task":
        """Run a fire-and-forget coroutine as an owned background task
        (cancelled by stop(), unlike emit()'s dispatch tasks)."""
        return spawn_owned(coro, self._bg_tasks)

    async def stop(self) -> None:
        self._state.members.discard(self)
        self._state.recount_lag()
        if self._is_ensemble_member:
            # Departing member: a dead leader triggers an election; a
            # death that breaks quorum degrades the survivors to
            # read-only (their write gate starts refusing).
            self._state.reevaluate()
        if self._sweeper:
            self._sweeper.cancel()
            try:
                await self._sweeper
            except asyncio.CancelledError:
                pass
        for task in list(self._bg_tasks):
            task.cancel()
        if self._bg_tasks:
            await asyncio.gather(*self._bg_tasks, return_exceptions=True)
        for conn in list(self._conns):
            await conn.close()
        if self._server:
            self._server.close()
            closed = asyncio.ensure_future(self._server.wait_closed())
            # wait_closed() returns once every accepted connection has
            # dropped.  A closed connection whose peer stops reading (a
            # proxy under a netem toxic) never finishes its flush, and a
            # connection whose handler started after the sweep above (a
            # client that reconnected at once) is still served: either
            # would hold this member's stop open for as long as its peer
            # lets it.  After a grace to flush, abort what is left.
            await asyncio.wait({closed}, timeout=_STOP_FLUSH_S)
            while not closed.done():
                for conn in list(self._conns):
                    await conn.close()
                for transport in list(self._transports):
                    transport.abort()
                await asyncio.wait({closed}, timeout=0.05)
            self._server = None  # marks this instance as a valid snapshot donor

    async def __aenter__(self) -> "ZKServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    # -- replication roles ----------------------------------------

    def _freeze_view(self) -> None:
        """Pin this member's read view at the current replicated state
        (used on entering read-only: majority commits made across a
        partition must be invisible here until the member rejoins)."""
        if self._lag_root is None:
            self._lag_root = _clone_tree(self._state.root)
            self._lag_zxid = self._state.zxid

    def _set_role(self, role: str) -> None:
        """Apply a role transition computed by the shared-state election.

        Entering ``read-only`` freezes the read view and drops every
        client connection (real ZK restarts the server in ro mode; the
        surviving clients must renegotiate with the ``read_only``
        handshake flag or fail over).  Leaving it catches the member up
        — counted as backlog replay or a snapshot restore — and drops
        connections again so ro sessions renegotiate to read-write.
        Leader/follower churn keeps connections: a follower serving a
        client does not care which member orders the commits.
        """
        old = self.mode
        if old == role:
            return
        self.mode = role
        if role == "read-only":
            self._freeze_view()
            if old in ("leader", "follower", "looking"):
                self._spawn(self.drop_connections())
            log.debug("member %d degraded to read-only", self.server_id)
        elif old == "read-only":
            self._count_catchup()
            self._catch_up()
            self._spawn(self.drop_connections())
            log.debug(
                "member %d rejoined quorum as %s", self.server_id, role
            )

    def _count_catchup(self) -> None:
        """Account a frozen (read-only) member's pending catch-up from
        its applied zxid — the rejoin-after-partition shape."""
        if self._lag_root is not None:
            self.catchup_from(self._lag_zxid)

    def catchup_from(self, departed_zxid: Optional[int]) -> None:
        """Account a rejoin sync from ``departed_zxid`` — the ONE copy
        of the classification rule, shared by restart-after-kill
        (ZKEnsemble.restart) and partition-heal (_count_catchup): diff
        replay when the committed backlog still covers the departure
        point, else a full snapshot restore (real ZK's DIFF vs SNAP)."""
        if departed_zxid is None or self._state.zxid <= departed_zxid:
            return
        backlog = self._state.log
        if backlog and backlog[0][0] <= departed_zxid + 1:
            self.catchup_replayed += sum(
                1 for zxid, _, _ in backlog if zxid > departed_zxid
            )
        else:
            # The departure point fell off the bounded backlog: a real
            # member would transfer a full snapshot (SNAP sync).
            self.catchup_snapshots += 1

    def _write_gate(self) -> str:
        """Admission verdict for a state-changing request on this member:
        ``"ok"`` (leader reachable with quorum — commit proceeds),
        ``"ro"`` (read-only: answer NOT_READONLY), ``"drop"``
        (mid-election: drop the connection, like a follower that lost
        its leader)."""
        if not self._is_ensemble_member:
            return "ok"
        if self.mode in ("leader", "follower"):
            return "ok"
        if self.mode == "looking":
            return "drop"
        return "ro"

    # -- test controls ------------------------------------------------------

    async def expire_session(self, session_id: int) -> None:
        """Force-expire a session (kills its connection, drops ephemerals)."""
        sess = self.sessions.get(session_id)
        if sess is None:
            return
        await self._expire(sess)

    async def drop_connections(self) -> None:
        """Sever all client TCP connections without expiring sessions."""
        for conn in list(self._conns):
            await conn.close()

    async def corrupt_node(self, path: str, data: bytes) -> None:
        """Overwrite a znode's payload out-of-band (a drift control).

        Models an operator's ``zkcli set`` / a tool clobbering a record:
        a genuine setData (version bump, mzxid, data watches fire), just
        not issued by the owner — exactly the drift the reconciler's
        ``payload``/``staleService`` sweep exists to catch.  Raises
        ZKError(NO_NODE) when the path does not exist.
        """
        await self._set_data_node(path, data, -1)

    def seize_node(self, path: str, owner: int) -> None:
        """Rewrite a node's ephemeralOwner (a drift control).

        Models the ownership corruptions a live run can be left with — a
        zombie predecessor's stale znode (owner = a dead/foreign session
        id), or a node flattened to persistent (owner = 0) by a bad
        restore.  Session ephemeral-sets are kept coherent so the expiry
        sweeper's behavior stays honest.  KeyError when the path does
        not exist.
        """
        node = self._resolve(path)
        if node.ephemeral_owner:
            prev = self.sessions.get(node.ephemeral_owner)
            if prev is not None:
                prev.ephemerals.discard(path)
        node.ephemeral_owner = owner
        if owner:
            sess = self.sessions.get(owner)
            if sess is not None:
                sess.ephemerals.add(path)

    def get_node(self, path: str) -> Optional[ZNode]:
        """Direct tree access for assertions (bypasses the protocol)."""
        try:
            return self._resolve(path)
        except KeyError:
            return None

    def dump_tree(self, path: str = "/") -> Dict[str, bytes]:
        """Flat {path: data} map of the subtree at ``path`` (tooling/tests)."""
        out: Dict[str, bytes] = {}

        def walk(node: ZNode, prefix: str) -> None:
            out[prefix or "/"] = node.data
            for name, child in sorted(node.children.items()):
                walk(child, f"{prefix}/{name}")

        try:
            start = self._resolve(path)
        except KeyError:
            return out
        walk(start, "" if path == "/" else path.rstrip("/"))
        return out

    # -- disk snapshots ------------------------------------------------------
    #
    # Real ZooKeeper persists its tree in snapshot + txlog files so a
    # restarted member comes back with the same data, zxid, and session
    # table (sessions then expire normally unless their clients reattach).
    # The standalone dev server models that with a single JSON snapshot:
    # save on shutdown, load on start.  Like the in-memory ``snapshot=``
    # donor, loaded sessions resume disconnected with their expiry
    # countdown restarted.

    def save_snapshot(self, path: str) -> None:
        """Atomically write the tree + session table + zxid to ``path``."""
        import base64
        import json

        nodes = []

        def walk(node: ZNode, prefix: str) -> None:
            nodes.append(
                {
                    "path": prefix or "/",
                    "data": base64.b64encode(node.data).decode(),
                    "ephemeral_owner": node.ephemeral_owner,
                    "czxid": node.czxid,
                    "mzxid": node.mzxid,
                    "pzxid": node.pzxid,
                    "ctime": node.ctime,
                    "mtime": node.mtime,
                    "version": node.version,
                    "cversion": node.cversion,
                    "aversion": node.aversion,
                    "acls": [
                        {"perms": a.perms, "scheme": a.scheme, "id": a.id}
                        for a in node.acls
                    ],
                }
            )
            for name, child in sorted(node.children.items()):
                walk(child, f"{prefix}/{name}")

        walk(self.root, "")
        payload = {
            "format": 1,
            "zxid": self.zxid,
            "next_session": self._next_session,
            "sessions": [
                {
                    "session_id": s.session_id,
                    "passwd": base64.b64encode(s.passwd).decode(),
                    "timeout_ms": s.timeout_ms,
                    "ephemerals": sorted(s.ephemerals),
                }
                for s in self.sessions.values()
                if not s.closed
            ],
            "nodes": nodes,
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load_snapshot(self, path: str) -> None:
        """Replace this (not-yet-started) server's state from a snapshot."""
        import base64
        import json

        if self._server is not None:
            raise RuntimeError("load_snapshot before start()")
        with open(path, "r", encoding="utf-8") as f:
            payload = json.load(f)
        if payload.get("format") != 1:
            raise ValueError(f"unknown snapshot format {payload.get('format')!r}")

        self.zxid = int(payload["zxid"])
        self._next_session = int(payload["next_session"])
        self.root = ZNode()
        for entry in payload["nodes"]:
            node = ZNode(
                data=base64.b64decode(entry["data"]),
                ephemeral_owner=int(entry["ephemeral_owner"]),
                czxid=int(entry["czxid"]),
                mzxid=int(entry["mzxid"]),
                pzxid=int(entry["pzxid"]),
                ctime=int(entry["ctime"]),
                mtime=int(entry["mtime"]),
                version=int(entry["version"]),
                cversion=int(entry["cversion"]),
                aversion=int(entry["aversion"]),
                acls=[
                    proto.ACL(a["perms"], a["scheme"], a["id"])
                    for a in entry["acls"]
                ],
            )
            p = entry["path"]
            if p == "/":
                node.children = self.root.children
                self.root = node
                continue
            parent_path, name = self._split(p)
            self._resolve(parent_path).children[name] = node  # parents first
        ensure_system_nodes(self.root)  # snapshots may predate /zookeeper
        self.sessions = {}
        for s in payload["sessions"]:
            sess = Session(
                session_id=int(s["session_id"]),
                passwd=base64.b64decode(s["passwd"]),
                timeout_ms=int(s["timeout_ms"]),
                last_heard=time.monotonic(),
                ephemerals=set(s["ephemerals"]),
            )
            self.sessions[sess.session_id] = sess
        # Countdowns restart when service resumes (same as the in-memory
        # snapshot donor path in start()).
        self._adopted_sessions = True

    # -- 4-letter-word admin commands ---------------------------------------

    def _count_nodes(self) -> Tuple[int, int]:
        """(znode count, approximate data size) over this member's read
        view — a lagging follower reports what it has applied, like real
        ZooKeeper's stats."""
        count, size = 0, 0
        stack = [self._lag_root if self._lag_root is not None else self.root]
        while stack:
            node = stack.pop()
            count += 1
            size += len(node.data)
            stack.extend(node.children.values())
        return count, size

    def _watch_stats(self) -> Tuple[int, int]:
        """(total watch registrations, distinct watched paths)."""
        total, paths = 0, set()
        for kind in self._watches.values():
            for path, conns in kind.items():
                total += len(conns)
                paths.add(path)
        return total, len(paths)

    def _four_letter(self, cmd: str) -> str:
        """Answer an admin command with real-ZooKeeper-shaped text."""
        if cmd == "ruok":
            return "imok"
        if cmd == "isro":
            # "ro" for a read-only (minority) member — and mid-election,
            # when the member cannot admit writers either; the client's
            # rw-probe uses this to find a serving read-write member.
            return (
                "ro" if self.mode in ("read-only", "looking") else "rw"
            )
        nodes, data_size = self._count_nodes()
        watches, watched_paths = self._watch_stats()
        if cmd == "srvr" or cmd == "stat":
            lines = []
            if cmd == "stat":
                lines.append(f"Zookeeper version: {_SERVER_VERSION}")
                lines.append("Clients:")
                for conn in self._conns:
                    peer = conn.writer.get_extra_info("peername") or ("?", 0)
                    sid = conn.session.session_id if conn.session else 0
                    lines.append(f" /{peer[0]}:{peer[1]}[1](sid=0x{sid:x})")
                lines.append("")
            else:
                lines.append(f"Zookeeper version: {_SERVER_VERSION}")
            lines += [
                "Latency min/avg/max: 0/0/0",
                f"Received: {self.packets_received}",
                f"Sent: {self.packets_sent}",
                f"Connections: {len(self._conns)}",
                "Outstanding: 0",
                # a lagging follower reports the zxid it has applied up
                # to (real ZK's lastProcessedZxid), so `admin srvr`
                # against each member makes replication lag visible
                f"Zxid: 0x{self._view_zxid():x}",
                f"Mode: {self.mode}",
                f"Node count: {nodes}",
            ]
            if self._is_ensemble_member:
                # Election/quorum observability: operators and
                # tests read the member's real role, applied zxid (the
                # Zxid line above), and quorum shape off one probe.
                lines += [
                    f"Quorum size: {self._state.quorum}",
                    f"Ensemble size: {self._state.ensemble_size}",
                    f"Elections: {self._state.elections}",
                ]
            return "\n".join(lines) + "\n"
        if cmd == "mntr":
            ephemerals = sum(len(s.ephemerals) for s in self.sessions.values())
            rows = [
                ("zk_version", _SERVER_VERSION),
                ("zk_avg_latency", 0),
                ("zk_packets_received", self.packets_received),
                ("zk_packets_sent", self.packets_sent),
                ("zk_num_alive_connections", len(self._conns)),
                ("zk_outstanding_requests", 0),
                ("zk_server_state", self.mode),
                ("zk_znode_count", nodes),
                ("zk_watch_count", watches),
                ("zk_ephemerals_count", ephemerals),
                ("zk_approximate_data_size", data_size),
                ("zk_expired_sessions", self.expired_count),
            ]
            if self._is_ensemble_member:
                rows += [
                    ("zk_quorum_size", self._state.quorum),
                    ("zk_ensemble_size", self._state.ensemble_size),
                    ("zk_applied_zxid", self._view_zxid()),
                    ("zk_elections", self._state.elections),
                    ("zk_write_refusals", self.writes_refused),
                    ("zk_leader_commits", self.commits),
                    ("zk_forwarded_writes", self.forwarded_writes),
                    ("zk_catchup_replayed_txns", self.catchup_replayed),
                    ("zk_catchup_snapshot_loads", self.catchup_snapshots),
                ]
            return "".join(f"{k}\t{v}\n" for k, v in rows)
        if cmd == "cons":
            lines = []
            for conn in self._conns:
                peer = conn.writer.get_extra_info("peername") or ("?", 0)
                sid = conn.session.session_id if conn.session else 0
                timeout = conn.session.timeout_ms if conn.session else 0
                lines.append(
                    f" /{peer[0]}:{peer[1]}[1]"
                    f"(sid=0x{sid:x},to={timeout})"
                )
            return "\n".join(lines) + "\n"
        if cmd == "dump":
            lines = ["SessionTracker dump:", f"Session Sets ({len(self.sessions)}):"]
            for sid, sess in sorted(self.sessions.items()):
                lines.append(f"0x{sid:x}\t{sess.timeout_ms}ms")
            lines.append("ephemeral nodes dump:")
            with_eph = {
                sid: s for sid, s in self.sessions.items() if s.ephemerals
            }
            lines.append(f"Sessions with Ephemerals ({len(with_eph)}):")
            for sid, sess in sorted(with_eph.items()):
                lines.append(f"0x{sid:x}:")
                lines.extend(f"\t{p}" for p in sorted(sess.ephemerals))
            return "\n".join(lines) + "\n"
        if cmd in ("wchc", "wchp"):
            # One traversal of the watch tables yields (sid, path) pairs;
            # wchc groups by session, wchp by path (like real ZK).
            pairs = {
                (c.session.session_id if c.session else 0, path)
                for kind in self._watches.values()
                for path, conns in kind.items()
                for c in conns
            }
            grouped: Dict[object, Set[object]] = {}
            for sid, path in pairs:
                key, member = (sid, path) if cmd == "wchc" else (path, sid)
                grouped.setdefault(key, set()).add(member)

            def show(v: object) -> str:
                return f"0x{v:x}" if isinstance(v, int) else str(v)

            # Keys are homogeneous per command (ints for wchc, paths for
            # wchp), so plain sorted() orders sessions numerically; show()
            # is formatting only.
            lines = []
            for key in sorted(grouped):
                lines.append(show(key))
                lines.extend(f"\t{show(m)}" for m in sorted(grouped[key]))
            return "\n".join(lines) + "\n"
        if cmd == "envi":
            import platform
            import sys as _sys

            rows = [
                ("zookeeper.version", _SERVER_VERSION),
                ("host.name", platform.node()),
                ("os.name", platform.system()),
                ("os.arch", platform.machine()),
                ("python.version", platform.python_version()),
                ("python.executable", _sys.executable),
            ]
            return "Environment:\n" + "".join(
                f"{k}={v}\n" for k, v in rows
            )
        if cmd == "conf":
            rows = [
                ("clientPort", self.port),
                ("minSessionTimeout", self.min_session_timeout_ms),
                ("maxSessionTimeout", self.max_session_timeout_ms),
                ("tickTime", self.tick_ms),
                ("serverId", self.server_id),
            ]
            return "".join(f"{k}={v}\n" for k, v in rows)
        if cmd == "wchs":
            conns_watching = len(
                {
                    id(c)
                    for kind in self._watches.values()
                    for conns in kind.values()
                    for c in conns
                }
            )
            return (
                f"{conns_watching} connections watching {watched_paths} paths\n"
                f"Total watches:{watches}\n"
            )
        return ""  # unreachable: _FOUR_LETTER_WORDS gates entry

    # -- session sweeper ----------------------------------------------------

    async def _sweep_loop(self) -> None:
        while True:
            await asyncio.sleep(self.tick_ms / 1000.0)
            now = time.monotonic()
            # A pending election completes after election_ms (driven by
            # whichever member's sweeper ticks first — deterministic to
            # within one tick, which the tests budget for).
            st = self._state
            if st.election_due is not None and now >= st.election_due:
                st.complete_election()
            # Lagging member batch catch-up: once the commit stream has
            # been quiescent for apply_delay_ms, the member applies its
            # backlog (real followers stream commits; quiescence-gating is
            # what keeps the frozen view a true point-in-time prefix).
            if (
                self._lag_root is not None
                and self.apply_delay_ms > 0
                and now - self._state.last_commit >= self.apply_delay_ms / 1000.0
            ):
                self._catch_up()
            # Only the LEADER expires sessions (real ZK's session tracker
            # lives on the leader): a quorum-less ensemble keeps every
            # session — and its ephemerals — frozen until quorum returns,
            # so a fleet riding out an outage through a read-only member
            # resumes with the same sessions.  Standalone servers sweep
            # as before.
            if self._is_ensemble_member and st.leader is not self:
                continue
            for sess in list(self.sessions.values()):
                # A live connection keeps the session alive via pings; the
                # expiry countdown only runs while disconnected (matching
                # real ZK, where the leader hears session pings).
                if sess.connected:
                    continue
                if now - sess.last_heard > sess.timeout_ms / 1000.0:
                    self.expired_count += 1
                    await self._expire(sess)

    async def _expire(self, sess: Session) -> None:
        if sess.closed:
            return  # another ensemble member's sweeper got here first
        log.debug("expiring session 0x%x", sess.session_id)
        sess.closed = True
        self.sessions.pop(sess.session_id, None)
        if sess.conn is not None:
            # Real ZK notifies an attached client of expiry then drops it.
            await sess.conn.send_event(EventType.NONE, "")
            conn, sess.conn = sess.conn, None
            await conn.close()
        await self._remove_ephemerals(sess)

    async def _remove_ephemerals(self, sess: Session) -> None:
        for path in sorted(sess.ephemerals, key=len, reverse=True):
            try:
                await self._delete_node(path)
            except KeyError:
                pass
        sess.ephemerals.clear()

    # -- quotas (real ZK 3.4 semantics: soft limits under /zookeeper/quota,
    # -- violations logged, never enforced) ----------------------------------

    def _subtree_usage(self, path: str) -> Tuple[int, int]:
        """(znode count, total data bytes) of the subtree at ``path``."""
        try:
            start = self._resolve(path)
        except KeyError:
            return (0, 0)
        count, size = 0, 0
        stack = [start]
        while stack:
            node = stack.pop()
            count += 1
            size += len(node.data)
            stack.extend(node.children.values())
        return (count, size)

    def _governing_quota(self, path: str) -> Optional[Tuple[str, Dict[str, int]]]:
        """The quota target governing ``path``, if any: walk the path's
        prefixes looking for /zookeeper/quota<prefix>/zookeeper_limits
        (setquota forbids nesting, so at most one governs)."""
        if path == "/" or path == "/zookeeper" or path.startswith("/zookeeper/"):
            return None
        comps = path.strip("/").split("/")
        quota_node = self.get_node(QUOTA_ROOT)
        if quota_node is None or not quota_node.children:
            return None
        node = quota_node
        prefix = ""
        for comp in comps:
            node = node.children.get(comp)
            if node is None:
                return None
            prefix += "/" + comp
            limits = node.children.get(LIMITS_LEAF)
            if limits is not None:
                return (prefix, parse_quota(limits.data))
        return None

    def _check_quota(self, path: str) -> None:
        """After a write under a quota'd subtree, log (never fail) when the
        limit is exceeded — real ZK's soft enforcement."""
        governing = self._governing_quota(path)
        if governing is None:
            return
        target, limits = governing
        count, nbytes = self._subtree_usage(target)
        if limits["count"] >= 0 and count > limits["count"]:
            self.quota_warnings += 1
            log.warning(
                "Quota exceeded: %s count=%d limit=%d",
                target, count, limits["count"],
            )
        if limits["bytes"] >= 0 and nbytes > limits["bytes"]:
            self.quota_warnings += 1
            log.warning(
                "Quota exceeded: %s bytes=%d limit=%d",
                target, nbytes, limits["bytes"],
            )

    async def _refresh_quota_stats(self, path: str) -> None:
        """Serve live usage from a .../zookeeper_stats read — the lazy
        equivalent of real ZK updating the stats node on every write,
        applied as a genuine setData (version bump + data watches) so
        stat/watch semantics on the stats node stay honest."""
        if not (
            path.startswith(QUOTA_ROOT + "/") and path.endswith("/" + STATS_LEAF)
        ):
            return
        target = path[len(QUOTA_ROOT): -len("/" + STATS_LEAF)]
        try:
            node = self._resolve(path)
        except KeyError:
            return
        count, nbytes = self._subtree_usage(target)
        data = format_quota(count, nbytes)
        if data != node.data:
            await self._set_data_node(path, data, -1)

    # -- tree ops -----------------------------------------------------------

    def _resolve(self, path: str, root: Optional[ZNode] = None) -> ZNode:
        node = root if root is not None else self.root
        if path == "/":
            return node
        for comp in path.strip("/").split("/"):
            node = node.children[comp]  # KeyError -> NO_NODE
        return node

    def _resolve_read(self, path: str) -> ZNode:
        """Resolve against this member's *read view*: the frozen stale
        tree while lagging behind the replicated state, else the live
        tree.  Write paths always use :meth:`_resolve` (commits go to the
        replicated state, as a real follower forwards them to the
        leader)."""
        return self._resolve(
            path, self._lag_root if self._lag_root is not None else self.root
        )

    def _split(self, path: str) -> Tuple[str, str]:
        parent, _, name = path.rpartition("/")
        return (parent or "/", name)

    def _next_zxid(self, op: str = "", path: str = "") -> int:
        # A commit is about to apply to the replicated state: every other
        # live member configured to lag, and currently caught up, freezes
        # its read view at the pre-commit state.  (The committing member
        # itself never freezes — a follower applies a commit before acking
        # it, preserving read-your-writes.)  Guarded by the shared lag
        # count so the no-lag configuration — every production-shaped
        # bench and test — pays nothing for the lag model on its write
        # hot path.
        if self._state.lag_members:
            for member in self._state.members:
                if (
                    member is not self
                    and member.apply_delay_ms > 0
                    and member._lag_root is None
                ):
                    member._lag_root = _clone_tree(self._state.root)
                    member._lag_zxid = self._state.zxid
        self.zxid += 1
        self._state.last_commit = time.monotonic()
        if self._is_ensemble_member:
            # ZAB bookkeeping: the LEADER orders and commits every write
            # (a serving follower forwards — here, the shared state makes
            # the forward a direct commit through the same zxid order);
            # the bounded committed backlog feeds rejoin catch-up.
            leader = self._state.leader
            if leader is not None:
                leader.commits += 1
                if leader is not self:
                    self.forwarded_writes += 1
            self._state.log.append((self.zxid, op, path))
        return self.zxid

    def _view_zxid(self) -> int:
        """The zxid this member's read view corresponds to — the frozen
        pre-commit zxid while lagging, else the replicated zxid."""
        return self._lag_zxid if self._lag_root is not None else self.zxid

    def _catch_up(self) -> None:
        """Apply the replicated state up to now: drop the stale read view.

        Watches armed against the stale view guard transitions that may
        already have committed (their events fired before the watch
        existed); real ZooKeeper's never-miss-a-transition guarantee
        means the follower delivers them when it applies the txns, so
        compare each armed path's stale state against the live tree and
        synthesize the missed event — the same reconciliation the
        SetWatches handler performs for reconnecting clients.

        A read-only member never catches up here: across a partition the
        majority's commits are unreachable, so its view stays frozen
        until the election machinery readmits it (``_set_role`` flips
        the role back first, then drives this catch-up).
        """
        if self._lag_root is None or self.mode == "read-only":
            return
        stale_root, self._lag_root = self._lag_root, None
        frozen_zxid = self._lag_zxid
        pending, self._lag_watches = self._lag_watches, []
        for kind, path, conn in pending:
            if conn.closed:
                continue
            # Only reconcile watches still armed: a watch the live
            # commit path already fired (popping it from the shared
            # table) must not deliver twice — one-shot semantics.  This
            # also collapses duplicate _lag_watches entries.
            holders = self._watches[kind].get(path)
            if holders is None or conn not in holders:
                continue
            try:
                live: Optional[ZNode] = self._resolve(path)
            except KeyError:
                live = None
            try:
                stale: Optional[ZNode] = self._resolve(path, stale_root)
            except KeyError:
                stale = None
            # A create logged after the freeze while the stale view had
            # the node means a delete+recreate happened inside the lag
            # window: the first backlog event an armed watch is owed is
            # the NODE_DELETED (one-shot watches consume it), not the
            # net data/children diff.
            recreated = (
                stale is not None
                and self._state.lag_creates.get(path, -1) > frozen_zxid
            )
            ev: Optional[int] = None
            if kind == _WATCH_EXIST:
                if live is not None:
                    ev = EventType.NODE_CREATED
                elif self._state.lag_creates.get(path, -1) > frozen_zxid:
                    # Created then deleted entirely inside the lag
                    # window: the stale/live diff is empty, but the
                    # backlog contains the create this watch is owed.
                    ev = EventType.NODE_CREATED
            elif kind == _WATCH_DATA:
                if live is None or recreated:
                    ev = EventType.NODE_DELETED
                elif stale is not None and live.mzxid != stale.mzxid:
                    ev = EventType.NODE_DATA_CHANGED
            elif kind == _WATCH_CHILD:
                if live is None or recreated:
                    ev = EventType.NODE_DELETED
                elif stale is not None and live.cversion != stale.cversion:
                    ev = EventType.NODE_CHILDREN_CHANGED
            if ev is None:
                continue  # no missed transition; the armed watch stands
            # One-shot semantics: retire this connection's watch, leave
            # other holders of the same (kind, path) armed.
            holders.discard(conn)
            if not holders:
                self._watches[kind].pop(path, None)
            self._spawn(self._send_watch_events({conn}, ev, path))
        # The create log only serves members still behind; once everyone
        # has applied the backlog it is dead weight — clear it so it
        # cannot grow across lag windows.
        if not any(m._lag_root is not None for m in self._state.members):
            self._state.lag_creates.clear()

    async def _fire_watches(self, kind: str, path: str, ev_type: int) -> None:
        conns = self._watches[kind].pop(path, set())
        if self._deferred_events is not None:
            self._deferred_events.append((conns, ev_type, path))
            return
        await self._send_watch_events(conns, ev_type, path)

    async def _send_watch_events(self, conns, ev_type: int, path: str) -> None:
        # Fan-out shape: encode the event once, write every watcher's
        # socket back-to-back without interleaved awaits, then drain.
        # The serialized per-watcher send_event walk made delivery to
        # the last of N watchers O(N) awaited round-trips.
        targets = [c for c in conns if not c.closed]
        if not targets:
            return
        framed = _event_frame(ev_type, path)
        for conn in targets:
            conn.post_framed(framed)
        for conn in targets:
            await conn.drain()

    def _add_watch(
        self, kind: str, path: str, conn: _Connection, stale_view: bool = False
    ) -> None:
        self._watches[kind].setdefault(path, set()).add(conn)
        if stale_view and self._lag_root is not None:
            # Armed against the stale view: catch-up must reconcile it
            # against the live tree (see _catch_up).  Watches re-armed by
            # the SET_WATCHES handler never enroll — that handler already
            # reconciled them against the live tree via relative_zxid, so
            # a catch-up event would duplicate what the client has seen.
            self._lag_watches.append((kind, path, conn))

    # -- ACLs (ZooKeeper 3.4 semantics) --------------------------------------
    #
    # Enforcement points match real ZK's PrepRequestProcessor/FinalRP:
    # create -> CREATE on the parent, delete -> DELETE on the parent,
    # setData -> WRITE, getData/getChildren -> READ, setACL -> ADMIN;
    # exists and getACL are deliberately unchecked (3.4 behavior).  The
    # reference never sets ACLs (zkplus creates everything world:anyone,
    # SURVEY.md §2.4), so none of this triggers for registrar traffic.

    @staticmethod
    def _ip_matches(acl_id: str, peer_ip: Optional[str]) -> bool:
        if peer_ip is None:
            return False
        import ipaddress

        try:
            addr = ipaddress.ip_address(peer_ip)
            if "/" in acl_id:
                return addr in ipaddress.ip_network(acl_id, strict=False)
            return addr == ipaddress.ip_address(acl_id)
        except ValueError:
            return False

    def _fix_acls(
        self, acls: List[proto.ACL], sess: Session
    ) -> List[proto.ACL]:
        """Validate a client-supplied ACL list, expanding the ``auth``
        scheme into the session's digest identities (real ZK's fixupACL)."""
        if not acls:
            raise proto.ZKError(Err.INVALID_ACL)
        out: List[proto.ACL] = []
        for acl in acls:
            if not isinstance(acl.perms, int) or not (
                0 < acl.perms <= proto.Perms.ALL
            ):
                raise proto.ZKError(Err.INVALID_ACL)
            if acl.scheme == "world":
                if acl.id != "anyone":
                    raise proto.ZKError(Err.INVALID_ACL)
                out.append(acl)
            elif acl.scheme == "auth":
                ids = sorted(
                    i for s, i in sess.auth_ids if s == "digest"
                )
                if not ids:
                    raise proto.ZKError(Err.INVALID_ACL)
                out.extend(proto.ACL(acl.perms, "digest", i) for i in ids)
            elif acl.scheme == "digest":
                if ":" not in acl.id:
                    raise proto.ZKError(Err.INVALID_ACL)
                out.append(acl)
            elif acl.scheme == "ip":
                import ipaddress

                try:
                    if "/" in acl.id:
                        ipaddress.ip_network(acl.id, strict=False)
                    else:
                        ipaddress.ip_address(acl.id)
                except ValueError:
                    raise proto.ZKError(Err.INVALID_ACL)
                out.append(acl)
            else:
                raise proto.ZKError(Err.INVALID_ACL)
        return out

    def _check_acl(
        self, acls: List[proto.ACL], perm: int, sess: Optional[Session]
    ) -> None:
        """Raise NO_AUTH unless some ACL entry grants ``perm`` to ``sess``."""
        for acl in acls:
            if not (acl.perms & perm):
                continue
            if acl.scheme == "world" and acl.id == "anyone":
                return
            if sess is None:
                continue
            if acl.scheme == "digest" and ("digest", acl.id) in sess.auth_ids:
                return
            if acl.scheme == "ip" and sess.conn is not None:
                if self._ip_matches(acl.id, sess.conn.peer_ip):
                    return
        raise proto.ZKError(Err.NO_AUTH)

    def _handle_auth(self, req: proto.AuthPacket, sess: Session) -> bool:
        """Apply an addauth packet; False means AUTH_FAILED (drop conn)."""
        if req.scheme == "digest":
            try:
                cred = (req.auth or b"").decode("utf-8")
                user, password = cred.split(":", 1)
            except (UnicodeDecodeError, ValueError):
                return False
            if not user:
                return False
            sess.auth_ids.add(
                ("digest", proto.digest_auth_id(user, password))
            )
            return True
        if req.scheme == "ip":
            # Real ZK's IPAuthenticationProvider just records the
            # connection's actual address, which _check_acl already matches
            # directly — accept and do nothing.
            return True
        return False

    async def _create_node(
        self,
        path: str,
        data: bytes,
        flags: int,
        session: Session,
        acls: Optional[List[proto.ACL]] = None,
    ) -> str:
        proto.check_path(path)
        acls = (
            self._fix_acls(acls, session)
            if acls is not None
            else list(proto.OPEN_ACL_UNSAFE)
        )
        parent_path, name = self._split(path)
        try:
            parent = self._resolve(parent_path)
        except KeyError:
            raise proto.ZKError(Err.NO_NODE, parent_path)
        self._check_acl(parent.acls, proto.Perms.CREATE, session)
        if parent.ephemeral_owner:
            raise proto.ZKError(Err.NO_CHILDREN_FOR_EPHEMERALS, parent_path)

        sequential = flags in (
            proto.CreateFlag.PERSISTENT_SEQUENTIAL,
            proto.CreateFlag.EPHEMERAL_SEQUENTIAL,
        )
        if sequential:
            name = f"{name}{parent.cversion:010d}"
            path = f"{parent_path.rstrip('/')}/{name}"
        if name in parent.children:
            raise proto.ZKError(Err.NODE_EXISTS, path)

        zxid = self._next_zxid("create", path)
        if self._state.lag_members:
            self._state.lag_creates[path] = zxid
        now = _now_ms()
        ephemeral = flags in (
            proto.CreateFlag.EPHEMERAL,
            proto.CreateFlag.EPHEMERAL_SEQUENTIAL,
        )
        node = ZNode(
            data=data or b"",
            ephemeral_owner=session.session_id if ephemeral else 0,
            czxid=zxid,
            mzxid=zxid,
            pzxid=zxid,
            ctime=now,
            mtime=now,
            acls=acls,
        )
        parent.children[name] = node
        parent.cversion += 1
        parent.pzxid = zxid
        if ephemeral:
            session.ephemerals.add(path)
        self._check_quota(path)
        await self._fire_watches(_WATCH_EXIST, path, EventType.NODE_CREATED)
        await self._fire_watches(_WATCH_DATA, path, EventType.NODE_CREATED)
        await self._fire_watches(
            _WATCH_CHILD, parent_path, EventType.NODE_CHILDREN_CHANGED
        )
        return path

    async def _delete_node(
        self, path: str, version: int = -1, sess: Optional[Session] = None
    ) -> None:
        # ``sess=None`` marks internal calls (ephemeral cleanup on session
        # close/expiry), which bypass ACL checks like real ZK's does.
        parent_path, name = self._split(path)
        parent = self._resolve(parent_path)  # KeyError propagates
        node = parent.children.get(name)
        if node is None:
            raise KeyError(path)
        if sess is not None:
            self._check_acl(parent.acls, proto.Perms.DELETE, sess)
        if version != -1 and node.version != version:
            raise proto.ZKError(Err.BAD_VERSION, path)
        if node.children:
            raise proto.ZKError(Err.NOT_EMPTY, path)
        # Allocate the zxid before mutating: lagging members freeze their
        # read view at the pre-commit state inside _next_zxid.
        zxid = self._next_zxid("delete", path)
        del parent.children[name]
        parent.cversion += 1
        parent.pzxid = zxid
        if node.ephemeral_owner:
            owner = self.sessions.get(node.ephemeral_owner)
            if owner:
                owner.ephemerals.discard(path)
        await self._fire_watches(_WATCH_DATA, path, EventType.NODE_DELETED)
        await self._fire_watches(_WATCH_EXIST, path, EventType.NODE_DELETED)
        await self._fire_watches(
            _WATCH_CHILD, parent_path, EventType.NODE_CHILDREN_CHANGED
        )
        await self._fire_watches(_WATCH_CHILD, path, EventType.NODE_DELETED)

    async def _set_data_node(
        self,
        path: str,
        data: Optional[bytes],
        version: int,
        sess: Optional[Session] = None,
    ) -> Stat:
        try:
            node = self._resolve(path)
        except KeyError:
            raise proto.ZKError(Err.NO_NODE, path)
        if sess is not None:
            self._check_acl(node.acls, proto.Perms.WRITE, sess)
        if version != -1 and node.version != version:
            raise proto.ZKError(Err.BAD_VERSION, path)
        # zxid first: _next_zxid freezes lagging members' pre-commit view.
        node.mzxid = self._next_zxid("setData", path)
        node.data = data or b""
        node.version += 1
        node.mtime = _now_ms()
        self._check_quota(path)
        await self._fire_watches(_WATCH_DATA, path, EventType.NODE_DATA_CHANGED)
        return node.stat()

    # -- multi (atomic transactions) ----------------------------------------

    def _validate_multi(self, ops: List[tuple], sess: Session) -> None:
        """Dry-run a transaction against an overlay of the tree.

        Raises the first op's ZKError without touching state, so the apply
        phase only ever runs transactions that fully succeed (real ZK's
        PrepRequestProcessor plays the same role).  The overlay tracks
        existence, version, ephemeral-ness, and child counts per path —
        enough for create/delete/setData/check semantics, including ops that
        observe earlier ops in the same transaction.
        """
        overlay: Dict[str, Dict[str, object]] = {}

        def lookup(path: str) -> Dict[str, object]:
            ent = overlay.get(path)
            if ent is None:
                try:
                    node = self._resolve(path)
                    ent = {
                        "exists": True,
                        "version": node.version,
                        "ephemeral": bool(node.ephemeral_owner),
                        "nchildren": len(node.children),
                        "cversion": node.cversion,
                        "acls": node.acls,
                    }
                except KeyError:
                    ent = {
                        "exists": False, "version": 0,
                        "ephemeral": False, "nchildren": 0, "cversion": 0,
                        "acls": [],
                    }
                overlay[path] = ent
            return ent

        for index, (op_type, req) in enumerate(ops):
            try:
                self._validate_one(op_type, req, lookup, sess)
            except proto.ZKError as err:
                err.op_index = index
                raise

    def _validate_one(self, op_type: int, req, lookup, sess: Session) -> None:
        try:
            proto.check_path(req.path)
        except ValueError:
            raise proto.ZKError(Err.BAD_ARGUMENTS, req.path)
        if op_type == OpCode.CREATE:
            acls = self._fix_acls(req.acls, sess)  # raises INVALID_ACL
            parent_path, _ = self._split(req.path)
            parent = lookup(parent_path)
            if not parent["exists"]:
                raise proto.ZKError(Err.NO_NODE, parent_path)
            self._check_acl(parent["acls"], proto.Perms.CREATE, sess)
            if parent["ephemeral"]:
                raise proto.ZKError(Err.NO_CHILDREN_FOR_EPHEMERALS, parent_path)
            sequential = req.flags in (
                proto.CreateFlag.PERSISTENT_SEQUENTIAL,
                proto.CreateFlag.EPHEMERAL_SEQUENTIAL,
            )
            # Resolve the effective path the apply phase will use —
            # sequential names derive from the parent's cversion, which the
            # overlay tracks, so collisions with pre-existing nodes are
            # caught here instead of aborting mid-apply.
            path = req.path
            if sequential:
                _, name = self._split(req.path)
                path = (
                    f"{parent_path.rstrip('/')}/"
                    f"{name}{parent['cversion']:010d}"
                )
            ent = lookup(path)
            if ent["exists"]:
                raise proto.ZKError(Err.NODE_EXISTS, path)
            ent.update(
                exists=True,
                version=0,
                ephemeral=req.flags in (
                    proto.CreateFlag.EPHEMERAL,
                    proto.CreateFlag.EPHEMERAL_SEQUENTIAL,
                ),
                nchildren=0,
                cversion=0,  # fresh node — a delete+recreate in the same
                # txn must not inherit the old node's child counter, or
                # sequential-name prediction diverges from the apply phase
                acls=acls,
            )
            parent["nchildren"] += 1
            parent["cversion"] = int(parent["cversion"]) + 1
        elif op_type == OpCode.DELETE:
            ent = lookup(req.path)
            if not ent["exists"]:
                raise proto.ZKError(Err.NO_NODE, req.path)
            parent = lookup(self._split(req.path)[0])
            self._check_acl(parent["acls"], proto.Perms.DELETE, sess)
            if req.version != -1 and ent["version"] != req.version:
                raise proto.ZKError(Err.BAD_VERSION, req.path)
            if ent["nchildren"]:
                raise proto.ZKError(Err.NOT_EMPTY, req.path)
            ent["exists"] = False
            parent["nchildren"] -= 1
            parent["cversion"] = int(parent["cversion"]) + 1
        elif op_type in (OpCode.SET_DATA, OpCode.CHECK):
            ent = lookup(req.path)
            if not ent["exists"]:
                raise proto.ZKError(Err.NO_NODE, req.path)
            self._check_acl(
                ent["acls"],
                proto.Perms.WRITE if op_type == OpCode.SET_DATA
                else proto.Perms.READ,
                sess,
            )
            if req.version != -1 and ent["version"] != req.version:
                raise proto.ZKError(Err.BAD_VERSION, req.path)
            if op_type == OpCode.SET_DATA:
                ent["version"] = int(ent["version"]) + 1
        else:
            raise proto.ZKError(Err.UNIMPLEMENTED, req.path)

    async def _multi(
        self, req: proto.MultiRequest, sess: Session
    ) -> proto.MultiResponse:
        """Atomically apply a transaction (validate first, then apply).

        On failure nothing is applied and the per-op results carry the
        failing op's code with RUNTIME_INCONSISTENCY for the rest — the
        documented ZooKeeper multi abort contract.
        """
        try:
            self._validate_multi(req.ops, sess)
        except proto.ZKError as err:
            failed_at = getattr(err, "op_index", 0)
            return proto.MultiResponse(
                results=[
                    proto.ErrorResult(
                        err=err.code if i == failed_at
                        else Err.RUNTIME_INCONSISTENCY
                    )
                    for i in range(len(req.ops))
                ]
            )

        # Apply with watch delivery deferred: the tree mutations below never
        # await, so the whole transaction commits within one event-loop step
        # (no other client's request — nor another multi — can observe or
        # create a half-applied state).  Validation above guarantees every
        # op succeeds, including sequential-name collisions.
        results = []
        self._deferred_events = []
        try:
            for op_type, op_req in req.ops:
                if op_type == OpCode.CREATE:
                    path = await self._create_node(
                        op_req.path, op_req.data, op_req.flags, sess,
                        op_req.acls,
                    )
                    results.append(proto.CreateResponse(path=path))
                elif op_type == OpCode.DELETE:
                    try:
                        await self._delete_node(
                            op_req.path, op_req.version, sess
                        )
                    except KeyError:
                        raise proto.ZKError(
                            Err.RUNTIME_INCONSISTENCY, op_req.path
                        )
                    results.append(proto.DeleteResult())
                elif op_type == OpCode.SET_DATA:
                    stat = await self._set_data_node(
                        op_req.path, op_req.data, op_req.version, sess
                    )
                    results.append(proto.SetDataResponse(stat=stat))
                else:  # OpCode.CHECK — validated above, nothing to apply
                    results.append(proto.CheckResult())
        finally:
            deferred, self._deferred_events = self._deferred_events, None
        for conns, ev_type, path in deferred:
            await self._send_watch_events(conns, ev_type, path)
        return proto.MultiResponse(results=results)

    # -- connection handling ------------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        conn = _Connection(self, reader, writer)
        self._conns.add(conn)
        self._transports.add(writer.transport)
        try:
            await self._serve(conn)
        except Exception:
            log.exception("connection handler crashed")
        finally:
            # Detach FIRST: the flush below can suspend, and a session
            # that still looks connected is exempt from the expiry sweep
            # — cleanup must never be hostage to the peer's read rate.
            self._conns.discard(conn)
            if conn.session is not None and conn.session.conn is conn:
                conn.session.conn = None
                conn.session.auth_ids.clear()
                conn.session.last_heard = time.monotonic()
            # Replies generated for earlier requests in a burst must not
            # be dropped because a LATER frame was malformed (or any
            # other serve-loop exit): pre-batching, each reply went out
            # immediately — deliver what was queued, bounded so a
            # non-reading peer cannot wedge the handler.
            try:
                await asyncio.wait_for(conn.flush(), timeout=1.0)
            except asyncio.CancelledError:
                await conn.close()
                raise  # honor cancellation once cleanup is done
            except Exception:  # noqa: BLE001 - timeout/conn loss: close below
                pass
            await conn.close()

    async def _serve(self, conn: _Connection) -> None:
        # --- handshake (or a 4-letter-word admin command) ---
        # Real ZooKeeper multiplexes admin "four letter words" (ruok, srvr,
        # stat, mntr, ...) onto the client port: 4 ASCII bytes instead of a
        # length-prefixed frame.  A genuine frame header is a small
        # big-endian length (<16 MiB), so its first byte is 0x00 — ASCII
        # command bytes are unambiguous.
        frames = FrameReader(conn.reader)
        first4 = await frames.read4()
        if first4 is None:
            return
        if first4 in _FOUR_LETTER_WORDS:
            text = self._four_letter(first4.decode("ascii"))
            try:
                conn.writer.write(text.encode())
                await conn.writer.drain()
            except (ConnectionError, OSError):
                pass
            return
        payload = await frames.frame(header=first4)
        if payload is None:
            return
        req = proto.ConnectRequest.read(Reader(payload))
        # Real ZooKeeper refuses a session whose client has seen a newer
        # zxid than this server ("Refusing session request as it has seen
        # zxid ...") by closing the connection without a ConnectResponse;
        # the client then tries another member.  Essential for lagging
        # members: accepting such a client would rewind its last_zxid via
        # our stale reply stamps and later re-deliver watch events it
        # already observed.
        view_zxid = self._view_zxid()
        if req.last_zxid_seen > view_zxid:
            self.refused_count += 1
            log.warning(
                "refusing session 0x%x: client has seen zxid 0x%x, ours is 0x%x",
                req.session_id, req.last_zxid_seen, view_zxid,
            )
            return
        if self.mode == "looking":
            # Mid-election a real member is not serving clients at all
            # (LOOKING state closes the client port); refuse by closing,
            # the same wire shape as the zxid refusal but counted apart
            # — the client's next reconnect attempt lands after the
            # election.
            self.refused_looking += 1
            return
        if self.mode == "read-only" and not req.read_only:
            # Real ZooKeeper's ReadOnlyZooKeeperServer only admits
            # clients that set the ConnectRequest read_only flag
            # (canBeReadOnly); everyone else is refused so they keep
            # looking for a read-write member.
            self.refused_ro += 1
            log.debug(
                "refusing non-read-only client while in read-only mode"
            )
            return
        sess = self._establish_session(req)
        w = Writer()
        if sess is None:
            # Expired/unknown session: real ZK answers with session_id 0
            # and timeout 0; the client treats this as session expiry.
            proto.ConnectResponse(
                protocol_version=0, timeout_ms=0, session_id=0, passwd=b"\x00" * 16
            ).write(w)
            await conn.send(w.to_bytes())
            return
        if sess.conn is not None and sess.conn is not conn:
            # Session moved: real ZK closes the superseded connection when
            # a client reattaches the session from a new one.
            old, sess.conn = sess.conn, None
            await old.close()
        # Auth is per-connection (real ZK's authInfo lives on the cnxn):
        # whatever the previous connection added must not leak to this one
        # — the client replays addauth itself after reconnecting.
        sess.auth_ids.clear()
        conn.session = sess
        sess.conn = conn
        sess.last_heard = time.monotonic()
        proto.ConnectResponse(
            protocol_version=0,
            timeout_ms=sess.timeout_ms,
            session_id=sess.session_id,
            passwd=sess.passwd,
            # The 3.4 wire flag (protocol.py ConnectResponse): tells the
            # client it attached to a read-only member — reads serve,
            # writes answer NOT_READONLY until it fails over.
            read_only=self.mode == "read-only",
        ).write(w)
        await conn.send(w.to_bytes())

        # --- request loop ---
        while not conn.closed:
            # Sync fast lane: a pipelined sweep leaves the next frame
            # already buffered — skip the coroutine round trip per
            # request (frame() still owns EOF/corrupt-length).
            payload = frames.frame_nowait()
            if payload is None:
                payload = await frames.frame()
                if payload is None:
                    return
            self.packets_received += 1
            sess.last_heard = time.monotonic()
            r = Reader(payload)
            hdr = proto.RequestHeader.read(r)
            if hdr.type == OpCode.CLOSE_SESSION:
                # closeSession is a QUORUM transaction too (it commits
                # the ephemeral deletes): a read-only minority member
                # cannot process it — the session and its ephemerals
                # stay alive until a leader expires them, exactly the
                # frozen-until-quorum invariant; mid-election the writer
                # is dropped like any other write.
                if self._is_ensemble_member:
                    verdict = self._write_gate()
                    if verdict == "drop":
                        self.election_drops += 1
                        await conn.flush()
                        await conn.close()
                        return
                    if verdict == "ro":
                        self.writes_refused += 1
                        await conn.send(
                            self._reply(hdr.xid, Err.NOT_READONLY)
                        )
                        return
                await self._close_session(sess)
                w = Writer()
                proto.ReplyHeader(hdr.xid, self.zxid, Err.OK).write(w)
                await conn.send(w.to_bytes())
                return
            if self.freeze:
                # Swallow the request: wedged-server simulation.  Replies
                # already generated for earlier requests in this burst
                # predate the wedge — deliver them first, matching the
                # pre-batching behavior where each was sent immediately.
                await conn.flush()
                continue
            if hdr.type == OpCode.AUTH:
                req = proto.AuthPacket.read(r)
                ok = self._handle_auth(req, sess)
                await conn.send(
                    self._reply(hdr.xid, Err.OK if ok else Err.AUTH_FAILED)
                )
                if not ok:
                    # Real ZK answers AUTH_FAILED then drops the connection.
                    return
                continue
            if hdr.type in _QUORUM_OPS and self._is_ensemble_member:
                verdict = self._write_gate()
                if verdict == "drop":
                    # Mid-election: a follower that lost its leader drops
                    # its writers (the in-flight op surfaces client-side
                    # as CONNECTION_LOSS, retryable); queued replies for
                    # earlier reads in the burst still go out.
                    self.election_drops += 1
                    await conn.flush()
                    await conn.close()
                    return
                if verdict == "ro":
                    self.writes_refused += 1
                    conn.queue(self._reply(hdr.xid, Err.NOT_READONLY))
                    if conn.queue_full() or not frames.pending():
                        await conn.flush()
                    continue
            # Coroutine-free lanes for the hot read ops: a
            # 10k-node heartbeat sweep is 10k EXISTS requests and a
            # resolve burst is getData/getChildren2 — none of which ever
            # await; routing them through the async _dispatch cost a
            # coroutine per request.
            if hdr.type == OpCode.EXISTS:
                reply = self._exists_fast(conn, sess, hdr, r)
            elif hdr.type == OpCode.GET_DATA:
                reply = self._get_data_fast(conn, sess, hdr, r)
                if reply is _SLOW_PATH:  # quota-stats read: may setData
                    reply = await self._dispatch(
                        conn, sess, hdr, Reader(payload, 8)
                    )
            elif hdr.type in (OpCode.GET_CHILDREN, OpCode.GET_CHILDREN2):
                reply = self._children_fast(conn, sess, hdr, r)
            else:
                reply = await self._dispatch(conn, sess, hdr, r)
            if reply is not None:
                conn.queue(reply)
            # Flush once per input burst — but also whenever the staged
            # replies hit the count/byte caps, so a client that streams
            # requests continuously (keeping a complete frame buffered
            # at all times) still receives replies and the queue stays
            # bounded in BOTH dimensions; the per-reply drain this
            # batching replaced was also the backpressure.
            if conn.queue_full() or not frames.pending():
                await conn.flush()

    def _establish_session(self, req: proto.ConnectRequest) -> Optional[Session]:
        if req.session_id:
            sess = self.sessions.get(req.session_id)
            if sess is None or sess.closed or sess.passwd != req.passwd:
                return None
            return sess
        timeout = max(
            self.min_session_timeout_ms,
            min(req.timeout_ms, self.max_session_timeout_ms),
        )
        self._next_session += 1
        sess = Session(
            session_id=self._next_session,
            passwd=os.urandom(16),
            timeout_ms=timeout,
            last_heard=time.monotonic(),
        )
        self.sessions[sess.session_id] = sess
        return sess

    async def _close_session(self, sess: Session) -> None:
        sess.closed = True
        self.sessions.pop(sess.session_id, None)
        await self._remove_ephemerals(sess)

    async def _dispatch(
        self, conn: _Connection, sess: Session, hdr: proto.RequestHeader, r: Reader
    ) -> Optional[bytes]:
        op = hdr.type
        try:
            if op == OpCode.PING:
                return self._reply(proto.XID_PING, Err.OK)
            if op == OpCode.CREATE:
                req = proto.CreateRequest.read(r)
                path = await self._create_node(
                    req.path, req.data, req.flags, sess, req.acls
                )
                self._catch_up()  # read-your-writes on this member
                return self._reply(hdr.xid, Err.OK, proto.CreateResponse(path=path))
            if op == OpCode.DELETE:
                req = proto.DeleteRequest.read(r)
                proto.check_path(req.path)
                try:
                    await self._delete_node(req.path, req.version, sess)
                except KeyError:
                    raise proto.ZKError(Err.NO_NODE, req.path)
                self._catch_up()
                return self._reply(hdr.xid, Err.OK)
            if op == OpCode.EXISTS:
                return self._exists_fast(conn, sess, hdr, r)
            if op == OpCode.GET_DATA:
                req = proto.GetDataRequest.read(r)
                proto.check_path(req.path)
                await self._refresh_quota_stats(req.path)
                try:
                    node = self._resolve_read(req.path)
                except KeyError:
                    raise proto.ZKError(Err.NO_NODE, req.path)
                self._check_acl(node.acls, proto.Perms.READ, sess)
                if req.watch:
                    self._add_watch(
                        _WATCH_DATA, req.path, conn, stale_view=True
                    )
                return (
                    proto.pack_reply_header(hdr.xid, self._view_zxid(), Err.OK)
                    + proto.pack_buffer(node.data)
                    + node.stat_packed()
                )
            if op == OpCode.SET_DATA:
                req = proto.SetDataRequest.read(r)
                proto.check_path(req.path)
                stat = await self._set_data_node(
                    req.path, req.data, req.version, sess
                )
                self._catch_up()
                return self._reply(
                    hdr.xid, Err.OK, proto.SetDataResponse(stat=stat)
                )
            if op == OpCode.GET_ACL:
                req = proto.GetACLRequest.read(r)
                proto.check_path(req.path)
                try:
                    node = self._resolve_read(req.path)
                except KeyError:
                    raise proto.ZKError(Err.NO_NODE, req.path)
                # Unchecked in 3.4 (ADMIN-gating arrived with 3.5's
                # checkGetACL flag) — anyone may inspect ACLs.
                return self._reply(
                    hdr.xid,
                    Err.OK,
                    proto.GetACLResponse(
                        acls=list(node.acls), stat=node.stat()
                    ),
                )
            if op == OpCode.SET_ACL:
                req = proto.SetACLRequest.read(r)
                proto.check_path(req.path)
                try:
                    node = self._resolve(req.path)
                except KeyError:
                    raise proto.ZKError(Err.NO_NODE, req.path)
                self._check_acl(node.acls, proto.Perms.ADMIN, sess)
                if req.version != -1 and node.aversion != req.version:
                    raise proto.ZKError(Err.BAD_VERSION, req.path)
                # Validate (fix_acls raises INVALID_ACL) before the zxid
                # is allocated — a failed op must not consume a zxid or
                # freeze lagging members.
                fixed_acls = self._fix_acls(req.acls, sess)
                # a write transaction, but mzxid untouched
                self._next_zxid("setAcl", req.path)
                node.acls = fixed_acls
                node.aversion += 1
                self._catch_up()
                return self._reply(
                    hdr.xid, Err.OK, proto.SetACLResponse(stat=node.stat())
                )
            if op in (OpCode.GET_CHILDREN, OpCode.GET_CHILDREN2):
                return self._children_fast(conn, sess, hdr, r)
            if op == OpCode.SET_WATCHES:
                req = proto.SetWatches.read(r)
                # Real ZooKeeper compares each path's state against the
                # client's relative_zxid and immediately delivers events the
                # client missed while disconnected, instead of silently
                # re-arming a watch for a change that already happened.
                for p in req.data_watches:
                    try:
                        node = self._resolve(p)
                    except KeyError:
                        await conn.send_event(EventType.NODE_DELETED, p)
                        continue
                    if node.mzxid > req.relative_zxid:
                        await conn.send_event(EventType.NODE_DATA_CHANGED, p)
                    else:
                        self._add_watch(_WATCH_DATA, p, conn)
                for p in req.exist_watches:
                    try:
                        self._resolve(p)
                        await conn.send_event(EventType.NODE_CREATED, p)
                    except KeyError:
                        self._add_watch(_WATCH_EXIST, p, conn)
                for p in req.child_watches:
                    try:
                        node = self._resolve(p)
                    except KeyError:
                        await conn.send_event(EventType.NODE_DELETED, p)
                        continue
                    if node.pzxid > req.relative_zxid:
                        await conn.send_event(EventType.NODE_CHILDREN_CHANGED, p)
                    else:
                        self._add_watch(_WATCH_CHILD, p, conn)
                return self._reply(hdr.xid, Err.OK)
            if op == OpCode.SYNC:
                req = proto.SyncRequest.read(r)
                # The catch-up barrier: real ZK's sync makes the serving
                # follower flush the leader's pipeline so subsequent reads
                # through it are current.  A lagging member applies its
                # whole backlog here; a caught-up one degenerates to a
                # request-pipeline ordering barrier.
                self._catch_up()
                return self._reply(
                    hdr.xid, Err.OK, proto.SyncResponse(path=req.path)
                )
            if op == OpCode.MULTI:
                req = proto.MultiRequest.read(r)
                results = await self._multi(req, sess)
                # Catch up BEFORE encoding, like the other write ops: a
                # write multi served by a lagging member must stamp its
                # reply with the applied zxid, not the frozen one —
                # otherwise the client's last_zxid understates its own
                # commit and the connect-time zxid-refusal guard cannot
                # protect its read-your-writes across a reconnect.
                self._catch_up()
                return self._reply(hdr.xid, Err.OK, results)
            if op == OpCode.CHECK:
                req = proto.CheckVersionRequest.read(r)
                proto.check_path(req.path)
                try:
                    node = self._resolve(req.path)
                except KeyError:
                    raise proto.ZKError(Err.NO_NODE, req.path)
                if req.version != -1 and node.version != req.version:
                    raise proto.ZKError(Err.BAD_VERSION, req.path)
                return self._reply(hdr.xid, Err.OK)
            log.warning("unimplemented opcode %d", op)
            return self._reply(hdr.xid, Err.UNIMPLEMENTED)
        except proto.ZKError as e:
            return self._reply(hdr.xid, e.code)
        except ValueError:
            return self._reply(hdr.xid, Err.BAD_ARGUMENTS)

    def _exists_fast(
        self, conn: "_Connection", sess: Session, hdr: proto.RequestHeader,
        r: Reader,
    ) -> bytes:
        """EXISTS handled without a coroutine (the request loop calls
        this directly) and without Stat/ExistsResponse intermediates —
        the server half of the heartbeat sweep's hot path.
        Replies are byte-identical to the general ``_dispatch`` path
        (``encode_reply_payload(.., ExistsResponse(node.stat()))``),
        pinned by tests/test_wire_golden.py; the error contract mirrors
        ``_dispatch``'s except clauses.
        """
        try:
            # Fields read inline (no ExistsRequest dataclass): this runs
            # once per swept znode.
            path = r.read_ustring()
            watch = r.read_bool()
            proto.check_path(path)
            try:
                node = self._resolve_read(path)
            except KeyError:
                if watch:
                    self._add_watch(_WATCH_EXIST, path, conn, stale_view=True)
                return self._reply(hdr.xid, Err.NO_NODE)
            if watch:
                self._add_watch(_WATCH_DATA, path, conn, stale_view=True)
            return proto.pack_reply_header(
                hdr.xid, self._view_zxid(), Err.OK
            ) + node.stat_packed()
        except proto.ZKError as e:
            return self._reply(hdr.xid, e.code)
        except ValueError:
            return self._reply(hdr.xid, Err.BAD_ARGUMENTS)

    def _get_data_fast(
        self, conn: "_Connection", sess: Session, hdr: proto.RequestHeader,
        r: Reader,
    ):
        """GET_DATA without a coroutine or dataclass intermediates (the
        resolver's op).  Quota-stats reads — which may genuinely rewrite
        the stats node — return :data:`_SLOW_PATH` so the request loop
        routes them through the async ``_dispatch``.  Replies byte-
        identical to the general path (tests/test_wire_golden.py)."""
        try:
            path = r.read_ustring()
            watch = r.read_bool()
            proto.check_path(path)
            if path.startswith(_QUOTA_PREFIX):
                return _SLOW_PATH
            try:
                node = self._resolve_read(path)
            except KeyError:
                return self._reply(hdr.xid, Err.NO_NODE)
            self._check_acl(node.acls, proto.Perms.READ, sess)
            if watch:
                self._add_watch(_WATCH_DATA, path, conn, stale_view=True)
            return (
                proto.pack_reply_header(hdr.xid, self._view_zxid(), Err.OK)
                + proto.pack_buffer(node.data)
                + node.stat_packed()
            )
        except proto.ZKError as e:
            return self._reply(hdr.xid, e.code)
        except ValueError:
            return self._reply(hdr.xid, Err.BAD_ARGUMENTS)

    def _children_fast(
        self, conn: "_Connection", sess: Session, hdr: proto.RequestHeader,
        r: Reader,
    ) -> bytes:
        """GET_CHILDREN/GET_CHILDREN2 without a coroutine (sync by
        construction); the vector body keeps the general record encoder.
        Serves both the request loop's fast lane and ``_dispatch``."""
        try:
            req = proto.GetChildrenRequest.read(r)
            proto.check_path(req.path)
            try:
                node = self._resolve_read(req.path)
            except KeyError:
                return self._reply(hdr.xid, Err.NO_NODE)
            self._check_acl(node.acls, proto.Perms.READ, sess)
            if req.watch:
                self._add_watch(_WATCH_CHILD, req.path, conn, stale_view=True)
            children = sorted(node.children)
            if hdr.type == OpCode.GET_CHILDREN:
                body = proto.GetChildrenResponse(children=children)
            else:
                body = proto.GetChildren2Response(
                    children=children, stat=node.stat()
                )
            return self._reply(hdr.xid, Err.OK, body)
        except proto.ZKError as e:
            return self._reply(hdr.xid, e.code)
        except ValueError:
            return self._reply(hdr.xid, Err.BAD_ARGUMENTS)

    def _reply(self, xid: int, err: int, body=None) -> bytes:
        # A lagging member stamps replies with the zxid its frozen view
        # corresponds to (real followers report their own
        # lastProcessedZxid).  Stamping the live shared zxid would make a
        # client's last_zxid overstate what it observed, suppressing the
        # SetWatches reconciliation it is owed after a reconnect.
        return proto.encode_reply_payload(xid, self._view_zxid(), err, body)


class ZKEnsemble:
    """N in-process ZK members sharing one replicated tree + session table.

    Models the production deployment the reference points clients at — a
    3–5 member ensemble (reference etc/config.coal.json:9-16, README's
    ops guidance), so that failover is tested against more than a
    single restarted server.  A client holding a session
    through member A can, when A dies, reattach the *same* session (with
    its ephemeral znodes intact) through member B, because members share a
    :class:`_SharedState`.  Watches set via one member fire on writes made
    through any member.

    The ensemble is a real replication protocol, not just
    shared state: one elected **leader** orders and commits writes at
    quorum (``size // 2 + 1``); killing it runs an election
    (``election_ms`` wide) during which candidates are ``looking``;
    members cut off from quorum — by deaths or by
    :meth:`partition` — serve **read-only** from a frozen
    zxid-consistent view (3.4 ``read_only`` handshake; writes answer
    NOT_READONLY) until quorum returns; a member
    :meth:`restart`\\ ed after :meth:`kill` catches up by committed-
    backlog replay or a snapshot (``backlog_max``); and only the leader
    expires sessions, so a quorum-less ensemble freezes every session
    in place.

    Usage::

        async with ZKEnsemble(3) as ens:
            cfg_servers = [
                {"host": h, "port": p} for h, p in ens.addresses
            ]
            ...
            await ens.kill(0)       # the member the client is talking to
            ...                     # client reattaches via another member
            await ens.restart(0)    # member rejoins with the shared state
    """

    def __init__(
        self,
        size: int = 3,
        host: str = "127.0.0.1",
        base_port: Optional[int] = None,
        election_ms: float = 0.0,
        backlog_max: int = 512,
        **server_kwargs,
    ):
        """``base_port``: members listen on consecutive ports starting
        here (for operators wanting a predictable servers list); default
        lets the OS pick free ports (right for tests).

        ``election_ms``: how long a leader election takes.
        0 (the default) elects instantly — the pre-quorum tests' shape;
        > 0 opens a real election window after a leader death during
        which candidate members are ``looking`` (handshakes refused,
        write connections dropped) and the failover MTTR a client
        measures includes the wait.

        ``backlog_max``: committed-transaction backlog bound.  A member
        rejoining within the backlog catches up by diff replay
        (``catchup_replayed``); one whose departure point fell off the
        tail takes a full snapshot (``catchup_snapshots``)."""
        if size < 1:
            raise ValueError("ensemble size must be >= 1")
        self.state = _SharedState()
        self.state.ensemble_size = size
        self.state.quorum = size // 2 + 1
        self.state.election_ms = election_ms
        self.state.log = deque(maxlen=max(1, backlog_max))
        self.servers: List[Optional[ZKServer]] = []
        self._host = host
        self._server_kwargs = server_kwargs
        self._size = size
        self._ports: List[Optional[int]] = [
            base_port + i if base_port else None for i in range(size)
        ]
        #: shared-state zxid at the moment each member was killed — the
        #: rejoin sync point (snapshot-vs-replay accounting in restart())
        self._departed_zxid: Dict[int, int] = {}

    def _new_member(self, i: int, port: int = 0) -> ZKServer:
        member = ZKServer(
            host=self._host,
            port=port,
            shared=self.state,
            server_id=i + 1,  # real ensembles number members from 1
            **self._server_kwargs,
        )
        return member

    async def start(self) -> "ZKEnsemble":
        self.servers = []
        for i in range(self._size):
            member = self._new_member(i, port=self._ports[i] or 0)
            await member.start()
            self._ports[i] = member.port
            self.servers.append(member)
        # The INITIAL election completes immediately even with an
        # election window configured: the window models failover (a
        # leader dying under live clients), not cold boot — tests must
        # be able to connect the moment start() returns.
        if self.state.election_due is not None:
            self.state.complete_election()
        self._elect()
        return self

    async def stop(self) -> None:
        for member in self.servers:
            if member is not None and member._server is not None:
                await member.stop()

    async def __aenter__(self) -> "ZKEnsemble":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    @property
    def addresses(self) -> List[Tuple[str, int]]:
        """(host, port) of every member, dead or alive — the client's
        ``servers`` list stays stable across member restarts."""
        return [(self._host, p) for p in self._ports if p is not None]

    def _elect(self) -> None:
        # Role assignment is the shared state's election machinery
        #; member start()/stop() already trigger it — this
        # remains as the explicit recompute hook.
        self.state.reevaluate()

    @property
    def leader_index(self) -> Optional[int]:
        """Index (into ``servers``) of the current leader, or None
        (mid-election / quorum lost)."""
        leader = self.state.leader
        if leader is None:
            return None
        for i, member in enumerate(self.servers):
            if member is leader:
                return i
        return None

    @property
    def has_quorum(self) -> bool:
        return self.state.leader is not None

    @property
    def size(self) -> int:
        return self._size

    def partition(self, groups: Sequence[Sequence[int]]) -> None:
        """Split member-to-member connectivity into ``groups`` of member
        indices (0-based).  The group that can assemble quorum keeps (or
        elects) the leader; every other member degrades to read-only
        with a frozen view — the partition-to-minority fault class.
        Members not named in any group are isolated singletons.
        """
        seen: Set[int] = set()
        for group in groups:
            for i in group:
                if not 0 <= i < self._size:
                    raise ValueError(f"member index {i} out of range")
                if i in seen:
                    raise ValueError(f"member {i} in more than one group")
                seen.add(i)
        # groups are stored by server_id (= index + 1, stable across
        # member restarts)
        self.state.groups = [{i + 1 for i in group} for group in groups]
        self.state.reevaluate()

    def heal_partition(self) -> None:
        """Restore full member-to-member connectivity (rejoining
        minority members catch up and resume as followers)."""
        self.state.groups = None
        self.state.reevaluate()

    async def kill(self, i: int) -> None:
        """Stop member ``i`` (connections die; sessions and ephemerals
        survive in the shared state until their own timeouts)."""
        member = self.servers[i]
        if member is None or member._server is None:
            return
        # The rejoin sync point: what this member had applied when it
        # departed (its view zxid — a lagging/ro member is behind the
        # shared head, and restart() owes it the difference).
        self._departed_zxid[i] = member._view_zxid()
        await member.stop()
        self.servers[i] = None

    async def restart(self, i: int) -> ZKServer:
        """Bring member ``i`` back on its original port, joined to the
        ensemble's shared state — catching up via committed-backlog
        replay, or a full snapshot when the backlog no longer covers its
        departure point (``catchup_replayed`` / ``catchup_snapshots``)."""
        if self.servers[i] is not None and self.servers[i]._server is not None:
            return self.servers[i]
        member = self._new_member(i, port=self._ports[i] or 0)
        await member.start()
        member.catchup_from(self._departed_zxid.pop(i, None))
        self._ports[i] = member.port
        self.servers[i] = member
        return member

    def set_lag(self, i: int, apply_delay_ms: int) -> None:
        """Make member ``i`` a lagging follower (``apply_delay_ms`` > 0)
        or bring it back in step (0, after an immediate catch-up).
        Lag starts from the *next* commit made through another member;
        the member's current view is the replicated state.  Reads through
        a lagging member then return stale data until a client issues
        ``sync()`` on it — the scenario ZKClient.sync exists for."""
        member = self.servers[i]
        if member is None or member._server is None:
            raise ValueError(f"member {i} is not running")
        member.apply_delay_ms = apply_delay_ms
        self.state.recount_lag()
        if apply_delay_ms <= 0:
            member._catch_up()

    @property
    def live(self) -> List[ZKServer]:
        return [
            m for m in self.servers if m is not None and m._server is not None
        ]

    def get_node(self, path: str) -> Optional[ZNode]:
        """Direct shared-tree access for assertions (member-independent)."""
        node = self.state.root
        if path != "/":
            for comp in path.strip("/").split("/"):
                node = node.children.get(comp)
                if node is None:
                    return None
        return node


async def _ctl_conn(ens: "ZKEnsemble", size: int, reader, writer) -> None:
    """One ensemble-control connection (see --ctl-port): line-oriented
    'stop N' / 'start N' / 'lag N MS' commands, N 1-based to match the
    CI zkctl convention (tests/test_real_zk_ensemble.py)."""
    try:
        while True:
            line = await reader.readline()
            if not line:
                return
            parts = line.decode("ascii", errors="replace").split()
            try:
                action = parts[0]
                if action == "heal":
                    ens.heal_partition()
                elif action == "partition":
                    # 'partition 1,2|3' — groups of 1-based members
                    groups = [
                        [int(m) - 1 for m in grp.split(",") if m]
                        for grp in parts[1].split("|")
                    ]
                    ens.partition(groups)
                else:
                    member = int(parts[1]) - 1
                    if not 0 <= member < size:
                        raise ValueError(f"member {parts[1]} out of range")
                    if action == "stop":
                        await ens.kill(member)
                    elif action == "start":
                        await ens.restart(member)
                    elif action == "lag":
                        ens.set_lag(member, int(parts[2]))
                    else:
                        raise ValueError(f"unknown action {action!r}")
            except (IndexError, ValueError) as e:
                writer.write(f"err {e}\n".encode())
            except Exception as e:  # noqa: BLE001 - report, keep serving
                writer.write(f"err {e!r}\n".encode())
            else:
                writer.write(b"ok\n")
            await writer.drain()
    except (ConnectionError, OSError):
        pass
    finally:
        try:
            writer.close()
        except Exception:  # noqa: BLE001
            pass


async def _amain(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="standalone in-process ZooKeeper test server"
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=21811)
    parser.add_argument(
        "--max-session-timeout", type=int, default=60_000, metavar="MS"
    )
    parser.add_argument(
        "--snapshot-file", metavar="PATH", default=None,
        help="persist the tree/sessions/zxid here (loaded on startup when "
        "present, saved every --snapshot-interval seconds and on clean "
        "SIGTERM/SIGINT; a crash/SIGKILL loses at most one interval — "
        "real ZooKeeper's continuously-fsynced txlog has no analog here)",
    )
    parser.add_argument(
        "--snapshot-interval", type=float, default=30.0, metavar="SECONDS",
        help="periodic --snapshot-file save cadence (0 disables the "
        "periodic safety net, keeping shutdown-only saves)",
    )
    parser.add_argument(
        "--ensemble", type=int, default=1, metavar="N",
        help="run an N-member ensemble sharing one replicated tree on "
        "consecutive ports starting at --port (models the 3-5 member "
        "production deployments clients are pointed at)",
    )
    parser.add_argument(
        "--lag", action="append", default=[], metavar="MEMBER:MS",
        help="make ensemble member MEMBER (0-based) a lagging follower "
        "with an MS-millisecond apply delay (repeatable; requires "
        "--ensemble > 1).  Reads through that member return stale data "
        "until a client issues sync() on it — rehearses ZKClient.sync's "
        "read barrier from the command line",
    )
    parser.add_argument(
        "--election-ms", type=float, default=0.0, metavar="MS",
        help="(ensemble only) leader-election duration: after a leader "
        "death, candidate members spend MS milliseconds 'looking' "
        "(handshakes refused, writers dropped) before the new leader "
        "serves — rehearses client failover MTTR from the command line",
    )
    parser.add_argument(
        "--ctl-port", type=int, default=None, metavar="PORT",
        help="(ensemble only) listen on PORT (0 = pick a free one) for "
        "line-oriented member control: 'stop N' / 'start N' / 'lag N MS' "
        "with N 1-based, answered with 'ok' or 'err <reason>'.  Lets the "
        "real-ensemble interop suite (tests/test_real_zk_ensemble.py, "
        "ZK_ENSEMBLE_CTL=host:port) drive failover against this hermetic "
        "ensemble exactly as CI drives it against Apache ZooKeeper",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG)
    if args.ensemble > 1 and args.snapshot_file:
        parser.error("--snapshot-file is standalone-only (use --ensemble 1)")
    if args.lag and args.ensemble <= 1:
        parser.error("--lag requires --ensemble > 1")
    if args.ctl_port is not None and args.ensemble <= 1:
        parser.error("--ctl-port requires --ensemble > 1")
    lags = []
    for spec in args.lag:
        member_s, _, ms_s = spec.partition(":")
        try:
            member, ms = int(member_s), int(ms_s)
        except ValueError:
            parser.error(f"--lag expects MEMBER:MS (e.g. 1:60000), got {spec!r}")
        if not 0 <= member < args.ensemble:
            parser.error(
                f"--lag member {member} out of range for --ensemble {args.ensemble}"
            )
        if ms <= 0:
            parser.error("--lag MS must be positive")
        lags.append((member, ms))

    stopping = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stopping.set)
        except NotImplementedError:
            pass

    if args.ensemble > 1:
        ens = ZKEnsemble(
            size=args.ensemble,
            host=args.host,
            base_port=args.port or None,
            election_ms=args.election_ms,
            max_session_timeout_ms=args.max_session_timeout,
        )
        await ens.start()
        for member, ms in lags:
            ens.set_lag(member, ms)
            print(f"member {member} lagging (apply delay {ms} ms)", flush=True)
        hosts = ",".join(f"{h}:{p}" for h, p in ens.addresses)
        print(f"zk test ensemble listening on {hosts}", flush=True)
        ctl_server = None
        if args.ctl_port is not None:
            ctl_server = await asyncio.start_server(
                lambda r, w: _ctl_conn(ens, args.ensemble, r, w),
                args.host,
                args.ctl_port,
            )
            ctl_port = ctl_server.sockets[0].getsockname()[1]
            print(
                f"ensemble control listening on {args.host}:{ctl_port}",
                flush=True,
            )
        try:
            await stopping.wait()
        finally:
            # close() only — on 3.12 Server.wait_closed() blocks until
            # every handler transport reports closed, which can outlive
            # a ctl client that already disconnected; this is process
            # shutdown, there is nothing to flush.
            if ctl_server is not None:
                ctl_server.close()
            await ens.stop()
        return

    server = ZKServer(
        host=args.host,
        port=args.port,
        max_session_timeout_ms=args.max_session_timeout,
    )
    if args.snapshot_file and os.path.exists(args.snapshot_file):
        server.load_snapshot(args.snapshot_file)
        print(f"loaded snapshot from {args.snapshot_file}", flush=True)
    await server.start()
    print(f"zk test server listening on {args.host}:{server.port}", flush=True)

    async def periodic_saves() -> None:
        # Crash safety net: without it a SIGKILL would lose everything
        # since the last shutdown.  A
        # transiently failing save (disk full, permissions) must not kill
        # the net — log and retry next interval.
        while True:
            await asyncio.sleep(args.snapshot_interval)
            try:
                server.save_snapshot(args.snapshot_file)
            except OSError:
                log.exception("periodic snapshot save failed; will retry")

    saver = (
        asyncio.create_task(periodic_saves())
        if args.snapshot_file and args.snapshot_interval > 0
        else None
    )
    try:
        await stopping.wait()
    finally:
        if saver is not None:
            saver.cancel()
            try:
                await saver
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass  # a dead saver must not block the final save below
        await server.stop()
        if args.snapshot_file:
            server.save_snapshot(args.snapshot_file)
            print(f"saved snapshot to {args.snapshot_file}", flush=True)


if __name__ == "__main__":
    try:
        asyncio.run(_amain())
    except KeyboardInterrupt:
        pass
