"""Watch-coherent in-memory cache of znode data + children.

The whole point of registrar is feeding Binder, the DNS server — and a
DNS answer that costs 2–3 live ZooKeeper round trips is capped at wire
latency no matter how fast the wire stack gets (docs/PERF.md).  The real
Binder fronts ZooKeeper with a zkplus watch-backed cache for exactly
this reason; :class:`ZKCache` is that layer for the rebuild.

It duck-types the two read calls the Binder-view resolver uses —
:meth:`read_node` and :meth:`get_many` — so ``binderview.resolve``
works identically over a :class:`~registrar_tpu_torch.zk.client.ZKClient`
(live reads) or a :class:`ZKCache` (memory), and a warm cached resolve
touches the server zero times.

Coherence model (docs/DESIGN.md "Watch-coherent resolve cache"):

  * every fill arms one-shot data/child watches with the read itself
    (``read_node(watch=True)`` / ``get_many(watch=True)``), so there is
    no arm-then-read window in which a write can slip through unseen;
  * a fired watch **drops** the entry before the next lookup can see it
    (events dispatch synchronously from the client's read loop); the
    next lookup is a live read that re-fills and re-arms.  Staleness is
    therefore bounded by watch delivery latency — the same bound the
    real Binder rides;
  * NO_NODE is cached negatively **with an exists-watch armed**, so an
    absent domain is answered from memory (no stampede on the server)
    and its creation invalidates the negative entry;
  * per-entry **generation counters**: a fill snapshots the entry's
    generation before its first RPC and stores only if the generation
    is unchanged after the replies arrive — an invalidation that races
    a refill can never be overwritten by the stale in-flight answer;
  * **degraded mode**: whenever the session is down, terminally
    expired, or a reconnect's watch re-arm failed (the client's
    ``watch_rearm_failed`` event), the cache flushes and turns
    non-authoritative — every lookup falls through to a live read until
    the next clean connect.  A reconnect (including a
    ``surviveSessionExpiry`` rebirth) resumes *cold but authoritative*:
    entries were flushed, and each refill arms fresh watches on the new
    connection, so nothing cached can predate the session boundary;
  * **stale-while-revalidate** (opt-in ``stale_max_age_s``,
    config ``cache.staleMaxAgeS``): the RFC 8767 serve-stale stance the
    DNS frontend and shard tier already take, promoted into the core
    cache.  Instead of flushing on a session drop, last-known-good
    entries keep answering for a bounded window — a backend blip or
    election is not a resolve outage for names whose data never changed
    — while the client's reconnect machinery IS the revalidation.  Past
    the bound the whole stale world is flushed and lookups fail
    truthfully; restoring authority flushes too (the invalidations
    missed while dark make every retained entry unprovable), and a
    terminal session expiry always flushes, so a rebirth can never
    resurrect a stale answer.  Default None: flush-on-degrade,
    reference-exact.

Single-flight fills: concurrent misses for one path share one in-flight
read, so a cold hot domain costs one RPC burst, not one per waiter.

Used by ``zkcli resolve --cached`` and the long-running ``zkcli
serve-view`` watch loop; benchmarked by bench.py (cached resolve
latency/QPS and the write→cache-visible coherence-lag metric);
instrumented by :func:`registrar_tpu_torch.metrics.instrument_cache`.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, Iterable, List, Optional, Tuple

from registrar_tpu_torch import trace
from registrar_tpu_torch.events import EventEmitter
from registrar_tpu_torch.zk.client import ZKClient
from registrar_tpu_torch.zk.protocol import Err, EventType, Stat, ZKError

log = logging.getLogger("registrar_tpu_torch.zkcache")

#: invalidation event types whose triggering write stamps the node's own
#: mtime — the only ones a refill can compute a coherence lag from
_DATA_EVENTS = (EventType.NODE_DATA_CHANGED, EventType.NODE_CREATED)

#: default bound on cached entries (docs/CONFIG.md ``cache.maxEntries``);
#: eviction is oldest-inserted-first — a resolve re-fills an evicted
#: entry transparently, so the bound trades memory for hit rate only.
DEFAULT_MAX_ENTRIES = 4096


class CacheOverloadError(Exception):
    """A cold fill was load-shed: ``fill_concurrency`` distinct-path
    fills were already in flight.  Deliberate and immediate —
    never a timeout — so the serve tier above can degrade (serve a
    bounded-age stale answer, or fail fast with an explicit shed
    reason) instead of queueing into collapse.  Joiners of an
    ALREADY-in-flight fill are never shed: single-flight sharing is the
    cheap case the bound exists to protect."""


class _Entry:
    """One cached node.  ``data is None`` ⇒ negative (node absent, an
    exists-watch is armed); ``children is None`` ⇒ children unknown (the
    entry was filled by a data-only ``get_many`` burst)."""

    __slots__ = ("data", "stat", "children")

    def __init__(
        self,
        data: Optional[bytes],
        stat: Optional[Stat],
        children: Optional[Tuple[str, ...]],
    ):
        self.data = data
        self.stat = stat
        self.children = children

    @property
    def negative(self) -> bool:
        return self.data is None


class ZKCache(EventEmitter):
    """Watch-invalidated read-through cache over one :class:`ZKClient`.

    Events: ``invalidated`` (path, watch event) after an entry is
    dropped by a fired watch — the ``serve-view`` loop's refresh signal;
    ``evicted`` (path) after an entry is dropped past ``max_entries``,
    its watch forgotten, so that what was built from it must go too;
    ``degraded`` (reason) / ``restored`` () on authority transitions.

    Not thread-safe (asyncio single-loop, like the client itself).
    """

    def __init__(
        self,
        zk: ZKClient,
        max_entries: int = DEFAULT_MAX_ENTRIES,
        fill_concurrency: Optional[int] = None,
        stale_max_age_s: Optional[float] = None,
    ):
        super().__init__()
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if fill_concurrency is not None and fill_concurrency < 0:
            raise ValueError("fill_concurrency must be >= 0")
        if stale_max_age_s is not None and stale_max_age_s < 0:
            raise ValueError("stale_max_age_s must be >= 0")
        self._zk = zk
        self.max_entries = max_entries
        #: serve-stale bound in seconds (module docstring).  None =
        #: reference-exact flush-on-degrade; 0 = fail closed (entries
        #: drop the moment authority is lost, like ``staleTtl: 0``).
        self.stale_max_age_s = stale_max_age_s
        #: monotonic stamp of the moment authority was lost with entries
        #: retained (the serve-stale window's start); None while
        #: authoritative or when SWR is off
        self._stale_since: Optional[float] = None
        #: cold-fill stampede bound: at most this many
        #: DISTINCT-path read_node fills in flight at once; the next
        #: would-be fill LEADER raises :class:`CacheOverloadError`
        #: instead of queueing (joiners always share).  None = unbounded,
        #: the pre-armor behavior.
        self.fill_concurrency = fill_concurrency
        #: insertion-ordered entry map (dict order drives eviction)
        self._entries: Dict[str, _Entry] = {}
        #: per-path invalidation generation, reset by clear() via _epoch
        self._gens: Dict[str, int] = {}
        #: global epoch folded into every generation snapshot: clear()
        #: bumps it, killing every in-flight store at once
        self._epoch = 0
        #: single-flight read_node fills: path -> future of the result
        self._inflight: Dict[str, asyncio.Future] = {}
        #: paths with a get_many fill in flight (count per path) — kept
        #: so _prune never drops a generation a bulk store still checks
        self._bulk: Dict[str, int] = {}
        #: paths with a registered client watch listener
        self._watched: set = set()
        #: path -> wall time its LAST data-change/creation invalidation
        #: was processed.  Only those refills can compute a coherence
        #: lag (a children-changed/deleted invalidation refills a node
        #: whose data mtime is unrelated to the triggering write), and
        #: the lag is measured to the INVALIDATION, not to the refill —
        #: once the entry is dropped every lookup is live, so the
        #: coherence window closed at the drop, however much later a
        #: query happens to refill the entry.
        self._lag_candidates: Dict[str, float] = {}
        self._session_up = zk.connected
        self._rearm_failed = False
        self._terminal = False
        #: per-instance tracer override; None = process default
        self.tracer = None
        self.stats: Dict[str, float] = {
            "hits": 0,
            "misses": 0,
            "fills": 0,
            "invalidations": 0,
            "bypasses": 0,
            "degraded_total": 0,
            "clears": 0,
            "evictions": 0,
            "coherence_lag_ms_last": 0.0,
            "coherence_lag_ms_total": 0.0,
            "coherence_lag_count": 0,
            "fill_sheds": 0,
            "stale_serves": 0,
            "stale_refusals": 0,
        }
        self._was_authoritative = self.authoritative
        zk.on("close", self._on_close)
        zk.on("connect", self._on_connect)
        zk.on("session_expired", self._on_session_expired)
        zk.on("watch_rearm_failed", self._on_rearm_failed)

    # -- authority ----------------------------------------------------------

    @property
    def authoritative(self) -> bool:
        """True while cached answers are coherence-guaranteed.  False ⇒
        every lookup falls through to a live read (module docstring)."""
        return (
            self._session_up and not self._rearm_failed and not self._terminal
        )

    @property
    def entries(self) -> int:
        return len(self._entries)

    def hit_rate(self) -> float:
        total = self.stats["hits"] + self.stats["misses"]
        return self.stats["hits"] / total if total else 0.0

    def _authority_changed(self, reason: str) -> None:
        now = self.authoritative
        if self._was_authoritative and not now:
            self.stats["degraded_total"] += 1
            log.warning("cache degraded (%s): serving live reads", reason)
            self.emit("degraded", reason)
        elif now and not self._was_authoritative:
            log.info("cache authoritative again (%s): cold start", reason)
            self.emit("restored")
        self._was_authoritative = now

    def _on_close(self, *_a) -> None:
        self._session_up = False
        # A fresh connection re-arms per-fill; the previous connection's
        # re-arm verdict is moot once it is gone.
        self._rearm_failed = False
        self._lose_authority()
        self._authority_changed("disconnected")

    def _on_connect(self, *_a) -> None:
        self._session_up = True
        # Cold but authoritative: everything cached before the drop was
        # flushed, and every refill arms fresh watches on THIS
        # connection — unless this connect's batch re-arm failed
        # (watch_rearm_failed fires before the connect event).  With
        # serve-stale this is the revalidation landing: the retained
        # entries are unprovable (their invalidations may have fired
        # while we were dark) and flush here too.
        self.clear()
        self._authority_changed("connected")

    def _on_session_expired(self, *_a) -> None:
        # Terminal expiry (surviveSessionExpiry off, or its breaker
        # tripped): the client is permanently closed; so is authority.
        # ALWAYS flushes — serve-stale never outlives the session's
        # death, so a later rebirth cannot resurrect a stale answer.
        self._terminal = True
        self.clear()
        self._authority_changed("session_expired")

    def _on_rearm_failed(self, *_a) -> None:
        self._rearm_failed = True
        self._lose_authority()
        self._authority_changed("watch_rearm_failed")

    def _lose_authority(self) -> None:
        """Authority lost on a non-terminal path: flush (reference), or
        — with ``stale_max_age_s`` set — open the serve-stale window and
        keep the last-known-good entries for its bounded duration."""
        if self.stale_max_age_s is None or self._terminal:
            self.clear()
            return
        if self._stale_since is None:
            self._stale_since = time.monotonic()

    def _stale_entry(self, path: str) -> Optional[_Entry]:
        """A bounded-age last-known-good entry servable while degraded,
        or None.  Crossing the age bound refuses and flushes the whole
        stale world: past it nothing retained is provable, and lookups
        must fail truthfully instead of answering from history."""
        if self._stale_since is None:
            return None
        entry = self._entries.get(path)
        if entry is None:
            return None
        if time.monotonic() - self._stale_since > self.stale_max_age_s:
            self.stats["stale_refusals"] += 1
            self.clear()
            return None
        return entry

    def clear(self) -> None:
        """Flush every entry and kill every in-flight store (epoch bump)."""
        self._entries.clear()
        self._gens.clear()
        self._lag_candidates.clear()
        self._epoch += 1
        self._stale_since = None
        self.stats["clears"] += 1

    def close(self) -> None:
        """Unhook from the client (listeners + watch bookkeeping)."""
        self._zk.off("close", self._on_close)
        self._zk.off("connect", self._on_connect)
        self._zk.off("session_expired", self._on_session_expired)
        self._zk.off("watch_rearm_failed", self._on_rearm_failed)
        for path in self._watched:
            self._zk.unwatch(path, self._on_event)
        self._watched.clear()
        self.clear()

    # -- invalidation -------------------------------------------------------

    def _gen(self, path: str) -> Tuple[int, int]:
        return (self._epoch, self._gens.get(path, 0))

    def _on_event(self, event) -> None:
        """A one-shot watch fired: drop the entry *now* (this runs
        synchronously from the client's frame dispatch, so no lookup can
        be scheduled between the event and the drop)."""
        path = event.path
        self._gens[path] = self._gens.get(path, 0) + 1
        dropped = self._entries.pop(path, None)
        if dropped is not None:
            self.stats["invalidations"] += 1
            trace.tracer_for(self).event(
                "cache.invalidated", path=path, type=event.type
            )
        if event.type in _DATA_EVENTS:
            self._lag_candidates[path] = time.time()
            # bound the candidate map: a path churned away before any
            # refill consumes its stamp must not leak it forever
            while len(self._lag_candidates) > self.max_entries:
                self._lag_candidates.pop(next(iter(self._lag_candidates)))
        else:
            self._lag_candidates.pop(path, None)
        self.emit("invalidated", path, event)
        self._prune(path)

    def _prune(self, path: str) -> None:
        """Drop per-path bookkeeping once nothing references it: no
        entry, no in-flight fill.  The generation entry must outlive any
        fill that snapshotted it (else a later snapshot would compare
        equal to a pre-bump one and resurrect stale data)."""
        if (
            path not in self._entries
            and path not in self._inflight
            and path not in self._bulk
        ):
            if path in self._watched:
                self._watched.discard(path)
                self._zk.unwatch(path, self._on_event)
            # With no fill in flight, no snapshot of this generation
            # can still be live — a later fill re-reads it (back at 0)
            # only after re-registering the listener, so an
            # invalidation after that bumps to 1 and still wins.
            # Popping here keeps a weeks-long serve-view from leaking
            # one generation per churned-away unique path.  Lag
            # candidates are NOT popped: they must outlive the drop to
            # be consumed by the next refill (bounded in _on_event).
            self._gens.pop(path, None)

    def _ensure_listener(self, path: str) -> None:
        if path not in self._watched:
            self._watched.add(path)
            self._zk.watch(path, self._on_event)

    def _store(
        self, path: str, entry: _Entry, gen: Tuple[int, int]
    ) -> None:
        """Install a filled entry unless its snapshot went stale."""
        if not self.authoritative or gen != self._gen(path):
            return
        # Coherence-lag observation: a refill that follows a DATA
        # invalidation (dataChanged/created — the only events whose
        # triggering write stamps this node's mtime) measures the
        # write→invalidation-processed window off that mtime (same
        # host in the hermetic/bench setup; in production this is an
        # approximation subject to clock skew).  The refill's own
        # timing is deliberately excluded: the stale window closed
        # when the entry was dropped, and a consumer that next queries
        # ten minutes later must not read as ten minutes of lag.
        inval_at = self._lag_candidates.pop(path, None)
        if inval_at is not None and entry.stat is not None:
            lag_ms = max(0.0, inval_at * 1000.0 - entry.stat.mtime)
            self.stats["coherence_lag_ms_last"] = lag_ms
            self.stats["coherence_lag_ms_total"] += lag_ms
            self.stats["coherence_lag_count"] += 1
        self._entries[path] = entry
        self.stats["fills"] += 1
        while len(self._entries) > self.max_entries:
            victim = next(iter(self._entries))
            del self._entries[victim]
            self._gens[victim] = self._gens.get(victim, 0) + 1
            self._zk.forget_watches(victim)
            self.stats["evictions"] += 1
            self._prune(victim)
            self.emit("evicted", victim)

    # -- the resolver's read surface ----------------------------------------

    async def read_node(
        self, path: str
    ) -> Optional[Tuple[bytes, Stat, List[str]]]:
        """Cached :meth:`ZKClient.read_node`: ``(data, stat, children)``
        or None when absent (served from the negative cache)."""
        if not self.authoritative:
            stale = self._stale_entry(path)
            if stale is not None and (
                stale.negative or stale.children is not None
            ):
                # Serve-stale: a bounded-age last-known-good
                # answer through the blip, RFC 8767 style.
                self.stats["stale_serves"] += 1
                if stale.negative:
                    return None
                return (stale.data, stale.stat, list(stale.children))
            self.stats["bypasses"] += 1
            return await self._zk.read_node(path)
        entry = self._entries.get(path)
        if entry is not None and (entry.negative or entry.children is not None):
            self.stats["hits"] += 1
            if entry.negative:
                return None
            return (entry.data, entry.stat, list(entry.children))
        self.stats["misses"] += 1
        return await self._fill_node(path)

    async def get_many(
        self, paths: Iterable[str]
    ) -> List[Optional[Tuple[bytes, Stat]]]:
        """Cached :meth:`ZKClient.get_many`; misses are refilled in one
        pipelined watch-arming burst."""
        paths = list(paths)
        if not self.authoritative:
            if paths and self._stale_since is not None:
                # All-or-nothing: a batch mixing stale entries with live
                # reads would compose an answer no single point in time
                # ever looked like — serve stale only when EVERY path is
                # covered, else fall through whole (and fail truthfully
                # if the backend is dark).
                stale = [self._stale_entry(p) for p in paths]
                if all(e is not None for e in stale):
                    self.stats["stale_serves"] += len(stale)
                    return [
                        None if e.negative else (e.data, e.stat)
                        for e in stale
                    ]
            self.stats["bypasses"] += 1
            return await self._zk.get_many(paths)
        out: List[Optional[Tuple[bytes, Stat]]] = [None] * len(paths)
        misses: List[Tuple[int, str]] = []
        for i, path in enumerate(paths):
            entry = self._entries.get(path)
            if entry is None:
                misses.append((i, path))
            elif entry.negative:
                self.stats["hits"] += 1
            else:
                self.stats["hits"] += 1
                out[i] = (entry.data, entry.stat)
        if not misses:
            return out
        self.stats["misses"] += len(misses)
        gens = []
        for _i, path in misses:
            self._ensure_listener(path)
            gens.append(self._gen(path))
            self._bulk[path] = self._bulk.get(path, 0) + 1
        try:
            with trace.tracer_for(self).span(
                "cache.fill", kind="bulk", count=len(misses)
            ):
                results = await self._zk.get_many(
                    (path for _i, path in misses), watch=True
                )
            for (i, path), gen, res in zip(misses, gens, results):
                out[i] = res
                if res is not None:
                    # A None (NO_NODE) result is returned uncached:
                    # getData leaves no watch on an absent node, and the
                    # parent's child watch already covers the churn that
                    # produced it.
                    self._store(path, _Entry(res[0], res[1], None), gen)
        finally:
            # AFTER the stores: _prune unregisters the invalidation
            # listener for paths that ended up with no entry — pruning
            # before storing would strip every freshly filled entry of
            # its coherence signal.
            for _i, path in misses:
                left = self._bulk.get(path, 0) - 1
                if left <= 0:
                    self._bulk.pop(path, None)
                    self._prune(path)
                else:
                    self._bulk[path] = left
        return out

    # -- fills --------------------------------------------------------------

    async def _fill_node(self, path: str):
        """Single-flight read_node fill: concurrent misses share one
        in-flight load; a cancelled leader hands leadership to the next
        waiter instead of failing the whole queue."""
        while True:
            fut = self._inflight.get(path)
            if fut is None:
                break
            try:
                return await asyncio.shield(fut)
            except asyncio.CancelledError:
                if fut.cancelled():
                    continue  # leader died; take over
                raise
        if (
            self.fill_concurrency is not None
            and len(self._inflight) >= self.fill_concurrency
        ):
            # Cold-fill stampede shed (class CacheOverloadError): this
            # would be a NEW fill leader beyond the bound.  Checked
            # after the join loop on purpose — a request for a path
            # already being filled rides the existing future for free.
            self.stats["fill_sheds"] += 1
            raise CacheOverloadError(
                f"cold-fill concurrency bound reached "
                f"({len(self._inflight)} >= {self.fill_concurrency})"
            )
        fut = asyncio.get_running_loop().create_future()
        self._inflight[path] = fut
        try:
            result = await self._load_node(path)
        except BaseException as err:
            if isinstance(err, asyncio.CancelledError):
                fut.cancel()
            else:
                fut.set_exception(err)
                fut.exception()  # mark retrieved: no waiter is guaranteed
            raise
        else:
            fut.set_result(result)
            return result
        finally:
            self._inflight.pop(path, None)
            self._prune(path)

    async def _load_node(self, path: str):
        with trace.tracer_for(self).span("cache.fill", path=path):
            return await self._load_node_inner(path)

    async def _load_node_inner(self, path: str):
        gen = self._gen(path)
        self._ensure_listener(path)
        node = await self._zk.read_node(path, watch=True)
        while node is None:
            # Negative caching: getData leaves no watch on NO_NODE, so
            # arm an exists-watch — the node's creation then invalidates
            # the negative entry.  A creation racing in between makes
            # the stat succeed; loop back to a real watched read.
            try:
                await self._zk.stat(path, watch=True)
            except ZKError as err:
                if err.code != Err.NO_NODE:
                    raise
                self._store(path, _Entry(None, None, ()), gen)
                return None
            node = await self._zk.read_node(path, watch=True)
        data, stat, children = node
        self._store(path, _Entry(data, stat, tuple(children)), gen)
        return (data, stat, children)
