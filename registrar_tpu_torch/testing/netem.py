"""netem — a deterministic, toxiproxy-style TCP fault-injection proxy.

The chaos suite (tests/test_chaos.py) injects *server-side* faults: member
kills, dropped connections, replication lag.  The nastier failures live in
the network itself — half-open TCP, a peer that stops reading (slow-loris),
frames sliced into tiny segments, reply stalls shorter than the session
watchdog — and none of them can be produced by a well-behaved server.
:class:`ChaosProxy` interposes a real asyncio TCP proxy between
:class:`~registrar_tpu_torch.zk.client.ZKClient` and a
:class:`~registrar_tpu_torch.testing.server.ZKServer` (or ensemble member) and
applies composable, runtime-toggleable "toxics" per direction:

    ==================  ====================================================
    toxic               wire behavior
    ==================  ====================================================
    Latency             delay each chunk by latency ± jitter
    Bandwidth           throttle to N bytes/s (pacing sleep per chunk)
    Slicer              fragment every chunk into tiny segments
    Truncate            forward the first N bytes, then silence forever
                        (half-open TCP: peer is gone, no FIN ever arrives)
    Blackhole           connect succeeds, nothing is ever forwarded
    StopReading         stop draining the source socket (slow-loris): the
                        sender's kernel buffer fills and its ``drain()``
                        blocks — the watchdog-wedge scenario
    ResetAfter          forward N bytes, then RST both directions
    ==================  ====================================================

Direction ``"up"`` is client→server, ``"down"`` is server→client.  Toxics
taking randomness draw it from the proxy's seeded RNG, so a failing run is
reproducible from its seed (the chaos storm prints ``CHAOS_SEED``).

Usage::

    async with ZKServer() as server:
        async with ChaosProxy(server.address, seed=7) as proxy:
            client = await ZKClient([proxy.address]).connect()
            proxy.add(Latency(latency_ms=30, jitter_ms=10), direction="down")
            ...
            proxy.clear()          # heal the link (live connections too)

Toxics apply to live connections immediately: the pumps consult the
installed list on every chunk (and every read), which is what makes
mid-operation fault injection — the whole point — possible.
"""

from __future__ import annotations

import asyncio
import logging
import socket
import struct
from typing import Dict, List, Optional, Sequence, Set, Tuple

from registrar_tpu_torch.events import spawn_owned

log = logging.getLogger("registrar_tpu_torch.testing.netem")

#: client -> server
UP = "up"
#: server -> client
DOWN = "down"

_READ_SIZE = 65536
#: cadence of the paused-pump poll (StopReading) — coarse is fine, the
#: point is *not* reading for a while, not precise timing
_PAUSE_POLL_S = 0.005


class Toxic:
    """One wire-fault behavior, applied to every chunk of one direction.

    Subclasses override :meth:`process` (transform/delay/swallow a chunk;
    returning None ends the chain for that chunk) and/or :meth:`paused`
    (True = the pump must not read from the source socket at all).  A
    toxic with ``masks_close = True`` also swallows the peer's EOF: the
    other side sees a half-open connection instead of an orderly FIN —
    exactly what a peer that died without closing looks like.
    """

    name = "toxic"
    masks_close = False

    def paused(self, link: "_Link") -> bool:
        return False

    async def process(self, link: "_Link", data: bytes) -> Optional[bytes]:
        return data

    def __repr__(self) -> str:  # seeds/params visible in failure output
        attrs = ", ".join(
            f"{k}={v!r}" for k, v in vars(self).items() if not k.startswith("_")
        )
        return f"{type(self).__name__}({attrs})"


class Latency(Toxic):
    """Delay each chunk by ``latency_ms`` ± uniform ``jitter_ms``."""

    name = "latency"

    def __init__(self, latency_ms: float = 50.0, jitter_ms: float = 0.0):
        self.latency_ms = latency_ms
        self.jitter_ms = jitter_ms

    async def process(self, link: "_Link", data: bytes) -> Optional[bytes]:
        delay = self.latency_ms
        if self.jitter_ms:
            delay += link.rng.uniform(-self.jitter_ms, self.jitter_ms)
        if delay > 0:
            await asyncio.sleep(delay / 1000.0)
        return data


class Bandwidth(Toxic):
    """Throttle a direction to ``bytes_per_s`` (sleep len/rate per chunk)."""

    name = "bandwidth"

    def __init__(self, bytes_per_s: float = 65536.0):
        if bytes_per_s <= 0:
            raise ValueError("bytes_per_s must be positive")
        self.bytes_per_s = bytes_per_s

    async def process(self, link: "_Link", data: bytes) -> Optional[bytes]:
        await asyncio.sleep(len(data) / self.bytes_per_s)
        return data


class Slicer(Toxic):
    """Fragment each chunk into tiny segments (``1..max_size`` bytes each,
    rng-sized), yielding to the event loop between segments so the far
    side's framing layer really sees torn frames.  Writes the segments
    itself, so it terminates the toxic chain for the chunk — install it
    last when composing.
    """

    name = "slicer"

    def __init__(self, max_size: int = 8, delay_ms: float = 0.0):
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        self.max_size = max_size
        self.delay_ms = delay_ms

    async def process(self, link: "_Link", data: bytes) -> Optional[bytes]:
        pos = 0
        while pos < len(data):
            n = link.rng.randint(1, self.max_size)
            link.write(data[pos: pos + n])
            pos += n
            if self.delay_ms:
                await asyncio.sleep(self.delay_ms / 1000.0)
            else:
                await asyncio.sleep(0)  # force separate transport writes
            await link.drain()
        return None


class Truncate(Toxic):
    """Forward the first ``n`` bytes of the direction, then silence forever
    — and mask the peer's close (half-open TCP: a frame can be cut mid-
    payload and no FIN ever tells the other side)."""

    name = "truncate"
    masks_close = True

    def __init__(self, n: int = 0):
        self.n = n

    async def process(self, link: "_Link", data: bytes) -> Optional[bytes]:
        passed = link.state.get(self, 0)
        if passed >= self.n:
            return None
        keep = data[: self.n - passed]
        link.state[self] = passed + len(keep)
        return keep


class Blackhole(Toxic):
    """Forward nothing, ever (connect still succeeds upstream of this).

    With it installed on both directions the peer is a total void: TCP
    accepts, writes are swallowed, replies never come, close is masked —
    the scenario the client's liveness watchdog exists for.
    """

    name = "blackhole"
    masks_close = True

    async def process(self, link: "_Link", data: bytes) -> Optional[bytes]:
        return None


class StopReading(Toxic):
    """Stop draining the source socket (slow-loris).

    The proxy's receive buffer, then the sender's kernel send buffer,
    fill; the sender's transport rises past its high-water mark and its
    ``drain()`` blocks indefinitely.  Installed on ``up``, this is the
    exact stall that wedged the pre-fix client watchdog
    (``ZKClient._ping_loop``) behind an unbounded drain.
    """

    name = "stop_reading"
    masks_close = True

    def paused(self, link: "_Link") -> bool:
        return True


class ResetAfter(Toxic):
    """Forward ``n`` bytes of the direction, then hard-reset the whole
    connection (RST via SO_LINGER, not an orderly FIN)."""

    name = "reset"

    def __init__(self, n: int = 0):
        self.n = n

    async def process(self, link: "_Link", data: bytes) -> Optional[bytes]:
        passed = link.state.get(self, 0)
        if passed + len(data) <= self.n:
            link.state[self] = passed + len(data)
            return data
        keep = data[: max(self.n - passed, 0)]
        if keep:
            link.write(keep)
            await link.drain()
        link.abort()
        return None


class _Link:
    """Per-connection, per-direction state handed to toxics."""

    __slots__ = ("direction", "conn", "rng", "writer", "state")

    def __init__(self, direction: str, conn: "_ProxyConn", writer) -> None:
        self.direction = direction
        self.conn = conn
        self.rng = conn.proxy.rng
        self.writer = writer
        #: per-toxic scratch (byte counters etc.), keyed by toxic identity
        self.state: Dict[Toxic, int] = {}

    def write(self, data: bytes) -> None:
        if not self.conn.closed:
            self.writer.write(data)

    async def drain(self) -> None:
        if self.conn.closed:
            return
        try:
            await self.writer.drain()
        except (ConnectionError, OSError):
            self.conn.close()

    def abort(self) -> None:
        self.conn.abort()


class _ProxyConn:
    """One proxied client connection (client socket + upstream socket)."""

    def __init__(self, proxy: "ChaosProxy", c_reader, c_writer, u_reader, u_writer):
        self.proxy = proxy
        self.c_reader = c_reader
        self.c_writer = c_writer
        self.u_reader = u_reader
        self.u_writer = u_writer
        self.closed = False

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for w in (self.c_writer, self.u_writer):
            try:
                w.close()
            except Exception:  # noqa: BLE001 - already-dead transport
                pass

    def abort(self) -> None:
        """RST both sides: linger-0 so close() emits a reset, not a FIN."""
        if self.closed:
            return
        self.closed = True
        for w in (self.c_writer, self.u_writer):
            try:
                sock = w.get_extra_info("socket")
                if sock is not None:
                    sock.setsockopt(
                        socket.SOL_SOCKET,
                        socket.SO_LINGER,
                        struct.pack("ii", 1, 0),
                    )
                w.transport.abort()
            except Exception:  # noqa: BLE001 - already-dead transport
                pass


class ChaosProxy:
    """Seeded fault-injection TCP proxy in front of one upstream address.

    ``seed`` drives every toxic's randomness (reproducible runs);
    ``sock_buf`` shrinks the proxy-side socket buffers (SO_RCVBUF on the
    accepting side, SO_SNDBUF/SO_RCVBUF upstream) so buffer-filling toxics
    (:class:`StopReading`) bite after kilobytes instead of megabytes.
    """

    def __init__(
        self,
        upstream: Tuple[str, int],
        host: str = "127.0.0.1",
        port: int = 0,
        seed: Optional[int] = None,
        sock_buf: Optional[int] = None,
    ):
        import random

        self.upstream = upstream
        self.host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self.rng = random.Random(seed)
        self.sock_buf = sock_buf
        self._toxics: Dict[str, List[Toxic]] = {UP: [], DOWN: []}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: Set[_ProxyConn] = set()
        self._tasks: Set[asyncio.Task] = set()

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "ChaosProxy":
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if self.sock_buf is not None:
                # Set BEFORE listen: accepted sockets inherit RCVBUF.
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_RCVBUF, self.sock_buf
                )
            sock.bind((self.host, self._requested_port))
            sock.setblocking(False)
        except OSError:
            sock.close()
            raise
        self._server = await asyncio.start_server(self._handle, sock=sock)
        self.port = self._server.sockets[0].getsockname()[1]
        log.debug(
            "ChaosProxy %s:%d -> %s:%d", self.host, self.port, *self.upstream
        )
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None
        for conn in list(self._conns):
            conn.close()
        for task in list(self._tasks):
            task.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)

    async def __aenter__(self) -> "ChaosProxy":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    # -- toxic management (runtime-toggleable) ------------------------------

    def add(self, toxic: Toxic, direction: str = DOWN) -> Toxic:
        """Install ``toxic`` on ``direction``; live connections pick it up
        on their next chunk/read.  Returns the toxic (handle for remove)."""
        if direction not in self._toxics:
            raise ValueError(f"direction must be {UP!r} or {DOWN!r}")
        self._toxics[direction].append(toxic)
        return toxic

    def remove(self, toxic: Toxic) -> None:
        for chain in self._toxics.values():
            if toxic in chain:
                chain.remove(toxic)

    def clear(self) -> None:
        """Heal the link: drop every toxic (paused pumps resume)."""
        for chain in self._toxics.values():
            chain.clear()

    def toxics(self, direction: str) -> List[Toxic]:
        return list(self._toxics[direction])

    def drop_connections(self) -> None:
        """Sever every proxied connection (the upstream server stays up)."""
        for conn in list(self._conns):
            conn.close()

    # -- data path ----------------------------------------------------------

    async def _connect_upstream(self):
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            if self.sock_buf is not None:
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_SNDBUF, self.sock_buf
                )
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_RCVBUF, self.sock_buf
                )
            sock.setblocking(False)
            await asyncio.get_running_loop().sock_connect(sock, self.upstream)
        except (ConnectionError, OSError):
            sock.close()
            raise
        return await asyncio.open_connection(sock=sock)

    async def _handle(self, c_reader, c_writer) -> None:
        try:
            u_reader, u_writer = await self._connect_upstream()
        except (ConnectionError, OSError):
            # Upstream down: refuse by closing (the accept already
            # succeeded — same shape as a mid-dial member kill).
            try:
                c_writer.close()
            except Exception:  # noqa: BLE001
                pass
            return
        conn = _ProxyConn(self, c_reader, c_writer, u_reader, u_writer)
        self._conns.add(conn)
        up = spawn_owned(
            self._pump(_Link(UP, conn, u_writer), c_reader), self._tasks
        )
        down = spawn_owned(
            self._pump(_Link(DOWN, conn, c_writer), u_reader), self._tasks
        )
        try:
            await asyncio.gather(up, down, return_exceptions=True)
        finally:
            self._conns.discard(conn)
            conn.close()

    async def _pump(self, link: _Link, reader) -> None:
        conn = link.conn
        try:
            while not conn.closed:
                # StopReading gate: while any installed toxic pauses this
                # direction the pump must NOT touch the socket — kernel
                # buffers filling up IS the fault being injected.
                if any(
                    t.paused(link) for t in self._toxics[link.direction]
                ):
                    await asyncio.sleep(_PAUSE_POLL_S)
                    continue
                data = await reader.read(_READ_SIZE)
                if not data:
                    break  # orderly EOF from the source
                for toxic in self.toxics(link.direction):
                    data = await toxic.process(link, data)
                    if data is None:
                        break
                if data:
                    link.write(data)
                    await link.drain()
        except asyncio.CancelledError:
            raise
        except (ConnectionError, OSError):
            conn.close()
            return
        if conn.closed:
            return
        if any(t.masks_close for t in self._toxics[link.direction]):
            # Half-open: the source hung up but the fault being modeled is
            # "peer vanished without a FIN" — leave the other side open
            # and silent; the client's watchdog/deadline must save it.
            return
        conn.close()


#: name -> factory(rng) for storm-style random toxic injection
#: (tests/test_chaos.py draws from this with its seeded RNG).  The storm
#: set leans transient — every entry here either passes traffic through
#: eventually or resets the connection, so a converging storm stays
#: convergeable; the forever-silent toxics (Blackhole, StopReading,
#: Truncate) are deliberately not in it and are exercised by the
#: deterministic per-toxic tests instead.
STORM_TOXICS = {
    "latency": lambda rng: Latency(
        latency_ms=rng.uniform(5, 40), jitter_ms=rng.uniform(0, 15)
    ),
    "bandwidth": lambda rng: Bandwidth(bytes_per_s=rng.uniform(8, 64) * 1024),
    "slicer": lambda rng: Slicer(max_size=rng.randint(2, 16)),
    "reset": lambda rng: ResetAfter(n=rng.randint(0, 4096)),
}


async def proxy_fleet(
    addresses: Sequence[Tuple[str, int]],
    rng=None,
    sock_buf: Optional[int] = None,
) -> List["ChaosProxy"]:
    """One started :class:`ChaosProxy` per upstream address, each with
    its own seed drawn from ``rng`` (a ``random.Random``; None = module
    RNG).

    The ensemble front-door shape: a client pointed at the
    returned proxies' addresses reaches every ensemble member through an
    independently faultable wire — the chaos storm's ensemble leg and
    the SLO harness's ensemble mode both build their fleets with this,
    so per-member network faults and member kills compose.  Callers own
    the proxies (``stop()`` each when done).
    """
    import random as random_mod

    draw = (rng or random_mod).randrange
    proxies: List[ChaosProxy] = []
    try:
        for address in addresses:
            proxies.append(
                await ChaosProxy(
                    address, seed=draw(2**32), sock_buf=sock_buf
                ).start()
            )
    except BaseException:
        for proxy in proxies:
            await proxy.stop()
        raise
    return proxies
