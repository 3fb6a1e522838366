"""Seeded heavy-tailed workload storms for the sharded serve tier.

The overload armor's offense side.  Uniform, well-behaved load
exercises none of the armor, and the traffic a Binder-shaped resolver
actually faces is neither.  :class:`StormWorkload` drives the tier over
the REAL client paths (:class:`~registrar_tpu_torch.shard.ShardDirectClient`
per storm client — the SO_REUSEPORT-shaped data plane the DNS frontend
will use) with the traffic mix the serve tier's armor exists for:

- **Zipf popularity** over the warm domain set (a handful of names take
  most of the hits — the head keeps every shard's warm slice hot while
  the tail forces cache churn),
- **flash-crowd bursts** concentrated on ONE shard's hash-ring slice
  (the victim is derived from the same deterministic ring the router
  uses, so a seeded storm always picks the same shard),
- **churned never-exists names** (each draw is a fresh name, so every
  one is a distinct negative-cache fill — the cold-fill stampede),
- **malformed frames** (the hostile-input corpus shapes: short
  resolve bodies, qtype overruns, truncated trace blocks),
- **slow-loris clients** (flood pipelined resolves, then read one byte
  per poll — the netem ``StopReading`` toxic's behavior applied to the
  serve side's unix socket, where a TCP proxy can't sit), and
- **half-open clients** (a length prefix promising bytes that never
  come — the ``Truncate`` shape).

Outcomes are classified hard: an admitted answer, an explicit shed
(:class:`~registrar_tpu_torch.shard.ShardShedError` with its reason), an
error, or a timeout.  The armored tier's contract — asserted by the
SLO scenario and gated by bench — is that the **timeout bucket stays
empty**: overload answers are fast answers or fast refusals, never
silence.

Everything is seeded.  The same ``seed`` draws the same names in the
same proportions, which is what lets the SLO harness re-run one storm
with the armor withheld (``repair=False``) and prove the same traffic
collapses an unarmored tier.
"""

from __future__ import annotations

import array
import asyncio
import bisect
import fcntl
import random
import select
import socket
import struct
import termios
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from registrar_tpu_torch.shard import (
    _HDR,
    DEFAULT_VNODES,
    OP_RESOLVE,
    TRACE_FLAG,
    HashRing,
    ShardClient,
    ShardDirectClient,
    ShardError,
    ShardShedError,
    pack_request,
    pack_resolve,
)

__all__ = [
    "StormReport",
    "StormWorkload",
    "half_open",
    "malformed_resolve_frames",
    "measure_capacity",
    "slow_loris",
    "zipf_weights",
]

#: traffic classes a resolver draw can belong to
CLASSES = ("warm", "flash", "churn")

#: How long past its hold a slow-loris client may wait for the worker to
#: read every request it sent, and then how long it waits on (more than
#: a write deadline) for the disconnect.  The armor fires only once the
#: worker's replies fill the kernel's socket buffer (up to ~280 KB on a
#: unix socket), our stream reader's read-ahead (128 KB) and the
#: worker transport's 64 KB high-water mark, and then stall a whole
#: write deadline; a worker the storm keeps busy gets there late.
LORIS_GRACE_S = 4.0
LORIS_SETTLE_S = 1.0


def zipf_weights(n: int, s: float = 1.2) -> List[float]:
    """Zipf(s) popularity weights for ranks 1..n (unnormalized)."""
    return [1.0 / (rank ** s) for rank in range(1, n + 1)]


class _ZipfPicker:
    """Seedable O(log n) Zipf draw over an ordered name list."""

    def __init__(self, names: Sequence[str], s: float = 1.2):
        self.names = list(names)
        cum: List[float] = []
        total = 0.0
        for w in zipf_weights(len(self.names), s):
            total += w
            cum.append(total)
        self._cum = cum
        self._total = total

    def pick(self, rng: random.Random) -> str:
        i = bisect.bisect_left(self._cum, rng.random() * self._total)
        return self.names[min(i, len(self.names) - 1)]


def _quantile_ms(samples: List[float], q: float) -> Optional[float]:
    if not samples:
        return None
    ordered = sorted(samples)
    idx = min(len(ordered) - 1, int(q * (len(ordered) - 1) + 0.5))
    return round(ordered[idx] * 1000.0, 4)


class StormReport:
    """Mutable outcome ledger one storm run fills in, then summarizes."""

    def __init__(self, seed: int):
        self.seed = seed
        self.sent = {cls: 0 for cls in CLASSES}
        self.ok = {cls: 0 for cls in CLASSES}
        self.errors = {cls: 0 for cls in CLASSES}
        self.timeouts = {cls: 0 for cls in CLASSES}
        #: explicit sheds by reason (the client-visible taxonomy)
        self.sheds: Dict[str, int] = {}
        #: seconds, admitted warm+flash answers only (the bench p99)
        self.admitted_warm_s: List[float] = []
        #: seconds to an explicit shed reply (must be FAST — the
        #: fail-fast half of the contract)
        self.shed_s: List[float] = []
        self.duration_s = 0.0
        self.loris = {"conns": 0, "disconnected": 0, "frames": 0}
        self.half_open = {"conns": 0, "held": 0}
        self.malformed = {"sent": 0, "answered": 0}

    @property
    def sent_total(self) -> int:
        return sum(self.sent.values())

    @property
    def sheds_total(self) -> int:
        return sum(self.sheds.values())

    @property
    def timeouts_total(self) -> int:
        return sum(self.timeouts.values())

    def record_shed(self, reason: str, elapsed_s: float) -> None:
        self.sheds[reason] = self.sheds.get(reason, 0) + 1
        self.shed_s.append(elapsed_s)

    def summary(self) -> Dict[str, Any]:
        """The storm envelope: what bench prints and the SLO fault
        event records."""
        return {
            "seed": self.seed,
            "duration_s": round(self.duration_s, 3),
            "offered_rps": (
                round(self.sent_total / self.duration_s, 1)
                if self.duration_s
                else 0.0
            ),
            "classes": {
                cls: {
                    "sent": self.sent[cls],
                    "ok": self.ok[cls],
                    "errors": self.errors[cls],
                    "timeouts": self.timeouts[cls],
                }
                for cls in CLASSES
            },
            "sheds": dict(sorted(self.sheds.items())),
            "sheds_total": self.sheds_total,
            "timeouts_total": self.timeouts_total,
            "admitted_warm_p50_ms": _quantile_ms(self.admitted_warm_s, 0.50),
            "admitted_warm_p99_ms": _quantile_ms(self.admitted_warm_s, 0.99),
            "shed_fastfail_p99_ms": _quantile_ms(self.shed_s, 0.99),
            "loris": dict(self.loris),
            "half_open": dict(self.half_open),
            "malformed": dict(self.malformed),
        }


def malformed_resolve_frames(rng: random.Random, count: int) -> List[bytes]:
    """``count`` hostile OP_RESOLVE frames drawn from the hostile-input
    corpus shapes the worker classifies (and answers) as protocol errors:
    short body, qtype overrun, non-UTF-8 name, truncated trace block.
    Every frame keeps a VALID length prefix — the point is to poison
    the request, not the connection."""
    frames: List[bytes] = []
    for i in range(count):
        req_id = 0x7F000000 + i
        shape = rng.randrange(4)
        if shape == 0:
            # resolve body too short (< 2 bytes)
            frames.append(pack_request(req_id, OP_RESOLVE, b"\x00"))
        elif shape == 1:
            # qtype length overruns the body
            frames.append(
                pack_request(req_id, OP_RESOLVE, bytes((0, 200)) + b"A")
            )
        elif shape == 2:
            # name bytes that are not UTF-8
            frames.append(
                pack_request(
                    req_id, OP_RESOLVE, bytes((0, 1)) + b"A" + b"\xff\xfe"
                )
            )
        else:
            # trace flag set, frame too short for the context block
            frames.append(
                struct.pack(">I", _HDR.size + 2)
                + _HDR.pack(req_id, OP_RESOLVE | TRACE_FLAG)
                + b"xx"
            )
    return frames


async def _open_raw(socket_path: str, rcvbuf: Optional[int] = None):
    """A raw (reader, writer) pair on the shard unix socket, optionally
    with a tiny receive buffer (makes a non-reading client back-pressure
    the worker at KB scale, the same trick netem's ChaosProxy plays
    with ``sock_buf``)."""
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        if rcvbuf is not None:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
        sock.setblocking(False)
        await asyncio.get_running_loop().sock_connect(sock, socket_path)
    except BaseException:
        sock.close()
        raise
    return await asyncio.open_unix_connection(sock=sock)


def _hung_up(sock) -> bool:
    """The peer closed the connection, seen without reading: on a unix
    socket its close raises our RDHUP at once, while the EOF itself
    waits behind every reply byte still buffered for us.  A transport
    that already closed the socket (a write to the gone peer failed)
    counts as hung up too."""
    if sock.fileno() < 0:
        return True
    poller = select.poll()
    poller.register(sock.fileno(), select.POLLRDHUP)
    return any(
        events & (select.POLLRDHUP | select.POLLHUP | select.POLLERR)
        for _fd, events in poller.poll(0)
    )


def _unread_requests(writer) -> int:
    """Request bytes the worker has not read yet: the transport's own
    buffer plus the kernel's send queue (``SIOCOUTQ``)."""
    queued = array.array("i", [0])
    fcntl.ioctl(writer.get_extra_info("socket").fileno(), termios.TIOCOUTQ,
                queued)
    return writer.transport.get_write_buffer_size() + queued[0]


async def slow_loris(
    socket_path: str,
    name: str = "loris.storm.slo.us",
    frames: int = 4000,
    hold_s: float = 2.0,
    rcvbuf: Optional[int] = 4096,
) -> Dict[str, Any]:
    """One slow-loris client against a shard socket: flood ``frames``
    pipelined resolves, then read ONE byte per poll (slow enough that
    the worker's reply buffer can only grow).  The armored worker's
    write deadline must disconnect us; an unarmored worker parks its
    handler tasks on ``drain()`` for as long as we care to hold.  We
    hold ``hold_s``, and past it until the worker has read every
    request and had ``LORIS_SETTLE_S`` to answer them (at most
    ``LORIS_GRACE_S`` more); a disconnect ends the hold at once.

    Returns ``{"disconnected": bool, "written": int, "read": int}`` —
    ``disconnected`` is the armor working.
    """
    reader, writer = await _open_raw(socket_path, rcvbuf=rcvbuf)
    written = 0
    read = 0
    disconnected = False
    deadline = time.monotonic() + hold_s
    sock = writer.get_extra_info("socket")
    settled_at = None
    try:
        body = pack_resolve(name, "A")
        chunk = b"".join(
            pack_request(i + 1, OP_RESOLVE, body) for i in range(frames)
        )
        writer.write(chunk)
        written = frames
        while True:
            now = time.monotonic()
            if _hung_up(sock):
                disconnected = True
                break
            if now >= deadline:
                if now >= deadline + LORIS_GRACE_S:
                    break
                if _unread_requests(writer):
                    settled_at = None
                elif settled_at is None:
                    settled_at = now
                elif now - settled_at >= LORIS_SETTLE_S:
                    break
            try:
                # The slow read: one byte per 50 ms keeps us a reader in
                # name only (a buffered byte comes back at once, so the
                # poll sleeps the rest of its 50 ms).  EOF or a reset
                # here IS the disconnect the write-deadline armor
                # promises.
                b = await asyncio.wait_for(reader.read(1), timeout=0.05)
                if not b:
                    disconnected = True
                    break
                read += 1
                await asyncio.sleep(max(0.0, now + 0.05 - time.monotonic()))
            except asyncio.TimeoutError:
                pass
            except (ConnectionError, OSError):
                disconnected = True
                break
        if not disconnected:
            # Verdict phase: on a unix socket the worker's abort()
            # surfaces as a clean EOF **behind** every reply byte
            # already buffered on our side — which the 1-byte/50 ms
            # read above would take minutes to drain.  Drain fast now:
            # reaching EOF means the worker hung up on us (the armor);
            # a still-live stream just runs the short timeout down.
            try:
                while True:
                    b = await asyncio.wait_for(
                        reader.read(65536), timeout=0.4
                    )
                    if not b:
                        disconnected = True
                        break
                    read += len(b)
            except asyncio.TimeoutError:
                pass
            except (ConnectionError, OSError):
                disconnected = True
    finally:
        try:
            writer.close()
        except Exception:  # noqa: BLE001 - hostile-client teardown
            pass
    return {"disconnected": disconnected, "written": written, "read": read}


async def half_open(
    socket_path: str,
    hold_s: float = 1.0,
) -> Dict[str, Any]:
    """One half-open client: a length prefix promising a frame that
    never arrives (netem's ``Truncate`` shape), held for ``hold_s``.
    The worker's read loop must simply wait it out — a half-open
    connection holds no in-flight slot, wedges nothing, and its EOF on
    close is a clean boundary for everyone else."""
    reader, writer = await _open_raw(socket_path)
    try:
        writer.write(struct.pack(">I", _HDR.size + 64))
        writer.write(_HDR.pack(1, OP_RESOLVE))
        await writer.drain()
        await asyncio.sleep(hold_s)
    finally:
        try:
            writer.close()
        except Exception:  # noqa: BLE001 - hostile-client teardown
            pass
    return {"held_s": hold_s}


async def measure_capacity(
    router_socket: str,
    names: Sequence[str],
    seconds: float = 0.4,
    clients: int = 4,
    pipeline: int = 4,
) -> float:
    """Measured warm-resolve capacity (requests/second): closed-loop
    round-robin resolves over ``names`` through the direct data plane.
    The number the "~5x capacity" storm sizing is anchored to."""
    done = 0
    deadline = time.monotonic() + seconds

    async def one_client(idx: int) -> None:
        nonlocal done
        client = await ShardDirectClient(router_socket).connect()
        try:
            i = idx
            while time.monotonic() < deadline:
                batch = [names[(i + k) % len(names)] for k in range(pipeline)]
                i += pipeline
                await asyncio.gather(
                    *(client.resolve(n, "A") for n in batch)
                )
                done += pipeline
        finally:
            await client.close()

    t0 = time.monotonic()
    await asyncio.gather(*(one_client(i) for i in range(clients)))
    elapsed = max(time.monotonic() - t0, 1e-6)
    return done / elapsed


class StormWorkload:
    """One seeded overload storm against a running sharded tier.

    ``warm_names`` must already resolve through the tier (the SLO
    harness hands its slice-probe domains; bench registers its own
    fixture set).  The flash-crowd victim shard is the owner of the
    LARGEST warm group on the same deterministic ring the router built,
    so one seed always storms one slice.

    ``offered_rps`` paces the resolver clients (None = unpaced, every
    client runs flat out); hostile connection counts are per-storm
    totals.  :meth:`run` returns the filled :class:`StormReport`.
    """

    def __init__(
        self,
        router_socket: str,
        warm_names: Sequence[str],
        seed: int,
        duration_s: float = 1.2,
        clients: int = 6,
        pipeline: int = 24,
        request_timeout_s: float = 2.0,
        offered_rps: Optional[float] = None,
        zipf_s: float = 1.2,
        churn_suffix: str = "churn.storm.slo.us",
        burst_every_s: float = 0.4,
        burst_s: float = 0.15,
        loris_conns: int = 2,
        loris_frames: int = 3000,
        half_open_conns: int = 1,
        malformed_frames: int = 24,
    ):
        if not warm_names:
            raise ValueError("a storm needs at least one warm name")
        self.router_socket = router_socket
        self.warm_names = list(warm_names)
        self.seed = int(seed)
        self.duration_s = duration_s
        self.clients = clients
        self.pipeline = pipeline
        self.request_timeout_s = request_timeout_s
        self.offered_rps = offered_rps
        self.zipf_s = zipf_s
        self.churn_suffix = churn_suffix
        self.burst_every_s = burst_every_s
        self.burst_s = burst_s
        self.loris_conns = loris_conns
        self.loris_frames = loris_frames
        self.half_open_conns = half_open_conns
        self.malformed_frames = malformed_frames
        self.report = StormReport(self.seed)
        self._churn_serial = 0
        self._deadline = 0.0
        self._t0 = 0.0

    # -- target selection ---------------------------------------------------

    async def _ring_info(self) -> Tuple[HashRing, Dict[int, str]]:
        async with ShardClient(self.router_socket) as rc:
            info = await rc.ring()
        sockets = {
            entry["shard"]: entry["socket"] for entry in info["shards"]
        }
        ring = HashRing(
            sockets.keys(), vnodes=info.get("vnodes", DEFAULT_VNODES)
        )
        return ring, sockets

    def _pick_victim(self, ring: HashRing) -> Tuple[int, List[str]]:
        """The flash-crowd victim: the shard owning the most warm names
        (ties break low, like the ring itself — deterministic)."""
        groups: Dict[int, List[str]] = {}
        for name in self.warm_names:
            groups.setdefault(
                ring.owner(name.rstrip(".").lower()), []
            ).append(name)
        victim = max(
            groups, key=lambda sid: (len(groups[sid]), -sid)
        )
        return victim, groups[victim]

    # -- the resolver storm --------------------------------------------------

    def _draw(
        self,
        rng: random.Random,
        warm: _ZipfPicker,
        flash: _ZipfPicker,
    ) -> Tuple[str, str]:
        """One (class, name) draw from the phase-dependent mixture."""
        elapsed = time.monotonic() - self._t0
        in_burst = (elapsed % self.burst_every_s) < self.burst_s
        r = rng.random()
        if in_burst:
            # Flash crowd: the victim slice takes the brunt.
            if r < 0.70:
                return "flash", flash.pick(rng)
            if r < 0.82:
                return "warm", warm.pick(rng)
        else:
            if r < 0.45:
                return "warm", warm.pick(rng)
            if r < 0.60:
                return "flash", flash.pick(rng)
        # Never-exists churn: every draw is a FRESH name, so every one
        # is a distinct negative-cache fill.
        self._churn_serial += 1
        return "churn", f"n{self._churn_serial}.{self.churn_suffix}"

    async def _one(self, client: ShardDirectClient, cls: str, name: str) -> None:
        rep = self.report
        rep.sent[cls] += 1
        t0 = time.monotonic()
        try:
            await asyncio.wait_for(
                client.resolve(name, "A"), self.request_timeout_s
            )
        except ShardShedError as err:
            rep.record_shed(err.reason, time.monotonic() - t0)
        except asyncio.TimeoutError:
            rep.timeouts[cls] += 1
        except (ShardError, ConnectionError, OSError):
            # Includes nonexistent-name errors on the churn class and
            # dead-worker connections in an unrepaired fleet: counted,
            # never fatal to the storm.
            rep.errors[cls] += 1
        else:
            rep.ok[cls] += 1
            if cls in ("warm", "flash"):
                rep.admitted_warm_s.append(time.monotonic() - t0)

    async def _resolver(
        self, idx: int, warm: _ZipfPicker, flash: _ZipfPicker
    ) -> None:
        rng = random.Random((self.seed * 1000003) ^ idx)
        try:
            client = await ShardDirectClient(self.router_socket).connect()
        except (ShardError, ConnectionError, OSError):
            self.report.errors["warm"] += 1
            return
        # Paced batches when offered_rps is set: each of C clients owes
        # offered/C requests per second, issued pipeline-at-a-time.
        batch_interval = (
            self.pipeline * self.clients / self.offered_rps
            if self.offered_rps
            else 0.0
        )
        try:
            while time.monotonic() < self._deadline:
                batch_t0 = time.monotonic()
                batch = [
                    self._draw(rng, warm, flash)
                    for _ in range(self.pipeline)
                ]
                await asyncio.gather(
                    *(self._one(client, cls, name) for cls, name in batch)
                )
                if batch_interval:
                    pause = batch_interval - (time.monotonic() - batch_t0)
                    if pause > 0:
                        await asyncio.sleep(
                            min(pause, self._deadline - time.monotonic())
                        )
        finally:
            await client.close()

    # -- the hostile connections --------------------------------------------

    async def _loris(self, victim_socket: str, idx: int) -> None:
        self.report.loris["conns"] += 1
        hold = max(self.duration_s - 0.1, 0.2)
        try:
            out = await slow_loris(
                victim_socket,
                name=self.warm_names[idx % len(self.warm_names)],
                frames=self.loris_frames,
                hold_s=hold,
            )
        except (ConnectionError, OSError):
            self.report.loris["disconnected"] += 1
            return
        self.report.loris["frames"] += out["written"]
        if out["disconnected"]:
            self.report.loris["disconnected"] += 1

    async def _half_open(self, victim_socket: str) -> None:
        self.report.half_open["conns"] += 1
        try:
            await half_open(
                victim_socket, hold_s=max(self.duration_s - 0.1, 0.2)
            )
            self.report.half_open["held"] += 1
        except (ConnectionError, OSError):
            pass

    async def _malformed(self, victim_socket: str) -> None:
        rng = random.Random(self.seed ^ 0x6D616C66)
        frames = malformed_resolve_frames(rng, self.malformed_frames)
        self.report.malformed["sent"] = len(frames)
        try:
            reader, writer = await _open_raw(victim_socket)
        except (ConnectionError, OSError):
            return
        try:
            writer.write(b"".join(frames))
            await writer.drain()
            answered = 0
            deadline = time.monotonic() + min(self.duration_s, 1.0)
            while answered < len(frames) and time.monotonic() < deadline:
                try:
                    head = await asyncio.wait_for(
                        reader.readexactly(4), timeout=0.2
                    )
                    (size,) = struct.unpack(">I", head)
                    await asyncio.wait_for(
                        reader.readexactly(size), timeout=0.2
                    )
                    answered += 1
                except (
                    asyncio.TimeoutError,
                    asyncio.IncompleteReadError,
                    ConnectionError,
                    OSError,
                ):
                    break
            self.report.malformed["answered"] = answered
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - hostile-client teardown
                pass

    # -- run ----------------------------------------------------------------

    async def run(self) -> StormReport:
        ring, sockets = await self._ring_info()
        victim, victim_names = self._pick_victim(ring)
        victim_socket = sockets[victim]
        warm = _ZipfPicker(self.warm_names, self.zipf_s)
        flash = _ZipfPicker(victim_names, self.zipf_s)
        self._t0 = time.monotonic()
        self._deadline = self._t0 + self.duration_s
        tasks = [
            self._resolver(i, warm, flash) for i in range(self.clients)
        ]
        tasks += [
            self._loris(victim_socket, i) for i in range(self.loris_conns)
        ]
        tasks += [
            self._half_open(victim_socket)
            for _ in range(self.half_open_conns)
        ]
        if self.malformed_frames:
            tasks.append(self._malformed(victim_socket))
        await asyncio.gather(*tasks)
        self.report.duration_s = time.monotonic() - self._t0
        return self.report
