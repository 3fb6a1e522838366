"""The port's DNS frontend and shard tier bind their DNS port without a race.

A DNS port of 0 means "a free port" (docs/CONFIG.md, ``serve.dns.port``).
A UDP pick on port 0 is free for UDP only: its number can already be held
on TCP, for example as an outgoing connection's local port, and then the
TCP listener on it fails with EADDRINUSE.  The port's
``DnsFront.start`` and ``allocate_port`` pick a number that is free on
both protocols and pick again when it is not; a front that fails to start
leaves no socket bound; and a ``ShardRouter`` that allocated its DNS port
holds a bound, never-listening TCP socket on it until it stops, so that
no outgoing connection takes the port before a worker binds it or while
a killed worker is respawned.

The first pick is held deterministically by wrapping ``socket.bind``: the
first UDP bind on port 0 once the test arms it binds a TCP socket on the
number it got.  An outgoing connection is confined to a few ports with the socket's
own ``IP_LOCAL_PORT_RANGE`` (Linux 6.3 and later).  Every socket binds
127.0.0.1 only.

Run as a script, the file measures instead of testing, on the
``registrar_tpu_torch`` that ``PYTHONPATH`` puts first (so a checkout of
another commit can be measured the same way)::

    python3 tests/test_torch_dnsfront_bind.py [CONNECTIONS STARTS REUSEPORT_BINDS]

It holds CONNECTIONS outgoing TCP connections (default 4 000), runs
``DnsFront(port=0).start()`` STARTS times (default 400) and counts the
starts that raised EADDRINUSE, the UDP sockets they left bound and the
picks made again; then
it binds REUSEPORT_BINDS UDP sockets (default 19 900) on port 0 with
``SO_REUSEPORT`` and counts the distinct ports they got.  One JSON line.
"""

import asyncio
import errno
import json
import logging
import os
import signal
import socket
import resource
import struct
import sys
import time

import pytest

from registrar_tpu.testing.server import ZKServer
from registrar_tpu_torch import dnsfront
from registrar_tpu_torch import shard as port_shard
from registrar_tpu_torch.binderview import Answer, Resolution
from test_torch_serve import _register_fleet

HOST = "127.0.0.1"
#: <linux/in.h>: a socket's own ephemeral range, ``high << 16 | low``
IP_LOCAL_PORT_RANGE = 51
#: a load balancer of the fleet of ``tests/test_torch_serve.py``, and the
#: addresses of its instances
FLEET_NAME = "web.cross.example.us"
FLEET_A = {f"10.77.0.{i}" for i in range(3)}


async def stub_resolver(lname, _qtype):
    return Resolution([Answer(lname, "A", 30, "192.0.2.1")])


def binds(port: int, kind: int) -> bool:
    """Whether a plain bind (no ``SO_REUSEPORT``) on ``port`` succeeds."""
    with socket.socket(socket.AF_INET, kind) as sock:
        try:
            sock.bind((HOST, port))
        except OSError as err:
            assert err.errno == errno.EADDRINUSE, err
            return False
    return True


async def a_records(port: int, *, tcp: bool, name: str = FLEET_NAME) -> list:
    query = dnsfront.build_query(7, name, dnsfront.QTYPE_A)
    send = dnsfront.query_tcp if tcp else dnsfront.query_udp
    resp = dnsfront.decode_response(await send(HOST, port, query))
    return sorted(rr[3] for rr in resp.answers)


class FirstPick:
    """Wraps ``socket.bind`` once armed: the first UDP bind on port 0
    after :meth:`arm` either keeps its TCP side taken, as an outgoing
    connection's local port would (``number`` is the port it got), or,
    given ``onto``, lands on that port instead of the kernel's pick."""

    def __init__(self) -> None:
        self.real_bind = socket.socket.bind
        self.armed = False
        self.onto = None
        self.number = None
        self.tcp = None

    def arm(self, onto=None) -> None:
        self.armed, self.onto = True, onto

    def bind(self, sock, address) -> None:
        first = (self.armed and sock.type == socket.SOCK_DGRAM
                 and address[1] == 0)
        if first:
            self.armed = False
            if self.onto is not None:
                address = (address[0], self.onto)
        self.real_bind(sock, address)
        if first:
            self.number = sock.getsockname()[1]
            if self.onto is None:
                self.tcp = hold_tcp(self.number, self.real_bind)

    def close(self) -> None:
        if self.tcp is not None:
            self.tcp.close()


def hold_tcp(port: int, bind=socket.socket.bind):
    """A plain TCP socket bound on ``port``, or None where another socket
    holds the port's TCP side already: it is taken either way."""
    tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        bind(tcp, (HOST, port))
    except OSError as err:
        tcp.close()
        assert err.errno == errno.EADDRINUSE, err
        return None
    return tcp


@pytest.fixture
def first_pick(monkeypatch):
    pick = FirstPick()
    monkeypatch.setattr(socket.socket, "bind",
                        lambda sock, address: pick.bind(sock, address))
    yield pick
    monkeypatch.undo()
    pick.close()


# --- (a) a port-0 front picks again ------------------------------------------


async def test_port_zero_front_picks_again_when_tcp_side_is_held(first_pick):
    front = dnsfront.DnsFront(stub_resolver, host=HOST, port=0)
    first_pick.arm()
    try:
        host, port = await front.start()
        first = first_pick.number
        assert first and (host, port) == (HOST, front.port)
        assert port not in (0, first)
        # no UDP socket stays bound on the first number
        assert binds(first, socket.SOCK_DGRAM)
        assert await a_records(port, tcp=False, name="x.example.us") == [
            "192.0.2.1"]
        assert await a_records(port, tcp=True, name="x.example.us") == [
            "192.0.2.1"]
    finally:
        await front.close()
    assert binds(port, socket.SOCK_DGRAM) and binds(port, socket.SOCK_STREAM)


async def test_port_zero_front_never_joins_a_reserved_port(first_pick):
    """A UDP pick on a port whose TCP side another reuseport socket of
    the same user holds (a tier's reservation) is picked again: the
    front does not join that socket."""
    reservation = dnsfront.reserve_port(HOST)
    reserved = reservation.getsockname()[1]
    front = dnsfront.DnsFront(stub_resolver, host=HOST, port=0)
    first_pick.arm(onto=reserved)
    try:
        _host, port = await front.start()
        assert first_pick.number == reserved and port != reserved
        assert binds(reserved, socket.SOCK_DGRAM)
    finally:
        await front.close()
        reservation.close()


# --- (b) a fixed port raises and leaves nothing bound --------------------------


def held_tcp_port() -> socket.socket:
    """A plain TCP socket bound on a port whose UDP side is free."""
    for _ in range(32):
        tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        tcp.bind((HOST, 0))
        if binds(tcp.getsockname()[1], socket.SOCK_DGRAM):
            return tcp
        tcp.close()
    raise AssertionError("no TCP port with a free UDP side")


async def test_fixed_port_held_on_tcp_raises_and_frees_udp():
    with held_tcp_port() as tcp:
        port = tcp.getsockname()[1]
        front = dnsfront.DnsFront(stub_resolver, host=HOST, port=port)
        with pytest.raises(OSError) as err:
            await front.start()
        assert err.value.errno == errno.EADDRINUSE
        assert front.port == port
        # the failed start left the UDP side free
        assert binds(port, socket.SOCK_DGRAM)
        await front.close()


# --- (c) allocate_port ---------------------------------------------------------


def test_allocate_port_is_free_on_both_protocols(first_pick):
    first_pick.arm()
    port = dnsfront.allocate_port(HOST)
    assert first_pick.number and port != first_pick.number
    assert binds(port, socket.SOCK_STREAM)
    assert binds(port, socket.SOCK_DGRAM)


def test_allocate_port_raises_after_its_last_try(monkeypatch):
    """Every pick held on TCP: the last EADDRINUSE is raised, after
    ``PORT_PICK_TRIES`` picks."""
    real_bind = socket.socket.bind
    picks, held = [], []

    def bind(sock, address):
        real_bind(sock, address)
        if sock.type == socket.SOCK_DGRAM and address[1] == 0:
            picks.append(sock.getsockname()[1])
            held.append(hold_tcp(picks[-1], real_bind))

    monkeypatch.setattr(socket.socket, "bind", bind)
    try:
        with pytest.raises(OSError) as err:
            dnsfront.allocate_port(HOST)
    finally:
        monkeypatch.undo()
        for sock in held:
            if sock is not None:
                sock.close()
    assert err.value.errno == errno.EADDRINUSE
    assert len(picks) == dnsfront.PORT_PICK_TRIES


# --- the router's reservation --------------------------------------------------


def confined_connect(target: int, low: int, high: int):
    """A TCP connection to ``target`` whose local port the kernel picks
    from ``low..high`` only: the socket, or the OSError of the connect."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.IPPROTO_IP, IP_LOCAL_PORT_RANGE,
                    struct.pack("I", high << 16 | low))
    try:
        sock.connect((HOST, target))
    except OSError as err:
        sock.close()
        return err
    return sock


def close_now(sock: socket.socket) -> None:
    """Close with a reset: no TIME_WAIT keeps the port from the tests
    that run beside this one."""
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0))
    sock.close()


def connect_block(target: int, low: int, high: int) -> list:
    """Every connection to ``target`` the kernel will make from local
    ports ``low..high``, held open."""
    block = []
    while True:
        got = confined_connect(target, low, high)
        if isinstance(got, OSError):
            assert got.errno == errno.EADDRNOTAVAIL, got
            return block
        block.append(got)


def test_router_reservation_keeps_outgoing_connections_off_its_port(tmp_path):
    with socket.socket() as listener:
        listener.bind((HOST, 0))
        listener.listen(16)
        target = listener.getsockname()[1]
        router = port_shard.ShardRouter(
            [(HOST, 1)], 1, str(tmp_path / "r.sock"),
            dns={"host": HOST, "port": 0})
        port = router.dns["port"]
        assert router._spec(0, 1, "s")["dns"] == {"host": HOST, "port": port}
        got = confined_connect(target, port, port)
        assert isinstance(got, OSError) and got.errno == errno.EADDRNOTAVAIL
        assert not binds(port, socket.SOCK_STREAM)
        assert binds(port, socket.SOCK_DGRAM)
        # a worker's reuseport listener joins the reservation and takes
        # the connection; the reservation itself takes none
        with socket.socket() as worker:
            worker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            worker.bind((HOST, port))
            worker.listen(16)
            worker.settimeout(5)
            conn = socket.create_connection((HOST, port), timeout=5)
            accepted, _peer = worker.accept()
            # reset by the client: no TIME_WAIT holds the DNS port after
            close_now(conn)
            accepted.close()
        asyncio.run(router.stop())
        got = confined_connect(target, port, port)
        assert not isinstance(got, OSError), got
        try:
            assert got.getsockname()[1] == port
        finally:
            close_now(got)
            listener.accept()[0].close()


# --- (d) a 2-shard tier on port 0, a worker killed and respawned ---------------


async def wait_for(predicate, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.05)


async def test_port_zero_tier_answers_through_a_respawn(tmp_path):
    server = await ZKServer().start()
    clients = await _register_fleet(server)
    router = None
    listener = socket.socket()
    block = []
    try:
        router = await port_shard.ShardRouter(
            [server.address], 2, str(tmp_path / "t.sock"),
            attach_spread="any", dns={"host": HOST, "port": 0},
        ).start()
        port = router.dns["port"]
        assert port and (await router.status())["serve"]["dns"]["port"] == port
        expected = await a_records(port, tcp=False)
        assert set(expected) == FLEET_A
        assert await a_records(port, tcp=True) == expected

        listener.bind((HOST, 0))
        listener.listen(256)
        low, high = max(1024, port - 32), min(65535, port + 32)
        victim = router._workers[0]
        dead = victim.proc
        router.kill_worker(0)
        # outgoing connections take every port around the DNS port
        # while the worker is down; none of them takes it
        block = await asyncio.to_thread(
            connect_block, listener.getsockname()[1], low, high)
        assert block and port not in {s.getsockname()[1] for s in block}
        await asyncio.to_thread(dead.wait, 10)
        assert dead.returncode == -signal.SIGKILL
        await wait_for(lambda: victim.respawns == 1 and victim.up
                       and victim.proc is not dead, "the respawn")
        assert router.shards_down() == []
        # every answer, over both protocols, comes from a live worker
        for _ in range(8):
            for tcp in (False, True):
                assert await a_records(port, tcp=tcp) == expected
        assert os.path.exists(f"/proc/{victim.proc.pid}")
    finally:
        for sock in block:
            close_now(sock)
        listener.close()
        if router is not None:
            await router.stop()
        for cl in clients:
            await cl.close()
        await server.stop()
    assert binds(port, socket.SOCK_STREAM) and binds(port, socket.SOCK_DGRAM)


# --- the measurement (run as a script) -----------------------------------------


async def measure_starts(connections: int, starts: int) -> dict:
    with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
        low, high = map(int, fh.read().split())
    with socket.socket() as listener:
        listener.bind((HOST, 0))
        listener.listen(4096)
        listener.setblocking(False)
        held = []
        try:
            for _ in range(connections):
                held.append(socket.create_connection(
                    listener.getsockname()))
                while True:
                    try:
                        held.append(listener.accept()[0])
                    except BlockingIOError:
                        break
            failed = left_bound = 0
            for _ in range(starts):
                front = dnsfront.DnsFront(stub_resolver, host=HOST, port=0)
                try:
                    await front.start()
                except OSError as err:
                    assert err.errno == errno.EADDRINUSE, err
                    failed += 1
                    # a start that fails leaves nothing bound, or this
                    udp = front._udp_transport
                    if udp is not None:
                        port = udp.get_extra_info("sockname")[1]
                        left_bound += not binds(port, socket.SOCK_DGRAM)
                await front.close()
        finally:
            for sock in held:
                sock.close()
    return {"held_connections": connections,
            "ephemeral_ports": high - low + 1,
            "held_share": connections / (high - low + 1),
            "starts": starts, "eaddrinuse": failed,
            "udp_left_bound": left_bound}


def measure_reuseport_picks(n: int) -> dict:
    socks = []
    try:
        for _ in range(n):
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            socks.append(sock)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            sock.bind((HOST, 0))
        ports = {sock.getsockname()[1] for sock in socks}
    finally:
        for sock in socks:
            sock.close()
    return {"reuseport_udp_binds": n, "distinct_ports": len(ports)}


class _Retries(logging.Handler):
    """Counts the front's "picking another" warnings, one per pick made
    again."""

    def __init__(self) -> None:
        super().__init__()
        self.n = 0

    def emit(self, record) -> None:
        self.n += "picking another" in record.getMessage()


def main(argv) -> None:
    connections, starts, reuseport = (
        [int(a) for a in argv] + [4000, 400, 19900][len(argv):])
    _soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    retries = _Retries()
    front_log = logging.getLogger("registrar_tpu_torch.dnsfront")
    front_log.addHandler(retries)
    front_log.propagate = False
    out = {"dnsfront": dnsfront.__file__,
           **asyncio.run(measure_starts(connections, starts)),
           "picks_retried": retries.n,
           **measure_reuseport_picks(min(reuseport, hard - 100))}
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
