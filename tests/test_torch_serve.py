"""The port's serve tier held against the reference's own tests and peers.

* Every test body of the reference's tests for ``binderview``,
  ``zkcache``, ``dnsfront`` (the 24 byte-exact vectors of
  ``tests/test_dns_golden.py``), ``shard``, the overload armor, the quota
  codec and the shard goldens of ``tests/test_malformed.py`` runs against
  the port, rebound as in ``tests/test_torch_daemon.py``.  The test
  server and ``registrar_tpu.testing.workload`` stay the reference's, so
  the storm bodies drive the port's tier with the reference's shard
  client.  No body is left out.
* Cross-package checks on the same inputs: ``HashRing`` ownership, the
  shard frame bytes read both ways, a client of each package against a
  tier of the other.
* A port ``ShardRouter`` spawns port workers only, read from the
  children's command lines.
"""

import os
import sys

import pytest

from registrar_tpu import binderview as ref_binderview
from registrar_tpu import shard as ref_shard
from registrar_tpu.testing.server import ZKServer
from registrar_tpu.zk.client import ZKClient
from registrar_tpu_torch import binderview as port_binderview
from registrar_tpu_torch import shard as port_shard
from tests.test_torch_daemon import bindings
from tests.test_torch_wire import body_cases, load_test_module, run_body

#: reference test file -> the test classes run (None: every body)
FILES = {
    "test_binderview.py": None,
    "test_zkcache.py": None,
    "test_dns_golden.py": None,
    "test_shard.py": None,
    "test_overload.py": None,
    "test_quota.py": None,
    "test_malformed.py": {"TestShardGoldens"},
}

CASES = [c for f, only in FILES.items() for c in body_cases(f, only=only)]


@pytest.mark.parametrize("filename", sorted(FILES))
def test_rebound_file_reaches_the_port(filename):
    mod = load_test_module(filename, port=True)
    assert bindings(mod, "registrar_tpu") == []
    assert bindings(mod, "registrar_tpu_torch") != []


def test_every_file_contributes_bodies():
    assert {c.values[0] for c in CASES} == set(FILES)
    assert len(CASES) > 120


@pytest.mark.parametrize("filename,qualname,case", CASES)
def test_reference_body_passes_against_the_port(
    filename, qualname, case, monkeypatch, tmp_path, capsys
):
    fixtures = {"monkeypatch": monkeypatch, "tmp_path": tmp_path,
                "capsys": capsys}
    run_body(load_test_module(filename, port=True), qualname, fixtures, case)


# --- the ring and the frames, both packages on the same inputs --------------

RING_DOMAINS = [f"svc{i}.ring.example.us" for i in range(256)]


@pytest.mark.parametrize("n", range(1, 9))
def test_hash_ring_owners_agree(n):
    """During an upgrade a router of one package and workers of the
    other must agree on every owner."""
    ref, port = ref_shard.HashRing(range(n)), port_shard.HashRing(range(n))
    owners = [port.owner(d) for d in RING_DOMAINS]
    assert owners == [ref.owner(d) for d in RING_DOMAINS]
    assert set(owners) == set(range(n))


RESOLVE_REQUESTS = [
    ("web.parity.joyent.us", "A", False),
    ("_http._tcp.web.parity.joyent.us", "SRV", True),
    ("MyDomain.Example.US", "TXT", False),
    ("bücher.example.us", "A", True),
    ("", "A", False),
]


@pytest.mark.parametrize("name,qtype,live", RESOLVE_REQUESTS)
def test_request_frames_are_identical(name, qtype, live):
    body = port_shard.pack_resolve(name, qtype, live)
    assert body == ref_shard.pack_resolve(name, qtype, live)
    assert port_shard.resolve_name(body) == ref_shard.resolve_name(body) == name
    ctx = (0x0123456789ABCDEF, 0xFEDCBA9876543210, 1)
    for trace_ctx in (None, ctx):
        frame = port_shard.pack_request(7, port_shard.OP_RESOLVE, body, trace_ctx)
        assert frame == ref_shard.pack_request(
            7, ref_shard.OP_RESOLVE, body, trace_ctx
        )


def _resolutions(binderview):
    A = binderview.Answer
    return [
        binderview.Resolution(),
        binderview.Resolution(answers=[
            A("web.parity.joyent.us", "A", 30, "10.77.0.0"),
            A("web.parity.joyent.us", "A", 30, "10.77.0.1"),
        ]),
        binderview.Resolution(
            answers=[A("_http._tcp.web.parity.joyent.us", "SRV", 60,
                       "0 10 80 i0.web.parity.joyent.us")],
            additionals=[A("i0.web.parity.joyent.us", "A", 30, "10.77.0.0")],
        ),
        binderview.Resolution(answers=[
            A("bücher.example.us", "TXT", 300, "registrar-type=host"),
        ]),
    ]


def _rows(res):
    return ([tuple(vars(a).values()) for a in res.answers],
            [tuple(vars(a).values()) for a in res.additionals])


@pytest.mark.parametrize("i", range(4))
def test_resolution_frames_are_identical_and_read_both_ways(i):
    ref_res = _resolutions(ref_binderview)[i]
    port_res = _resolutions(port_binderview)[i]
    ref_bytes = ref_shard.encode_resolution(ref_res)
    port_bytes = port_shard.encode_resolution(port_res)
    assert port_bytes == ref_bytes
    from_ref = port_shard.decode_resolution(ref_bytes)
    from_port = ref_shard.decode_resolution(port_bytes)
    assert isinstance(from_ref, port_binderview.Resolution)
    assert isinstance(from_port, ref_binderview.Resolution)
    assert _rows(from_ref) == _rows(from_port) == _rows(ref_res)
    # and the frame that carries them
    frame = port_shard.pack_frame(9, port_shard.STATUS_OK, port_bytes)
    assert frame == ref_shard.pack_frame(9, ref_shard.STATUS_OK, ref_bytes)


# --- live tiers: each package's client against the other's tier ------------


SERVICE = {"type": "service",
           "service": {"srvce": "_http", "proto": "_tcp", "port": 80}}
#: (registration, address format, instances): a service of each type
#: usable behind a service, and host types queried directly
FLEET = [
    ({"domain": "web.cross.example.us", "type": "load_balancer",
      "aliases": ["alias.web.cross.example.us"], "service": SERVICE},
     "10.77.0.%d", 3),
    ({"domain": "moray.cross.example.us", "type": "moray_host",
      "ports": [2020, 2021], "service": SERVICE}, "10.78.0.%d", 2),
    ({"domain": "ops.cross.example.us", "type": "ops_host",
      "service": SERVICE}, "10.79.0.%d", 2),
    ({"domain": "lonely.cross.example.us", "type": "db_host"},
     "10.80.0.%d", 1),
]
QUERIES = [
    ("web.cross.example.us", "A"),
    ("_http._tcp.web.cross.example.us", "SRV"),
    ("alias.web.cross.example.us", "A"),
    ("moray.cross.example.us", "A"),
    ("_http._tcp.moray.cross.example.us", "SRV"),
    ("ops.cross.example.us", "A"),
    ("i0.ops.cross.example.us", "A"),
    ("i0.lonely.cross.example.us", "A"),
    ("i0.lonely.cross.example.us", "TXT"),
    ("absent.cross.example.us", "A"),
]
#: the queries of QUERIES that answer nothing: ops_host is usable only
#: behind a service, and the last name is not registered
EMPTY = {("i0.ops.cross.example.us", "A"), ("absent.cross.example.us", "A")}


async def _register_fleet(server) -> list:
    from registrar_tpu.registration import register

    clients = []
    for reg, ip_fmt, instances in FLEET:
        cl = await ZKClient([server.address]).connect()
        clients.append(cl)
        for i in range(instances):
            await register(cl, reg, admin_ip=ip_fmt % i, hostname=f"i{i}",
                           settle_delay=0)
    return clients


async def _answers(client_mod, socket_path) -> list:
    out = []
    async with client_mod.ShardClient(socket_path) as sc:
        for name, qtype in QUERIES:
            for live in (False, True):
                out.append(_rows(await sc.resolve(name, qtype, live=live)))
    return out


async def test_each_client_reads_the_other_packages_tier(tmp_path):
    server = await ZKServer().start()
    clients = await _register_fleet(server)
    routers = []
    try:
        for mod in (ref_shard, port_shard):
            routers.append(await mod.ShardRouter(
                [server.address], 2, str(tmp_path / f"{mod.__name__}.sock"),
                attach_spread="any",
            ).start())
        ref_tier, port_tier = routers
        ref_on_port = await _answers(ref_shard, port_tier.socket_path)
        port_on_ref = await _answers(port_shard, ref_tier.socket_path)
        assert ref_on_port == port_on_ref
        live = [
            _rows(await ref_binderview.resolve(clients[0], name, qtype))
            for name, qtype in QUERIES
        ]
        assert ref_on_port == [r for r in live for _ in (0, 1)]
        assert {q for q, (a, _) in zip(QUERIES, live) if not a} == EMPTY
    finally:
        for router in routers:
            await router.stop()
        for cl in clients:
            await cl.close()
        await server.stop()


# --- a port tier spawns port workers ----------------------------------------


def _cmdline(pid: int) -> list:
    with open(f"/proc/{pid}/cmdline", "rb") as fh:
        return [a.decode() for a in fh.read().split(b"\0") if a]


def _children(pid: int) -> list:
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(entry))
    return out


async def test_port_router_spawns_port_workers(tmp_path):
    server = await ZKServer().start()
    router = None
    try:
        router = await port_shard.ShardRouter(
            [server.address], 2, str(tmp_path / "spawn.sock"),
            attach_spread="any",
        ).start()
        workers = sorted(h.proc.pid for h in router._workers.values())
        assert len(workers) == 2
        assert sorted(_children(os.getpid())) == workers
        for pid in workers:
            argv = _cmdline(pid)
            assert argv[0] == sys.executable
            assert argv[1:3] == ["-m", "registrar_tpu_torch.shard"], argv
            with open(f"/proc/{pid}/maps") as fh:
                maps = fh.read()
            assert "libtorch" not in maps and "jaxlib" not in maps
    finally:
        if router is not None:
            await router.stop()
        await server.stop()
