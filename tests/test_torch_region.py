"""The region path of ``chip_smoke.py`` held against the reference.

* The plan at full size: 64 domains, 10 000 instances by a seeded Zipf
  split, the answer-size rules behind TC.
* The plan at 8 domains and 1 000 instances (one domain over 370, its
  SRV answer past one TCP message; three between 73 and 370, their A
  answers past one datagram) registered through each package, the
  smoke's way, against the reference's ``ZKServer``: the trees are
  equal.
* A 2-shard tier of each package over that tree: every unix-socket
  answer equal, cached and live; the UDP and TCP replies equal byte for
  byte after the id, TC where an answer outgrows its transport; the
  port's client codec reads the whole TCP answer of a domain past 256
  instances, which the reference's refuses.
* A 2 000-query storm through the smoke's TC-following client against
  the port's tier.
* The two repairs the region needed, in each package: a DNS answer
  built from a cache entry that was evicted past ``maxEntries`` (its
  watch forgotten) is dropped with it, and one resolved while its
  domain was invalidated is not kept.  The reference keeps both, stale.
"""

import asyncio
import random
import socket

import pytest

pytest.importorskip("numpy")
pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from registrar_tpu import binderview as ref_binderview  # noqa: E402
from registrar_tpu import dnsfront as ref_dnsfront  # noqa: E402
from registrar_tpu import events as ref_events  # noqa: E402
from registrar_tpu import registration as ref_registration  # noqa: E402
from registrar_tpu import shard as ref_shard  # noqa: E402
from registrar_tpu import zkcache as ref_zkcache  # noqa: E402
from registrar_tpu.testing.server import ZKServer  # noqa: E402
from registrar_tpu.zk.client import ZKClient as RefClient  # noqa: E402
from registrar_tpu_torch import binderview as port_binderview  # noqa: E402
from registrar_tpu_torch import dnsfront as port_dnsfront  # noqa: E402
from registrar_tpu_torch import events as port_events  # noqa: E402
from registrar_tpu_torch import registration as port_registration  # noqa: E402
from registrar_tpu_torch import shard as port_shard  # noqa: E402
from registrar_tpu_torch import zkcache as port_zkcache  # noqa: E402
from registrar_tpu_torch.zk.client import ZKClient as PortClient  # noqa: E402

#: the small depth: 8 domains over a 2-shard ring.  At s = 1.1 eight
#: domains put one over 370 only from 957 instances on.
DOMAINS, INSTANCES, SHARDS = 8, 1000, 2
STORM_QUERIES = 2000
PACKAGES = {
    "reference": (RefClient, ref_registration.register),
    "port": (PortClient, port_registration.register),
}
#: each package's serve-side modules: (client, cache, resolver, front)
SERVE = {
    "reference": (RefClient, ref_zkcache, ref_binderview, ref_dnsfront),
    "port": (PortClient, port_zkcache, port_binderview, port_dnsfront),
}


def small_plan() -> dict:
    return chip_smoke.region_plan(DOMAINS, INSTANCES, (SHARDS,))


def dns_port() -> int:
    """A port under the kernel's ephemeral range, free for a TCP listener
    and a UDP socket.  A port-0 pick is free for UDP only: the TCP
    listener on it can meet an outgoing connection's port."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
        low = int(fh.read().split()[0])
    for _ in range(100):
        port = random.randrange(max(1024, low - 10000), low)
        with socket.socket() as tcp, \
                socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as udp:
            try:
                tcp.bind(("127.0.0.1", port))
                udp.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no port free for DNS")


# --- the plan -----------------------------------------------------------------


def test_region_plan_at_full_size():
    hosts = chip_smoke.region_plan()
    assert hosts == chip_smoke.region_plan()  # seeded
    sizes = [len(h) for h in hosts.values()]
    assert len(hosts) == chip_smoke.REGION_DOMAINS == 64
    assert sum(sizes) == chip_smoke.REGION_INSTANCES == 10_000
    assert all(5 <= n <= 1000 for n in sizes)
    assert sum(n > 73 for n in sizes) >= 16
    assert sum(n > 370 for n in sizes) >= 1
    ring = port_shard.HashRing(range(chip_smoke.SHARDS))
    assert {ring.owner(d) for d in hosts} == set(range(chip_smoke.SHARDS))
    assert all(d.endswith("." + chip_smoke.REGION_SUFFIX) for d in hosts)
    addresses = [a for h in hosts.values() for a in h.values()]
    assert len(set(addresses)) == len(addresses)
    assert all(0 <= int(o) < 256 for a in addresses for o in a.split("."))
    # the answer-size rules: an A answer outgrows 1232 bytes past 73
    # instances, an SRV answer a TCP message past about 370
    assert [chip_smoke.a_answer_bytes(d, len(h)) > chip_smoke.UDP_PAYLOAD_MAX
            for d, h in hosts.items()] == [n > 73 for n in sizes]
    big = [d for d, h in hosts.items()
           if chip_smoke.srv_answer_bytes(d, h) > chip_smoke.TCP_MSG_MAX]
    assert big and all(len(hosts[d]) > 370 for d in big)


@pytest.mark.parametrize("domains,instances", [(64, 10_000), (8, 1000), (8, 957), (3, 15)])
def test_zipf_split_sums_and_bounds(domains, instances):
    sizes = chip_smoke.zipf_split(domains, instances)
    assert sum(sizes) == instances and len(sizes) == domains
    assert all(5 <= n <= 1000 for n in sizes)
    assert sizes == sorted(sizes, reverse=True)


def test_small_plan_takes_every_answer_shape():
    sizes = sorted((len(h) for h in small_plan().values()), reverse=True)
    assert sum(sizes) == INSTANCES
    assert sizes[0] > 370 and 73 < sizes[1] <= 370


# --- the region registered through each package -------------------------------


async def register_region(package: str, server) -> tuple:
    """The small plan registered the smoke's way through ``package``:
    chip_smoke.REGION_PER_SESSION instances per session."""
    client_cls, register = PACKAGES[package]
    hosts = small_plan()
    instances = [(d, h, a) for d, hs in hosts.items() for h, a in hs.items()]
    per = chip_smoke.REGION_PER_SESSION
    sessions = [await client_cls([server.address]).connect()
                for _ in range(len(instances) // per)]
    owned = await chip_smoke.register_instances(register, [
        (client, instances[k * per:(k + 1) * per])
        for k, client in enumerate(sessions)])
    assert len(owned) == INSTANCES
    return hosts, sessions, owned


async def tree(server, sessions) -> list:
    """(path, payload, index of the owning session or None) of every
    znode under /com, package names mapped to the reference's."""
    index = {c.session_id: k for k, c in enumerate(sessions)}
    observer = await PortClient([server.address]).connect()
    out = []

    async def walk(path):
        data, st = await observer.get(path)
        owner = index[st.ephemeral_owner] if st.ephemeral_owner else None
        out.append((path, bytes(data).replace(b"registrar_tpu_torch",
                                              b"registrar_tpu"), owner))
        for child in sorted(await observer.get_children(path)):
            await walk(f"{path}/{child}")

    try:
        await walk("/com")
    finally:
        await observer.close()
    return out


async def close_all(sessions) -> None:
    await asyncio.gather(*(c.close() for c in sessions))


async def test_each_package_registers_the_same_region():
    trees = {}
    for package in PACKAGES:
        server = await ZKServer().start()
        sessions = []
        try:
            _hosts, sessions, _owned = await register_region(package, server)
            trees[package] = await tree(server, sessions)
        finally:
            await close_all(sessions)
            await server.stop()
    assert trees["port"] == trees["reference"]
    ephemerals = [t for t in trees["port"] if t[2] is not None]
    assert len(ephemerals) == INSTANCES
    assert {t[2] for t in ephemerals} == set(range(INSTANCES // 10))


# --- a tier of each package over the region -----------------------------------


async def start_tiers(server, tmp_path) -> dict:
    """A 2-shard tier of each package with etc/config.example.json's DNS
    block (udpPayloadMax 1232), each on a port of its own."""
    dns = {"host": "127.0.0.1", "udpPayloadMax": 1232, "negativeTtl": 5,
           "staleTtl": 30, "maxPending": 256, "rateLimit": 20000}
    tiers = {}
    for package, mod in (("reference", ref_shard), ("port", port_shard)):
        tiers[package] = await mod.ShardRouter(
            [server.address], SHARDS, str(tmp_path / f"{package}.sock"),
            attach_spread="any", dns={**dns, "port": dns_port()},
        ).start()
    return tiers


async def answers(mod, socket_path, hosts) -> list:
    out = []
    async with mod.ShardClient(socket_path) as sc:
        for dom in hosts:
            for name, qtype in ((dom, "A"), (f"_http._tcp.{dom}", "SRV")):
                for live in (False, True):
                    res = await sc.resolve(name, qtype, live=live)
                    out.append((chip_smoke.rows(res.answers),
                                chip_smoke.rows(res.additionals)))
    return out


def query(name: str, qtype: int) -> bytes:
    return port_dnsfront.build_query(
        7, name, qtype, edns_size=port_dnsfront.DEFAULT_UDP_PAYLOAD_MAX)


async def test_each_packages_tier_answers_the_region_alike(tmp_path):
    server = await ZKServer().start()
    sessions, tiers = [], {}
    try:
        hosts, sessions, _owned = await register_region("port", server)
        tiers = await start_tiers(server, tmp_path)
        # unix socket, cached and live, equal and as docs/CONTRACT.md says
        got = {p: await answers(mod, tiers[p].socket_path, hosts)
               for p, mod in (("reference", ref_shard), ("port", port_shard))}
        assert got["port"] == got["reference"]
        async with port_shard.ShardClient(tiers["port"].socket_path) as sc:
            await chip_smoke.check_answers(sc, hosts, hosts)

        ports = {p: t.dns["port"] for p, t in tiers.items()}
        big, mid = sorted(hosts, key=lambda d: -len(hosts[d]))[:2]
        assert len(hosts[big]) > 370 and 73 < len(hosts[mid]) <= 370
        # over UDP, both A answers outgrow a datagram: TC, no records
        for dom in (big, mid):
            packet = query(dom, port_dnsfront.QTYPE_A)
            replies = {p: await ref_dnsfront.query_udp("127.0.0.1", port, packet)
                       for p, port in ports.items()}
            assert replies["port"][2:] == replies["reference"][2:]
            resp = port_dnsfront.decode_response(replies["port"])
            assert resp.tc and resp.answers == [] and resp.rcode == 0
        # over TCP, every A and SRV answer, byte for byte
        for dom, hs in hosts.items():
            a = query(dom, port_dnsfront.QTYPE_A)
            srv = query(f"_http._tcp.{dom}", port_dnsfront.QTYPE_SRV)
            for packet in (a, srv):
                replies = {p: await ref_dnsfront.query_tcp("127.0.0.1", port, packet)
                           for p, port in ports.items()}
                assert replies["port"][2:] == replies["reference"][2:]
                resp = port_dnsfront.decode_response(replies["port"])
                if packet is a:
                    assert len(replies["port"]) == chip_smoke.a_answer_bytes(dom, len(hs))
                    assert not resp.tc
                    assert sorted(resp.answers) == chip_smoke.expected_a(dom, hs.values())
                elif chip_smoke.srv_answer_bytes(dom, hs) > chip_smoke.TCP_MSG_MAX:
                    # the reference's limit: TC with no records, over TCP too
                    assert resp.tc and resp.answers == [] and resp.additionals == []
                else:
                    assert len(replies["port"]) == chip_smoke.srv_answer_bytes(dom, hs)
                    assert not resp.tc
                    assert (sorted(resp.answers), sorted(resp.additionals)) \
                        == chip_smoke.expected_srv(dom, hs)
        # the reference's client codec refuses a whole A answer past 256
        # records; the port's reads it
        raw = await ref_dnsfront.query_tcp(
            "127.0.0.1", ports["port"], query(big, port_dnsfront.QTYPE_A))
        with pytest.raises(ref_dnsfront.DnsFormatError):
            ref_dnsfront.decode_response(raw)
        assert len(port_dnsfront.decode_response(raw).answers) == len(hosts[big])
    finally:
        for t in tiers.values():
            await t.stop()
        await close_all(sessions)
        await server.stop()


async def test_storm_follows_tc_over_tcp_against_the_port_tier(tmp_path):
    server = await ZKServer().start()
    sessions, tier = [], None
    try:
        hosts, sessions, _owned = await register_region("port", server)
        tier = await port_shard.ShardRouter(
            [server.address], SHARDS, str(tmp_path / "storm.sock"),
            attach_spread="any", dns={"host": "127.0.0.1", "port": dns_port(),
                                      "udpPayloadMax": 1232},
        ).start()
        plan, nx_names = chip_smoke.storm_plan(list(hosts), STORM_QUERIES)
        expected = chip_smoke.storm_expected(hosts, nx_names)
        storm = await chip_smoke.dns_storm(tier.dns["port"], plan, expected)
        assert storm["timeouts"] == [] and storm["errors"] == []
        latency = storm["latency"]
        n_tc = sum(expected[name][2] for name, _kind in plan)
        assert n_tc > 0 and len(latency["A_TC"]) == n_tc
        assert sum(map(len, latency.values())) == STORM_QUERIES
        assert {n.split(".", 1)[1] for n in nx_names} == {chip_smoke.REGION_SUFFIX}
    finally:
        if tier is not None:
            await tier.stop()
        await close_all(sessions)
        await server.stop()


# --- the DNS encode cache's coherence at a region's size ----------------------


async def dns_a(port: int, name: str) -> list:
    raw = await port_dnsfront.query_udp(
        "127.0.0.1", port, query(name, port_dnsfront.QTYPE_A))
    return sorted(r[3] for r in port_dnsfront.decode_response(raw).answers)


@pytest.mark.parametrize("package", sorted(SERVE))
async def test_dns_answer_drops_an_instance_whose_entry_was_evicted(package):
    """A 4-entry domain's answer is cached, a 9-entry domain's resolve
    evicts its entries (cache bound 6), then one of its instances
    leaves: the port answers without it, the reference from its stale
    template, since the evicted entries' watches were forgotten."""
    client_cls, zkcache, binderview, dnsfront = SERVE[package]
    server = await ZKServer().start()
    writer = await PortClient([server.address]).connect()
    reader = front = None
    try:
        small, filler = "small.evict.example.com", "filler.evict.example.com"
        hosts = {small: {f"s{i}": f"10.1.0.{i}" for i in range(3)},
                 filler: {f"f{i}": f"10.2.0.{i}" for i in range(8)}}
        owned = await chip_smoke.register_instances(port_registration.register, [
            (writer, [(d, h, a) for d, hs in hosts.items() for h, a in hs.items()])])
        reader = await client_cls([server.address]).connect()
        cache = zkcache.ZKCache(reader, max_entries=6)
        front = dnsfront.DnsFront(
            lambda name, qtype: binderview.resolve(cache, name, qtype),
            port=dns_port(), source=cache)
        _host, port = await front.start()
        assert await dns_a(port, small) == sorted(hosts[small].values())
        assert await dns_a(port, filler) == sorted(hosts[filler].values())
        assert cache.stats["evictions"] >= 4
        await port_registration.unregister(writer, [owned[(small, "s0")][1][0]])
        await asyncio.sleep(0.2)
        if package == "port":
            assert await dns_a(port, small) == ["10.1.0.1", "10.1.0.2"]
        else:
            assert await dns_a(port, small) == sorted(hosts[small].values())
    finally:
        if front is not None:
            await front.close()
        if reader is not None:
            await reader.close()
        await writer.close()
        await server.stop()


@pytest.mark.parametrize("package", sorted(SERVE))
async def test_template_resolved_across_an_invalidation_is_not_kept(package):
    """A miss whose resolve overlaps an invalidation of its domain
    answers, but the port keeps no template of it (the next query
    resolves again); the reference keeps it."""
    _client, _zkcache, binderview, dnsfront = SERVE[package]
    events = ref_events if package == "reference" else port_events
    source = events.EventEmitter()
    source.authoritative = True
    released, calls = asyncio.Event(), []

    async def resolver(name, _qtype):
        calls.append(name)
        await released.wait()
        return binderview.Resolution(
            answers=[binderview.Answer(name, "A", 30, "10.3.0.1")])

    front = dnsfront.DnsFront(resolver, port=dns_port(), source=source)
    _host, port = await front.start()
    try:
        name = "svc.race.example.com"
        first = asyncio.ensure_future(dns_a(port, name))
        while not calls:
            await asyncio.sleep(0.01)
        source.emit("invalidated", "/com/example/race/svc/host-1", None)
        released.set()
        assert await first == ["10.3.0.1"]
        assert await dns_a(port, name) == ["10.3.0.1"]
        assert len(calls) == (2 if package == "port" else 1)
    finally:
        await front.close()
