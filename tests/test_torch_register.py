"""The port's registration pipeline held against the reference.

The same registrations run through ``registrar_tpu`` and through
``registrar_tpu_torch``, each into its own fresh in-process ``ZKServer``.
The two znode trees must be identical: every path, every payload byte,
and every node's kind (ephemeral to the registering session, or
persistent).  Unregistering must leave identical trees too, and both
pipelines must honour the settle delay between cleanup and create.
"""

import asyncio
import time

import pytest

from registrar_tpu import registration as ref_registration
from registrar_tpu.testing.server import ZKServer
from registrar_tpu.zk.client import ZKClient as RefZKClient
from registrar_tpu_torch import registration as port_registration
from registrar_tpu_torch.zk.client import ZKClient as PortZKClient

DOMAIN = "unit.test.registrar"  # -> /registrar/test/unit

PACKAGES = {
    "ref": (ref_registration, RefZKClient),
    "port": (port_registration, PortZKClient),
}

#: (registration, admin_ip): the shapes of tests/test_register.py
SHAPES = {
    "host_only": ({"domain": DOMAIN, "type": "host"}, "10.0.0.1"),
    "admin_ip_ttl": (
        {"domain": DOMAIN, "type": "host", "ttl": 30},
        "192.168.0.5",
    ),
    "lb_ports_aliases_service": (
        {
            "domain": DOMAIN,
            "type": "load_balancer",
            "aliases": [f"a1.{DOMAIN}", f"a2.{DOMAIN}"],
            "ttl": 30,
            "ports": [80, 443],
            "service": {
                "type": "service",
                "service": {"srvce": "_http", "proto": "_tcp", "port": 80, "ttl": 60},
            },
        },
        "10.0.0.17",
    ),
    "explicit_ports_override": (
        {
            "domain": DOMAIN,
            "type": "moray_host",
            "ports": [2020, 2021],
            "service": {
                "type": "service",
                "service": {"srvce": "_moray", "proto": "_tcp", "port": 2020},
            },
        },
        "10.0.0.3",
    ),
    "service_port_inherited": (
        {
            "domain": DOMAIN,
            "type": "redis_host",
            "service": {
                "type": "service",
                "service": {"srvce": "_redis", "proto": "_tcp", "port": 6379},
            },
        },
        "10.9.9.9",
    ),
}


async def dump_tree(client, owner: int, path: str = "/") -> list:
    """(path, payload, kind) for every znode under ``path``; kind is
    "ephemeral" for nodes ``owner`` holds, else "persistent"."""
    data, st = await client.get(path)
    kind = (
        "ephemeral" if st.ephemeral_owner == owner
        else "persistent" if st.ephemeral_owner == 0
        else "foreign"
    )
    out = [(path, bytes(data), kind)]
    for child in sorted(await client.get_children(path)):
        out += await dump_tree(
            client, owner, path.rstrip("/") + "/" + child
        )
    return out


async def run_package(name: str, steps):
    """Run ``steps(registration_module, client)`` against a fresh server;
    returns (steps' result, the tree afterwards)."""
    registration, client_cls = PACKAGES[name]
    server = await ZKServer().start()
    client = await client_cls([server.address]).connect()
    try:
        result = await steps(registration, client)
        return result, await dump_tree(client, client.session_id)
    finally:
        await client.close()
        await server.stop()


async def both(steps):
    ref = await run_package("ref", steps)
    port = await run_package("port", steps)
    return ref, port


def _register(registration_mod, client, shape, **kw):
    reg, admin_ip = SHAPES[shape]
    return registration_mod.register(
        client, reg, admin_ip=admin_ip, hostname="testhost",
        settle_delay=kw.pop("settle_delay", 0.01), **kw,
    )


@pytest.mark.parametrize("shape", sorted(SHAPES))
async def test_register_builds_identical_trees(shape):
    async def steps(mod, client):
        return await _register(mod, client, shape)

    (ref_nodes, ref_tree), (port_nodes, port_tree) = await both(steps)
    assert port_nodes == ref_nodes
    assert port_tree == ref_tree
    # The registration really landed: the host record is ephemeral.
    kinds = {path: kind for path, _, kind in port_tree}
    assert kinds[port_nodes[0]] == "ephemeral"


@pytest.mark.parametrize("shape", sorted(SHAPES))
async def test_unregister_leaves_identical_trees(shape):
    async def steps(mod, client):
        nodes = await _register(mod, client, shape)
        return await mod.unregister(client, nodes)

    (ref_deleted, ref_tree), (port_deleted, port_tree) = await both(steps)
    assert port_deleted == ref_deleted
    assert port_tree == ref_tree
    assert not any(kind == "ephemeral" for _, _, kind in port_tree)


async def test_reregister_over_stale_state_is_identical():
    async def steps(mod, client):
        reg, _ = SHAPES["lb_ports_aliases_service"]
        await mod.register(
            client, reg, admin_ip="10.0.0.4", hostname="testhost",
            settle_delay=0.01,
        )
        return await mod.register(
            client, reg, admin_ip="10.0.0.5", hostname="testhost",
            settle_delay=0.01,
        )

    (ref_nodes, ref_tree), (port_nodes, port_tree) = await both(steps)
    assert port_nodes == ref_nodes
    assert port_tree == ref_tree
    assert any(b'"10.0.0.5"' in data for _, data, _ in port_tree)


def test_settle_constant_matches():
    assert port_registration.SETTLE_DELAY_S == ref_registration.SETTLE_DELAY_S == 1.0


@pytest.mark.parametrize("name", sorted(PACKAGES))
async def test_settle_delay_is_honoured(name, monkeypatch):
    """The pipeline sleeps exactly ``settle_delay`` once, after cleanup
    and before any create."""
    registration_mod, _ = PACKAGES[name]
    real_sleep = asyncio.sleep
    sleeps = []

    async def recording_sleep(delay, *a, **kw):
        sleeps.append(delay)
        return await real_sleep(delay, *a, **kw)

    monkeypatch.setattr(registration_mod.asyncio, "sleep", recording_sleep)

    async def steps(mod, client):
        t0 = time.monotonic()
        await _register(mod, client, "host_only", settle_delay=0.25)
        return time.monotonic() - t0

    elapsed, _ = await run_package(name, steps)
    assert 0.25 in sleeps
    assert elapsed >= 0.25
