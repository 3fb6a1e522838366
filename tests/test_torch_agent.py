"""The port's ``register_plus`` held against the reference's.

Each scenario runs once per package, each against its own fresh
in-process ``ZKServer``, driven by the same steps:

* a ``test -f <flag>`` health check with threshold 2 is flipped down and
  back up: both agents must emit the same transition events with the
  same arguments and leave the same znode trees at every stage;
* a level-triggered reconciler with repair on meets a deleted host
  record and a corrupted payload: both must report the same drift and
  converge to the same tree.
"""

import asyncio
import os

import pytest

from registrar_tpu import agent as ref_agent
from registrar_tpu.testing.server import ZKServer
from registrar_tpu.zk.client import ZKClient as RefZKClient
from registrar_tpu_torch import agent as port_agent
from registrar_tpu_torch.zk.client import ZKClient as PortZKClient

DOMAIN = "agent.test.registrar"
PATH = "/registrar/test/agent"
HOST = "agenthost"
REGISTRATION = {
    "domain": DOMAIN,
    "type": "load_balancer",
    "aliases": [f"alias-1.{DOMAIN}"],
    "ttl": 30,
    "ports": [80, 443],
    "service": {
        "type": "service",
        "service": {"srvce": "_http", "proto": "_tcp", "port": 80, "ttl": 60},
    },
}

PACKAGES = {"ref": (ref_agent, RefZKClient), "port": (port_agent, PortZKClient)}

#: transition events; heartbeats are left out, their count is timing
TRANSITIONS = ("register", "fail", "unregister", "ok", "error", "drift",
               "driftRepaired")


async def dump_tree(client, owner: int, path: str = "/") -> list:
    data, st = await client.get(path)
    kind = (
        "ephemeral" if st.ephemeral_owner == owner
        else "persistent" if st.ephemeral_owner == 0
        else "foreign"
    )
    out = [(path, bytes(data), kind)]
    for child in sorted(await client.get_children(path)):
        out += await dump_tree(client, owner, path.rstrip("/") + "/" + child)
    return out


def _plain(arg):
    if isinstance(arg, BaseException):
        return type(arg).__name__
    if hasattr(arg, "reason") and hasattr(arg, "path"):  # a reconcile Drift
        return (arg.path, arg.reason)
    return arg


def record_transitions(ee) -> list:
    events = []
    for name in TRANSITIONS:
        ee.on(name, lambda *a, _n=name: events.append((_n, [_plain(x) for x in a])))
    return events


async def wait_until(predicate, timeout=10.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not predicate():
        if loop.time() > deadline:
            raise TimeoutError("condition not reached")
        await asyncio.sleep(0.01)


async def run_package(name: str, scenario):
    agent_mod, client_cls = PACKAGES[name]
    server = await ZKServer().start()
    client = await client_cls([server.address]).connect()
    try:
        return await scenario(agent_mod, server, client)
    finally:
        await client.close()
        await server.stop()


async def health_flip(agent_mod, server, client, flag):
    open(flag, "w").close()
    ee = agent_mod.register_plus(
        client, REGISTRATION, admin_ip="10.0.0.17", hostname=HOST,
        settle_delay=0.01, heartbeat_interval=0.05,
        health_check={
            "command": f"test -f {flag}",
            "interval": 0.03,
            "timeout": 1.0,
            "threshold": 2,
        },
    )
    events = record_transitions(ee)
    beats = []
    ee.on("heartbeat", beats.append)
    trees = []
    try:
        await wait_until(lambda: [e for e, _ in events] == ["register"])
        await wait_until(lambda: len(beats) >= 3)
        trees.append(await dump_tree(client, client.session_id))

        os.unlink(flag)  # the check starts failing
        await wait_until(lambda: any(e == "unregister" for e, _ in events))
        trees.append(await dump_tree(client, client.session_id))

        open(flag, "w").close()  # and recovers
        await wait_until(lambda: [e for e, _ in events].count("register") == 2)
        trees.append(await dump_tree(client, client.session_id))
    finally:
        ee.stop()
    return events, trees


async def test_health_flip_emits_identical_events_and_trees(tmp_path):
    ref = await run_package(
        "ref", lambda *a: health_flip(*a, str(tmp_path / "ref-flag"))
    )
    port = await run_package(
        "port", lambda *a: health_flip(*a, str(tmp_path / "port-flag"))
    )
    assert port == ref
    events, (registered, down, recovered) = port
    znodes = [f"{PATH}/{HOST}", f"{PATH}/alias-1", PATH]
    assert [e for e, _ in events] == [
        "register", "fail", "unregister", "ok", "register"
    ]
    assert events[0] == ("register", [znodes])
    assert not any(kind == "ephemeral" for _, _, kind in down)
    assert recovered == registered
    assert sum(kind == "ephemeral" for _, _, kind in registered) == 2


async def reconcile_repair(agent_mod, server, client, damage):
    ee = agent_mod.register_plus(
        client, REGISTRATION, admin_ip="10.0.0.17", hostname=HOST,
        settle_delay=0.01, heartbeat_interval=0.05,
        reconcile={"interval_seconds": 0.05, "repair": True},
    )
    events = record_transitions(ee)
    try:
        await wait_until(lambda: [e for e, _ in events] == ["register"])
        await damage(server, client)
        await wait_until(lambda: any(e == "driftRepaired" for e, _ in events))
        # converged: a later sweep finds nothing
        (summary,) = await ee.wait_for("reconcile", timeout=10)
        while summary["drift"]:
            (summary,) = await ee.wait_for("reconcile", timeout=10)
        tree = await dump_tree(client, client.session_id)
    finally:
        ee.stop()
    return [e for e in events if e[0] in ("drift", "driftRepaired")], tree


async def _delete_host(server, client):
    await client.unlink(f"{PATH}/{HOST}")


async def _corrupt_alias(server, client):
    await server.corrupt_node(f"{PATH}/alias-1", b'{"evil":1}')


@pytest.mark.parametrize(
    "damage", [_delete_host, _corrupt_alias], ids=["missing", "payload"]
)
async def test_reconcile_drift_repair_is_identical(damage):
    ref = await run_package(
        "ref", lambda *a: reconcile_repair(*a, damage)
    )
    port = await run_package(
        "port", lambda *a: reconcile_repair(*a, damage)
    )
    assert port == ref
    drift, tree = port
    assert drift and drift[0][0] == "drift"
    nodes = {path: (data, kind) for path, data, kind in tree}
    host_data, host_kind = nodes[f"{PATH}/{HOST}"]
    assert host_kind == "ephemeral"
    assert nodes[f"{PATH}/alias-1"] == (host_data, "ephemeral")


def test_timing_constants_match():
    for name in ("DEFAULT_HEARTBEAT_INTERVAL_S", "HEARTBEAT_FAILURE_BACKOFF_S"):
        assert getattr(port_agent, name) == getattr(ref_agent, name)
