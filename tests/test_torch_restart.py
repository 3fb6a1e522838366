"""The port's daemon restarts held against the reference's daemon.

* Every test body of ``tests/test_restart_e2e.py`` runs against the port
  (rebound as in ``tests/test_torch_daemon.py``): handoff, drain, the
  second-signal exit, SIGHUP reload and every statefile fallback.
* Handoff across implementations, both ways: one package's daemon writes
  the statefile and detaches on SIGTERM, the other package's daemon
  resumes the same session, and a resolver polling every 10 ms sees zero
  NO_NODE.  The two share the statefile format and config fingerprint.
* Lifecycle parity: both daemons run one config, each against its own
  fresh server, through terminal session expiry (exit 1), a bad config
  (exit 78) and a second SIGTERM during a drain (exit 70).  The znode
  trees, the exit codes and the ordered bunyan lines must agree.  A line
  is compared by ``name``, ``level``, ``msg`` and ``component``; the
  port's module loggers are ``registrar_tpu_torch.<module>`` where the
  reference's are ``registrar_tpu.<module>``, so that prefix is mapped
  before the comparison and everything else must be equal.  ``time``,
  ``pid``, ``hostname``, ``src`` and the structured fields are not
  compared.

Every daemon is a subprocess with a bounded wait; the coroutine tests
have the suite's 60 s limit.
"""

import asyncio
import json
import os
import re
import signal
import socket
import subprocess
import sys

import pytest

from registrar_tpu import statefile as ref_statefile
from registrar_tpu.testing.server import ZKServer
from registrar_tpu.zk.client import ZKClient
from registrar_tpu_torch import statefile as port_statefile
from tests.test_restart_e2e import NODE, _cfg_dict, _Poller, _wait_for
from tests.test_torch_wire import body_cases, load_test_module, run_body

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("registrar_tpu", "registrar_tpu_torch")
SESSION_ID = re.compile(r"\b0x[0-9a-f]+\b")

CASES = body_cases("test_restart_e2e.py")


@pytest.mark.parametrize("filename,qualname,case", CASES)
def test_reference_body_passes_against_the_port(
    filename, qualname, case, monkeypatch, tmp_path
):
    fixtures = {"monkeypatch": monkeypatch, "tmp_path": tmp_path}
    run_body(load_test_module(filename, port=True), qualname, fixtures, case)


def spawn(package: str, cfg_path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", package, "-f", str(cfg_path)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": REPO, "LOG_LEVEL": "info"},
    )


async def finish(proc: subprocess.Popen, timeout: float = 15) -> tuple:
    """(exit code, output) of a daemon, killed if it outlives ``timeout``."""
    try:
        rc = await asyncio.to_thread(proc.wait, timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    out = proc.stdout.read().decode()
    proc.stdout.close()
    return rc, out


async def stop_all(*procs) -> None:
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.kill()
            await asyncio.to_thread(proc.wait, 10)
        if proc is not None and not proc.stdout.closed:
            proc.stdout.close()


# --- handoff across implementations -----------------------------------------


@pytest.mark.parametrize(
    "first,second", [PACKAGES, PACKAGES[::-1]], ids=["ref-to-port", "port-to-ref"]
)
async def test_handoff_across_implementations(first, second, tmp_path):
    server = await ZKServer(max_session_timeout_ms=30000).start()
    observer = await ZKClient([server.address]).connect()
    state_path = tmp_path / "state.json"
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(_cfg_dict(
        server, state_path, reconcile={"intervalSeconds": 0.2, "repair": True},
    )))
    pred = succ = None
    try:
        pred = spawn(first, cfg_path)
        await _wait_for(lambda: observer.exists(NODE))
        sid0 = (await observer.stat(NODE)).ephemeral_owner

        poller = _Poller(observer, NODE).start()
        pred.send_signal(signal.SIGTERM)
        rc, pred_out = await finish(pred)
        assert rc == 0, pred_out
        assert "session handed off" in pred_out

        # Both packages read the file the predecessor wrote, alike.
        ref_state = ref_statefile.load(str(state_path))
        port_state = port_statefile.load(str(state_path))
        assert vars(port_state) == vars(ref_state)
        assert ref_state.session_id == sid0
        stamp0 = ref_state.stamp

        succ = spawn(second, cfg_path)
        await _wait_for(
            lambda: asyncio.sleep(
                0, ref_statefile.load(str(state_path)).stamp != stamp0
            ),
            timeout=20,
        )
        await asyncio.sleep(0.8)  # heartbeats and reconciler sweeps
        await poller.stop()

        assert poller.checks > 10
        assert poller.misses == 0, (
            f"{poller.misses}/{poller.checks} polls saw NO_NODE"
        )
        assert poller.owners == {sid0}
        assert succ.poll() is None

        succ.send_signal(signal.SIGTERM)
        rc, out = await finish(succ)
        assert rc == 0, out
        assert "session resumed; verifying registration in place" in out
        assert "resumed registration verified in place" in out
        assert "drift detected" not in out
    finally:
        await stop_all(pred, succ)
        await observer.close()
        await server.stop()


# --- lifecycle parity ---------------------------------------------------------

REGISTRATION = {
    "domain": "life.e2e.registrar",
    "type": "load_balancer",
    "aliases": ["alias-1.life.e2e.registrar"],
    "ttl": 30,
    "ports": [80, 443],
    "service": {
        "type": "service",
        "service": {"srvce": "_http", "proto": "_tcp", "port": 80, "ttl": 60},
    },
    # no heartbeat inside the scenario: its lines would race the exit
    "heartbeatInterval": 60000,
}
HOST_NODE = "/registrar/e2e/life/" + socket.gethostname()


def lifecycle_config(server, scenario: str, tmp) -> dict:
    cfg = {
        "registration": dict(REGISTRATION),
        "adminIp": "10.0.0.17",
        "zookeeper": {
            "servers": [{"host": server.host, "port": server.port}],
            "timeout": 10000,
        },
    }
    if scenario == "bad_config":
        cfg["zookeeper"]["servers"] = []
    if scenario == "second_sigterm":
        cfg["restart"] = {
            "stateFile": str(tmp / "state.json"),
            "mode": "drain",
            "drainGraceSeconds": 30,
        }
    return cfg


async def dump_tree(client, path: str = "/") -> list:
    """(path, payload, ephemeral?) of every znode from ``path`` down."""
    data, st = await client.get(path)
    out = [(path, bytes(data), st.ephemeral_owner != 0)]
    for child in sorted(await client.get_children(path)):
        out += await dump_tree(client, path.rstrip("/") + "/" + child)
    return out


async def run_lifecycle(package: str, scenario: str, tmp) -> dict:
    """One daemon of ``package`` through ``scenario`` on a fresh server."""
    tmp.mkdir()
    server = await ZKServer(max_session_timeout_ms=30000).start()
    observer = await ZKClient([server.address]).connect()
    cfg_path = tmp / "config.json"
    cfg_path.write_text(json.dumps(lifecycle_config(server, scenario, tmp)))
    proc = None
    tree = None
    try:
        proc = spawn(package, cfg_path)
        if scenario != "bad_config":
            await _wait_for(lambda: observer.exists(HOST_NODE))
            tree = await dump_tree(observer)
        if scenario == "expiry":
            owner = (await observer.stat(HOST_NODE)).ephemeral_owner
            await server.expire_session(owner)
        elif scenario == "second_sigterm":
            proc.send_signal(signal.SIGTERM)
            await _wait_for(lambda: _gone(observer, HOST_NODE), timeout=10)
            proc.send_signal(signal.SIGTERM)
        rc, out = await finish(proc)
        after = await dump_tree(observer)
    finally:
        await stop_all(proc)
        await observer.close()
        await server.stop()
    return {
        "tree": tree, "rc": rc, "after": after,
        "components": [json.loads(line)["component"] for line in out.splitlines()],
        "lines": bunyan_lines(out, package, {
            str(tmp): "<tmp>", f"{server.host}:{server.port}": "<server>",
        }),
    }


async def _gone(observer, node) -> bool:
    return await observer.exists(node) is None


def bunyan_lines(out: str, package: str, run_values: dict) -> list:
    """(name, level, msg, component) of every line, the package prefix of
    ``component`` mapped to ``registrar_tpu``; in ``msg`` the values of one
    run (its directory, its server's address: ``run_values``) and session
    ids are replaced by placeholders."""
    lines = []
    for raw in out.splitlines():
        rec = json.loads(raw)  # every line is one bunyan object
        component = rec["component"]
        if component.startswith(package + "."):
            component = "registrar_tpu." + component[len(package) + 1:]
        msg = SESSION_ID.sub("<session>", rec["msg"])
        for value, placeholder in run_values.items():
            msg = msg.replace(value, placeholder)
        lines.append((rec["name"], rec["level"], msg, component))
    return lines


EXPECTED_RC = {"expiry": 1, "bad_config": 78, "second_sigterm": 70}


@pytest.mark.parametrize("scenario", sorted(EXPECTED_RC))
async def test_lifecycle_matches_reference(scenario, tmp_path):
    ref, port = await asyncio.gather(
        run_lifecycle("registrar_tpu", scenario, tmp_path / "ref"),
        run_lifecycle("registrar_tpu_torch", scenario, tmp_path / "port"),
    )
    assert ref["rc"] == EXPECTED_RC[scenario]
    assert port["rc"] == ref["rc"]
    assert port["tree"] == ref["tree"]
    assert port["after"] == ref["after"]
    assert port["lines"] == ref["lines"]
    assert ref["lines"], "the daemon logged nothing"
    assert "registrar" in ref["components"]
    # The mapping above is the only difference: the daemon's own lines say
    # "registrar" in both, a module's line names its own package.
    for result, package in ((ref, "registrar_tpu."), (port, "registrar_tpu_torch.")):
        modules = set(result["components"]) - {"registrar"}
        assert all(c.startswith(package) for c in modules), modules
    if scenario != "bad_config":  # the config is rejected before any module logs
        assert set(port["components"]) - {"registrar"}
