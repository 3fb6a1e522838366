"""The port's operator CLI held against the reference's.

* Every test body of ``tests/test_zkcli.py`` runs against the port,
  rebound as in ``tests/test_torch_daemon.py``: ``python3 -m
  registrar_tpu.tools.zkcli`` in a body becomes ``python3 -m
  registrar_tpu_torch.tools.zkcli``, and ``serve-sharded`` starts the
  port's tier.  No body is left out.
* ``python3 -m registrar_tpu.tools.zkcli`` and ``python3 -m
  registrar_tpu_torch.tools.zkcli`` print the same standard output and
  exit with the same code for ``tree``, ``resolve``, ``resolve
  --cached``, ``dig`` (UDP and TCP) and ``status``, against one server,
  one tree and one port tier started with ``zkcli serve-sharded``.  In
  ``dig`` output the random query id and the query time are masked;
  ``status`` reads a snapshot of the tier's ``/status`` that is held
  still, so that both tools print the same moment.
"""

import asyncio
import concurrent.futures
import http.server
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from registrar_tpu.testing.server import ZKServer
from tests.test_torch_daemon import bindings
from tests.test_torch_serve import FLEET, _register_fleet
from tests.test_torch_wire import body_cases, load_test_module, run_body

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("registrar_tpu", "registrar_tpu_torch")

CASES = body_cases("test_zkcli.py")


def test_rebound_file_reaches_the_port():
    mod = load_test_module("test_zkcli.py", port=True)
    assert bindings(mod, "registrar_tpu") == []
    assert bindings(mod, "registrar_tpu_torch") != []


def test_every_class_contributes_bodies():
    classes = {c.values[1].split(".")[0] for c in CASES}
    assert {"TestZkCli", "TestServeSharded", "TestShardedStatus",
            "TestCachedResolve", "TestServeView"} <= classes
    assert len(CASES) > 35


@pytest.mark.parametrize("filename,qualname,case", CASES)
def test_reference_body_passes_against_the_port(
    filename, qualname, case, monkeypatch, tmp_path, capsys
):
    fixtures = {"monkeypatch": monkeypatch, "tmp_path": tmp_path,
                "capsys": capsys}
    run_body(load_test_module(filename, port=True), qualname, fixtures, case)


# --- both CLIs against one server, one tree and one port tier --------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http_json(port: int, path: str):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=5
    ) as resp:
        return json.loads(resp.read())


class _Frozen(http.server.BaseHTTPRequestHandler):
    """Serves one fixed ``/status`` body."""

    body = b"{}"

    def do_GET(self):  # noqa: N802 - the stdlib's hook name
        self.send_response(200 if self.path == "/status" else 404)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(self.body)

    def log_message(self, *_args):
        pass


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A ZooKeeper server holding the cross-package fleet, a port tier
    started through ``zkcli serve-sharded``, and a frozen copy of its
    ``/status``."""
    tmp = tmp_path_factory.mktemp("zkcli_parity")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro, timeout=30):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    server = run(ZKServer().start())
    clients = run(_register_fleet(server))
    metrics_port, dns_port = _free_port(), _free_port()
    tier_cfg = {
        "registration": {"domain": "tier.cross.example.us",
                         "type": "load_balancer"},
        "zookeeper": {"servers": [{"host": server.host, "port": server.port}]},
        "serve": {"shards": 2, "socketPath": str(tmp / "resolve.sock"),
                  "attachSpread": "any",
                  "dns": {"host": "127.0.0.1", "port": dns_port}},
        "metrics": {"host": "127.0.0.1", "port": metrics_port},
    }
    tier_path = tmp / "tier.json"
    tier_path.write_text(json.dumps(tier_cfg))
    log = open(tmp / "tier.log", "w")
    tier = subprocess.Popen(
        [sys.executable, "-m", "registrar_tpu_torch.tools.zkcli",
         "serve-sharded", "-f", str(tier_path)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdout=log, stderr=subprocess.STDOUT,
    )
    frozen = None
    try:
        deadline = time.monotonic() + 30
        while True:
            assert tier.poll() is None, (tmp / "tier.log").read_text()
            try:
                snapshot = _http_json(metrics_port, "/status")
                if len(snapshot.get("shards") or {}) == 2 and not snapshot.get(
                    "shards_down"
                ):
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, (tmp / "tier.log").read_text()
            time.sleep(0.1)
        _Frozen.body = json.dumps(snapshot).encode()
        frozen = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Frozen)
        threading.Thread(target=frozen.serve_forever, daemon=True).start()
        status_path = tmp / "status.json"
        status_path.write_text(json.dumps({
            **tier_cfg,
            "metrics": {"host": "127.0.0.1", "port": frozen.server_port},
        }))
        yield {"server": f"{server.host}:{server.port}",
               "dns": f"127.0.0.1:{dns_port}", "status": str(status_path)}
    finally:
        if frozen is not None:
            frozen.shutdown()
        if tier.poll() is None:
            tier.send_signal(signal.SIGTERM)
            try:
                tier.wait(timeout=15)
            except subprocess.TimeoutExpired:
                tier.kill()
                tier.wait(timeout=10)
        log.close()
        for cl in clients:
            run(cl.close())
        run(server.stop())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)


#: id -> (zkcli arguments, with {server}/{dns}/{status} filled from the
#: world, and the exit code both tools must give)
COMMANDS = {
    "tree": (["-s", "{server}", "tree", "/us/example/cross"], 0),
    "resolve_a": (["-s", "{server}", "resolve", "web.cross.example.us"], 0),
    "resolve_srv": (["-s", "{server}", "resolve", "-t", "SRV",
                     "_http._tcp.moray.cross.example.us"], 0),
    "resolve_absent": (["-s", "{server}", "resolve",
                        "absent.cross.example.us"], 1),
    "resolve_cached": (["-s", "{server}", "resolve", "--cached",
                        "web.cross.example.us"], 0),
    "resolve_cached_srv": (["-s", "{server}", "resolve", "--cached", "-t",
                            "SRV", "_http._tcp.web.cross.example.us"], 0),
    "dig_udp_a": (["dig", "--server", "{dns}", "web.cross.example.us"], 0),
    "dig_udp_srv": (["dig", "--server", "{dns}",
                     "_http._tcp.web.cross.example.us"], 0),
    "dig_udp_nxdomain": (["dig", "--server", "{dns}",
                          "absent.cross.example.us"], 1),
    "dig_tcp_a": (["dig", "--tcp", "--server", "{dns}",
                   "moray.cross.example.us"], 0),
    "dig_tcp_srv": (["dig", "--tcp", "--server", "{dns}",
                     "_http._tcp.moray.cross.example.us"], 0),
    "status": (["status", "-f", "{status}"], 0),
}

_VOLATILE = [
    (re.compile(r"(status: \w+, id: )\d+"), r"\1<id>"),
    (re.compile(r"(;; Query time: )[0-9.]+( msec)"), r"\1<t>\2"),
]


def _cli(package: str, argv) -> tuple:
    proc = subprocess.run(
        [sys.executable, "-m", f"{package}.tools.zkcli", *argv],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=60,
    )
    out = proc.stdout
    for pattern, repl in _VOLATILE:
        out = pattern.sub(repl, out)
    return proc.returncode, out


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_both_clis_print_the_same(world, name):
    args, rc = COMMANDS[name]
    argv = [a.format(**world) for a in args]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref, port = pool.map(lambda p: _cli(p, argv), PACKAGES)
    assert port == ref
    assert ref[0] == rc, ref
    # a resolve with no answers says so on stderr alone
    assert bool(ref[1].strip()) == (name != "resolve_absent"), ref
    if name.startswith("dig"):
        status = "NXDOMAIN" if rc else "NOERROR"
        assert f"status: {status}, id: <id>" in ref[1]
        assert f"({'TCP' if '--tcp' in argv else 'UDP'})" in ref[1]
    if name == "tree":
        # every instance of the fleet is in the printed tree
        hosts = sum(n for _reg, _ip, n in FLEET)
        assert len(re.findall(r"\bi\d\b", ref[1])) >= hosts
