"""Each package's client against the other package's ZooKeeper server.

The reference's own tests of the server's surfaces run twice more, each
time with one side of the wire swapped (``tests/test_torch_wire.py``):

* the reference's client, registration and daemon against the port's
  ``ZKServer`` and ``ZKEnsemble`` (only the test harness rebound:
  ``port=False, harness=True``);
* the port's client, registration and daemon against the reference's
  server and ensemble (only the client side rebound, the binding of
  every client-side file in ``tests/test_torch_*.py``).

Both must pass every body: the two servers answer every request the two
clients make alike, elections, read-only mode and failover included.
The two server CLIs announce their port with the same line.
"""

import os
import re
import subprocess
import sys

import pytest

from tests.test_torch_daemon import bindings
from tests.test_torch_wire import TESTS, body_cases, load_test_module, run_body

FILES = (
    "test_multi.py",
    "test_acl.py",
    "test_chroot.py",
    "test_ensemble.py",
)

REF_CLIENT = [c for f in FILES for c in body_cases(f, port=False, harness=True)]
PORT_CLIENT = [c for f in FILES for c in body_cases(f)]


def _homes(mod, package):
    return {home for _name, home in bindings(mod, package, harness=True)}


@pytest.mark.parametrize("filename", sorted(FILES))
def test_cross_bindings_swap_one_side_each(filename):
    ref_client = load_test_module(filename, port=False, harness=True)
    homes = _homes(ref_client, "registrar_tpu")
    assert homes and not any(h.startswith("registrar_tpu.testing") for h in homes)
    assert all(h.startswith("registrar_tpu_torch.testing")
               for h in _homes(ref_client, "registrar_tpu_torch"))
    port_client = load_test_module(filename, port=True)
    assert all(h.startswith("registrar_tpu.testing")
               for h in _homes(port_client, "registrar_tpu"))
    assert not any(h.startswith("registrar_tpu_torch.testing")
                   for h in _homes(port_client, "registrar_tpu_torch"))


def test_both_directions_cover_every_body():
    assert [c.values[:2] for c in REF_CLIENT] == [c.values[:2] for c in PORT_CLIENT]
    assert {c.values[0] for c in REF_CLIENT} == set(FILES)
    assert len(REF_CLIENT) > 80


@pytest.mark.parametrize("filename,qualname,case", REF_CLIENT)
def test_reference_client_against_the_ported_server(
    filename, qualname, case, monkeypatch, tmp_path
):
    run_body(load_test_module(filename, port=False, harness=True), qualname,
             {"monkeypatch": monkeypatch, "tmp_path": tmp_path}, case)


@pytest.mark.parametrize("filename,qualname,case", PORT_CLIENT)
def test_ported_client_against_the_reference_server(
    filename, qualname, case, monkeypatch, tmp_path
):
    run_body(load_test_module(filename, port=True), qualname,
             {"monkeypatch": monkeypatch, "tmp_path": tmp_path}, case)


def _listening_line(package: str) -> str:
    """The server CLI's announcement on standard output (its debug log
    goes to standard error)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{package}.testing.server",
         "--host", "127.0.0.1", "--port", "0"],
        cwd=os.path.dirname(TESTS), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True,
    )
    try:
        return proc.stdout.readline().strip()
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_server_clis_announce_the_same_line():
    lines = {p: _listening_line(p) for p in ("registrar_tpu", "registrar_tpu_torch")}
    pattern = re.compile(r"zk test server listening on 127\.0\.0\.1:(\d+)")
    assert all(pattern.fullmatch(line) for line in lines.values()), lines
