"""The port's fault injection held against the reference's own tests.

Every test body of ``tests/test_netem.py`` (the ``ChaosProxy`` toxics:
blackhole, reset, latency, stop-reading, truncate, and the client's
recovery through each), ``tests/test_chaos.py`` (the seeded churn
storms against a proxied ensemble) and ``tests/test_overload.py`` (the
serve tier's armor under the storm ``workload``) runs with every module
the port has rebound to ``registrar_tpu_torch``, the test harness
included.  No body is left out.

The port's slow-loris client differs from the reference's on purpose:
it reads one byte per 50 ms even when bytes are waiting (the
reference's returns at once for a buffered byte, and so drains a worker
as fast as a Python loop can), sees the worker hang up without draining
what is buffered, and holds on until the worker has read every request
it sent.  The last test pins that behaviour.
"""

import asyncio

import pytest

from registrar_tpu_torch.shard import ShardWorker
from registrar_tpu_torch.testing import workload
from registrar_tpu_torch.testing.server import ZKServer
from tests.test_torch_daemon import bindings
from tests.test_torch_wire import body_cases, load_test_module, run_body

#: the reference test files whose bodies run against the port's harness
FILES = (
    "test_netem.py",
    "test_chaos.py",
    "test_overload.py",
)

CASES = [c for f in FILES for c in body_cases(f, harness=True)]


@pytest.mark.parametrize("filename", sorted(FILES))
def test_rebound_file_reaches_the_ported_harness(filename):
    mod = load_test_module(filename, port=True, harness=True)
    assert bindings(mod, "registrar_tpu", harness=True) == []
    homes = {home for _name, home in bindings(mod, "registrar_tpu_torch")}
    assert any(h.startswith("registrar_tpu_torch.testing") for h in homes)


def test_every_file_contributes_bodies():
    assert {c.values[0] for c in CASES} == set(FILES)
    assert len(CASES) >= 20


@pytest.mark.parametrize("filename,qualname,case", CASES)
def test_reference_body_passes_against_the_ported_harness(
    filename, qualname, case, monkeypatch, tmp_path, capsys
):
    fixtures = {"monkeypatch": monkeypatch, "tmp_path": tmp_path,
                "capsys": capsys}
    run_body(load_test_module(filename, port=True, harness=True), qualname,
             fixtures, case)


async def test_slow_loris_is_slow_and_is_cut_loose(tmp_path):
    """Against an armored worker the loris reads a handful of bytes, not
    the worker's replies, and sees the write deadline cut it loose well
    inside its hold; against an unarmored one it holds, and the worker
    answers every request it read."""
    server = await ZKServer().start()
    spec = {"shard": 0, "shards": 1, "servers": [[server.host, server.port]],
            "timeoutMs": 4000, "maxInflightPerConn": 6}
    armored = ShardWorker({**spec, "socket": str(tmp_path / "a.sock"),
                           "writeDeadlineS": 0.3})
    bare = ShardWorker({**spec, "socket": str(tmp_path / "b.sock")})
    try:
        await armored.start()
        await bare.start()
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        out = await workload.slow_loris(
            armored.socket_path, name="absent.loris.example.us",
            frames=20000, hold_s=3.0)
        elapsed = loop.time() - t0
        assert out["disconnected"] and out["written"] == 20000
        assert out["read"] < 100 and elapsed < 3.0
        assert armored.sheds["slow_client"] >= 1
        out = await workload.slow_loris(
            bare.socket_path, name="absent.loris.example.us",
            frames=2000, hold_s=0.5)
        assert not out["disconnected"] and out["read"] > 0
    finally:
        await armored.close()
        await bare.close()
        await server.stop()
