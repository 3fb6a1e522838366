"""The port's ZooKeeper server held against the reference's own tests.

Every test body of the reference's tests for the hermetic server's
surfaces (ACLs and auth, the four-letter admin words and ``zkcli
admin``, chroot, ``multi`` transactions, snapshots and the standalone
``python3 -m registrar_tpu_torch.testing.server`` CLI) runs with every
module the port has rebound to ``registrar_tpu_torch``, the test
harness included (``tests/test_torch_wire.py``, ``harness=True``): the
port's client against the port's server.  A coroutine body has 60 s; a
subprocess body has its own limit.  No body is left out.
"""

import pytest

from tests.test_torch_daemon import bindings
from tests.test_torch_wire import body_cases, load_test_module, run_body

#: the reference test files whose bodies run against the port's harness
FILES = (
    "test_acl.py",
    "test_admin_4lw.py",
    "test_chroot.py",
    "test_multi.py",
    "test_snapshot.py",
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
    assert len(CASES) >= 70


@pytest.mark.parametrize("filename,qualname,case", CASES)
def test_reference_body_passes_against_the_ported_harness(
    filename, qualname, case, monkeypatch, tmp_path, capsys
):
    fixtures = {"monkeypatch": monkeypatch, "tmp_path": tmp_path,
                "capsys": capsys}
    run_body(load_test_module(filename, port=True, harness=True), qualname,
             fixtures, case)


# --- a stop that no peer can hold open ---------------------------------------


async def test_stop_aborts_a_peer_that_stops_reading():
    """``ZKServer.stop`` (and so ``ZKEnsemble.kill``) returns although a
    peer has stopped reading with replies still queued to it, as a netem
    proxy does under a stall toxic.  Closing such a transport waits on a
    flush that never comes, and asyncio's ``wait_closed`` on the
    connection; the port's server aborts it after a short grace."""
    import asyncio
    import struct
    import time

    from registrar_tpu_torch.testing.server import _STOP_FLUSH_S, ZKServer
    from registrar_tpu_torch.zk.client import ZKClient

    def frame(body: bytes) -> bytes:
        return struct.pack(">i", len(body)) + body

    server = ZKServer()
    await server.start()
    client = await ZKClient([("127.0.0.1", server.port)]).connect()
    await client.create("/big", b"x" * 1_000_000)
    await client.close()
    reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
    try:
        # ConnectRequest: protocol 0, zxid 0, timeout 30 s, session 0,
        # a zeroed 16-byte password, not read-only.
        writer.write(frame(struct.pack(">iqiqi", 0, 0, 30000, 0, 16)
                           + b"\0" * 17))
        length = struct.unpack(">i", await reader.readexactly(4))[0]
        await reader.readexactly(length)
        # 50 pipelined GET_DATA of the 1 MB node, none of them read.
        path = b"/big"
        for xid in range(1, 51):
            writer.write(frame(struct.pack(">ii", xid, 4)
                               + struct.pack(">i", len(path)) + path + b"\0"))
        await writer.drain()
        await asyncio.sleep(0.3)
        t = time.monotonic()
        await asyncio.wait_for(server.stop(), timeout=10)
        assert time.monotonic() - t < _STOP_FLUSH_S + 2.0
    finally:
        writer.transport.abort()
