"""The port's daemon slice held against the reference's own tests.

Every test body of the reference's tests for ``jlog``, ``config``,
``statefile``, ``traceview``, ``metrics`` and ``main``, and the
all-options daemon of ``tests/test_e2e_options.py``, runs against the
port: each file is executed with every module the port has rebound to
``registrar_tpu_torch`` (``tests/test_torch_wire.py``), so
``python3 -m registrar_tpu`` in a body becomes ``python3 -m
registrar_tpu_torch`` and the subprocess cases drive the port's daemon.
The test server (``registrar_tpu.testing.server``) stays the reference's:
it is the peer the port is checked against.  A parametrized body runs
once per case.  A coroutine body has 60 s; a subprocess body has its own
``timeout`` or ``wait`` limit.  No body is left out.
"""

import dataclasses
import json
import os
import time
import types

import pytest

from registrar_tpu import statefile as ref_statefile
from registrar_tpu_torch import statefile as port_statefile
from registrar_tpu.config import load_config as ref_load_config
from registrar_tpu_torch.config import load_config as port_load_config
from tests.test_torch_wire import body_cases, load_test_module, run_body

#: the reference test files whose bodies run against the port
FILES = (
    "test_jlog.py",
    "test_config.py",
    "test_statefile.py",
    "test_traceview.py",
    "test_metrics.py",
    "test_main.py",
    "test_e2e_options.py",
)

CASES = [c for f in FILES for c in body_cases(f)]
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "etc",
                       "config.example.json")


def bindings(mod, package: str, harness: bool = False) -> list:
    """Names in a rebound test module bound to a module of ``package``, or
    to a function or class defined in one.  Unless ``harness`` is set the
    reference's test harness (``registrar_tpu.testing``), the peer of a
    client-side body, is left out."""
    out = []
    for name, value in vars(mod).items():
        home = (
            value.__name__ if isinstance(value, types.ModuleType)
            else getattr(value, "__module__", None)
        )
        if (
            isinstance(home, str)
            and home.split(".")[0] == package
            and (harness or not home.startswith("registrar_tpu.testing"))
        ):
            out.append((name, home))
    return out


@pytest.mark.parametrize("filename", sorted(FILES))
def test_rebound_file_reaches_the_port(filename):
    mod = load_test_module(filename, port=True)
    assert bindings(mod, "registrar_tpu") == []
    assert bindings(mod, "registrar_tpu_torch") != []


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_statefile_is_shared_with_the_reference(writer, tmp_path):
    """One format and one fingerprint: a state file either package
    writes, the other loads field for field and finds resumable."""
    ref, port = ref_statefile, port_statefile
    assert port.FORMAT == ref.FORMAT == "registrar-statefile-v1"
    with open(EXAMPLE) as fh:
        example = json.load(fh)
    for chroot in ("", example["zookeeper"]["chroot"]):
        assert port.config_fingerprint(
            example["registration"], example["adminIp"], chroot
        ) == ref.config_fingerprint(
            example["registration"], example["adminIp"], chroot
        )
    fingerprint = ref.config_fingerprint(
        example["registration"], example["adminIp"], ""
    )
    save, load = (ref, port) if writer == "ref" else (port, ref)
    path = str(tmp_path / "state.json")
    save.save(path, save.SessionState(
        session_id=0x6AD29D50000002, passwd=bytes(range(16)),
        negotiated_timeout_ms=30000, last_zxid=0x1F, chroot="",
        config_hash=fingerprint, znodes=["/com/example/us-east/myservice/vm"],
        pid=4242, stamp=time.time(),
    ))
    state = load.load(path)
    assert vars(state) == vars(save.load(path))
    assert load.check_resumable(state, fingerprint) is None


def test_example_config_loads_alike():
    """Every block of etc/config.example.json, serve, cache and
    observability included, parses to the same values in both packages."""
    assert dataclasses.asdict(port_load_config(EXAMPLE)) == dataclasses.asdict(
        ref_load_config(EXAMPLE)
    )


def test_every_file_contributes_bodies():
    assert {c.values[0] for c in CASES} == set(FILES)
    assert len(CASES) > 150


@pytest.mark.parametrize("filename,qualname,case", CASES)
def test_reference_body_passes_against_the_port(
    filename, qualname, case, monkeypatch, tmp_path, capsys, caplog
):
    fixtures = {
        "monkeypatch": monkeypatch, "tmp_path": tmp_path,
        "capsys": capsys, "caplog": caplog,
    }
    run_body(load_test_module(filename, port=True), qualname, fixtures, case)
