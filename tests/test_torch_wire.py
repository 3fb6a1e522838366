"""The port's wire codec held against the reference, capture by capture.

Three differential checks, each on the same inputs through both
packages:

* every golden test body in ``tests/test_wire_golden.py``,
  ``tests/test_framing.py`` and the zk-surface goldens of
  ``tests/test_malformed.py`` runs twice: once as written (bound to
  ``registrar_tpu``) and once with every ported module rebound to
  ``registrar_tpu_torch``.  Both bindings must pass, so the port encodes
  the same hand-derived bytes, decodes the same fields, and rejects with
  the same error classes and malformed tallies;
* every golden frame those bodies build is decoded as every jute record
  type by both packages, whole and truncated: the same fields (or the
  same error class and message), the same reader position, the same
  re-encoded bytes and the same malformed tally;
* ``FrameReader`` carves or rejects identically in both packages under
  arbitrary chunk cuts (seeded cuts and hypothesis, as
  ``tests/test_fuzz.py`` uses it).
"""

import ast
import asyncio
import dataclasses
import inspect
import os
import random
import re
import sys
import types

import pytest

from registrar_tpu import malformed as ref_malformed
from registrar_tpu.zk import framing as ref_framing
from registrar_tpu.zk import jute as ref_jute
from registrar_tpu.zk import protocol as ref_proto
from registrar_tpu_torch import malformed as port_malformed
from registrar_tpu_torch.zk import framing as port_framing
from registrar_tpu_torch.zk import jute as port_jute
from registrar_tpu_torch.zk import protocol as port_proto

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - the property case reports a skip
    given = None

TESTS = os.path.dirname(os.path.abspath(__file__))
PORT_DIR = os.path.join(os.path.dirname(TESTS), "registrar_tpu_torch")
REF_DIR = os.path.join(os.path.dirname(TESTS), "registrar_tpu")

_REF_NAME = re.compile(r"\bregistrar_tpu((?:\.\w+)*)\b(?!_)")


def _module_depth(root: str, parts) -> int:
    """How many leading ``parts`` name a module or package under ``root``."""
    for n in range(len(parts), 0, -1):
        base = os.path.join(root, *parts[:n])
        if os.path.isfile(base + ".py") or os.path.isfile(
            os.path.join(base, "__init__.py")
        ):
            return n
    return 0


#: The reference's test harness package (ZooKeeper server, netem, storm
#: workload, SLO harness), relative to ``registrar_tpu``.
HARNESS = "testing"


def _rebind_source(source: str, harness: bool = False, client: bool = True) -> str:
    """Point every reference module that the port has at the port.  The
    test harness (``registrar_tpu.testing``) stays the reference's unless
    ``harness`` is set: for a client-side body it is the peer the port is
    checked against; a harness body runs against the port's own.  With
    ``client`` unset only the harness moves: the reference's client
    against the port's server."""

    def swap(m):
        parts = [p for p in m.group(1).split(".") if p]
        module = parts[: _module_depth(REF_DIR, parts)]
        if _module_depth(PORT_DIR, module) != len(module):
            return m.group(0)
        moves = harness if module[:1] == [HARNESS] else client
        return "registrar_tpu_torch" + m.group(1) if moves else m.group(0)

    return _REF_NAME.sub(swap, source)


_LOADED = {}


def load_test_module(
    filename: str, port: bool, harness: bool = False
) -> types.ModuleType:
    """``tests/<filename>`` executed as a fresh module: its ported
    client-side imports rebound to ``registrar_tpu_torch`` when ``port``
    is set, its test-harness imports when ``harness`` is set."""
    key = (filename, port, harness)
    if key not in _LOADED:
        path = os.path.join(TESTS, filename)
        with open(path) as fh:
            source = fh.read()
        if port or harness:
            source = _rebind_source(source, harness=harness, client=port)
        binding = ("ref", "port", "refclient", "harness")[port + 2 * harness]
        name = f"_{binding}_bound_{filename[:-3]}"
        mod = types.ModuleType(name)
        mod.__file__ = path
        sys.modules[name] = mod
        exec(compile(source, path, "exec"), mod.__dict__)
        _LOADED[key] = mod
    return _LOADED[key]


def _calls(node, name: str) -> bool:
    return any(
        isinstance(n, ast.Call) and getattr(n.func, "id", None) == name
        for n in ast.walk(node)
    )


def _test_names(filename: str, only=None, exclude=(), calling=None):
    """``name`` / ``Class.name`` of every test in a file, from its AST;
    with ``calling``, only the module-level tests that call that name."""
    with open(os.path.join(TESTS, filename)) as fh:
        tree = ast.parse(fh.read())
    out = []
    fn_types = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in tree.body:
        if isinstance(node, fn_types) and node.name.startswith("test"):
            if calling is None or _calls(node, calling):
                out.append(node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            if calling is not None or (only is not None and node.name not in only):
                continue
            out.extend(
                f"{node.name}.{m.name}"
                for m in node.body
                if isinstance(m, fn_types) and m.name.startswith("test")
            )
    return [n for n in out if n not in exclude]


def _body(mod, qualname: str):
    cls_name, _, fn_name = qualname.rpartition(".")
    return getattr(getattr(mod, cls_name)(), fn_name) if cls_name else getattr(
        mod, fn_name
    )


def param_sets(fn) -> list:
    """The arguments of every case of a body's ``pytest.mark.parametrize``
    marks, one dict per case (one empty dict for an unparametrized body)."""
    sets = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[:2]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        rows = [
            v.values if isinstance(v, type(pytest.param())) else
            tuple(v) if len(names) > 1 else (v,)
            for v in values
        ]
        sets = [{**s, **dict(zip(names, r))} for s in sets for r in rows]
    return sets


def body_cases(filename: str, exclude=(), only=None, harness=False,
               port=True) -> list:
    """A ``pytest.param(filename, qualname, case)`` for every test body of
    a reference file bound to the port (of the classes in ``only``, when
    given), a parametrized body once per case."""
    mod = load_test_module(filename, port=port, harness=harness)
    out = []
    for qualname in _test_names(filename, only=only, exclude=exclude):
        n = len(param_sets(_body(mod, qualname)))
        name = f"{filename[5:-3]}::{qualname}"
        out += [
            pytest.param(filename, qualname, case,
                         id=f"{name}[{case}]" if n > 1 else name)
            for case in range(n)
        ]
    return out


def run_body(mod, qualname: str, fixtures: dict, case: int = 0) -> None:
    """Run one case of one test body, with a 60 s limit on a coroutine."""
    fn = _body(mod, qualname)
    fixtures = {**fixtures, **param_sets(fn)[case]}
    kwargs = {
        name: fixtures[name] for name in inspect.signature(fn).parameters
    }
    if inspect.iscoroutinefunction(fn):
        asyncio.run(asyncio.wait_for(fn(**kwargs), timeout=60))
    else:
        fn(**kwargs)


GOLDEN_BODIES = (
    [("test_wire_golden.py", n) for n in _test_names("test_wire_golden.py")]
    + [("test_framing.py", n) for n in _test_names("test_framing.py")]
    + [
        ("test_malformed.py", n)
        for n in _test_names(
            "test_malformed.py",
            only={"TestJuteGoldens", "TestFramingGoldens", "TestTally"},
        )
    ]
)


REBIND_SAMPLE = (
    "from registrar_tpu.zk.protocol import Stat\n"
    "from registrar_tpu import malformed\n"
    "from registrar_tpu.testing.server import ZKServer\n"
    "from registrar_tpu.shard import ShardError\n"
    "from registrar_tpu.testing import workload\n"
    "cmd = ['-m', 'registrar_tpu.testing.server', '--port', '0']\n"
    "x = 'registrar_tpu.agent.HEARTBEAT_FAILURE_BACKOFF_S'\n"
    "y = 'registrar_tpu_torch.agent'\n"
)


def test_rebinding_reaches_every_ported_module():
    """Client-side bodies: every ported module goes to the port, the test
    harness stays the reference's (the peer)."""
    assert _rebind_source(REBIND_SAMPLE).splitlines() == [
        "from registrar_tpu_torch.zk.protocol import Stat",
        "from registrar_tpu_torch import malformed",
        "from registrar_tpu.testing.server import ZKServer",
        "from registrar_tpu_torch.shard import ShardError",
        "from registrar_tpu.testing import workload",
        "cmd = ['-m', 'registrar_tpu.testing.server', '--port', '0']",
        "x = 'registrar_tpu_torch.agent.HEARTBEAT_FAILURE_BACKOFF_S'",
        "y = 'registrar_tpu_torch.agent'",
    ]


def test_harness_only_rebinding_keeps_the_reference_client():
    """Cross-runs: the reference's client against the port's harness."""
    assert _rebind_source(REBIND_SAMPLE, harness=True, client=False).splitlines() == [
        "from registrar_tpu.zk.protocol import Stat",
        "from registrar_tpu import malformed",
        "from registrar_tpu_torch.testing.server import ZKServer",
        "from registrar_tpu.shard import ShardError",
        "from registrar_tpu_torch.testing import workload",
        "cmd = ['-m', 'registrar_tpu_torch.testing.server', '--port', '0']",
        "x = 'registrar_tpu.agent.HEARTBEAT_FAILURE_BACKOFF_S'",
        "y = 'registrar_tpu_torch.agent'",
    ]


def test_harness_rebinding_reaches_the_ported_harness():
    """Harness bodies: the test harness goes to the port as well."""
    assert _rebind_source(REBIND_SAMPLE, harness=True).splitlines() == [
        "from registrar_tpu_torch.zk.protocol import Stat",
        "from registrar_tpu_torch import malformed",
        "from registrar_tpu_torch.testing.server import ZKServer",
        "from registrar_tpu_torch.shard import ShardError",
        "from registrar_tpu_torch.testing import workload",
        "cmd = ['-m', 'registrar_tpu_torch.testing.server', '--port', '0']",
        "x = 'registrar_tpu_torch.agent.HEARTBEAT_FAILURE_BACKOFF_S'",
        "y = 'registrar_tpu_torch.agent'",
    ]


@pytest.mark.parametrize(
    "filename,qualname", GOLDEN_BODIES, ids=[f"{f[5:-3]}::{q}" for f, q in GOLDEN_BODIES]
)
def test_golden_body_passes_in_both_packages(
    filename, qualname, monkeypatch, tmp_path
):
    fixtures = {"monkeypatch": monkeypatch, "tmp_path": tmp_path}
    ref_mod = load_test_module(filename, port=False)
    port_mod = load_test_module(filename, port=True)
    # The port binding really reaches the port's codec.
    if hasattr(port_mod, "Reader"):
        assert port_mod.Reader is port_jute.Reader
    if hasattr(port_mod, "FrameReader"):
        assert port_mod.FrameReader is port_framing.FrameReader
    run_body(ref_mod, qualname, fixtures)
    run_body(port_mod, qualname, fixtures)


# --- every golden capture decoded by both packages ---------------------------


def _record_types(proto):
    return {
        name: obj
        for name, obj in vars(proto).items()
        if isinstance(obj, type)
        and dataclasses.is_dataclass(obj)
        and hasattr(obj, "read")
    }


REF_RECORDS = _record_types(ref_proto)
PORT_RECORDS = _record_types(port_proto)


def plain(value):
    """A package-neutral form of a decoded value: records become
    (class name, fields), views become bytes."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (
            type(value).__name__,
            {f.name: plain(getattr(value, f.name)) for f in dataclasses.fields(value)},
        )
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, (bytearray, memoryview)):
        return bytes(value)
    return value


def decode(proto, jute, malformed, record: str, data: bytes):
    """Everything observable about decoding ``data`` as ``record``."""
    records = REF_RECORDS if proto is ref_proto else PORT_RECORDS
    before = malformed.counts()
    r = jute.Reader(data)
    try:
        obj = records[record].read(r)
    except Exception as err:  # noqa: BLE001 - the class is the result
        outcome = ("raise", type(err).__name__, str(err))
    else:
        w = jute.Writer()
        try:
            obj.write(w)
            encoded = w.to_bytes()
        except Exception as err:  # noqa: BLE001 - the class is the result
            encoded = ("raise", type(err).__name__, str(err))
        outcome = ("ok", plain(obj), r.pos, encoded)
    after = malformed.counts()
    tally = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return outcome, tally


def _captures(filename: str, qualname: str):
    """The golden byte strings one test body builds (through its ``hx``
    helper), collected while the body runs against the port."""
    mod = load_test_module(filename, port=True)
    seen = []
    real_hx = mod.hx

    def recording_hx(*parts):
        out = real_hx(*parts)
        seen.append(out)
        return out

    mod.hx = recording_hx
    try:
        run_body(mod, qualname, {})
    finally:
        mod.hx = real_hx
    return seen


WIRE_BODIES = _test_names("test_wire_golden.py", calling="hx")


def test_record_types_match():
    assert sorted(REF_RECORDS) == sorted(PORT_RECORDS)
    assert len(REF_RECORDS) >= 30


@pytest.mark.parametrize("qualname", WIRE_BODIES)
def test_golden_captures_decode_identically(qualname):
    captures = _captures("test_wire_golden.py", qualname)
    assert captures, "the body builds no golden frame"
    checked = 0
    for frame_bytes in captures:
        # After the length prefix, after a request header, after a
        # reply header; each whole and cut short by one byte.
        for start in (4, 12, 20):
            for end in (len(frame_bytes), len(frame_bytes) - 1):
                data = frame_bytes[start:end]
                if not data:
                    continue
                for record in REF_RECORDS:
                    ref = decode(ref_proto, ref_jute, ref_malformed, record, data)
                    port = decode(
                        port_proto, port_jute, port_malformed, record, data
                    )
                    assert port == ref, (record, data.hex())
                    checked += 1
    assert checked > 0


# --- FrameReader under arbitrary chunk cuts ---------------------------------


class _Scripted:
    def __init__(self, chunks):
        self._chunks = [c for c in chunks if c]

    async def read(self, _n):
        return self._chunks.pop(0) if self._chunks else b""


def carve_all(framing, malformed, chunks):
    """Carved frames (and the raise, if any) of a chunked stream."""
    before = malformed.counts()["zk_framing"]
    fr = framing.FrameReader(_Scripted(chunks))
    carved = []

    async def go():
        while await fr.fill():
            carved.append([bytes(f) for f in fr.carve()])

    try:
        asyncio.run(go())
        error = None
    except ConnectionError as err:
        error = (type(err).__name__, str(err))
    return carved, error, malformed.counts()["zk_framing"] - before


def _frame(payload: bytes) -> bytes:
    return len(payload).to_bytes(4, "big") + payload


def _cut(wire: bytes, cuts):
    points = sorted({min(c, len(wire)) for c in cuts})
    bounds = [0, *points, len(wire)]
    return [wire[a:b] for a, b in zip(bounds, bounds[1:])]


def _assert_same_carving(chunks):
    ref = carve_all(ref_framing, ref_malformed, chunks)
    port = carve_all(port_framing, port_malformed, chunks)
    assert port == ref


# The cut cases of tests/test_framing.py, plus corrupt-length tails.
FRAMING_STREAMS = {
    "burst": _frame(b"one") + _frame(b"two") + _frame(b""),
    "split": _frame(b"split-payload"),
    "partial_tail": _frame(b"whole") + _frame(b"partial")[:6],
    "negative_length": (-1).to_bytes(4, "big", signed=True),
    "oversized_length": (ref_framing.MAX_FRAME + 1).to_bytes(4, "big"),
    "max_length_prefix": ref_framing.MAX_FRAME.to_bytes(4, "big") + b"x" * 8,
    "frames_then_bad_length": _frame(b"a") + _frame(b"bb")
    + (-3).to_bytes(4, "big", signed=True) + b"xx",
    "large_burst": b"".join(_frame(b"p" * 84) for _ in range(200)),
}


@pytest.mark.parametrize("name", sorted(FRAMING_STREAMS))
def test_framing_carves_identically_under_every_cut(name):
    wire = FRAMING_STREAMS[name]
    if len(wire) <= 64:
        # every single cut point, then every pair
        for a in range(len(wire) + 1):
            _assert_same_carving(_cut(wire, [a]))
            for b in range(a, len(wire) + 1, 3):
                _assert_same_carving(_cut(wire, [a, b]))
    else:
        rng = random.Random(1234)
        for _ in range(200):
            cuts = [rng.randrange(len(wire) + 1) for _ in range(rng.randrange(1, 8))]
            _assert_same_carving(_cut(wire, cuts))


if given is not None:

    @given(
        st.lists(st.binary(max_size=32), max_size=4),
        st.binary(max_size=16),
        st.lists(st.integers(0, 160), max_size=4),
    )
    @settings(max_examples=200, deadline=None)
    def test_framing_carve_or_reject_matches_reference(payloads, garbage, cuts):
        wire = b"".join(_frame(p) for p in payloads) + garbage
        _assert_same_carving(_cut(wire, cuts))

else:  # pragma: no cover - hypothesis ships with the test extras

    def test_framing_carve_or_reject_matches_reference():
        pytest.skip("hypothesis not installed")
