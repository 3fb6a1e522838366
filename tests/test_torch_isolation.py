"""The port stands alone: it never reaches ``registrar_tpu`` or JAX.

Every reference module imports its siblings by absolute path and names
its logger with a string literal, and the package's lazy export map
holds module paths as strings; a copied file that missed one of these
would silently run the reference.  These tests import the whole port in
a fresh interpreter and scan its source, and that of ``chip_smoke.py``,
for any such reference, and run the port's entry points (the daemon,
the shard worker, the CLI, the test ZooKeeper server and the training
dry run's child) to list every module each loads.  They also pin that
``chip_smoke.py`` has no CPU fallback.
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "registrar_tpu_torch")
REF = os.path.join(REPO, "registrar_tpu")
SMOKE = os.path.join(REPO, "chip_smoke.py")

FORBIDDEN_ROOTS = {"registrar_tpu", "jax", "jaxlib"}


def port_files():
    out = []
    for dirpath, _, files in os.walk(PORT):
        out += [
            os.path.relpath(os.path.join(dirpath, f), REPO)
            for f in files
            if f.endswith(".py")
        ]
    return sorted(out)


def port_modules():
    mods = []
    for rel in port_files():
        mod = rel[:-3].replace(os.sep, ".")
        mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return mods


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN_ROOTS


def test_port_has_every_module_of_the_slice():
    assert set(port_modules()) == {
        "registrar_tpu_torch",
        "registrar_tpu_torch.malformed",
        "registrar_tpu_torch.events",
        "registrar_tpu_torch.retry",
        "registrar_tpu_torch.trace",
        "registrar_tpu_torch.records",
        "registrar_tpu_torch.registration",
        "registrar_tpu_torch.health",
        "registrar_tpu_torch.reconcile",
        "registrar_tpu_torch.agent",
        "registrar_tpu_torch.config",
        "registrar_tpu_torch.jlog",
        "registrar_tpu_torch.statefile",
        "registrar_tpu_torch.traceview",
        "registrar_tpu_torch.metrics",
        "registrar_tpu_torch.main",
        "registrar_tpu_torch.binderview",
        "registrar_tpu_torch.zkcache",
        "registrar_tpu_torch.dnsfront",
        "registrar_tpu_torch.shard",
        "registrar_tpu_torch.tools",
        "registrar_tpu_torch.tools.zkcli",
        "registrar_tpu_torch.__main__",
        "registrar_tpu_torch.graft_entry",
        "registrar_tpu_torch.zk",
        "registrar_tpu_torch.zk.jute",
        "registrar_tpu_torch.zk.framing",
        "registrar_tpu_torch.zk.protocol",
        "registrar_tpu_torch.zk.client",
        "registrar_tpu_torch.zk.quota",
        "registrar_tpu_torch.testing",
        "registrar_tpu_torch.testing.netem",
        "registrar_tpu_torch.testing.server",
        "registrar_tpu_torch.testing.workload",
        "registrar_tpu_torch.testing.slo",
    }


@pytest.mark.parametrize("rel", [f for f in port_files() if "graft_entry" not in f])
def test_module_keeps_its_reference_counterpart(rel):
    counterpart = os.path.join(REF, os.path.relpath(os.path.join(REPO, rel), PORT))
    assert os.path.isfile(counterpart), rel


def test_fresh_interpreter_import_leaves_no_reference_or_jax():
    script = (
        "import importlib, json, sys\n"
        f"mods = {port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "pkg = sys.modules['registrar_tpu_torch']\n"
        "exports = {n: m for n, m in pkg._EXPORTS.items()\n"
        "           if getattr(pkg, n) is getattr(sys.modules[m], n)}\n"
        "print(json.dumps({'modules': sorted(sys.modules), 'exports': exports}))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.splitlines()[-1])
    leaked = [m for m in result["modules"] if _forbidden(m)]
    assert leaked == []
    assert set(port_modules()) <= set(result["modules"])
    assert len(result["exports"]) == 21
    for name, module in result["exports"].items():
        assert module.startswith("registrar_tpu_torch."), (name, module)


def _scan(path: str):
    """(imports, string constants, getLogger names) of one source file."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    imports, strings, loggers = [], [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imports += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            imports.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            strings.append(node.value)
        if (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "getLogger"
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            loggers.append(node.args[0].value)
    return imports, strings, loggers


#: the daemon's top-level bunyan ``component``; it names no module
DAEMON_LOGGER = "registrar"


def _names_reference_module(s: str) -> bool:
    return s == "registrar_tpu" or s.startswith("registrar_tpu.")


@pytest.mark.parametrize("rel", port_files())
def test_port_source_names_no_reference_module(rel):
    imports, strings, loggers = _scan(os.path.join(REPO, rel))
    assert [i for i in imports if _forbidden(i)] == []
    # the lazy export map and any other module path held as a string
    assert [s for s in strings if _names_reference_module(s)] == []
    assert all(
        name.startswith("registrar_tpu_torch.") or name == DAEMON_LOGGER
        for name in loggers
    ), loggers


def test_serve_tier_vocabularies_equal_the_reference():
    """The label vocabularies ``metrics`` reads from the port's shard tier
    and DNS frontend equal the reference's, and ``metrics`` takes them
    from the port's modules, not from copies of its own."""
    from registrar_tpu import dnsfront as ref_dnsfront
    from registrar_tpu import shard as ref_shard
    from registrar_tpu_torch import dnsfront, metrics, shard

    assert shard.SHED_REASONS == ref_shard.SHED_REASONS
    assert dnsfront.QTYPE_NAMES == ref_dnsfront.QTYPE_NAMES
    assert dnsfront.SERVED_QTYPES == ref_dnsfront.SERVED_QTYPES
    for name in ("SHED_REASONS", "QTYPE_NAMES", "SERVED_QTYPES"):
        assert not hasattr(metrics, name), name
    registry = metrics.instrument_shards(shard.ShardRouter(
        [("127.0.0.1", 1)], 1, "/nonexistent/resolve.sock"))
    text = registry.render()
    for reason in shard.SHED_REASONS:
        assert f'registrar_shed_total{{reason="{reason}"}} 0' in text
    for qtype in dnsfront.SERVED_QTYPES:
        name = dnsfront.QTYPE_NAMES[qtype]
        assert f'qtype="{name}",rcode="NOERROR"' in text


def _imported_by(argv, **env) -> tuple:
    """(exit code, every module imported, standard output) of ``python3
    -X importtime <argv>`` in a fresh interpreter, with ``env`` added to
    its environment."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", *argv], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, **env), capture_output=True,
        text=True, timeout=60,
    )
    modules = {
        line.rsplit("|", 1)[1].strip()
        for line in proc.stderr.splitlines()[1:]  # below the header
        if line.startswith("import time:")
    }
    return proc.returncode, modules, proc.stdout


#: id -> (interpreter arguments, exit code, a port module it must load).
#: The shard worker, given no spec, loads its whole module and exits 1.
ENTRY_POINTS = {
    "version": (["-m", "registrar_tpu_torch", "--version"], 0,
                "registrar_tpu_torch.main"),
    "check": (["-m", "registrar_tpu_torch", "-f",
               os.path.join(REPO, "etc", "config.example.json"), "-n"], 0,
              "registrar_tpu_torch.main"),
    "shard_worker": (["-m", "registrar_tpu_torch.shard"], 1,
                     "registrar_tpu_torch.dnsfront"),
    "zkcli_help": (["-m", "registrar_tpu_torch.tools.zkcli", "--help"], 0,
                   "registrar_tpu_torch.binderview"),
    "zk_server_help": (["-m", "registrar_tpu_torch.testing.server", "--help"],
                       0, "registrar_tpu_torch.zk.quota"),
}


@pytest.mark.parametrize("args", sorted(ENTRY_POINTS))
def test_daemon_entry_point_loads_no_reference_jax_or_torch(args):
    argv, expected_rc, loaded = ENTRY_POINTS[args]
    rc, modules, _ = _imported_by(argv)
    assert rc == expected_rc
    assert loaded in modules
    assert [m for m in modules if m.split(".")[0] in (*FORBIDDEN_ROOTS, "torch")] == []


def test_graft_entry_child_loads_no_reference_or_jax():
    """The training dry run's child, launched by path as
    ``dryrun_multichip`` launches it, runs one gloo rank on torch alone."""
    script = os.path.join(PORT, "graft_entry.py")
    rc, modules, out = _imported_by(
        [script, "--dryrun-child", "1"],
        PYTHONSAFEPATH="1", GRAFT_DRYRUN_DEVICE="cpu", OMP_NUM_THREADS="1",
    )
    assert rc == 0
    assert out.startswith("DRYRUN_OK n=1 dp=1 tp=1 ")
    assert {"torch", "torch.distributed", "torch.multiprocessing"} <= modules
    assert [m for m in modules if _forbidden(m)] == []
    assert not any(m.startswith("registrar_tpu_torch") for m in modules)


def test_chip_smoke_imports_neither_reference_nor_jax():
    imports, strings, _ = _scan(SMOKE)
    assert [i for i in imports if _forbidden(i)] == []
    assert {i.split(".")[0] for i in imports} <= {
        "registrar_tpu_torch", "torch", "numpy", *sys.stdlib_module_names
    }
    # it spawns, imports and names no reference module at all
    assert [s for s in strings if _names_reference_module(s)] == []
    with open(SMOKE) as fh:
        assert re.search(r"\bregistrar_tpu\b(?!_)", fh.read()) is None


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py")], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_has_no_cpu_fallback():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert '"kernels"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
