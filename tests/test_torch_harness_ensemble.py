"""The port's ZooKeeper ensemble held against the reference's own tests.

Every test body of ``tests/test_ensemble.py`` (replication, sync
barrier, elections, quorum loss, read-only mode, rolling restarts, a
real daemon riding member deaths) and ``tests/test_soak.py`` runs with
every module the port has rebound to ``registrar_tpu_torch``, the test
harness included: the port's clients and daemon against the port's
``ZKEnsemble``.  No body is left out.
"""

import pytest

from tests.test_torch_daemon import bindings
from tests.test_torch_wire import body_cases, load_test_module, run_body

#: the reference test files whose bodies run against the port's harness
FILES = (
    "test_ensemble.py",
    "test_soak.py",
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
    assert len(CASES) >= 45


@pytest.mark.parametrize("filename,qualname,case", CASES)
def test_reference_body_passes_against_the_ported_harness(
    filename, qualname, case, monkeypatch, tmp_path, capsys
):
    fixtures = {"monkeypatch": monkeypatch, "tmp_path": tmp_path,
                "capsys": capsys}
    run_body(load_test_module(filename, port=True, harness=True), qualname,
             fixtures, case)
