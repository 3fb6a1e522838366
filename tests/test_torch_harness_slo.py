"""The port's availability harness held against the reference's own tests.

Every test body of ``tests/test_slo.py`` (the SLO math, the harness's
probe and fault attribution, the ensemble and shard scenarios, the
metrics it feeds) runs with every module the port has rebound to
``registrar_tpu_torch``, the test harness included: the port's
``SLOHarness`` over the port's ensemble, proxies and shard tier.  No
body is left out.  Beside them, one seed must give one scenario
schedule in both packages' harnesses.
"""

import pytest

from tests.test_torch_daemon import bindings
from tests.test_torch_wire import body_cases, load_test_module, run_body

#: the reference test files whose bodies run against the port's harness
FILES = (
    "test_slo.py",
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
    assert len(CASES) >= 30


@pytest.mark.parametrize("filename,qualname,case", CASES)
def test_reference_body_passes_against_the_ported_harness(
    filename, qualname, case, monkeypatch, tmp_path, capsys
):
    fixtures = {"monkeypatch": monkeypatch, "tmp_path": tmp_path,
                "capsys": capsys}
    run_body(load_test_module(filename, port=True, harness=True), qualname,
             fixtures, case)


# --- one seed, one schedule, in both packages --------------------------------

#: scenarios whose draws (members, victims, order) come from the seed
SCHEDULE = (
    ("deploy-wave", {"wave": 2, "down_s": 0.05}),
    ("crash-loop", {"crashes": 2, "restart_delay": 0.05}),
    ("expiry-storm", {"victims": 2, "restart_delay": 0.05}),
    ("health-flap", {"flaps": 1, "down_s": 0.05}),
    ("netem-episode", {"episodes": 1}),
)


async def _schedule(slo_module, seed: int):
    harness = slo_module.SLOHarness(
        members=4, seed=seed, probe_interval=0.02, session_timeout_ms=400,
    )
    await harness.start()
    try:
        for fault_id, kwargs in SCHEDULE:
            await harness.run_scenario(fault_id, **kwargs)
            await harness.settle(0.05)
    finally:
        await harness.stop()
    return (
        [(f.fault, f.member) for f in harness.faults],
        [fid for fid, _start, _end in harness.segments],
        harness.rng.random(),  # the same number of draws, in the same order
    )


@pytest.mark.parametrize("seed", [7, 1234])
async def test_same_seed_same_schedule_in_both_packages(seed):
    from registrar_tpu.testing import slo as ref_slo
    from registrar_tpu_torch.testing import slo as port_slo

    ref = await _schedule(ref_slo, seed)
    port = await _schedule(port_slo, seed)
    assert port == ref
    assert [fid for fid, _ in SCHEDULE] == ref[1]
    members = {m for _f, m in ref[0] if m is not None}
    assert len(ref[0]) >= 8 and len(members) > 1


def test_traces_and_catalog_match_the_reference():
    from registrar_tpu.testing import slo as ref_slo
    from registrar_tpu_torch.testing import slo as port_slo

    assert port_slo.FAULT_IDS == ref_slo.FAULT_IDS
    assert port_slo.TRACES == ref_slo.TRACES
