"""The port's training step held against ``__graft_entry__.py``'s.

JAX's ``_init_params(PRNGKey(0))`` weights are carried across with
``params_from_jax``; the same inputs, made from a seed with numpy, go
through JAX's jitted ``value_and_grad`` step and the port's
``train_step`` on the CPU.

Tolerances:

* the loss within ``graft_entry.LOSS_RTOL = 2**-6`` relative.  XLA may
  keep the prediction in float32 where the port rounds it to bf16 (and
  the dry run's row-parallel sum rounds each partial product too): each
  rounding moves a prediction by at most 2**-8 relative and the squared
  error by twice that, two roundings at most;
* the gradients within ``graft_entry.GRAD_RTOL = 2**-5`` of the
  largest element of JAX's gradient of that weight (``grad_error``).
  The update ``0.01 * g`` is about 2**-10 of a weight, so rounding the
  new weight to bf16 drops most of it: the updated weights are checked
  for dtype and for the SGD rule applied to the port's own gradients,
  and the gradients carry the comparison.

The dry run's seams (deadline, failed child, device rules) are tested
here with stub children; its gloo runs are in
``tests/test_torch_train_mesh.py``.
"""

import os
import time

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from registrar_tpu_torch import graft_entry as g

LOSS_RTOL = g.LOSS_RTOL


def _jax_step():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    def loss_fn(params, x, y):
        pred = jax_entry._forward(jnp, params, x)
        return jnp.mean((pred.astype(jnp.float32) - y) ** 2)

    @jax.jit
    def step(params, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        params = jax.tree.map(
            lambda p, gr: p - 0.01 * gr.astype(p.dtype), params, grads
        )
        return params, loss, grads

    return jax, jnp, step


def _inputs(case: int, rows: int = g.BATCH):
    """Case 0: the dry run's ``x = ones``, ``y = zeros``; the others
    seeded normal inputs and targets."""
    if case == 0:
        return (np.ones((rows, g.DIN), np.float32),
                np.zeros((rows, g.DOUT), np.float32))
    rng = np.random.default_rng(1234 + case)
    x = rng.standard_normal((rows, g.DIN)).astype(np.float32)
    y = 0.1 * rng.standard_normal((rows, g.DOUT)).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def jax_case():
    jax, jnp, step = _jax_step()
    params = jax_entry._init_params(jax, jnp, jax.random.PRNGKey(0))
    outs = []
    for case in range(4):
        x, y = _inputs(case)
        new, loss, grads = step(
            params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(y)
        )
        outs.append((
            {k: np.asarray(v, np.float32) for k, v in new.items()},
            float(loss),
            {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in grads.items()},
        ))
    # The dry run's weights (dryrun_params) through JAX's step: x = ones,
    # so the loss is the same for every n.
    rows = g.DRYRUN_ROWS_PER_DP
    dry = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
           for k, v in g.dryrun_params().items()}
    _, dry_loss, _ = step(
        dry,
        jnp.ones((rows, g.DIN), jnp.bfloat16),
        jnp.zeros((rows, g.DOUT), jnp.float32),
    )
    host = {k: np.asarray(v) for k, v in params.items()}
    return host, outs, float(dry_loss)


def _sgd_applied(new, params, grads) -> None:
    """``new`` is ``p - 0.01 * g`` in bf16 for the port's own ``g``."""
    for name in ("w1", "w2"):
        assert new[name].dtype == torch.bfloat16
        assert new[name].shape == params[name].shape
        assert not new[name].requires_grad
        want = params[name] - 0.01 * grads[name].to(torch.bfloat16)
        assert torch.equal(new[name], want)


@pytest.mark.parametrize("case", range(4), ids=["ones", "seed1", "seed2", "seed3"])
def test_train_step_matches_jax(jax_case, case):
    params, outs, _ = jax_case
    want_params, want_loss, want_grads = outs[case]
    x, y = _inputs(case)
    tp = g.params_from_jax(params)
    xb, yt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(y)
    new, loss = g.train_step(tp, xb, yt)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert loss.item() == pytest.approx(want_loss, rel=LOSS_RTOL)
    grad_loss, grads = g.loss_and_grads(tp, xb, yt)
    assert torch.equal(grad_loss, loss)
    for name in ("w1", "w2"):
        assert grads[name].dtype == torch.bfloat16
        assert want_params[name].shape == tuple(new[name].shape)
    assert g.grad_error(grads, want_grads) <= g.GRAD_RTOL
    _sgd_applied(new, tp, grads)


@pytest.mark.parametrize("factor", [0.0, 0.5, 2.0, -1.0])
def test_grad_check_fails_a_wrong_gradient(jax_case, factor):
    """The gradient check tells a right step from one whose gradient is
    zero, halved, doubled (a backward that all-reduces a replicated loss
    again) or of the wrong sign."""
    params, outs, _ = jax_case
    _, _, want_grads = outs[1]
    x, y = _inputs(1)
    _, grads = g.loss_and_grads(
        g.params_from_jax(params), torch.from_numpy(x).bfloat16(),
        torch.from_numpy(y),
    )
    assert g.grad_error(grads, want_grads) <= g.GRAD_RTOL
    wrong = {k: v * factor for k, v in grads.items()}
    assert g.grad_error(wrong, want_grads) > 8 * g.GRAD_RTOL


def test_train_step_changes_the_weights_and_leaves_the_inputs(jax_case):
    params, _, _ = jax_case
    tp = g.params_from_jax(params)
    before = {k: v.clone() for k, v in tp.items()}
    x, y = _inputs(1)
    new, _ = g.train_step(tp, torch.from_numpy(x).bfloat16(), torch.from_numpy(y))
    for name in ("w1", "w2"):
        assert torch.equal(tp[name], before[name])
        assert not torch.equal(new[name], tp[name])


@pytest.mark.parametrize("case", range(4), ids=["ones", "seed1", "seed2", "seed3"])
def test_bf16_step_is_close_to_the_fp32_reference(jax_case, case):
    params, _, _ = jax_case
    tp = g.params_from_jax(params)
    x, y = _inputs(case)
    xb, yt = torch.from_numpy(x).bfloat16(), torch.from_numpy(y)
    loss, grads = g.loss_and_grads(tp, xb, yt)
    ref_loss, ref_grads = g.loss_and_grads_reference(tp, xb, yt)
    assert ref_loss.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in ref_grads.values())
    assert loss.item() == pytest.approx(ref_loss.item(), rel=LOSS_RTOL)
    assert g.grad_error(grads, ref_grads) <= g.GRAD_RTOL
    ref, step_loss = g.train_step_reference(tp, xb, yt)
    assert torch.equal(step_loss, ref_loss)
    for name in ("w1", "w2"):
        assert ref[name].dtype == torch.float32
        # in float32 the update survives: new - old is 0.01 * g
        torch.testing.assert_close(
            tp[name].float() - ref[name], 0.01 * ref_grads[name],
            rtol=2.0**-10, atol=1e-8,
        )


def test_loss_fn_casts_the_prediction_up():
    params = g.dryrun_params()
    x = torch.ones((4, g.DIN), dtype=torch.bfloat16)
    y = torch.zeros((4, g.DOUT))
    loss = g.loss_fn(params, x, y)
    assert loss.dtype == torch.float32
    pred = g.forward(params, x).float()
    assert loss.item() == pytest.approx(torch.mean(pred**2).item(), rel=1e-6)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_matches_the_reference(n):
    tp = 2 if n % 2 == 0 else 1
    assert g.mesh_shape(n) == (n // tp, tp)


def test_dryrun_deadline_is_enforced(monkeypatch, tmp_path):
    """The dry run fails loudly, not hangs, when the child wedges; the
    whole process group goes with it."""
    pidfile = tmp_path / "grandchild.pid"
    stub = tmp_path / "wedged_child.py"
    stub.write_text(
        "import subprocess, sys, time\n"
        "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)'])\n"
        f"open({str(pidfile)!r}, 'w').write(str(p.pid))\n"
        "time.sleep(60)\n"
    )
    monkeypatch.setattr(g, "_DRYRUN_DEADLINE_S", 1.0)
    monkeypatch.setattr(g, "_SELF_PATH", str(stub))
    with pytest.raises(RuntimeError, match="deadline"):
        g.dryrun_multichip(2, device="cpu")
    pid = int(pidfile.read_text())
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as fh:
                if fh.read().rsplit(")", 1)[1].split()[0] == "Z":
                    break
        except OSError:
            break
        time.sleep(0.05)
    else:
        os.kill(pid, 9)
        pytest.fail("the rank-like grandchild outlived the deadline")


def test_dryrun_child_failure_is_reported(monkeypatch, tmp_path):
    """A child that exits without the OK marker raises, not passes."""
    stub = tmp_path / "broken_child.py"
    stub.write_text("import sys\nprint('boom')\nsys.exit(3)\n")
    monkeypatch.setattr(g, "_SELF_PATH", str(stub))
    with pytest.raises(RuntimeError, match="child failed"):
        g.dryrun_multichip(2, device="cpu")


def test_dryrun_ok_line_missing_is_a_failure(monkeypatch, tmp_path):
    stub = tmp_path / "quiet_child.py"
    stub.write_text("print('DRYRUN n=2')\n")
    monkeypatch.setattr(g, "_SELF_PATH", str(stub))
    with pytest.raises(RuntimeError, match="child failed"):
        g.dryrun_multichip(2, device="cpu")


def test_dryrun_child_is_launched_by_path(monkeypatch, tmp_path):
    """The child runs ``_SELF_PATH --dryrun-child n`` with the device in
    its environment."""
    stub = tmp_path / "echo_child.py"
    stub.write_text(
        "import os, sys\n"
        "print('DRYRUN_OK n=%s dp=1 tp=1 loss=%s grad_err=0' % (\n"
        "    sys.argv[2], 1.0 if sys.argv[1] == '--dryrun-child'\n"
        "    and os.environ['GRAFT_DRYRUN_DEVICE'] == 'cpu' else 0.0))\n"
    )
    monkeypatch.setattr(g, "_SELF_PATH", str(stub))
    assert g.dryrun_multichip(3, device="cpu") == {
        "n": 3, "dp": 1, "tp": 1, "loss": 1.0, "grad_err": 0.0
    }


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_without_a_device_raises_on_a_gpu_less_host(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g.dryrun_multichip(n)


def test_dryrun_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        g.dryrun_multichip(2)


def test_dryrun_rejects_an_unknown_device():
    with pytest.raises(ValueError, match="unsupported device"):
        g.dryrun_multichip(1, device="meta")
