"""``dryrun_multichip(n, device="cpu")`` held against JAX's step.

The ranks run on gloo, one process each, over a ``(dp, tp)`` mesh and
shard the weights of ``dryrun_params``.  The same weights, carried to
JAX as bf16, go through JAX's jitted step; the dry run's loss is held to
JAX's within ``LOSS_RTOL`` (``tests/test_torch_train.py`` says why).
Every row of ``x`` is the same, so JAX's loss does not depend on ``n``:
one JAX number is the reference for every ``n``.  Each rank also holds
its gradient shards to the one-process ``loss_and_grads`` on the full
weights within ``GRAD_RTOL`` of the largest element, and fails the run
otherwise; ``train_step`` is held to JAX's gradients in
``tests/test_torch_train.py``.
"""

import numpy as np
import pytest
import torch

from registrar_tpu_torch import graft_entry as g
from tests.test_torch_train import LOSS_RTOL, jax_case  # noqa: F401 - fixture


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip_on_gloo(jax_case, n):
    _, _, dry_loss = jax_case
    out = g.dryrun_multichip(n, device="cpu")
    dp, tp = g.mesh_shape(n)
    assert (out["n"], out["dp"], out["tp"]) == (n, dp, tp)
    assert np.isfinite(out["loss"])
    assert out["loss"] == pytest.approx(dry_loss, rel=LOSS_RTOL)
    assert 0.0 <= out["grad_err"] <= g.GRAD_RTOL
    if tp == 1:  # no partial sums: the same products as the one process
        assert out["grad_err"] == 0.0


def test_dryrun_default_weights_match_the_one_process_step():
    """The dry run's loss is the in-process step's on the same weights
    (the check ``chip_smoke.py`` makes on the card)."""
    out = g.dryrun_multichip(1, device="cpu")
    x = torch.ones((g.BATCH, g.DIN), dtype=torch.bfloat16)
    _, loss = g.train_step(g.dryrun_params(), x, torch.zeros((g.BATCH, g.DOUT)))
    assert out["loss"] == pytest.approx(loss.item(), rel=LOSS_RTOL)
