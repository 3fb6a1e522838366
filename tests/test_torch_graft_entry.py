"""The harness MLP in PyTorch held against ``__graft_entry__.py``.

JAX's ``_init_params(PRNGKey(0))`` weights are carried across through
numpy; the port's bf16 forward on the CPU must then match JAX's bf16
forward on the same inputs within ``RTOL``/``ATOL``.  Both round the
hidden layer and the output to bf16 but may sum in another order, so
the bound is two bf16 ulps (2**-6) relative plus 1e-3 absolute, about
2**-8 of the products' summed magnitude at these widths.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from registrar_tpu_torch import graft_entry as g

RTOL = 2.0**-6
ATOL = 1e-3


@pytest.fixture(scope="module")
def jax_case():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    params = jax_entry._init_params(jax, jnp, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1234)
    xs = [np.ones((g.BATCH, g.DIN), np.float32)] + [
        rng.standard_normal((g.BATCH, g.DIN)).astype(np.float32)
        for _ in range(4)
    ]
    outs = [
        np.asarray(
            jax_entry._forward(jnp, params, jnp.asarray(x, jnp.bfloat16)),
            dtype=np.float32,
        )
        for x in xs
    ]
    return {k: np.asarray(v) for k, v in params.items()}, xs, outs


def test_widths_match_the_jax_entry():
    assert (g.BATCH, g.DIN, g.DHID, g.DOUT) == (
        jax_entry.BATCH, jax_entry.DIN, jax_entry.DHID, jax_entry.DOUT
    )


def test_params_from_jax_is_lossless(jax_case):
    params, _, _ = jax_case
    ported = g.params_from_jax(params)
    for name in ("w1", "w2"):
        assert ported[name].dtype == torch.bfloat16
        assert tuple(ported[name].shape) == params[name].shape  # (in, out)
        np.testing.assert_array_equal(
            ported[name].float().numpy(), params[name].astype(np.float32)
        )


@pytest.mark.parametrize("case", range(5), ids=["ones", *map(str, range(4))])
def test_bf16_forward_matches_jax(jax_case, case):
    params, xs, outs = jax_case
    model = g.MLP(g.params_from_jax(params))
    x = torch.from_numpy(xs[case]).to(torch.bfloat16)
    with torch.inference_mode():
        y = model(x)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (g.BATCH, g.DOUT)
    np.testing.assert_allclose(
        y.float().numpy(), outs[case], rtol=RTOL, atol=ATOL
    )


def test_forward_reference_is_fp32_and_close(jax_case):
    params, xs, _ = jax_case
    tp = g.params_from_jax(params)
    x = torch.from_numpy(xs[1]).to(torch.bfloat16)
    ref = g.forward_reference(tp, x)
    assert ref.dtype == torch.float32
    np.testing.assert_allclose(
        g.forward(tp, x).float().numpy(), ref.numpy(), rtol=RTOL, atol=ATOL
    )


def test_entry_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g.entry()


def test_entry_on_cpu_when_asked():
    fn, (params, x) = g.entry(device="cpu")
    assert x.dtype == torch.bfloat16 and tuple(x.shape) == (g.BATCH, g.DIN)
    assert torch.equal(x, torch.ones_like(x))
    assert x.device.type == params["w1"].device.type == "cpu"
    y = fn(params, x)
    assert tuple(y.shape) == (g.BATCH, g.DOUT) and torch.isfinite(y).all()
    # seeded: the same weights every call
    _, (again, _) = g.entry(device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in ("w1", "w2"))


def test_init_params_scale_and_layout():
    params = g.init_params(torch.Generator().manual_seed(7))
    assert tuple(params["w1"].shape) == (g.DIN, g.DHID)
    assert tuple(params["w2"].shape) == (g.DHID, g.DOUT)
    assert all(p.dtype == torch.bfloat16 for p in params.values())
    std = params["w1"].float().std().item()
    assert 0.015 < std < 0.025  # N(0, 1) * 0.02 over 8192 draws


def test_mlp_rejects_transposed_weights():
    params = g.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="w1"):
        g.MLP({"w1": params["w1"].T, "w2": params["w2"]})
