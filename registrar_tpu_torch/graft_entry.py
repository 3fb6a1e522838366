"""The harness MLP of ``__graft_entry__.py`` in PyTorch.

A bf16 two-layer MLP, ``relu(x @ w1) @ w2`` at
``BATCH, DIN, DHID, DOUT = 32, 64, 128, 8``.  The two products are plain
matmuls (no hand-written kernel computes them in the JAX original either),
so ``@`` is the port.  Weights keep the JAX ``(in, out)`` layout; nothing
here hides a transpose inside ``nn.Linear``.

The entry point runs on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU the default raises instead of falling back to the CPU.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

BATCH, DIN, DHID, DOUT = 32, 64, 128, 8

#: N(0, 1) draws are scaled by this, as in the JAX init.
INIT_SCALE = 0.02

Params = Dict[str, torch.Tensor]
Device = Union[str, torch.device, None]


def init_params(generator: torch.Generator) -> Params:
    """bf16 weights drawn N(0, 1) from ``generator`` and scaled by 0.02,
    on the generator's device."""
    kw = dict(generator=generator, dtype=torch.bfloat16, device=generator.device)
    return {
        "w1": torch.randn((DIN, DHID), **kw) * INIT_SCALE,
        "w2": torch.randn((DHID, DOUT), **kw) * INIT_SCALE,
    }


def params_from_jax(
    params: Mapping[str, np.ndarray], device: Device = "cpu"
) -> Params:
    """Carry JAX weights across as bf16 tensors in the same ``(in, out)``
    layout.  JAX bf16 arrays reach numpy as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses, so they pass through float32:
    bf16 -> fp32 -> bf16 is exact."""
    return {
        name: torch.from_numpy(np.asarray(params[name], dtype=np.float32))
        .to(device=device, dtype=torch.bfloat16)
        for name in ("w1", "w2")
    }


def forward(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``relu(x @ w1) @ w2`` in the inputs' dtype."""
    return torch.relu(x @ params["w1"]) @ params["w2"]


def forward_reference(
    params: Mapping[str, torch.Tensor], x: torch.Tensor
) -> torch.Tensor:
    """The same function in float32: the yardstick the bf16 forward is
    held against.  Nothing on the :func:`entry` path calls it."""
    w1, w2 = params["w1"].float(), params["w2"].float()
    return torch.relu(x.float() @ w1) @ w2


class MLP(nn.Module):
    """The harness MLP: bf16 ``w1`` (64, 128) and ``w2`` (128, 8)."""

    def __init__(self, params: Mapping[str, torch.Tensor]) -> None:
        super().__init__()
        for name, shape in (("w1", (DIN, DHID)), ("w2", (DHID, DOUT))):
            if tuple(params[name].shape) != shape:
                raise ValueError(
                    f"{name} has shape {tuple(params[name].shape)}, "
                    f"want {shape}"
                )
        self.w1 = nn.Parameter(params["w1"].to(torch.bfloat16))
        self.w2 = nn.Parameter(params["w2"].to(torch.bfloat16))

    def params(self) -> Params:
        return {"w1": self.w1, "w2": self.w2}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), x)


def entry(device: Device = None) -> Tuple[object, Tuple[Params, torch.Tensor]]:
    """Return ``(fn, example_args)``: the forward and its inputs, with
    weights from a generator seeded 0 and ``x = ones(32, 64)`` in bf16.
    On ``cuda`` unless ``device`` names another; without a GPU the default
    raises rather than falling back to the CPU."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    dev = torch.device("cuda" if device is None else device)
    generator = torch.Generator(device=dev).manual_seed(0)
    params = init_params(generator)
    x = torch.ones((BATCH, DIN), dtype=torch.bfloat16, device=dev)
    return forward, (params, x)

