"""The harness MLP of ``__graft_entry__.py`` in PyTorch.

A bf16 two-layer MLP, ``relu(x @ w1) @ w2`` at
``BATCH, DIN, DHID, DOUT = 32, 64, 128, 8``.  The two products are plain
matmuls (no hand-written kernel computes them in the JAX original either),
so ``@`` is the port.  Weights keep the JAX ``(in, out)`` layout; nothing
here hides a transpose inside ``nn.Linear``.

Besides the forward, the module holds the training step: ``loss_fn`` and
``train_step`` (fwd + autograd bwd + SGD in one process), and
``dryrun_multichip(n)``, the same step over an ``n``-rank dp x tp
``DeviceMesh`` with ``w1`` column-parallel and ``w2`` row-parallel, run in
a child process under a hard deadline.

The entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU the default raises instead of falling back to the CPU.

Run the dry run by hand (``cpu`` runs the ranks on gloo, ``cuda`` on
NCCL, one card per rank)::

    python3 -m registrar_tpu_torch.graft_entry 8 cpu
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
from datetime import timedelta
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

BATCH, DIN, DHID, DOUT = 32, 64, 128, 8

#: SGD step size of the training step, as in the JAX original.
LR = 0.01

#: Rows of ``x`` per data-parallel rank in the dry run.
DRYRUN_ROWS_PER_DP = 4

#: Hard deadline of the dry-run child.  A rank start and one tiny step
#: take seconds; minutes means something is wedged, and a clear error
#: beats an open-ended hang.
_DRYRUN_DEADLINE_S = float(os.environ.get("GRAFT_DRYRUN_DEADLINE_S", "240"))

#: Script the dry-run child executes (a seam for tests, which point it at
#: a stub child to exercise the deadline and failure paths).
_SELF_PATH = os.path.abspath(__file__)

#: How the parent tells the child which device type its ranks use.
_DEVICE_ENV = "GRAFT_DRYRUN_DEVICE"

#: The bf16 step's loss vs another computation of it (the float32 step,
#: JAX's step, the sharded step): relative.  Each bf16 rounding of the
#: prediction (of the output, and in the sharded step of each partial
#: product) moves it by at most 2**-8 relative and the squared error by
#: twice that; two such roundings at most.
LOSS_RTOL = 2.0**-6

#: The bf16 step's gradients vs another computation of them (the float32
#: step, JAX's step, the sharded step): the largest elementwise difference
#: of a weight's gradient, relative to the largest element of the other
#: gradient of that weight (:func:`grad_error`).  The gradients, not the
#: updated weights, are held: ``LR * |g|`` is about 2**-10 of ``|w|``, so
#: rounding the new weight to bf16 drops most of the update and a weight
#: check could not tell a right step from one with no gradient at all.
#: Each gradient element is a sum of products whose factors (the
#: prediction, its error, the hidden activations) are each rounded to
#: bf16 once or twice, 2**-8 relative each, and the products are summed
#: in float32; 2**-5 of the largest element holds those roundings, and a
#: zero, halved or doubled gradient misses it by a factor of 16 or more.
GRAD_RTOL = 2.0**-5

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


# --- the training step -------------------------------------------------------


def loss_fn(
    params: Mapping[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """Mean squared error of the bf16 forward against ``y``, in float32:
    the prediction is cast up before the difference, as in the JAX
    original, so the gradient crosses the cast back into bf16."""
    pred = forward(params, x)
    return torch.mean((pred.float() - y) ** 2)


def _sgd(params: Mapping[str, torch.Tensor], grads: Params, lr: float) -> Params:
    """``p - lr * g`` in each weight's own dtype."""
    return {
        name: (params[name].detach() - lr * grads[name].to(params[name].dtype))
        for name in ("w1", "w2")
    }


def _leaves(params: Mapping[str, torch.Tensor], dtype=None) -> Params:
    """Both weights, detached and cast to ``dtype`` (default: their own),
    as leaves for autograd; the caller's tensors are left alone."""
    return {
        k: params[k].detach().to(dtype or params[k].dtype).requires_grad_(True)
        for k in ("w1", "w2")
    }


def loss_and_grads(
    params: Mapping[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor
) -> Tuple[torch.Tensor, Params]:
    """:func:`loss_fn` and its gradients with respect to both weights,
    computed by autograd in the weights' dtype (bf16)."""
    leaves = _leaves(params)
    loss = loss_fn(leaves, x, y)
    grads = torch.autograd.grad(loss, (leaves["w1"], leaves["w2"]))
    return loss.detach(), dict(zip(("w1", "w2"), grads))


def loss_and_grads_reference(
    params: Mapping[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor
) -> Tuple[torch.Tensor, Params]:
    """The same loss and gradients in float32 throughout."""
    leaves = _leaves(params, torch.float32)
    pred = forward_reference(leaves, x)
    loss = torch.mean((pred - y.float()) ** 2)
    grads = torch.autograd.grad(loss, (leaves["w1"], leaves["w2"]))
    return loss.detach(), dict(zip(("w1", "w2"), grads))


def grad_error(grads: Mapping[str, torch.Tensor],
               ref: Mapping[str, torch.Tensor]) -> float:
    """The largest ``max|g - r| / max|r|`` over the weights named in
    ``grads``: the measure :data:`GRAD_RTOL` bounds."""
    worst = 0.0
    for name, g in grads.items():
        r = ref[name].float()
        diff = (g.float() - r).abs().max().item()
        scale = r.abs().max().item()
        if diff:
            worst = max(worst, diff / scale if scale else float("inf"))
    return worst


def train_step(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    y: torch.Tensor,
    lr: float = LR,
) -> Tuple[Params, torch.Tensor]:
    """One fwd + bwd + SGD step in one process: ``(new_params, loss)``.
    Autograd computes the gradients in the weights' dtype (bf16); the
    update is ``p - lr * g``.  Runs on whatever device the tensors are
    on."""
    loss, grads = loss_and_grads(params, x, y)
    return _sgd(params, grads, lr), loss


def train_step_reference(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    y: torch.Tensor,
    lr: float = LR,
) -> Tuple[Params, torch.Tensor]:
    """The same step in float32 throughout: the yardstick the bf16 step
    is held against.  Nothing on the training path calls it."""
    loss, grads = loss_and_grads_reference(params, x, y)
    return _sgd({k: params[k].float() for k in ("w1", "w2")}, grads, lr), loss


def dryrun_params(device: Device = "cpu") -> Params:
    """The dry run's default weights: ``init_params`` from a CPU generator
    seeded 0, so that every rank, every device and the one-process step
    draw the same numbers, moved to ``device``."""
    params = init_params(torch.Generator().manual_seed(0))
    return {k: v.to(device) for k, v in params.items()}


def mesh_shape(n_devices: int) -> Tuple[int, int]:
    """``(dp, tp)`` of an ``n``-rank mesh: tp = 2 when n is even."""
    tp = 2 if n_devices % 2 == 0 else 1
    return n_devices // tp, tp


def _child_env(n_devices: int, device_type: str) -> dict:
    """Environment of the dry-run child.  ``PYTHONSAFEPATH`` keeps the
    script's own directory (this package, whose ``trace.py`` would shadow
    the standard library's) off ``sys.path``; one thread per rank keeps
    ``n`` gloo ranks from oversubscribing the host."""
    env = dict(os.environ)
    env["PYTHONSAFEPATH"] = "1"
    env.setdefault("OMP_NUM_THREADS", "1")
    env[_DEVICE_ENV] = device_type
    return env


def _device_type(n_devices: int, device: Device) -> str:
    """``cpu`` or ``cuda``; a CUDA run needs one card per rank and never
    falls back to the CPU."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "ranks on the CPU over gloo"
            )
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) needs {n_devices} CUDA "
                f"devices, one per rank; have {torch.cuda.device_count()}"
            )
    elif kind != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return kind


def _kill_group(pgid: int) -> None:
    """SIGKILL the child's process group: the child and every rank."""
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _parse_ok(line: str) -> dict:
    """``DRYRUN_OK k=v ...`` as a dict of ints and floats."""
    out = {}
    for field in line.split()[1:]:
        key, _, value = field.partition("=")
        out[key] = int(value) if key in ("n", "dp", "tp") else float(value)
    return out


def dryrun_multichip(n_devices: int, device: Device = None) -> dict:
    """One full train step (fwd + bwd + SGD) over an ``n``-rank dp x tp
    mesh, in a child process that starts the ranks, under the hard
    deadline ``_DRYRUN_DEADLINE_S``.

    With no ``device`` the ranks run on ``cuda`` over NCCL, rank r on
    ``cuda:r``, and the call raises when there are fewer than ``n``
    cards; ``device="cpu"`` runs them on gloo.  Every rank shards the
    weights of :func:`dryrun_params`.  Returns the fields of rank 0's
    ``DRYRUN_OK`` line: ``n``, ``dp``, ``tp``, the loss and ``grad_err``,
    the :func:`grad_error` of the sharded step's gradients against
    :func:`loss_and_grads` on the full weights, largest over the ranks.
    """
    device_type = _device_type(n_devices, device)
    cmd = [sys.executable, _SELF_PATH, "--dryrun-child", str(n_devices)]
    proc = subprocess.Popen(
        cmd,
        env=_child_env(n_devices, device_type),
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        start_new_session=True,
    )
    try:
        out, _ = proc.communicate(timeout=_DRYRUN_DEADLINE_S)
    except subprocess.TimeoutExpired:
        _kill_group(proc.pid)
        out, _ = proc.communicate()
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) exceeded the internal "
            f"{_DRYRUN_DEADLINE_S:.0f}s deadline (rank start or step "
            f"wedged). Output tail:\n{(out or '')[-2000:]}"
        ) from None
    finally:
        _kill_group(proc.pid)  # no rank outlives the call
        proc.wait()
    ok = [ln for ln in out.splitlines() if ln.startswith("DRYRUN_OK ")]
    if proc.returncode != 0 or not ok:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) child failed "
            f"(rc={proc.returncode}). Output tail:\n{out[-2000:]}"
        )
    return _parse_ok(ok[-1])


class _RowParallelSum(torch.autograd.Function):
    """The sum of the row-parallel partial products over ``tp``: an
    all-reduce forward.  Every tp rank then holds the same prediction and
    the same loss, so the gradient passes back through unchanged."""

    @staticmethod
    def forward(ctx, partial, group):  # noqa: D102 - autograd hook
        import torch.distributed as dist

        out = partial.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):  # noqa: D102 - autograd hook
        return grad, None


def _sharded_loss_and_grads(shards: Params, x, y, mesh):
    """The loss and gradients on this rank's shards: ``x``/``y`` rows of
    its dp slice, the ``w1`` columns and ``w2`` rows of its tp slice.
    Returns the global loss (the dp mean of the local ones) and the
    gradients of the shards, summed over ``dp`` and divided by dp."""
    import torch.distributed as dist

    tp_group, dp_group = mesh.get_group("tp"), mesh.get_group("dp")
    dp = mesh.size(0)
    leaves = _leaves(shards)
    partial = torch.relu(x @ leaves["w1"]) @ leaves["w2"]
    pred = _RowParallelSum.apply(partial, tp_group)
    local = torch.mean((pred.float() - y) ** 2)
    grads = torch.autograd.grad(local, (leaves["w1"], leaves["w2"]))
    for g in grads:  # the global loss is the dp mean of the local ones
        dist.all_reduce(g, group=dp_group)
        g.div_(dp)
    loss = local.detach().clone()
    dist.all_reduce(loss, group=dp_group)
    return loss / dp, dict(zip(("w1", "w2"), grads))


def _dryrun_rank(rank: int, n_devices: int, device_type: str,
                 store_path: str) -> None:
    """One rank of the dry run: its process group, the mesh, one step on
    its shards, and the check against the one-process step."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dev, backend = torch.device("cuda", rank), "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, n_devices),
        rank=rank, world_size=n_devices, timeout=timedelta(seconds=120),
    )
    try:
        dp, tp = mesh_shape(n_devices)
        mesh = init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))
        i, j = mesh.get_local_rank("dp"), mesh.get_local_rank("tp")
        params = dryrun_params(dev)
        rows = DRYRUN_ROWS_PER_DP
        x = torch.ones((dp * rows, DIN), dtype=torch.bfloat16, device=dev)
        y = torch.zeros((dp * rows, DOUT), dtype=torch.float32, device=dev)
        cols = slice(j * DHID // tp, (j + 1) * DHID // tp)
        shards = {"w1": params["w1"][:, cols], "w2": params["w2"][cols, :]}
        batch = slice(i * rows, (i + 1) * rows)
        loss, grads = _sharded_loss_and_grads(shards, x[batch], y[batch], mesh)
        new = _sgd(shards, grads, LR)
        if device_type == "cuda":
            torch.cuda.synchronize()
        if not bool(torch.isfinite(loss)):
            raise RuntimeError("train step produced non-finite loss")
        # The sharded step against the one-process step on the full
        # weights: every rank checks the loss and its own gradients.
        ref_loss, ref = loss_and_grads(params, x, y)
        if abs(float(loss) - float(ref_loss)) > LOSS_RTOL * abs(float(ref_loss)):
            raise RuntimeError(
                f"rank {rank}: sharded loss {float(loss)!r} off the "
                f"one-process step's {float(ref_loss)!r}"
            )
        err = 0.0
        for name, sl in (("w1", (slice(None), cols)), ("w2", (cols, slice(None)))):
            if new[name].shape != shards[name].shape or new[name].dtype != torch.bfloat16:
                raise RuntimeError(f"rank {rank}: updated {name} shard is "
                                   f"{tuple(new[name].shape)} {new[name].dtype}")
            # relative to the largest gradient of the whole weight
            scale = ref[name].float().abs().max().item()
            diff = (grads[name].float() - ref[name][sl].float()).abs().max().item()
            err = max(err, diff / scale)
        if not err <= GRAD_RTOL:
            raise RuntimeError(
                f"rank {rank}: sharded gradients off the one-process step's "
                f"by {err:.3e} of the largest"
            )
        worst = torch.tensor(err, dtype=torch.float32, device=dev)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        if rank == 0:
            print(
                f"DRYRUN_OK n={n_devices} dp={dp} tp={tp} "
                f"loss={float(loss):.9e} grad_err={float(worst):.3e}",
                flush=True,
            )
    finally:
        dist.destroy_process_group()


def _spawned_rank(index: int, *args) -> None:
    """Ranks 1 .. n-1, started by :func:`_dryrun_child`."""
    _dryrun_rank(index + 1, *args)


def _dryrun_child(n_devices: int) -> None:
    """The child of :func:`dryrun_multichip`: starts the ``n`` ranks.  It
    is rank 0 itself and spawns the others, which saves one interpreter
    start; a rank that fails raises here, and the others are stopped."""
    import torch.multiprocessing as mp

    device_type = os.environ.get(_DEVICE_ENV, "cuda")
    with tempfile.TemporaryDirectory(prefix="graft-store-") as tmp:
        args = (n_devices, device_type, os.path.join(tmp, "store"))
        others = None
        if n_devices > 1:
            others = mp.start_processes(
                _spawned_rank, args=args, nprocs=n_devices - 1, join=False,
                start_method="spawn",
            )
        try:
            _dryrun_rank(0, *args)
            while others is not None and not others.join():
                pass
        finally:
            if others is not None:
                for proc in others.processes:
                    if proc.is_alive():
                        proc.terminate()


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--dryrun-child":
        _dryrun_child(int(sys.argv[2]))
    else:
        n = int(sys.argv[1]) if len(sys.argv) > 1 else 1
        print(dryrun_multichip(n, sys.argv[2] if len(sys.argv) > 2 else None))

