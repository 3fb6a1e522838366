"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``registrar_tpu_torch`` through its main path and checks every
result; any failed check raises and the script exits non-zero.  There is
no CPU fallback: without a CUDA device it exits with status 1 before
printing any result.

Phases:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. model: the harness MLP built from a seeded generator on the card
   serves 8 seeded (32, 64) batches plus the ``ones`` input of
   ``entry()``; each bf16 output is held against the float32
   ``forward_reference`` on the card, and the bf16 forward is timed with
   CUDA events;
3. registration: ``register_plus`` registers the deployment shape of
   ``etc/config.example.json`` against a ZooKeeper, heartbeats, is taken
   down and back up by a flipping health check, and its session closes;
   the tree is compared with the data contract (docs/CONTRACT.md) at
   every stage;
4. fleet scale: 1000 ephemerals on one session, swept by
   ``heartbeat_many`` as 100 services x 10 znodes;
5. daemon: ``python3 -m registrar_tpu_torch -f cfg.json`` with the
   deployment shape of ``etc/config.example.json`` (its registration,
   adminIp and tuning; heartbeat 0.2 s, a ``test -f <flag>`` health check
   every 0.1 s with threshold 2) against the same ZooKeeper: the
   ``-n`` pre-flight (0, and 78 for a broken registration), a cold start
   (tree, bunyan lines, ``/metrics``, ``/status``), a health flip, a
   SIGTERM that deletes the ephemerals at once, and a handoff restart in
   which a successor resumes the same session while an observer polling
   every 10 ms sees no NO_NODE;
6. serve tier: ``python3 -m registrar_tpu_torch.tools.zkcli
   serve-sharded -f tier.json`` with the ``serve`` and ``cache`` blocks
   of ``etc/config.example.json`` (4 shards, ``attachSpread: spread``,
   the overload knobs, a DNS frontend) over a Manta-style fleet of 16
   service domains x 50 load balancers registered through
   ``registration.register``: ``zkcli status``, every domain's A and
   SRV answers over the unix socket (cached and live) held to
   docs/CONTRACT.md, ``zkcli dig`` over UDP and TCP, a seeded Zipf
   storm of 20 000 UDP queries (10 % NXDOMAIN) that must see no timeout
   and no wrong answer, an unregister that the cached answer must drop,
   a SIGHUP reshard to 5 shards under a polling resolver that must see
   no error, a ``kill -9`` of one worker, and a SIGTERM that must leave
   no worker behind;
7. train: the training step on the card at full width (``train_step``,
   bf16, fwd + autograd bwd + SGD) held against the float32 reference
   for the loss and both weights' gradients, and timed with CUDA events; ``dryrun_multichip(1)``, one rank on the card
   over NCCL, must print ``DRYRUN_OK`` with the in-process step's loss;
   ``dryrun_multichip(2, device="cpu")`` runs the tp = 2 mesh over gloo
   on the host;
8. slo: the port's availability harness runs the seeded ``quick`` trace
   (5 members, a 3-member ZooKeeper ensemble, a 2-shard serve tier,
   every cataloged fault class once) with its levers on, and every
   fault class must have been injected and probed;
9. kernels: the repository has no Pallas kernel, so the port has no
   hand-written kernel to build or check: ``{"kernels": []}``.

Phases 3 to 6 run against the port's own ZooKeeper server
(``python3 -m registrar_tpu_torch.testing.server``), started as a child
process.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Timings name the card, its power limit and the host CPU beside them:
phases 3 to 6 and 8 are host work.
"""

import asyncio
import copy
import json
import logging
import os
import platform
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: bf16 output vs the float32 reference: two bf16 ulps relative plus an
#: absolute term of about 2**-8 of the products' summed magnitude.
RTOL = 2.0**-6
ATOL = 1e-3

#: Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet,
#: dense): HBM bytes per second and bf16 tensor-core operations per second.
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12

SEED = 0
N_REQUESTS = 8
TIMED_LAUNCHES = 200
WARMUP_LAUNCHES = 20

#: The deployment shape of etc/config.example.json.
DOMAIN = "myservice.us-east.example.com"
ALIAS = "alias-1.myservice.us-east.example.com"
HOSTNAME = "smokehost"
REGISTRATION = {
    "domain": DOMAIN,
    "type": "load_balancer",
    "aliases": [ALIAS],
    "ttl": 30,
    "ports": [80, 443],
    "service": {
        "type": "service",
        "service": {"srvce": "_http", "proto": "_tcp", "port": 80, "ttl": 60},
    },
}
ADMIN_IP = "10.0.0.17"

#: Expected znodes, written from docs/CONTRACT.md: (path, payload, kind).
SERVICE_PATH = "/com/example/us-east/myservice"
HOST_PAYLOAD = (
    b'{"type":"load_balancer","address":"10.0.0.17","ttl":30,'
    b'"load_balancer":{"address":"10.0.0.17","ports":[80,443]}}'
)
SERVICE_PAYLOAD = (
    b'{"type":"service","service":{"type":"service",'
    b'"service":{"srvce":"_http","proto":"_tcp","port":80,"ttl":60}}}'
)
PARENTS = [
    ("/com", b"", "persistent"),
    ("/com/example", b"", "persistent"),
    ("/com/example/us-east", b"", "persistent"),
]
REGISTERED_TREE = PARENTS + [
    (SERVICE_PATH, SERVICE_PAYLOAD, "persistent"),
    (SERVICE_PATH + "/alias-1", HOST_PAYLOAD, "ephemeral"),
    (SERVICE_PATH + "/" + HOSTNAME, HOST_PAYLOAD, "ephemeral"),
]
OWNED_ZNODES = [
    SERVICE_PATH + "/" + HOSTNAME,
    SERVICE_PATH + "/alias-1",
    SERVICE_PATH,
]

#: the daemon's exit status for a rejected config (BSD sysexits)
EX_CONFIG = 78
#: the observer's poll period while it watches the daemon's znodes
POLL_S = 0.01

FLEET_SERVICES, FLEET_NODES_PER_SERVICE = 100, 10
MULTI_CHUNK = 500
#: enough sweeps (about 1 s) for the CPU shares to resolve a 10 ms tick
FLEET_SWEEPS = 50

#: seeded (x, y) batches the training step is held to its float32
#: reference on, besides the dry run's x = ones, y = zeros
N_TRAIN_CASES = 4

#: the SLO trace of phase 8, as the availability harness's runner
#: defaults to it: the quick trace, levers on, with a fixed seed
SLO_TRACE, SLO_SEED = "quick", 1234
#: the least count of fault classes with a measured MTTD and MTTR
#: (the harness runner's floor for the quick trace)
SLO_MIN_MEASURED = 4


class SmokeError(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def host_cpu() -> str:
    """The host CPU's model name, or its vendor, family and model numbers
    where the name is masked; with the count of cores this process sees."""
    info = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, sep, value = line.partition(":")
                if not sep:
                    break  # the first processor's block is enough
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name == "unknown" and "cpu family" in info:
        name = (f"{info.get('vendor_id', '?')} family {info['cpu family']} "
                f"model {info.get('model', '?')}")
    if name == "unknown":
        name = platform.machine()
    return f"{name}, {os.cpu_count()} cores"


# --- phase 1 -----------------------------------------------------------------


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}", flush=True)
    print(smi, flush=True)
    return {"card": name, "nvidia_smi": smi, "host_cpu": host_cpu()}


# --- phase 2 -----------------------------------------------------------------


def _close_enough(y: torch.Tensor, ref: torch.Tensor) -> float:
    from registrar_tpu_torch.graft_entry import BATCH, DOUT

    check(tuple(y.shape) == (BATCH, DOUT), f"output shape {tuple(y.shape)}")
    check(y.dtype == torch.bfloat16, f"output dtype {y.dtype}")
    check(bool(torch.isfinite(y).all()), "non-finite output")
    err = (y.float() - ref).abs()
    bound = RTOL * ref.abs() + ATOL
    check(bool((err <= bound).all()), f"bf16 forward off the fp32 reference by {err.max().item()}")
    return err.max().item()


def _time_ms(fn) -> list:
    """Per-launch times of ``fn`` on the card, one pair of CUDA events
    around each launch, after a warm-up."""
    for _ in range(WARMUP_LAUNCHES):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_LAUNCHES):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def phase_model(where: dict) -> None:
    from registrar_tpu_torch.graft_entry import (
        BATCH, DHID, DIN, DOUT, MLP, entry, forward_reference, init_params,
    )

    dev = torch.device("cuda")
    model = MLP(init_params(torch.Generator(device=dev).manual_seed(SEED)))
    check(model.w1.device.type == "cuda", "model weights are not on the card")
    errs = []
    with torch.inference_mode():
        for i in range(N_REQUESTS):
            rng = np.random.default_rng(SEED + 1 + i)
            x = torch.from_numpy(
                rng.standard_normal((BATCH, DIN)).astype(np.float32)
            ).to(dev, torch.bfloat16)
            errs.append(_close_enough(model(x), forward_reference(model.params(), x)))
        fn, (params, ones) = entry()
        check(ones.device.type == "cuda", "entry() did not default to the card")
        errs.append(_close_enough(fn(params, ones), forward_reference(params, ones)))

        forward_ms = _time_ms(lambda: model(ones))
        reference_ms = _time_ms(lambda: forward_reference(params, ones))
    # The least time the card could take for the forward: each input and
    # the output moved once, or the products at the bf16 peak.
    moved = 2 * (BATCH * DIN + DIN * DHID + DHID * DOUT + BATCH * DOUT)
    flops = 2 * BATCH * DHID * (DIN + DOUT)
    bound_ms = max(moved / H100_BYTES_PER_S, flops / H100_BF16_FLOPS) * 1e3
    emit({
        "phase": "model",
        "requests": N_REQUESTS + 1,
        "max_abs_err": max(errs),
        "rtol": RTOL, "atol": ATOL,
        "forward_ms_median": statistics.median(forward_ms),
        "forward_ms_min": min(forward_ms),
        "fp32_reference_ms_median": statistics.median(reference_ms),
        "bytes": moved,
        "operations": flops,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if moved / H100_BYTES_PER_S > flops / H100_BF16_FLOPS
        else "operations",
        "launches_timed": TIMED_LAUNCHES,
        **where,
    })


# --- phase 3 and 4: a ZooKeeper stand-in in a child process -----------------


class ZooKeeperChild:
    """The port's hermetic ZooKeeper server
    (``registrar_tpu_torch.testing.server``), as a separate process
    reached only over TCP."""

    def __init__(self) -> None:
        self.proc = None
        self.lines = []
        self.port = None

    def __enter__(self) -> "ZooKeeperChild":
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "registrar_tpu_torch.testing.server",
             "--host", "127.0.0.1", "--port", "0"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        found = threading.Event()

        def drain() -> None:
            for line in self.proc.stdout:
                self.lines.append(line.rstrip())
                if self.port is None and "listening on" in line:
                    self.port = int(line.rsplit(":", 1)[1])
                    found.set()
            found.set()

        self._drain = threading.Thread(target=drain, daemon=True)
        self._drain.start()
        found.wait(timeout=60)
        if self.port is None:
            self.__exit__(None, None, None)
            raise SmokeError(
                "ZooKeeper child did not start: " + " | ".join(self.lines[-20:])
            )
        return self

    def __exit__(self, *exc) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self._drain.join(timeout=10)


async def dump_tree(client, owner: int, path: str) -> list:
    """(path, payload, kind) of every znode from ``path`` down.  A znode
    deleted while the walk reads it (a deregistration racing the poll)
    is left out, as the next poll would find it."""
    from registrar_tpu_torch.zk.protocol import Err, ZKError

    try:
        data, st = await client.get(path)
        children = sorted(await client.get_children(path))
    except ZKError as err:
        if err.code == Err.NO_NODE:
            return []
        raise
    kind = (
        "ephemeral" if st.ephemeral_owner == owner
        else "persistent" if st.ephemeral_owner == 0
        else "foreign"
    )
    out = [(path, bytes(data), kind)]
    for child in children:
        out += await dump_tree(client, owner, path.rstrip("/") + "/" + child)
    return out


async def phase_registration(port: int, where: dict) -> None:
    from registrar_tpu_torch import register_plus
    from registrar_tpu_torch.zk.client import ZKClient

    servers = [("127.0.0.1", port)]
    observer = await ZKClient(servers).connect()
    client = await ZKClient(servers).connect()
    owner = client.session_id
    try:
        with tempfile.TemporaryDirectory() as tmp:
            flag = os.path.join(tmp, "healthy")
            open(flag, "w").close()
            t0 = time.perf_counter()
            ee = register_plus(
                client, REGISTRATION, admin_ip=ADMIN_IP, hostname=HOSTNAME,
                heartbeat_interval=0.2,
                health_check={
                    "command": f"test -f {flag}",
                    "interval": 0.1,
                    "timeout": 5.0,
                    "threshold": 2,
                },
            )
            errors = []
            ee.on("error", errors.append)
            beats = []
            ee.on("heartbeat", beats.append)
            try:
                (znodes,) = await ee.wait_for("register", timeout=30)
                register_s = time.perf_counter() - t0
                check(znodes == OWNED_ZNODES, f"owned znodes {znodes}")
                tree = await dump_tree(observer, owner, "/com")
                check(tree == REGISTERED_TREE, f"registered tree {tree}")

                while len(beats) < 3:
                    await ee.wait_for("heartbeat", timeout=30)
                check(all(b == OWNED_ZNODES for b in beats), "heartbeat znodes")

                t1 = time.perf_counter()
                os.unlink(flag)
                (_err, deleted) = await ee.wait_for("unregister", timeout=30)
                down_s = time.perf_counter() - t1
                check(deleted == OWNED_ZNODES, f"deregistered {deleted}")
                tree = await dump_tree(observer, owner, "/com")
                check(tree == PARENTS, f"tree while down {tree}")

                t2 = time.perf_counter()
                open(flag, "w").close()
                (znodes,) = await ee.wait_for("register", timeout=30)
                up_s = time.perf_counter() - t2
                check(znodes == OWNED_ZNODES, f"re-registered {znodes}")
                tree = await dump_tree(observer, owner, "/com")
                check(tree == REGISTERED_TREE, f"tree after recovery {tree}")
                check(not errors, f"agent errors {errors!r}")
            finally:
                ee.stop()
        await client.close()
        tree = await dump_tree(observer, owner, "/com")
        check(
            tree == PARENTS + [(SERVICE_PATH, SERVICE_PAYLOAD, "persistent")],
            f"tree after the session closed {tree}",
        )
    finally:
        await client.close()
        await observer.close()
    emit({
        "phase": "registration",
        "znodes": len(OWNED_ZNODES),
        "heartbeats": len(beats),
        "register_s": register_s,
        "health_down_to_unregistered_s": down_s,
        "health_up_to_registered_s": up_s,
        **where,
    })


async def phase_fleet(port: int, where: dict, server_pid=None) -> None:
    from registrar_tpu_torch.zk.client import Op, OwnershipError, ZKClient
    from registrar_tpu_torch.zk.protocol import CreateFlag

    servers = [("127.0.0.1", port)]
    client = await ZKClient(servers).connect()
    other = await ZKClient(servers).connect()
    try:
        services = [f"/fleet/svc-{i:03d}" for i in range(FLEET_SERVICES)]
        groups = [
            [f"{svc}/node-{j:02d}" for j in range(FLEET_NODES_PER_SERVICE)]
            for svc in services
        ]
        await client.multi(
            [Op.create("/fleet")] + [Op.create(svc) for svc in services]
        )
        ephemerals = [n for g in groups for n in g]
        t0 = time.perf_counter()
        for i in range(0, len(ephemerals), MULTI_CHUNK):
            await client.multi([
                Op.create(n, b"{}", flags=CreateFlag.EPHEMERAL)
                for n in ephemerals[i:i + MULTI_CHUNK]
            ])
        create_s = time.perf_counter() - t0

        # CPU seconds of the client (this process) and of the ZooKeeper
        # child over the sweeps' wall time: where a sweep's host time goes.
        sweeps = []
        client0 = time.process_time()
        server0 = cpu_seconds(server_pid) if server_pid else 0.0
        for _ in range(FLEET_SWEEPS):
            t = time.perf_counter()
            outcomes = await client.heartbeat_many(groups)
            sweeps.append((time.perf_counter() - t) * 1e3)
            check(outcomes == [None] * FLEET_SERVICES,
                  f"unowned probes: {[o for o in outcomes if o is not None][:3]}")
        sweep_s = sum(sweeps) / 1e3
        client_share = (time.process_time() - client0) / sweep_s
        server_share = ((cpu_seconds(server_pid) - server0) / sweep_s
                        if server_pid else None)
        # The ownership check is live: another session's node is refused.
        await other.create("/fleet/foreign", b"{}", flags=CreateFlag.EPHEMERAL)
        (foreign,) = await client.heartbeat_many([["/fleet/foreign"]])
        check(isinstance(foreign, OwnershipError), f"foreign probe gave {foreign!r}")
    finally:
        await other.close()
        await client.close()
    emit({
        "phase": "fleet",
        "ephemerals": len(ephemerals),
        "multi_chunk": MULTI_CHUNK,
        "create_s": create_s,
        "sweep": f"{FLEET_SERVICES} services x {FLEET_NODES_PER_SERVICE} znodes",
        "sweep_ms_median": statistics.median(sweeps),
        "sweep_ms": sweeps,
        "sweep_client_cpu_share": client_share,
        "sweep_server_cpu_share": server_share,
        **where,
    })


# --- phase 5: the daemon ----------------------------------------------------


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def daemon_config(zk_port: int, flag: str, metrics_port: int) -> dict:
    """etc/config.example.json pointed at the child ZooKeeper: the same
    registration, adminIp and tuning, the smoke's heartbeat and health
    check, its own metrics port and trace dump path, and no serve, cache,
    chroot or restart block."""
    with open(os.path.join(ROOT, "etc", "config.example.json")) as fh:
        cfg = json.load(fh)
    reg = dict(cfg["registration"])
    reg.pop("heartbeatInterval")
    check(reg == REGISTRATION, f"etc/config.example.json registration {reg}")
    check(cfg["adminIp"] == ADMIN_IP, f"adminIp {cfg['adminIp']}")
    for key in ("serve", "cache", "restart"):
        cfg.pop(key)
    cfg["observability"]["dumpPath"] = os.path.join(
        os.path.dirname(flag), "trace-dump.json")
    cfg["zookeeper"].pop("chroot")
    cfg["zookeeper"]["servers"] = [{"host": "127.0.0.1", "port": zk_port}]
    cfg["registration"]["heartbeatInterval"] = 200
    cfg["healthCheck"] = {
        "command": f"test -f {flag}", "interval": 100, "timeout": 1000,
        "threshold": 2,
    }
    cfg["metrics"] = {"host": "127.0.0.1", "port": metrics_port}
    cfg["logLevel"] = "info"
    return cfg


def write_json(path: str, obj) -> str:
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return path


class Daemon:
    """``python3 -m registrar_tpu_torch -f <cfg>`` (or the interpreter
    arguments ``argv``) as a child process, its standard output and
    error gathered line by line."""

    def __init__(self, cfg_path: str, argv=None) -> None:
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable,
             *(argv or ["-m", "registrar_tpu_torch", "-f", cfg_path])],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        self.lines = []
        self.errors = []
        self._drains = [
            threading.Thread(target=self._drain, args=(pipe, sink), daemon=True)
            for pipe, sink in ((self.proc.stdout, self.lines),
                               (self.proc.stderr, self.errors))
        ]
        for t in self._drains:
            t.start()

    @staticmethod
    def _drain(pipe, sink) -> None:
        for line in pipe:
            sink.append(line.rstrip("\n"))

    def records(self) -> list:
        """Every stdout line, each of which must be one bunyan object."""
        out = []
        for line in list(self.lines):
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                raise SmokeError(f"daemon stdout line is not JSON: {line!r}")
            check(isinstance(rec, dict) and rec.get("name") == "registrar"
                  and isinstance(rec.get("level"), int) and "msg" in rec,
                  f"daemon stdout line is not a bunyan record: {line!r}")
            out.append(rec)
        return out

    async def wait_msg(self, msg: str, timeout: float = 30) -> float:
        """Seconds from spawn until a line whose ``msg`` starts with
        ``msg`` is logged."""
        deadline = time.perf_counter() + timeout
        while not any(r["msg"].startswith(msg) for r in self.records()):
            ended = not any(t.is_alive() for t in self._drains)
            check(not ended and time.perf_counter() < deadline,
                  f"daemon never logged {msg!r}: {self.tail()}")
            await asyncio.sleep(POLL_S)
        return time.perf_counter() - self.t0

    async def signal_and_wait(self, sig, timeout: float = 30) -> int:
        self.proc.send_signal(sig)
        return await asyncio.to_thread(self.proc.wait, timeout)

    def tail(self) -> str:
        return " | ".join((self.lines + self.errors)[-20:])

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)
        for t in self._drains:
            t.join(timeout=10)


async def wait_until(fn, what: str, timeout: float = 30):
    """Poll ``fn`` every POLL_S until it returns a true value."""
    deadline = time.perf_counter() + timeout
    while True:
        value = await fn()
        if value:
            return value
        check(time.perf_counter() < deadline, f"timed out waiting for {what}")
        await asyncio.sleep(POLL_S)


def http_get(port: int, path: str) -> str:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=10
    ) as resp:
        check(resp.status == 200, f"GET {path} answered {resp.status}")
        return resp.read().decode()


class Poller:
    """A resolver's view: ``exists`` on one znode every POLL_S, counting
    the NO_NODE answers and the owners seen."""

    def __init__(self, client, path: str) -> None:
        self.client, self.path = client, path
        self.checks = self.misses = 0
        self.owners = set()
        self._stop = asyncio.Event()
        self._task = asyncio.create_task(self._loop())

    async def _loop(self) -> None:
        while not self._stop.is_set():
            st = await self.client.exists(self.path)
            self.checks += 1
            if st is None:
                self.misses += 1
            else:
                self.owners.add(st.ephemeral_owner)
            await asyncio.sleep(POLL_S)

    async def stop(self) -> None:
        self._stop.set()
        await self._task


def preflight(cfg_path: str, broken_path: str) -> None:
    def run(path):
        return subprocess.run(
            [sys.executable, "-m", "registrar_tpu_torch", "-f", path, "-n"],
            cwd=ROOT, capture_output=True, text=True, timeout=60,
        )

    ok = run(cfg_path)
    check(ok.returncode == 0, f"-n on the config exited {ok.returncode}: "
          f"{ok.stdout} {ok.stderr}")
    check('"msg":"configuration OK"' in ok.stdout, f"-n said {ok.stdout!r}")
    bad = run(broken_path)
    check(bad.returncode == EX_CONFIG,
          f"-n on a broken registration exited {bad.returncode}, not "
          f"{EX_CONFIG}: {bad.stdout} {bad.stderr}")


async def phase_daemon(port: int, where: dict) -> None:
    from registrar_tpu_torch.zk.client import ZKClient

    hostname = socket.gethostname()
    host_path = SERVICE_PATH + "/" + hostname
    alias_path = SERVICE_PATH + "/alias-1"
    registered = PARENTS + [
        (SERVICE_PATH, SERVICE_PAYLOAD, "persistent"),
        (alias_path, HOST_PAYLOAD, "ephemeral"),
        (host_path, HOST_PAYLOAD, "ephemeral"),
    ]
    # A health deregister deletes the childless service node too; a closed
    # session leaves it (phase 3 holds register_plus to the same trees).
    down = PARENTS
    closed = PARENTS + [(SERVICE_PATH, SERVICE_PAYLOAD, "persistent")]
    owned = [host_path, alias_path, SERVICE_PATH]

    observer = await ZKClient([("127.0.0.1", port)]).connect()
    daemons = []

    async def owner_of(path):
        st = await observer.exists(path)
        return st.ephemeral_owner if st is not None else None

    async def tree_is(expected, owner):
        return await dump_tree(observer, owner, "/com") == expected

    try:
        with tempfile.TemporaryDirectory() as tmp:
            flag = os.path.join(tmp, "healthy")
            open(flag, "w").close()
            metrics_port = free_port()
            cfg = daemon_config(port, flag, metrics_port)
            cfg_path = write_json(os.path.join(tmp, "config.json"), cfg)
            broken = copy.deepcopy(cfg)
            del broken["registration"]["type"]
            preflight(cfg_path, write_json(os.path.join(tmp, "broken.json"), broken))

            # cold start
            d = Daemon(cfg_path)
            daemons.append(d)
            owner = await wait_until(lambda: owner_of(host_path), "the host znode")
            register_s = time.perf_counter() - d.t0
            await wait_until(lambda: tree_is(registered, owner),
                             "the registered tree")
            await d.wait_msg("registrar: registered")
            records = d.records()
            components = {r["component"] for r in records}
            check("registrar" in components, f"components {components}")
            modules = components - {"registrar"}
            check(modules and all(c.startswith("registrar_tpu_torch.")
                                  for c in modules), f"components {components}")
            metrics = await asyncio.to_thread(http_get, metrics_port, "/metrics")
            for series in ("registrar_registrations_total 1",
                           "registrar_zk_connected 1"):
                check(f"\n{series}\n" in f"\n{metrics}",
                      f"/metrics lacks {series!r}")
            status = json.loads(
                await asyncio.to_thread(http_get, metrics_port, "/status"))
            check(status["session"]["id"] == f"0x{owner:x}",
                  f"/status session {status['session']}")
            check([z["path"] for z in status["registration"]["znodes"]] == owned,
                  f"/status znodes {status['registration']}")
            check(status["health"]["configured"] and not status["health"]["down"],
                  f"/status health {status['health']}")

            # health flip through the daemon
            t = time.perf_counter()
            os.unlink(flag)
            await wait_until(lambda: tree_is(down, owner), "health deregister")
            health_down_s = time.perf_counter() - t
            t = time.perf_counter()
            open(flag, "w").close()
            await wait_until(lambda: tree_is(registered, owner),
                             "health re-register")
            health_up_s = time.perf_counter() - t

            # SIGTERM without a restart block: the session closes
            d.proc.send_signal(signal.SIGTERM)
            t = time.perf_counter()

            async def gone():
                return await owner_of(host_path) is None

            await wait_until(gone, "the host znode to go on SIGTERM")
            sigterm_to_gone_s = time.perf_counter() - t
            rc = await asyncio.to_thread(d.proc.wait, 30)
            check(rc == 0, f"daemon exited {rc} on SIGTERM: {d.tail()}")
            check(await tree_is(closed, owner), "tree after SIGTERM")
            await d.wait_msg("registrar: shutting down")
            log_lines = len(d.records())

            # handoff restart
            cfg["restart"] = {"stateFile": os.path.join(tmp, "state.json"),
                              "mode": "handoff", "drainGraceSeconds": 0}
            write_json(cfg_path, cfg)
            pred = Daemon(cfg_path)
            daemons.append(pred)
            sid0 = await wait_until(lambda: owner_of(host_path),
                                    "the host znode (handoff)")
            await wait_until(lambda: tree_is(registered, sid0),
                             "the registered tree (handoff)")
            poller = Poller(observer, host_path)
            rc = await pred.signal_and_wait(signal.SIGTERM)
            check(rc == 0, f"handoff predecessor exited {rc}: {pred.tail()}")
            await pred.wait_msg(
                "restart: session handed off; ephemerals remain live for "
                "the successor")
            check(await tree_is(registered, sid0),
                  "the ephemerals did not stay up after the handoff")
            succ = Daemon(cfg_path)
            daemons.append(succ)
            handoff_resume_s = await succ.wait_msg(
                "resumed registration verified in place")
            await asyncio.sleep(0.5)  # heartbeats of the successor
            await poller.stop()
            check(poller.checks > 20, f"only {poller.checks} polls")
            check(poller.misses == 0,
                  f"{poller.misses}/{poller.checks} polls saw NO_NODE")
            check(poller.owners == {sid0}, f"owners {poller.owners}")
            check(await tree_is(registered, sid0), "tree after the handoff")
            check(succ.proc.poll() is None, f"successor died: {succ.tail()}")
            rc = await succ.signal_and_wait(signal.SIGTERM)
            check(rc == 0, f"successor exited {rc}: {succ.tail()}")
    finally:
        for d in daemons:
            d.stop()
        await observer.close()
    emit({
        "phase": "daemon",
        "daemon_register_s": register_s,
        "health_down_to_unregistered_s": health_down_s,
        "health_up_to_registered_s": health_up_s,
        "sigterm_to_gone_s": sigterm_to_gone_s,
        "handoff_no_node_polls": poller.misses,
        "handoff_polls": poller.checks,
        "handoff_resume_s": handoff_resume_s,
        "log_lines_cold_run": log_lines,
        **where,
    })


# --- phase 6: the serve tier ------------------------------------------------

#: A Manta-style fleet: 16 service domains of 50 load balancers each, in
#: the registration shape of etc/config.example.json.
SERVE_SUFFIX = "manta.us-east.example.com"
SERVE_DOMAINS, SERVE_INSTANCES = 16, 50
SERVE_PORTS = [80, 443]
#: the shard counts of the tier before and after the reshard step
SHARDS, RESHARDS = 4, 5
#: the seeded DNS storm: Zipf over the domains' A names, 10 % NXDOMAIN
STORM_QUERIES = 20_000
STORM_NX_SHARE = 0.10
STORM_NX_NAMES = 64
STORM_ZIPF_S = 1.1
STORM_SOCKETS = 16
STORM_WINDOW = 4
STORM_TIMEOUT_S = 2.0
#: the tier's answer TTLs, from docs/CONTRACT.md: a service A answer is
#: min(SRV-chain TTL, host TTL), SRV answers carry the service's ttl
A_TTL, SRV_TTL = 30, 60


def serve_domains() -> list:
    """16 domain names that cover every slice of both the 4-shard and
    the 5-shard ring, so that every worker carries traffic before and
    after the reshard: coverage first, then the next names in order."""
    from registrar_tpu_torch.shard import HashRing

    rings = [HashRing(range(SHARDS)), HashRing(range(RESHARDS))]
    names = [f"{k}.{SERVE_SUFFIX}" for k in range(1, 257)]
    chosen, covered = [], set()
    for name in names:
        slots = {(len(r.shard_ids), r.owner(name)) for r in rings}
        if not slots <= covered:
            chosen.append(name)
            covered |= slots
    check(len(covered) == SHARDS + RESHARDS, f"ring slots covered: {covered}")
    chosen += [n for n in names if n not in chosen][:SERVE_DOMAINS - len(chosen)]
    check(len(chosen) == SERVE_DOMAINS, f"{len(chosen)} domains")
    return sorted(chosen, key=names.index)


def instance_address(d: int, i: int) -> str:
    return f"10.{100 + d}.0.{10 + i}"


def expected_a(domain: str, addresses) -> list:
    return sorted((domain, "A", A_TTL, a) for a in addresses)


def expected_srv(domain: str, hosts: dict) -> tuple:
    """(answers, additionals) of ``_http._tcp.<domain>`` for the
    instances in ``hosts`` (hostname -> address), from docs/CONTRACT.md:
    one SRV per port per instance, one A additional per instance."""
    answers = sorted(
        (f"_http._tcp.{domain}", "SRV", SRV_TTL, f"0 10 {p} {h}.{domain}.")
        for h in hosts for p in SERVE_PORTS
    )
    additionals = sorted((f"{h}.{domain}", "A", A_TTL, a) for h, a in hosts.items())
    return answers, additionals


def rows(answers) -> list:
    return sorted((a.name, a.rtype, a.ttl, a.data) for a in answers)


def tier_config(zk_port: int, tmp: str, metrics_port: int, dns_port: int) -> dict:
    """etc/config.example.json's ``serve`` and ``cache`` blocks as written,
    with the socket in ``tmp``, the DNS frontend on a free port, the
    metrics listener on another, the child ZooKeeper and no chroot; the
    registration, adminIp and zookeeper tuning the loader reads with
    them."""
    with open(os.path.join(ROOT, "etc", "config.example.json")) as fh:
        cfg = json.load(fh)
    zookeeper = dict(cfg["zookeeper"])
    zookeeper.pop("chroot")
    zookeeper["servers"] = [{"host": "127.0.0.1", "port": zk_port}]
    serve = copy.deepcopy(cfg["serve"])
    check(serve["shards"] == SHARDS, f"serve.shards {serve['shards']}")
    serve["socketPath"] = os.path.join(tmp, "resolve.sock")
    serve["dns"]["port"] = dns_port
    return {
        "registration": cfg["registration"],
        "adminIp": cfg["adminIp"],
        "zookeeper": zookeeper,
        "cache": cfg["cache"],
        "serve": serve,
        "metrics": {"host": "127.0.0.1", "port": metrics_port},
        "logLevel": cfg["logLevel"],
    }


def cmdline(pid: int) -> list:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            return [a.decode() for a in fh.read().split(b"\0") if a]
    except OSError:
        return []


def children(pid: int) -> list:
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as fh:
                    fields = fh.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid:
                out.append(int(entry))
    return sorted(out)


def cpu_seconds(pid: int) -> float:
    """User plus system CPU time a process has used so far."""
    with open(f"/proc/{pid}/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def alive(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def zkcli(*args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "registrar_tpu_torch.tools.zkcli", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=60,
    )


def dig_records(out: str, section: str) -> list:
    """The records of one section of ``zkcli dig`` output."""
    lines = out.splitlines()
    start = f";; {section} SECTION:"
    if start not in lines:
        return []
    recs = []
    for line in lines[lines.index(start) + 1:]:
        if line.startswith(";"):
            break
        name, ttl, _in, rtype, data = line.split("\t")
        recs.append((name.rstrip("."), rtype, int(ttl), data))
    return sorted(recs)


class StormSocket(asyncio.DatagramProtocol):
    """One connected UDP socket of the storm; replies are matched to
    queries by id."""

    def __init__(self) -> None:
        self.waiting = {}
        self.transport = None

    def connection_made(self, transport) -> None:
        self.transport = transport
        sock = transport.get_extra_info("socket")
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)

    def datagram_received(self, data, _addr) -> None:
        fut = self.waiting.pop(int.from_bytes(data[:2], "big"), None)
        if fut is not None and not fut.done():
            fut.set_result((data, time.perf_counter()))


async def dns_storm(port: int, plan: list, expected: dict) -> dict:
    """Send ``plan`` (a list of (name, kind)) over STORM_SOCKETS connected
    UDP sockets, STORM_WINDOW queries in flight on each.  The first reply
    for each name is decoded and held to ``expected[name]`` (rcode and
    records); every later reply must equal it byte for byte after the
    id.  Returns the counts and the per-kind latencies."""
    from registrar_tpu_torch import dnsfront

    loop = asyncio.get_running_loop()
    sockets = []
    for _ in range(STORM_SOCKETS):
        _t, proto = await loop.create_datagram_endpoint(
            StormSocket, remote_addr=("127.0.0.1", port))
        sockets.append(proto)
    canonical = {}
    latency = {"A": [], "NXDOMAIN": []}
    timeouts = []
    next_id = [0] * STORM_SOCKETS

    def verify(name: str, data: bytes) -> None:
        body = data[2:]
        if canonical.get(name) == body:
            return
        resp = dnsfront.decode_response(data)
        rcode, records = expected[name]
        check(resp.rcode == rcode and not resp.tc,
              f"storm {name}: rcode {resp.rcode} tc {resp.tc}")
        got = sorted((n, t, ttl, text) for n, t, ttl, text in resp.answers)
        check(got == records, f"storm {name}: answers {got[:3]}...")
        canonical.setdefault(name, body)

    async def lane(s: int, queries: list) -> None:
        proto = sockets[s]
        for name, kind in queries:
            qid = next_id[s]
            next_id[s] = (qid + 1) & 0xFFFF
            fut = loop.create_future()
            proto.waiting[qid] = fut
            packet = dnsfront.build_query(
                qid, name, dnsfront.QTYPE_A,
                edns_size=dnsfront.DEFAULT_UDP_PAYLOAD_MAX)
            t0 = time.perf_counter()
            proto.transport.sendto(packet)
            try:
                data, t1 = await asyncio.wait_for(fut, STORM_TIMEOUT_S)
            except asyncio.TimeoutError:
                proto.waiting.pop(qid, None)
                timeouts.append(name)
                continue
            latency[kind].append((t1 - t0) * 1e3)
            verify(name, data)

    lanes = [[] for _ in range(STORM_SOCKETS * STORM_WINDOW)]
    for i, query in enumerate(plan):
        lanes[i % len(lanes)].append(query)
    t = time.perf_counter()
    try:
        await asyncio.gather(*(
            lane(i // STORM_WINDOW, q) for i, q in enumerate(lanes)))
    finally:
        for proto in sockets:
            proto.transport.close()
    wall = time.perf_counter() - t
    return {"wall_s": wall, "timeouts": timeouts, "latency": latency}


def storm_plan(domains: list) -> tuple:
    """The seeded storm: (plan, names of the NXDOMAIN pool)."""
    rng = np.random.default_rng(SEED)
    weights = 1.0 / np.arange(1, len(domains) + 1) ** STORM_ZIPF_S
    ranked = [domains[i] for i in rng.permutation(len(domains))]
    nx_names = [f"absent{k}.{SERVE_SUFFIX}" for k in range(STORM_NX_NAMES)]
    is_nx = rng.random(STORM_QUERIES) < STORM_NX_SHARE
    hit = rng.choice(len(ranked), size=STORM_QUERIES, p=weights / weights.sum())
    miss = rng.integers(0, STORM_NX_NAMES, size=STORM_QUERIES)
    plan = [
        (nx_names[m], "NXDOMAIN") if nx else (ranked[h], "A")
        for nx, h, m in zip(is_nx, hit, miss)
    ]
    return plan, nx_names


def percentile(values: list, q: float) -> float:
    return float(np.percentile(np.asarray(values), q))


async def stop_tier(tier, workers) -> None:
    """Stop the tier and every worker it spawned, whatever state a failed
    check left them in: SIGTERM, then SIGKILL for whatever still runs."""
    workers = set(workers) | set(children(tier.proc.pid))
    if tier.proc.poll() is None:
        tier.proc.send_signal(signal.SIGTERM)
        try:
            await asyncio.to_thread(tier.proc.wait, 15)
        except subprocess.TimeoutExpired:
            pass
    tier.stop()
    for pid in workers:
        if alive(pid) and "registrar_tpu_torch.shard" in cmdline(pid):
            os.kill(pid, signal.SIGKILL)


async def phase_serve(port: int, where: dict) -> None:
    from registrar_tpu_torch import dnsfront
    from registrar_tpu_torch.registration import register, unregister
    from registrar_tpu_torch.shard import HashRing, ShardClient
    from registrar_tpu_torch.zk.client import ZKClient

    servers = [("127.0.0.1", port)]
    domains = serve_domains()
    hosts = {
        dom: {f"lb-{i:02d}": instance_address(d, i)
              for i in range(SERVE_INSTANCES)}
        for d, dom in enumerate(domains)
    }
    with open(os.path.join(ROOT, "etc", "config.example.json")) as fh:
        example = json.load(fh)["registration"]
    sessions, tier, sc = [], None, None
    pids_seen = set()
    out = {"phase": "serve", "domains": len(domains),
           "instances": len(domains) * SERVE_INSTANCES}
    t_phase = time.perf_counter()
    try:
        # the fleet: one session per service, one register() per instance
        t = time.perf_counter()
        for dom in domains:
            sessions.append(await ZKClient(servers).connect())
        owned = {}

        async def register_domain(client, dom):
            reg = {k: v for k, v in example.items()
                   if k not in ("aliases", "heartbeatInterval")}
            reg["domain"] = dom
            for host, addr in hosts[dom].items():
                owned[(dom, host)] = await register(
                    client, reg, admin_ip=addr, hostname=host, settle_delay=0)

        await asyncio.gather(*(register_domain(c, d)
                               for c, d in zip(sessions, domains)))
        out["register_s"] = time.perf_counter() - t
        check(len(owned) == len(domains) * SERVE_INSTANCES, f"{len(owned)} registered")

        with tempfile.TemporaryDirectory() as tmp:
            metrics_port, dns_port = free_port(), free_port()
            cfg = tier_config(port, tmp, metrics_port, dns_port)
            cfg_path = write_json(os.path.join(tmp, "tier.json"), cfg)

            async def status():
                return json.loads(
                    await asyncio.to_thread(http_get, metrics_port, "/status"))

            async def tier_up(n):
                try:
                    st = await status()
                except OSError:
                    return None
                shards = st.get("shards") or {}
                if (len(shards) == n and all(s["up"] for s in shards.values())
                        and not st["shards_down"]):
                    return st
                return None

            # 1. start
            tier = Daemon(cfg_path, ["-m", "registrar_tpu_torch.tools.zkcli",
                                     "serve-sharded", "-f", cfg_path])
            st = await wait_until(lambda: tier_up(SHARDS), "the tier to start")
            out["tier_start_s"] = time.perf_counter() - tier.t0
            check(st["serve"]["dns"]["port"] == dns_port, f"dns {st['serve']['dns']}")
            proc = await asyncio.to_thread(zkcli, "status", "-f", cfg_path)
            check(proc.returncode == 0, f"zkcli status exited {proc.returncode}: "
                  f"{proc.stderr}")
            up = re.findall(r"^zkcli: status: shard (\d+) up ", proc.stderr, re.M)
            check(sorted(up) == [str(i) for i in range(SHARDS)],
                  f"zkcli status shard lines {up}: {proc.stderr}")
            worker_pids = sorted(s["pid"] for s in st["shards"].values())
            pids_seen.update(worker_pids)
            check(children(tier.proc.pid) == worker_pids,
                  f"tier children {children(tier.proc.pid)} vs {worker_pids}")
            for pid in worker_pids:
                argv = cmdline(pid)
                check(argv[1:3] == ["-m", "registrar_tpu_torch.shard"],
                      f"worker {pid} runs {argv[:3]}")

            # 2. unix-socket answers, cached and live
            sc = await ShardClient(cfg["serve"]["socketPath"]).connect()

            async def check_answers(doms, live_too=True):
                for dom in doms:
                    want_srv = expected_srv(dom, hosts[dom])
                    for live in ((False, True) if live_too else (False,)):
                        res = await sc.resolve(dom, "A", live=live)
                        check(rows(res.answers) == expected_a(dom, hosts[dom].values())
                              and not res.additionals,
                              f"A {dom} live={live}: {rows(res.answers)[:2]}")
                        res = await sc.resolve(f"_http._tcp.{dom}", "SRV", live=live)
                        check((rows(res.answers), rows(res.additionals)) == want_srv,
                              f"SRV {dom} live={live}: {rows(res.answers)[:2]}")

            t = time.perf_counter()
            await check_answers(domains)
            out["unix_answers_s"] = time.perf_counter() - t
            out["unix_resolves_checked"] = len(domains) * 4

            # 3. real DNS packets through zkcli dig, UDP and TCP
            dom = domains[0]
            server = f"127.0.0.1:{dns_port}"
            digs = {
                "udp_a": ["--server", server, dom],
                "tcp_a": ["--tcp", "--server", server, dom],
                "udp_srv": ["--server", server, f"_http._tcp.{dom}"],
                "tcp_srv": ["--tcp", "--server", server, f"_http._tcp.{dom}"],
                "udp_nxdomain": ["--server", server, f"absent.{SERVE_SUFFIX}"],
            }
            results = await asyncio.gather(*(
                asyncio.to_thread(zkcli, "dig", *a) for a in digs.values()))
            dig = dict(zip(digs, results))
            for key in ("udp_a", "tcp_a"):
                p = dig[key]
                check(p.returncode == 0 and "status: NOERROR," in p.stdout,
                      f"dig {key}: {p.returncode} {p.stdout} {p.stderr}")
                check(dig_records(p.stdout, "ANSWER")
                      == expected_a(dom, hosts[dom].values()), f"dig {key} answers")
            for key in ("udp_srv", "tcp_srv"):
                p = dig[key]
                check(p.returncode == 0 and "status: NOERROR," in p.stdout,
                      f"dig {key}: {p.returncode} {p.stdout} {p.stderr}")
                check((dig_records(p.stdout, "ANSWER"),
                       dig_records(p.stdout, "ADDITIONAL"))
                      == expected_srv(dom, hosts[dom]), f"dig {key} records")
            check("(UDP->TCP)" in dig["udp_srv"].stdout,
                  "a 100-record SRV answer did not truncate over UDP")
            p = dig["udp_nxdomain"]
            check(p.returncode == 1 and "status: NXDOMAIN," in p.stdout
                  and dig_records(p.stdout, "ANSWER") == []
                  and [r[1] for r in dig_records(p.stdout, "AUTHORITY")] == ["SOA"],
                  f"dig nxdomain: {p.returncode} {p.stdout}")
            out["dig_checked"] = sorted(digs)

            # 4. the DNS storm over the SO_REUSEPORT group
            plan, nx_names = storm_plan(domains)
            expected = {d: (dnsfront.RCODE_NOERROR, expected_a(d, hosts[d].values()))
                        for d in domains}
            expected.update({n: (dnsfront.RCODE_NXDOMAIN, []) for n in nx_names})
            before = await status()
            workers = {sid: s["pid"] for sid, s in before["shards"].items()}
            cpu0 = {sid: cpu_seconds(pid) for sid, pid in workers.items()}
            client0 = time.process_time()
            storm = await dns_storm(dns_port, plan, expected)
            client_cpu = time.process_time() - client0
            worker_cpu = {sid: cpu_seconds(pid) - cpu0[sid]
                          for sid, pid in workers.items()}
            after = await status()
            check(storm["timeouts"] == [],
                  f"{len(storm['timeouts'])} storm queries timed out")

            def dns_counts(snapshot):
                return {sid: s["dns"] for sid, s in snapshot["shards"].items()}

            hits = misses = 0
            per_shard = {}
            for sid, dns in dns_counts(after).items():
                prev = dns_counts(before).get(sid) or {"queries": {}}
                per_shard[sid] = (sum(dns["queries"].values())
                                  - sum(prev["queries"].values()))
                hits += dns["encode_cache"]["hits"]
                misses += dns["encode_cache"]["misses"]
            check(sum(per_shard.values()) == STORM_QUERIES,
                  f"tier counted {per_shard} of {STORM_QUERIES} storm queries")
            sheds = after["serve"]["sheds_total"]
            dns_sheds = {sid: dns["sheds"] for sid, dns in dns_counts(after).items()}
            check(not any(sheds.values())
                  and not any(any(v.values()) for v in dns_sheds.values()),
                  f"sheds {sheds}, DNS sheds {dns_sheds}")
            n_nx = len(storm["latency"]["NXDOMAIN"])
            out.update({
                "storm_queries": STORM_QUERIES,
                "storm_nxdomain": n_nx,
                "storm_timeouts": len(storm["timeouts"]),
                "storm_in_flight": STORM_SOCKETS * STORM_WINDOW,
                "storm_s": storm["wall_s"],
                "storm_qps": STORM_QUERIES / storm["wall_s"],
                "storm_a_p50_ms": percentile(storm["latency"]["A"], 50),
                "storm_a_p99_ms": percentile(storm["latency"]["A"], 99),
                "storm_nxdomain_p99_ms": percentile(storm["latency"]["NXDOMAIN"], 99),
                "storm_queries_by_shard": per_shard,
                # CPU seconds over storm seconds: near 1 is a saturated core
                "storm_client_cpu_share": client_cpu / storm["wall_s"],
                "storm_worker_cpu_share": {
                    sid: cpu / storm["wall_s"] for sid, cpu in worker_cpu.items()},
                "encode_cache_hit_ratio": hits / (hits + misses),
            })

            # 5. coherence: one instance leaves, the cached answer drops it
            victim_dom, victim = domains[0], "lb-00"
            victim_addr = hosts[victim_dom].pop(victim)
            session = sessions[0]
            t = time.perf_counter()
            await unregister(session, [owned[(victim_dom, victim)][0]])
            acked = time.perf_counter()

            async def dropped():
                res = await sc.resolve(victim_dom, "A")
                return victim_addr not in {a.data for a in res.answers}

            await wait_until(dropped, "the cached A answer to drop the instance",
                             timeout=10)
            out["coherence_lag_ms"] = (time.perf_counter() - acked) * 1e3
            out["coherence_write_ms"] = (acked - t) * 1e3

            async def dns_dropped():
                raw = await dnsfront.query_udp(
                    "127.0.0.1", dns_port, dnsfront.build_query(
                        7, victim_dom, dnsfront.QTYPE_A,
                        edns_size=dnsfront.DEFAULT_UDP_PAYLOAD_MAX))
                got = sorted(dnsfront.decode_response(raw).answers)
                return got == expected_a(victim_dom, hosts[victim_dom].values())

            await wait_until(dns_dropped, "the DNS answer to drop the instance",
                             timeout=10)
            out["coherence_dns_lag_ms"] = (time.perf_counter() - acked) * 1e3
            await check_answers([victim_dom])

            # 6. reshard 4 -> 5 under a polling resolver
            poll = {"n": 0, "errors": []}
            stop_polling = asyncio.Event()

            async def poller():
                async with ShardClient(cfg["serve"]["socketPath"]) as psc:
                    i = 0
                    while not stop_polling.is_set():
                        dom = domains[i % len(domains)]
                        i += 1
                        try:
                            res = await psc.resolve(dom, "A")
                            if rows(res.answers) != expected_a(dom, hosts[dom].values()):
                                poll["errors"].append(f"{dom}: wrong answer")
                        except Exception as err:  # noqa: BLE001 - counted
                            poll["errors"].append(f"{dom}: {err!r}")
                        poll["n"] += 1
                        await asyncio.sleep(0.001)

            polling = asyncio.create_task(poller())
            await asyncio.sleep(0.2)
            cfg["serve"]["shards"] = RESHARDS
            write_json(cfg_path, cfg)
            generation = after["serve"]["generation"]
            t = time.perf_counter()
            tier.proc.send_signal(signal.SIGHUP)
            handoff = re.compile(
                r"resharded to (\d+) shards \((\d+) warm domains handed off "
                r"in (\d+) ms\)")

            async def resharded():
                return next(filter(None, map(handoff.search, list(tier.errors))), None)

            m = await wait_until(resharded, "the reshard", timeout=30)
            st = await wait_until(lambda: tier_up(RESHARDS), "5 shards up")
            out["reshard_s"] = time.perf_counter() - t
            check(int(m.group(1)) == RESHARDS, m.group(0))
            check(st["serve"]["generation"] > generation, f"generation {st['serve']}")
            await asyncio.sleep(0.2)
            stop_polling.set()
            await polling
            check(poll["errors"] == [], f"poller errors {poll['errors'][:5]}")
            check(poll["n"] > 20, f"only {poll['n']} polls")
            out.update({"warm_handoff_ms": int(m.group(3)),
                        "warm_domains_moved": int(m.group(2)),
                        "reshard_polls": poll["n"],
                        "reshard_poll_errors": len(poll["errors"])})
            # every slice of the 5-shard ring answers its own domains
            ring = HashRing(range(RESHARDS))
            before = {sid: s["resolves_total"] for sid, s in st["shards"].items()}
            await check_answers(domains, live_too=False)
            st = await status()
            moved_on = {sid for sid, s in st["shards"].items()
                        if s["resolves_total"] > before[sid]}
            check(moved_on == {str(ring.owner(d)) for d in domains}
                  == {str(i) for i in range(RESHARDS)},
                  f"shards that answered after the reshard: {sorted(moved_on)}")
            pids_seen.update(s["pid"] for s in st["shards"].values())

            # 7. crash: kill -9 one worker; it respawns and answers resume
            victim_sid = "0"
            old_pid = st["shards"][victim_sid]["pid"]
            respawns = st["serve"]["respawns_total"]
            t = time.perf_counter()
            os.kill(old_pid, signal.SIGKILL)

            async def respawned():
                now = await tier_up(RESHARDS)
                if now and now["shards"][victim_sid]["pid"] != old_pid:
                    return now
                return None

            st = await wait_until(respawned, "the worker's respawn", timeout=30)
            out["respawn_s"] = time.perf_counter() - t
            check(st["serve"]["respawns_total"] == respawns + 1,
                  f"respawns_total {st['serve']['respawns_total']}")
            new_pid = st["shards"][victim_sid]["pid"]
            check(cmdline(new_pid)[1:3] == ["-m", "registrar_tpu_torch.shard"],
                  f"respawned worker runs {cmdline(new_pid)[:3]}")
            pids_seen.update(s["pid"] for s in st["shards"].values())
            await check_answers([d for d in domains if str(ring.owner(d)) == victim_sid])
            out["resumed_s"] = time.perf_counter() - t

            # 8. stop
            await sc.close()
            sc = None
            t = time.perf_counter()
            rc = await tier.signal_and_wait(signal.SIGTERM)
            out["stop_s"] = time.perf_counter() - t
            check(rc == 0, f"tier exited {rc} on SIGTERM: {tier.tail()}")
            left = [pid for pid in sorted(pids_seen) if alive(pid)
                    and "registrar_tpu_torch.shard" in cmdline(pid)]
            check(left == [], f"workers left behind: {left}")
            out["workers_seen"] = len(pids_seen)
            out["phase_s"] = time.perf_counter() - t_phase
    finally:
        if sc is not None:
            await sc.close()
        if tier is not None:
            await stop_tier(tier, pids_seen)
        for client in sessions:
            await client.close()
    emit({**out, **where})


# --- phase 7: the training step ---------------------------------------------


def _train_close(params: dict, x, y) -> dict:
    """The bf16 step against its float32 reference on one input: the loss
    within LOSS_RTOL, each gradient within GRAD_RTOL of the reference's
    largest element, and the updated weights bf16 on the card.  Returns
    the loss's abs error and each gradient's relative error."""
    from registrar_tpu_torch.graft_entry import (
        GRAD_RTOL, LOSS_RTOL, grad_error, loss_and_grads,
        loss_and_grads_reference, train_step,
    )

    loss, grads = loss_and_grads(params, x, y)
    ref_loss, ref = loss_and_grads_reference(params, x, y)
    check(bool(torch.isfinite(loss)), "non-finite training loss")
    check(abs(loss.item() - ref_loss.item()) <= LOSS_RTOL * abs(ref_loss.item()),
          f"bf16 loss {loss.item()!r} off the fp32 loss {ref_loss.item()!r}")
    errs = {"loss": abs(loss.item() - ref_loss.item())}
    new, _ = train_step(params, x, y)
    for name in ("w1", "w2"):
        got = new[name]
        check(got.device.type == "cuda" and got.dtype == torch.bfloat16
              and got.shape == params[name].shape,
              f"updated {name} on {got.device} as {got.dtype} {tuple(got.shape)}")
        errs[name] = grad_error({name: grads[name]}, ref)
        check(errs[name] <= GRAD_RTOL,
              f"gradient of {name} off the fp32 step's by {errs[name]:.3e} "
              "of its largest element")
    return errs


def phase_train(where: dict) -> None:
    from registrar_tpu_torch.graft_entry import (
        BATCH, DHID, DIN, DOUT, GRAD_RTOL, LOSS_RTOL, dryrun_multichip,
        dryrun_params, mesh_shape, train_step, train_step_reference,
    )

    dev = torch.device("cuda")
    params = dryrun_params(dev)
    ones = torch.ones((BATCH, DIN), dtype=torch.bfloat16, device=dev)
    zeros = torch.zeros((BATCH, DOUT), dtype=torch.float32, device=dev)
    cases = [(ones, zeros)]
    for i in range(N_TRAIN_CASES):
        rng = np.random.default_rng(SEED + 100 + i)
        x = rng.standard_normal((BATCH, DIN)).astype(np.float32)
        y = 0.1 * rng.standard_normal((BATCH, DOUT)).astype(np.float32)
        cases.append((torch.from_numpy(x).to(dev, torch.bfloat16),
                      torch.from_numpy(y).to(dev)))
    errs = [_train_close(params, x, y) for x, y in cases]
    _, step_loss = train_step(params, ones, zeros)

    step_ms = _time_ms(lambda: train_step(params, ones, zeros))
    reference_ms = _time_ms(lambda: train_step_reference(params, ones, zeros))
    # The least time the card could take for the step: the weights, x and
    # y read once, the new weights and the loss written once; the forward
    # (2 products) and the backward (dW2, dH, dW1) at the bf16 peak.
    moved = (2 * 2 * (DIN * DHID + DHID * DOUT) + 2 * BATCH * DIN
             + 4 * BATCH * DOUT + 4)
    flops = 4 * BATCH * DIN * DHID + 6 * BATCH * DHID * DOUT
    bound_ms = max(moved / H100_BYTES_PER_S, flops / H100_BF16_FLOPS) * 1e3

    # One rank on the card over NCCL, then the tp = 2 mesh on the host
    # over gloo (this card machine has one card), one after the other so
    # that dryrun_s is the NCCL run's alone: each is a child process and
    # most of its time is interpreter and rank start.
    def timed(*args, **kwargs):
        t = time.perf_counter()
        out = dryrun_multichip(*args, **kwargs)
        return out, time.perf_counter() - t

    nccl, dryrun_s = timed(1)
    gloo, gloo_s = timed(2, device="cpu")
    # x = ones rows, so the batch size does not change the loss.
    check(bool(np.isfinite(nccl["loss"])), f"dry run loss {nccl}")
    check(abs(nccl["loss"] - step_loss.item()) <= LOSS_RTOL * abs(step_loss.item()),
          f"dry run loss {nccl['loss']!r} vs the in-process step's "
          f"{step_loss.item()!r}")
    for run in (nccl, gloo):  # each rank held its gradients; the worst
        check(run["grad_err"] <= GRAD_RTOL, f"dry run gradients {run}")
    check((gloo["dp"], gloo["tp"]) == mesh_shape(2), f"gloo dry run {gloo}")
    check(abs(gloo["loss"] - step_loss.item()) <= LOSS_RTOL * abs(step_loss.item()),
          f"gloo dry run loss {gloo['loss']!r} vs {step_loss.item()!r}")
    emit({
        "phase": "train",
        "cases": len(cases),
        "max_abs_err_loss": max(e["loss"] for e in errs),
        "grad_rel_err_w1": max(e["w1"] for e in errs),
        "grad_rel_err_w2": max(e["w2"] for e in errs),
        "loss": step_loss.item(),
        "train_step_ms_median": statistics.median(step_ms),
        "train_step_ms_min": min(step_ms),
        "fp32_reference_ms_median": statistics.median(reference_ms),
        "bytes": moved,
        "operations": flops,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if moved / H100_BYTES_PER_S > flops / H100_BF16_FLOPS
        else "operations",
        "launches_timed": TIMED_LAUNCHES,
        "dryrun_nccl": nccl,
        "dryrun_s": dryrun_s,
        "dryrun_gloo_host": {**gloo, "backend": "gloo", "device": "cpu (host)",
                             "seconds": gloo_s},
        **where,
    })


# --- phase 8: the availability harness --------------------------------------


class _StormEnvelope(logging.Handler):
    """Keeps the storm workload's summary that the ``overload-storm``
    scenario logs once its checks have passed."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.summary = None

    def emit(self, record: logging.LogRecord) -> None:
        if str(record.msg).startswith("overload-storm envelope"):
            self.summary = record.args[-1]


async def phase_slo(where: dict) -> None:
    from registrar_tpu_torch.testing import slo

    quick = [fid for fid, _kw in slo.TRACES[SLO_TRACE]["scenarios"]]
    check(set(quick) == set(slo.FAULT_IDS),
          f"the quick trace covers {sorted(set(quick))}, the catalog "
          f"{sorted(slo.FAULT_IDS)}")
    # Reconnect and degrade warnings are the simulator working.
    quiet = logging.getLogger("registrar_tpu_torch")
    level = quiet.level
    quiet.setLevel(logging.ERROR)
    storm_log = logging.getLogger(slo.__name__)
    envelope = _StormEnvelope()
    storm_log.addHandler(envelope)
    storm_log.setLevel(logging.INFO)
    t = time.perf_counter()
    try:
        report = await slo.run_trace(SLO_TRACE, seed=SLO_SEED, levers=True)
    finally:
        quiet.setLevel(level)
        storm_log.removeHandler(envelope)
        storm_log.setLevel(logging.NOTSET)
    wall = time.perf_counter() - t
    storm = envelope.summary
    check(storm is not None, "overload-storm logged no envelope")
    faults = report["faults"]
    unprobed = [fid for fid in quick
                if fid not in faults or not faults[fid]["injected"]
                or faults[fid].get("availability") is None]
    check(unprobed == [], f"fault classes not injected and probed: {unprobed}")
    gate = report["gate_metrics"]
    check(gate["fault_classes_measured"] >= SLO_MIN_MEASURED,
          f"only {gate['fault_classes_measured']} fault classes measured")
    check(report["probes"]["total"] > 100, f"probes {report['probes']}")
    check(report["shards"]["shards"] == 2 and report["ensemble"]["members"] == 3,
          f"trace shape {report['shards']} {report['ensemble']}")
    emit({
        "phase": "slo",
        "trace": SLO_TRACE,
        "seed": SLO_SEED,
        "levers": True,
        "members": report["members"],
        "fault_classes": len(quick),
        **gate,
        "availability_by_class": {
            fid: faults[fid]["availability"] for fid in quick},
        "mttr_s_by_class": {fid: faults[fid]["mttr_s_mean"] for fid in quick},
        "probes": report["probes"],
        # the storm clients' own explicit sheds, the scenario's check
        "storm_client_sheds": storm["sheds_total"],
        "storm_timeouts": storm["timeouts_total"],
        "loris": storm["loris"],
        "trace_s": report["duration_s"],
        "phase_s": wall,
        **where,
    })


async def host_phases(port: int, where: dict, server_pid=None) -> None:
    await phase_registration(port, where)
    await phase_fleet(port, where, server_pid)
    await phase_daemon(port, where)
    await phase_serve(port, where)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    # Fails here, before any result, outside a checkout of the repository.
    import registrar_tpu_torch  # noqa: F401

    where = phase_device()
    phase_model(where)
    with ZooKeeperChild() as zk:
        asyncio.run(host_phases(zk.port, where, zk.proc.pid))
    phase_train(where)
    asyncio.run(phase_slo(where))
    print(json.dumps({"kernels": []}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
