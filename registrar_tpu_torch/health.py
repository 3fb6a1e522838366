"""Periodic command-based health checking.

Rebuild of reference lib/health.js:22-148: every ``interval`` seconds run a
shell command with a ``timeout`` (SIGTERM to the command's whole process
group on expiry — the shell runs in its own session so grandchildren
can't outlive the kill — 1 MiB output cap); a
check fails on non-zero exit (unless ``ignore_exit_status``) or when stdout
fails an optional regex match.  Failures accumulate; at ``threshold``
failures within the sliding ``period`` window the service is declared down.

Event surface (mirrors the reference's object-mode stream records,
lib/health.js:77-84,117-120): listeners on ``data`` receive dicts::

    {"type": "ok",   "command": ...}
    {"type": "fail", "command": ..., "err": <Exception>, "failures": <int>,
     "isDown": <bool>, "threshold": <int>}

plus ``end`` when stopped.  Defaults are the reference's exactly
(BASELINE.md): interval 60 s, exec timeout 1 s, threshold 5, period 300 s.

Deliberate fixes over the reference (its window logic is acknowledged
broken — reference README.md:99-102, HEAD-2282/HEAD-2283; SURVEY.md §7):

  * the failure window really slides: failures older than ``period`` are
    pruned on every check, instead of one timer wiping the list at odd
    times (reference lib/health.js:60-64,130);
  * a successful check while down clears the down state and the window, so
    one later blip cannot instantly re-trigger isDown (the reference's
    ``down`` latch never resets, lib/health.js:66-68);
  * ``stdout_match.invert`` is implemented (the reference validates it at
    lib/health.js:32-33 but never applies it).
"""

from __future__ import annotations

import asyncio
import logging
import os
import re
import signal
import time
from typing import Any, Dict, List, Mapping, Optional

from registrar_tpu_torch import trace
from registrar_tpu_torch.events import EventEmitter

log = logging.getLogger("registrar_tpu_torch.health")

#: Reference defaults, lib/health.js:43,51,56,58.
DEFAULT_INTERVAL_S = 60.0
DEFAULT_TIMEOUT_S = 1.0
DEFAULT_THRESHOLD = 5
DEFAULT_PERIOD_S = 300.0
MAX_OUTPUT_BYTES = 1024 * 1024  # reference lib/health.js:50 maxBuffer


class HealthCheckError(Exception):
    """A single failed check (non-zero exit, timeout, or stdout mismatch)."""

    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(message)
        self.code = code


class DownError(Exception):
    """Threshold failures within the window — the MultiError analog
    (reference lib/health.js:73)."""

    def __init__(self, errors: List[Exception]):
        self.errors = list(errors)
        super().__init__(
            f"{len(self.errors)} consecutive health check failures: "
            + "; ".join(str(e) for e in self.errors)
        )


def _compile_stdout_match(stdout_match: Optional[Mapping[str, Any]]):
    """Compile the reference's ``stdoutMatch{pattern,flags,invert}`` config
    (JS RegExp flags mapped to Python re flags)."""
    if not stdout_match or not stdout_match.get("pattern"):
        return None, False
    flags = 0
    for ch in stdout_match.get("flags") or "":
        if ch == "i":
            flags |= re.IGNORECASE
        elif ch == "m":
            flags |= re.MULTILINE
        elif ch == "s":
            flags |= re.DOTALL
        elif ch in ("g", "u", "y"):
            pass  # stateful/unicode JS flags: no Python equivalent needed
        else:
            raise ValueError(f"unsupported stdoutMatch flag: {ch!r}")
    return re.compile(stdout_match["pattern"], flags), bool(
        stdout_match.get("invert")
    )


class HealthCheck(EventEmitter):
    """Periodic checker; see module docstring for the event surface."""

    def __init__(
        self,
        command: str,
        interval: float = DEFAULT_INTERVAL_S,
        timeout: float = DEFAULT_TIMEOUT_S,
        threshold: int = DEFAULT_THRESHOLD,
        period: float = DEFAULT_PERIOD_S,
        ignore_exit_status: bool = False,
        stdout_match: Optional[Mapping[str, Any]] = None,
    ):
        super().__init__()
        if not isinstance(command, str) or not command:
            raise ValueError("command must be a non-empty string")
        for name, val in (
            ("interval", interval), ("timeout", timeout), ("period", period),
        ):
            if not isinstance(val, (int, float)) or val <= 0:
                raise ValueError(f"{name} must be a positive number")
        if not isinstance(threshold, int) or threshold < 1:
            raise ValueError("threshold must be a positive integer")
        self.command = command
        self.interval = float(interval)
        self.timeout = float(timeout)
        self.threshold = threshold
        self.period = float(period)
        self.ignore_exit_status = bool(ignore_exit_status)
        self._regex, self._invert = _compile_stdout_match(stdout_match)

        self._fails: List[tuple] = []  # (monotonic_ts, HealthCheckError)
        self._down = False
        self._task: Optional[asyncio.Task] = None
        self._running = False
        #: per-instance tracer override; None = process default
        self.tracer = None

    @property
    def is_down(self) -> bool:
        return self._down

    @property
    def running(self) -> bool:
        return self._running

    def start(self) -> "HealthCheck":
        if not self._running:
            self._running = True
            self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    def stop(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.emit("end")

    #: Crash-restart backoff bounds for the check loop (below).
    CRASH_BACKOFF_INITIAL_S = 1.0
    CRASH_BACKOFF_MAX_S = 60.0

    async def _loop(self) -> None:
        # An unexpected exception must never silently end health checking
        # while the host stays registered — that would disable the exact
        # protection the checker exists to provide.  A
        # crash is surfaced on ``error``, *counted as a failed check* (so
        # repeated crashes cross the threshold and deregister the host
        # through the normal fail path), and the loop restarts with
        # exponential backoff.
        backoff = self.CRASH_BACKOFF_INITIAL_S
        while self._running:
            try:
                await self.check_once()
                backoff = self.CRASH_BACKOFF_INITIAL_S
            except asyncio.CancelledError:
                raise
            except Exception as err:  # noqa: BLE001
                log.exception("health check crashed; restarting in %gs", backoff)
                self.emit("error", err)
                record = self._mark_down(
                    HealthCheckError(f"health check crashed: {err!r}")
                )
                self.emit("data", record)
                if not self._running:
                    return
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, self.CRASH_BACKOFF_MAX_S)
                continue
            if not self._running:
                return
            await asyncio.sleep(self.interval)

    async def check_once(self) -> Dict[str, Any]:
        """Run one check and emit its ``data`` record (also returned)."""
        with trace.tracer_for(self).span(
            "health.exec", command=self.command
        ) as sp:
            env = None
            if sp.trace_id is not None:
                # Stamp the subprocess with the active trace:
                # a check command that logs $REGISTRAR_TRACE_ID makes
                # its own shell output joinable to the health.exec span
                # — the same ids the shard wire extension carries, so a
                # health-driven deregistration's whole causal chain
                # greps by one token.  With tracing off, env is None
                # and the child inherits the parent environment
                # untouched (parity).
                env = dict(os.environ)
                env["REGISTRAR_TRACE_ID"] = sp.trace_id
                env["REGISTRAR_SPAN_ID"] = sp.span_id
            err = await self._run_command(env)
            if err is not None:
                sp.set_attr("failed", str(err))
        if err is None:
            record = self._mark_ok()
        else:
            record = self._mark_down(err)
        self.emit("data", record)
        return record

    async def _run_command(
        self, env: Optional[Dict[str, str]] = None
    ) -> Optional[HealthCheckError]:
        log.debug("check: running %s", self.command)
        try:
            proc = await asyncio.create_subprocess_shell(
                self.command,
                env=env,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE,
                # Own process group: the shell routinely spawns
                # grandchildren (pipelines, `curl | grep`, & chains) that
                # inherit it, so the timeout kill below can take out the
                # WHOLE group — killing only the shell leaks any child
                # that outlives it (and a signal-ignoring child used to
                # survive every escalation while holding our pipes open).
                start_new_session=hasattr(os, "killpg"),
            )
        except OSError as e:
            return HealthCheckError(f"{self.command} failed to spawn: {e}")
        try:
            stdout, exceeded = await asyncio.wait_for(
                self._drain_capped(proc), timeout=self.timeout
            )
        except asyncio.CancelledError:
            # stop() mid-check: don't orphan the child process.  The
            # bounded reap also closes the pipe transports explicitly —
            # their fds would otherwise stay registered until a pipe EOF
            # that never comes while a signal-ignoring grandchild holds
            # the inherited write ends (the wait itself is NOT the
            # hazard: asyncio resolves wait() when the child watcher
            # reaps the shell, independent of the pipes).
            await self._force_reap(proc)
            raise
        except asyncio.TimeoutError:
            # SIGTERM to the whole process group, matching the
            # reference's killSignal (lib/health.js:48); escalate if it
            # lingers.  Drain the pipes so their transports are closed
            # and the child isn't wedged on a full pipe; after the grace
            # period escalate to the bounded group-SIGKILL reap (the
            # pipes may be held open by a signal-ignoring grandchild —
            # which the group KILL now reaps too).
            self._kill_group(proc, signal.SIGTERM)
            try:
                await asyncio.wait_for(self._drain(proc), timeout=1.0)
            except asyncio.TimeoutError:
                await self._force_reap(proc)
            return HealthCheckError(
                f"{self.command} timed out after {self.timeout}s"
            )

        if exceeded:
            return HealthCheckError(f"{self.command} exceeded output limit")
        if proc.returncode != 0 and not self.ignore_exit_status:
            return HealthCheckError(
                f"{self.command} exited {proc.returncode}", code=proc.returncode
            )
        if self._regex is not None:
            text = stdout.decode("utf-8", errors="replace")
            matched = self._regex.search(text) is not None
            if matched == self._invert:  # invert=False: fail when no match
                return HealthCheckError(
                    f"stdout match ({self._regex.pattern}) failed", code=-1
                )
        return None

    @staticmethod
    def _kill_group(proc, sig) -> None:
        """Signal the child's whole process group, shell included.

        The shell is spawned with ``start_new_session=True``, so its pid
        doubles as the group id and every grandchild it forked (that did
        not setsid itself) is in the group — ``os.killpg`` reaches the
        processes a shell-only ``terminate()``/``kill()`` leaks.  Falls
        back to signalling the shell alone when the group is already
        gone, or on platforms without process groups."""
        if hasattr(os, "killpg"):
            try:
                os.killpg(proc.pid, sig)
                return
            except ProcessLookupError:
                return  # whole group already exited
            except (PermissionError, OSError):
                pass  # e.g. pid is not a group leader: fall through
        try:
            if sig == getattr(signal, "SIGKILL", None):
                proc.kill()
            else:
                proc.terminate()
        except ProcessLookupError:
            pass

    async def _force_reap(self, proc) -> None:
        """Group SIGKILL, reap (bounded), and close the pipe transports.

        The ONE copy of the reap escalation (both the timeout and
        cancellation paths end here).  ``wait()`` resolves when the
        child watcher reaps the killed shell — asyncio sets the exit
        waiters in ``_process_exited``, with pipe EOF playing no part —
        so the 1 s bound only guards against a wedged/absent watcher.
        The explicit transport close matters separately: the pipe
        read-transports stay registered until EOF, which never comes
        while a signal-ignoring grandchild holds the inherited write
        ends — without it their open fds linger for the garbage
        collector.  ``_transport`` is asyncio private API, so its
        absence (a future internals change) degrades to skipping the
        close rather than crashing the reap path."""
        self._kill_group(proc, getattr(signal, "SIGKILL", signal.SIGTERM))
        transport = getattr(proc, "_transport", None)
        try:
            await asyncio.wait_for(proc.wait(), timeout=1.0)
        except asyncio.TimeoutError:
            # The watcher did not reap within the bound — wedged watcher
            # or dead watcher thread.  Close the pipe transports (when
            # the private API still exposes them) and give the reap one
            # more BOUNDED chance: transport.close() frees fds but only
            # _process_exited resolves the exit waiters, so an unbounded
            # second wait() could hang stop() forever in exactly the
            # wedged-watcher case this timeout exists for.  The child is
            # already SIGKILLed; abandoning leaves at worst a zombie.
            if transport is not None:
                transport.close()
            try:
                await asyncio.wait_for(proc.wait(), timeout=1.0)
            except asyncio.TimeoutError:
                log.warning(
                    "health check child not reaped after SIGKILL; abandoning"
                )
        else:
            if transport is not None:
                transport.close()  # idempotent

    async def _drain_capped(self, proc) -> "tuple[bytes, bool]":
        """Read the child's output to EOF with the reference's *streaming*
        output cap (exec maxBuffer, lib/health.js:45-52): the child is
        SIGTERMed the moment stdout or stderr crosses MAX_OUTPUT_BYTES,
        and at most the cap is ever retained in memory — a fast-writing
        runaway command cannot balloon the daemon's RSS while the timeout
        window runs.  Returns (stdout up to the cap, exceeded?)."""
        exceeded = False

        async def read(stream, keep: bool) -> bytes:
            nonlocal exceeded
            chunks: List[bytes] = []
            total = 0
            while True:
                chunk = await stream.read(65536)
                if not chunk:
                    return b"".join(chunks)
                before, total = total, total + len(chunk)
                if total > MAX_OUTPUT_BYTES:
                    if not exceeded:
                        exceeded = True
                        self._kill_group(proc, signal.SIGTERM)
                    # Keep only up to the cap; drain (and discard) the
                    # rest so the pipe reaches EOF and the child can die.
                    if keep and before < MAX_OUTPUT_BYTES:
                        chunks.append(chunk[: MAX_OUTPUT_BYTES - before])
                    continue
                if keep:
                    chunks.append(chunk)

        stdout, _ = await asyncio.gather(
            read(proc.stdout, True), read(proc.stderr, False)
        )
        await proc.wait()
        return stdout, exceeded

    @staticmethod
    async def _drain(proc) -> None:
        """Discard remaining pipe output and reap the child."""

        async def sink(stream) -> None:
            while await stream.read(65536):
                pass

        await asyncio.gather(sink(proc.stdout), sink(proc.stderr))
        await proc.wait()

    def _mark_ok(self) -> Dict[str, Any]:
        log.debug("healthCheck: %s ok", self.command)
        if self._down or self._fails:
            # Recovery clears the window (fix over the reference's
            # never-resetting down latch, see module docstring).
            self._down = False
            self._fails.clear()
        return {"type": "ok", "command": self.command}

    def _mark_down(self, err: HealthCheckError) -> Dict[str, Any]:
        log.debug("check: %s failed: %s", self.command, err)
        now = time.monotonic()
        cutoff = now - self.period
        self._fails = [(ts, e) for ts, e in self._fails if ts >= cutoff]
        self._fails.append((now, err))
        out_err: Exception = err
        if not self._down and len(self._fails) >= self.threshold:
            self._down = True
            out_err = DownError([e for _, e in self._fails])
        return {
            "type": "fail",
            "command": self.command,
            "err": out_err,
            "failures": len(self._fails),
            "isDown": self._down,
            "threshold": self.threshold,
        }


def create_health_check(
    command: Optional[str] = None, **options: Any
) -> HealthCheck:
    """Factory mirroring the reference's createHealthCheck(options)
    (lib/health.js:22).  Accepts either snake_case kwargs or a config-shaped
    mapping with the reference's camelCase keys::

        create_health_check(command="...", interval=5, threshold=3)
        create_health_check(**{"command": "...", "ignoreExitStatus": True,
                               "stdoutMatch": {"pattern": "ok"}})
    """
    rename = {
        "ignoreExitStatus": "ignore_exit_status",
        "stdoutMatch": "stdout_match",
    }
    kwargs = {rename.get(k, k): v for k, v in options.items()}
    # The reference's interval/timeout/period are milliseconds; the Python
    # surface is seconds.  Config-file translation happens in config.py.
    return HealthCheck(command=command, **kwargs)
