"""The registrar daemon mainline (CLI).

Rebuild of reference main.js:102-200.  Usage::

    python -m registrar_tpu_torch -f /opt/registrar/etc/config.json [-v ...]

Behavior parity:

  * ``-f`` config file (required), ``-v`` repeatable verbosity escalation,
    ``-h`` usage (reference main.js:29-46,107-121);
  * log level: LOG_LEVEL env < config ``logLevel`` < ``-v`` flags
    (reference main.js:24,66-76); bunyan-shaped JSON lines on stdout;
  * ZooKeeper connect retries forever with exponential 1-90 s backoff
    (reference lib/zk.js:97-101);
  * ``session_expired`` => log fatal + ``exit(1)`` so the supervisor
    (systemd/SMF) restarts the process with a fresh session — crash-restart
    is the load-bearing recovery design (reference main.js:141-144,
    SURVEY.md §3.4).  The opt-in ``surviveSessionExpiry`` config key
    absorbs expiry in-process instead: the client builds a
    fresh session, the agent re-registers, and exit(1) only remains as
    the fallback when the rebirth circuit breaker trips;
  * every lifecycle event is logged, with heartbeat failures edge-triggered
    through an ``is_down`` latch so a long outage logs once
    (reference main.js:149,187-198).

Addition over the reference: SIGTERM/SIGINT run a graceful stop that
closes the ZK session, which deletes the ephemerals *immediately* instead
of waiting out the session timeout — an instance drained with
``systemctl stop registrar`` leaves DNS as fast as Binder's cache allows.
(The reference is stopped with SMF ``:kill`` and waits for expiry,
README.md:85-87.)

Zero-downtime restarts (opt-in ``restart`` config block):

  * ``mode: "handoff"`` — SIGTERM persists the live session's handoff
    state (:mod:`registrar_tpu_torch.statefile`) and detaches the TCP
    connection WITHOUT closing the session: the ephemerals stay up for
    the negotiated timeout, the successor process reattaches the same
    session from the state file and verifies (not recreates) the
    registration — a watching resolver sees **zero** NO_NODE across the
    restart.  Every degraded shape (stale/foreign/tampered state file,
    config change, a reattach the server refuses) falls back to today's
    fresh-session registration;
  * ``mode: "drain"`` — SIGTERM unregisters cleanly, waits
    ``drainGraceSeconds``, then exits 0;
  * a second SIGTERM/SIGINT during a wedged graceful stop forces an
    immediate exit (:data:`EX_FORCED`) — operators are never pushed to
    SIGKILL;
  * SIGHUP re-reads the config file and hot-applies the registration
    delta through the agent's single-flight pipeline lock (unchanged
    znodes are never touched); keys that cannot hot-apply are named in
    a warning and need a restart.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import sys
import time

from registrar_tpu_torch import __version__
from registrar_tpu_torch import jlog
from registrar_tpu_torch import statefile
from registrar_tpu_torch import trace as trace_mod
from registrar_tpu_torch.events import spawn_owned
from registrar_tpu_torch.agent import register_plus
from registrar_tpu_torch.config import (
    Config,
    ConfigError,
    ConfigUnreadableError,
    RestartConfig,
    load_config,
)
from registrar_tpu_torch.registration import unlink_tolerant
from registrar_tpu_torch.zk.client import (
    ZKClient,
    connect_with_backoff,
)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="registrar",
        description="service-discovery sidecar: registers this host in "
        "ZooKeeper for Binder-served DNS",
    )
    parser.add_argument(
        "-f", "--file", metavar="FILE", required=True,
        help="configuration file to process",
    )
    parser.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="verbose output; use multiple times for more verbosity",
    )
    parser.add_argument(
        "-n", "--check-config", action="store_true",
        help="validate the configuration file and exit (0 = valid); "
        "no ZooKeeper connection is made",
    )
    parser.add_argument(
        "--version", action="version", version=f"registrar {__version__}"
    )
    return parser.parse_args(argv)


#: exit status for configuration errors (BSD sysexits EX_CONFIG).
#: Distinct from the generic exit(1) used for runtime failures (session
#: expiry, failed initial registration) so the supervisor can crash-
#: restart on the latter but stop retrying a config that can never work
#: (systemd/registrar.service sets RestartPreventExitStatus=78).
EX_CONFIG = 78

#: exit status when a SECOND SIGTERM/SIGINT lands while a graceful stop
#: is still running: the operator's escape hatch out
#: of a wedged shutdown (an unreachable ensemble stalling the drain, a
#: long drainGraceSeconds) without reaching for SIGKILL.  Distinct from
#: 0 (clean stop) and 1 (runtime failure) so supervisors and humans can
#: tell a forced exit from both.  BSD sysexits EX_SOFTWARE.
EX_FORCED = 70


def configure(argv=None) -> Config:
    """Parse args + config, set up logging (reference main.js:52-84)."""
    args = parse_args(argv)
    log = jlog.setup("registrar")
    try:
        cfg = load_config(args.file)
    except ConfigUnreadableError as e:
        # Read failures (file not provisioned yet, permissions) are often
        # transient — exit 1 so the supervisor's restart can cure them,
        # unlike the EX_CONFIG path below which it must not retry.
        log.critical("unable to read configuration %s", args.file,
                     exc_info=(type(e), e, e.__traceback__))
        sys.exit(1)
    except ConfigError as e:
        log.critical("invalid configuration %s", args.file,
                     exc_info=(type(e), e, e.__traceback__))
        sys.exit(EX_CONFIG)
    if cfg.unknown_keys:
        # Ignored like the reference ignores them — but a typo like
        # "healthcheck" silently disabling health checking is worth a
        # warning.  Emitted BEFORE the config's own logLevel applies, so
        # a {"logLevel": "error"} config cannot suppress it.
        log.warning(
            "configuration has unrecognized top-level keys (ignored): %s",
            ", ".join(cfg.unknown_keys),
            extra={"zdata": {"keys": list(cfg.unknown_keys)}},
        )
    if cfg.log_level:
        level = jlog.LEVELS.get(cfg.log_level.lower())
        if level is None:
            log.critical("invalid logLevel %r", cfg.log_level)
            sys.exit(EX_CONFIG)
        logging.getLogger().setLevel(level)
    if args.verbose:
        jlog.escalate(args.verbose)
    if args.check_config:
        # nginx -t style pre-flight for config-agent/CI pipelines: the same
        # validation the daemon would apply, without touching ZooKeeper —
        # including the registration schema check register_plus runs at
        # startup (reference lib/register.js:174-201), which load_config
        # alone does not cover.
        from registrar_tpu_torch.registration import _validate_registration

        try:
            _validate_registration(cfg.registration)
        except ValueError as e:
            log.critical("invalid registration in %s", args.file,
                         exc_info=(type(e), e, e.__traceback__))
            sys.exit(EX_CONFIG)
        log.info("configuration OK", extra={"zdata": {"file": args.file}})
        sys.exit(0)
    log.info("configuration loaded from %s", args.file,
             extra={"zdata": {"file": args.file}})
    return cfg


def _client_from_config(cfg: Config) -> ZKClient:
    """The daemon's ZKClient settings, in ONE place: the cold-start path
    and the handoff-resume path must run with identical client tuning —
    a zookeeper key honored by one and silently dropped by the other
    would make a restarted daemon behave differently from a cold one."""
    return ZKClient(
        cfg.zookeeper.servers,
        timeout_ms=cfg.zookeeper.timeout_ms,
        connect_timeout_ms=cfg.zookeeper.connect_timeout_ms,
        chroot=cfg.zookeeper.chroot,
        request_timeout_ms=cfg.zookeeper.request_timeout_ms,
        survive_session_expiry=cfg.survive_session_expiry,
        max_session_rebirths=cfg.max_session_rebirths,
        can_be_read_only=cfg.zookeeper.can_be_read_only,
        connect_race_stagger_ms=cfg.zookeeper.connect_race_stagger_ms,
        ping_interval_ms=cfg.zookeeper.ping_interval_ms,
        dead_after_ms=cfg.zookeeper.dead_after_ms,
    )


async def _drain_unregister(zk: ZKClient, znodes, log) -> list:
    """Best-effort deregistration for the drain shutdown.

    Unlike the pipeline's strict ``unregister``, this walk NEVER aborts
    early: the whole point of a drain is that every record this host
    still serves leaves DNS before the process exits, so an
    already-absent node (health-down raced us, an operator deleted one
    out-of-band) is success, a still-shared service node is left in
    place as usual, and any other per-node error is logged while the
    remaining nodes are still processed.  Returns the nodes deleted.
    """
    deleted = []
    for node in znodes:
        try:
            # check: disable=await-in-lock-free-mutator -- shutdown-only
            # walk: ee.stop() has already run, so no recovery actor is
            # alive to contend, and the agent's lock died with it
            outcome = await unlink_tolerant(zk, node)
        except asyncio.CancelledError:
            raise
        except Exception as err:  # noqa: BLE001 - keep draining the rest
            log.error("restart: drain could not delete %s", node,
                      extra={"zdata": {"err": repr(err)}})
            continue
        if outcome == "deleted":
            deleted.append(node)
    return deleted


async def _attempt_resume(cfg: Config, restart_cfg: RestartConfig,
                          fingerprint: str, log):
    """Try to adopt the predecessor's session from the state file.

    Returns ``(client_or_None, manifest_or_None, attempted)``:

      * ``(client, manifest, True)`` — the session reattached; the agent
        should verify-not-recreate against ``manifest``;
      * ``(client, None, True)`` — a resume was staged but the server
        refused it (expired in the gap): the client holds a FRESH
        session, register normally;
      * ``(None, None, True)`` — the state file was unusable (stale
        stamp, config-hash mismatch, foreign/corrupt/short passwd):
        connect + register exactly as a cold start;
      * ``(None, None, False)`` — no state file at all (a normal cold
        start, nothing to report).
    """
    try:
        state = statefile.load(restart_cfg.state_file)
    except statefile.StateFileMissing:
        return None, None, False
    except statefile.StateFileError as e:
        log.warning(
            "restart: unusable state file (%s); starting fresh", e,
            extra={"zdata": {"reason": e.reason,
                             "file": restart_cfg.state_file}},
        )
        return None, None, True
    reason = statefile.check_resumable(state, fingerprint)
    if reason is not None:
        log.warning(
            "restart: state file not resumable (%s); starting fresh",
            reason,
            extra={"zdata": {"reason": reason,
                             "session": f"0x{state.session_id:x}",
                             "file": restart_cfg.state_file}},
        )
        return None, None, True
    zk = _client_from_config(cfg)
    zk.seed_session(
        state.session_id, state.passwd,
        negotiated_timeout_ms=state.negotiated_timeout_ms,
        last_zxid=state.last_zxid,
    )
    log.info(
        "restart: resuming predecessor session",
        extra={"zdata": {"session": f"0x{state.session_id:x}",
                         "predecessorPid": state.pid,
                         "znodes": list(state.znodes)}},
    )
    await connect_with_backoff(zk)
    if zk.session_id == state.session_id:
        log.info(
            "restart: session resumed; verifying registration in place",
            extra={"zdata": {"session": f"0x{zk.session_id:x}"}},
        )
        return zk, list(state.znodes), True
    # seed refused: the client already fell back to a fresh session
    # (zk.client resume_refused path) — register from scratch.
    log.warning(
        "restart: session resume refused (expired in the gap); "
        "registering fresh",
        extra={"zdata": {"stale": f"0x{state.session_id:x}",
                         "session": f"0x{zk.session_id:x}"}},
    )
    return zk, None, True


async def run(cfg: Config, *, _exit=sys.exit) -> None:
    """Connect, register, and serve events until stopped or expired."""
    log = logging.getLogger("registrar")

    # -- operation tracing (opt-in `observability` block) ----------
    # Installed FIRST so the initial connect/registration is traced too.
    # Absent block: the module default stays trace.DISABLED and not a
    # single span, log field, or metric series is added (parity pinned
    # by tests/test_trace.py).
    tracer = None
    trace_filter = None
    obs = cfg.observability
    if obs is not None:
        tracer = trace_mod.Tracer(
            sample_rate=obs.sample_rate,
            slow_span_ms=obs.slow_span_ms,
            max_spans=obs.flight_recorder_spans,
        )
        trace_mod.set_tracer(tracer)
        trace_filter = trace_mod.TraceContextFilter()
        for handler in logging.getLogger().handlers:
            handler.addFilter(trace_filter)
        log.info(
            "observability: tracing enabled",
            extra={"zdata": {"sampleRate": obs.sample_rate,
                             "slowSpanMs": obs.slow_span_ms,
                             "flightRecorderSpans":
                                 obs.flight_recorder_spans}},
        )
    try:
        await _run_traced(cfg, log, tracer, _exit=_exit)
    finally:
        if obs is not None:
            trace_mod.set_tracer(None)
            for handler in logging.getLogger().handlers:
                handler.removeFilter(trace_filter)


async def _run_traced(cfg: Config, log, tracer, *, _exit=sys.exit) -> None:
    restart_cfg = cfg.restart
    fingerprint = (
        statefile.config_fingerprint(
            cfg.registration, cfg.admin_ip, cfg.zookeeper.chroot
        )
        if restart_cfg is not None
        else None
    )

    zk = None
    resume_manifest = None
    resume_attempted = False
    if restart_cfg is not None:
        zk, resume_manifest, resume_attempted = await _attempt_resume(
            cfg, restart_cfg, fingerprint, log
        )
    if zk is None:
        # Same construction + infinite-backoff envelope create_zk_client
        # wraps (reference lib/zk.js:62-127) — shared with the resume
        # path above via _client_from_config/connect_with_backoff.
        zk = await connect_with_backoff(_client_from_config(cfg))

    zk.on("close", lambda *a: log.warning("zookeeper: disconnected"))
    # The initial connect already happened; later connects are reconnects
    # (the reference ignores the first 'connect' for the same reason,
    # main.js:135-139).
    zk.on("connect", lambda *a: log.info("zookeeper: reconnected"))

    stopping = asyncio.Event()
    exit_code = 0

    def _die(msg: str) -> None:
        # Route fatal conditions through the orderly shutdown below rather
        # than raising SystemExit inside the emitting task: zk.close()
        # then completes (deleting any half-registered ephemerals
        # immediately) before the process exits nonzero.
        nonlocal exit_code
        log.critical(msg)
        exit_code = 1
        stopping.set()

    # With surviveSessionExpiry, expiry is absorbed in-process and
    # announced as session_reborn; session_expired then only fires
    # terminally (feature off, or the rebirth circuit breaker tripped) —
    # either way the reference's crash-restart path below still applies.
    zk.on("session_expired",
          lambda *_a: _die("ZooKeeper session_expired event; exiting"))
    zk.on("session_reborn", lambda sid: log.warning(
        "zookeeper: session expired; fresh session established in-process",
        extra={"zdata": {"session": f"0x{sid:x}"}}))
    zk.on("rebirth_breaker_tripped", lambda n: log.error(
        "zookeeper: session rebirth circuit breaker tripped",
        extra={"zdata": {"rebirths_in_window": n}}))

    ee = register_plus(
        zk,
        cfg.registration,
        admin_ip=cfg.admin_ip,
        health_check=cfg.health_check,
        heartbeat_interval=cfg.heartbeat_interval_s,
        heartbeat_retry=cfg.heartbeat_retry,
        repair_heartbeat_miss=cfg.repair_heartbeat_miss,
        reconcile=(
            {
                "interval_seconds": cfg.reconcile.interval_s,
                "repair": cfg.reconcile.repair,
            }
            if cfg.reconcile is not None
            else None
        ),
        resume_manifest=resume_manifest,
    )

    ee.on("fail", lambda err: log.error(
        "registrar: healthcheck failed", extra={"zdata": {"err": err}}))
    ee.on("ok", lambda: log.info("registrar: healthcheck ok (was down)"))

    def on_error(err) -> None:
        log.error("registrar: unexpected error", extra={"zdata": {"err": err}})
        if not ee.znodes:
            # Initial registration failed: nothing will retry it (the
            # reference just logs and idles broken, lib/index.js:46-50).
            # Exit so the supervisor restarts us — the same crash-restart
            # policy as session expiry.
            _die("registrar: initial registration failed; exiting")

    ee.on("error", on_error)
    ee.on("register", lambda nodes: log.info(
        "registrar: registered", extra={"zdata": {"znodes": nodes}}))
    ee.on("unregister", lambda err, nodes: log.warning(
        "registrar: unregistered",
        extra={"zdata": {"err": err, "znodes": nodes}}))
    ee.on("drift", lambda d: log.warning(
        "registrar: drift detected",
        extra={"zdata": {"path": d.path, "reason": d.reason,
                         "detail": d.detail}}))
    ee.on("driftRepaired", lambda d: log.info(
        "registrar: drift repaired",
        extra={"zdata": {"path": d.path, "reason": d.reason}}))

    # Edge-triggered heartbeat logging (reference main.js:149,187-198).
    is_down = False

    def on_heartbeat_failure(err) -> None:
        nonlocal is_down
        if not is_down:
            log.error("zookeeper: heartbeat failed",
                      extra={"zdata": {"err": err}})
        is_down = True

    def on_heartbeat(_nodes) -> None:
        nonlocal is_down
        if is_down:
            log.info("zookeeper heartbeat ok")
        is_down = False

    ee.on("heartbeatFailure", on_heartbeat_failure)
    ee.on("heartbeat", on_heartbeat)

    # -- handoff state keeper -------------------------------------
    # The state file tracks the LIVE session: rewritten on every session
    # establish/reattach/rebirth and registration refresh, stamped once
    # more at SIGTERM-handoff time, and fenced (deleted) the moment the
    # session is known dead (terminal expiry) or deliberately closed.
    state_note = {"hash": fingerprint}
    state_tasks: set = set()
    state_write_lock = asyncio.Lock()

    def _snapshot_state():
        return statefile.SessionState(
            session_id=zk.session_id,
            passwd=zk.session_passwd,
            negotiated_timeout_ms=zk.negotiated_timeout_ms,
            last_zxid=zk.last_zxid,
            chroot=zk.chroot,
            config_hash=state_note["hash"],
            znodes=list(ee.znodes),
            pid=os.getpid(),
            stamp=time.time(),
        )

    def _log_statefile_error(err: OSError) -> None:
        # A broken state file costs the NEXT restart its handoff (it
        # degrades to a fresh registration); it must never cost THIS
        # process its registration.
        log.error(
            "restart: cannot write state file %s",
            restart_cfg.state_file, extra={"zdata": {"err": repr(err)}},
        )

    def write_statefile(*_a) -> None:
        """Synchronous save — ONLY for the SIGTERM-handoff stamp, where
        the process is about to exit and the write must land first."""
        if restart_cfg is None or zk.closed or zk.session_id == 0:
            return
        try:
            statefile.save(restart_cfg.state_file, _snapshot_state())
        except OSError as err:
            _log_statefile_error(err)

    def write_statefile_bg(*_a) -> None:
        """Event-listener save: the state is snapshotted NOW (on the
        loop, a consistent view) but the two fsyncs run in a worker
        thread — register/connect/rebirth fire exactly when the session
        machinery is busiest, and a slow disk must not stall the loop.
        The lock serializes writers so snapshots land in event order."""
        if restart_cfg is None or zk.closed or zk.session_id == 0:
            return
        state = _snapshot_state()

        async def _save() -> None:
            async with state_write_lock:
                try:
                    await asyncio.to_thread(
                        statefile.save, restart_cfg.state_file, state
                    )
                except OSError as err:
                    _log_statefile_error(err)

        spawn_owned(_save(), state_tasks)

    def clear_statefile(*_a) -> None:
        if restart_cfg is not None:
            statefile.clear(restart_cfg.state_file)

    if restart_cfg is not None:
        ee.on("register", write_statefile_bg)
        zk.on("connect", write_statefile_bg)
        zk.on("session_reborn", write_statefile_bg)
        # Fencing: a terminally expired session must never be offered to
        # a successor (the reattach would be refused, but a dead-session
        # state file also misleads operators and `zkcli state`).
        zk.on("session_expired", clear_statefile)

    # -- SIGHUP config hot-reload ---------------------------------
    reload_lock = asyncio.Lock()

    async def do_reload() -> None:
        async with reload_lock:
            result = "failed"
            path = cfg.source_path
            if path is None:
                log.error("SIGHUP: no config file to reload from")
            else:
                log.info("SIGHUP: reloading configuration from %s", path)
                try:
                    new_cfg = load_config(path)
                    from registrar_tpu_torch.registration import (
                        _validate_registration,
                    )

                    _validate_registration(new_cfg.registration)
                except (ConfigError, ValueError) as err:
                    log.error(
                        "SIGHUP: invalid configuration; keeping the "
                        "running config",
                        exc_info=(type(err), err, err.__traceback__),
                    )
                else:
                    if new_cfg.log_level and new_cfg.log_level != cfg.log_level:
                        level = jlog.LEVELS.get(new_cfg.log_level.lower())
                        if level is not None:
                            logging.getLogger().setLevel(level)
                            cfg.log_level = new_cfg.log_level
                            log.info("SIGHUP: logLevel -> %s",
                                     new_cfg.log_level)
                    cold = _cold_reload_changes(cfg, new_cfg)
                    if cold:
                        log.warning(
                            "SIGHUP: changes to %s cannot hot-apply; "
                            "restart to pick them up", ", ".join(cold),
                            extra={"zdata": {"keys": cold}},
                        )
                    try:
                        result = await ee.reload(
                            new_cfg.registration, new_cfg.admin_ip
                        )
                    except asyncio.CancelledError:
                        raise
                    except RuntimeError as err:
                        log.error("SIGHUP: %s", err)
                    except Exception as err:  # noqa: BLE001
                        # The agent's desired state already switched to
                        # the new records (reload mutates before it
                        # writes), so heartbeat/reconciler converge on
                        # them; adopt the new config here too.
                        log.error(
                            "SIGHUP: reload delta failed mid-apply (%r); "
                            "recovery layers will converge on the new "
                            "records", err,
                        )
                        cfg.registration = dict(new_cfg.registration)
                        cfg.admin_ip = new_cfg.admin_ip
                    else:
                        cfg.registration = dict(new_cfg.registration)
                        cfg.admin_ip = new_cfg.admin_ip
                        log.info(
                            "SIGHUP: configuration reload %s", result,
                            extra={"zdata": {"result": result}},
                        )
                    if restart_cfg is not None:
                        state_note["hash"] = statefile.config_fingerprint(
                            cfg.registration, cfg.admin_ip,
                            cfg.zookeeper.chroot,
                        )
                        write_statefile_bg()
            ee.emit("configReload", result)

    # -- /status snapshot state -----------------------------------
    # The introspection endpoint's last-known view of the slow-moving
    # bits: the client's state string and the reconciler's last summary
    # are events, so a snapshot must remember them.
    status_note = {"zk_state": "connected" if zk.connected else "disconnected",
                   "last_reconcile": None, "started": time.time(),
                   "transitions": {}}

    # Last-transition stamps: the wall-clock moment
    # each slow-moving state last CHANGED — session, health, and
    # registration — so an operator (or the SLO harness's live-daemon
    # mode) can compute MTTR from /status alone: recovery stamp minus
    # fault stamp, no log archaeology.
    def _note_transition(kind: str, state: str) -> None:
        status_note["transitions"][kind] = {
            "state": state, "at": round(time.time(), 3),
        }

    def _on_zk_state(s) -> None:
        status_note["zk_state"] = s
        _note_transition("session", s)

    zk.on("state", _on_zk_state)
    ee.on("register",
          lambda *_a: _note_transition("registration", "registered"))
    ee.on("unregister",
          lambda *_a: _note_transition("registration", "unregistered"))
    ee.on("fail", lambda *_a: _note_transition("health", "down"))
    ee.on("ok", lambda *_a: _note_transition("health", "up"))
    ee.on(
        "reconcile",
        lambda summary: status_note.__setitem__(
            "last_reconcile",
            {"at": time.time(), **{k: summary.get(k)
                                   for k in ("duration", "drift", "repaired")}},
        ),
    )

    metrics_server = None
    if cfg.metrics is not None:
        from registrar_tpu_torch.metrics import (
            MetricsRegistry,
            MetricsServer,
            instrument,
            instrument_tracing,
        )

        registry = MetricsRegistry()
        if tracer is not None:
            # BEFORE instrument(): the tracing histograms own the
            # registrar_reconcile_sweep_seconds family when enabled.
            instrument_tracing(tracer, registry)
        instrument(ee, zk, registry)
        async def _trace_tree(trace_id: str):
            # GET /debug/trace?id=: the daemon is one
            # process, so "assembly" is just its own recorder — but
            # the payload shape (and the orphan convention) is the
            # same one the sharded tier's cross-process fan-out
            # serves, so dashboards and zkcli trace --id read both.
            from registrar_tpu_torch import traceview

            return traceview.assemble(
                trace_mod.get_tracer().dump(trace_id=trace_id).get(
                    "entries", []
                ),
                trace_id,
            )

        try:
            metrics_server = await MetricsServer(
                registry,
                host=cfg.metrics.host,
                port=cfg.metrics.port,
                status_provider=lambda: _status_snapshot(
                    cfg, zk, ee, status_note
                ),
                trace_provider=lambda n: trace_mod.get_tracer().dump(n),
                trace_tree_provider=_trace_tree,
            ).start()
        except OSError as err:
            # A busy/forbidden port must not take down registration —
            # metrics are an observability add-on, not the product.
            log.error("metrics: cannot listen on %s:%d",
                      cfg.metrics.host, cfg.metrics.port,
                      extra={"zdata": {"err": err}})
        else:
            log.info("metrics: listening",
                     extra={"zdata": {"host": cfg.metrics.host,
                                      "port": metrics_server.port}})

    if resume_attempted and resume_manifest is None:
        # The agent reports "reattached"/"repaired" itself; the shapes
        # where no session came back (unusable file, refused reattach)
        # are only known here.  Emitted after the metrics wiring above
        # so the counter sees it.
        ee.emit("resume", "fresh")

    loop = asyncio.get_running_loop()

    def on_stop_signal() -> None:
        if stopping.is_set():
            # Second-signal escape hatch: the
            # graceful stop below is wedged (unreachable ensemble, long
            # drain grace) and the operator signalled again — leave NOW,
            # with a distinct line and code, so nobody reaches for
            # SIGKILL.  os._exit skips cleanup by design: cleanup is
            # exactly what is stuck.
            log.critical(
                "second termination signal during graceful stop; "
                "forcing immediate exit (code %d)", EX_FORCED,
            )
            try:
                sys.stdout.flush()
            except Exception:  # noqa: BLE001
                pass
            # check: disable=unguarded-private-attr -- os._exit is the
            # documented immediate-exit API (skips atexit/finalizers by
            # design), which is exactly what a wedged shutdown needs
            os._exit(EX_FORCED)
        stopping.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, on_stop_signal)
        except NotImplementedError:  # non-unix test environments
            pass
    reload_tasks: set = set()
    try:
        loop.add_signal_handler(
            signal.SIGHUP, lambda: spawn_owned(do_reload(), reload_tasks)
        )
    except (NotImplementedError, AttributeError):  # non-unix
        pass

    # -- SIGUSR2: dump the flight recorder ------------------------
    dump_tasks: set = set()

    def dump_flight_recorder() -> None:
        tr = trace_mod.get_tracer()
        if not tr.enabled:
            log.warning(
                "SIGUSR2: tracing is disabled (no `observability` config "
                "block); nothing to dump"
            )
            return
        # Snapshot on-loop (a bounded list copy + render, ms-scale);
        # write in a worker thread.  SIGUSR2 arrives mid-incident, when
        # a wedged filesystem at dumpPath is most likely — blocking the
        # loop on that write could stall heartbeats past the session
        # timeout and let the diagnostic itself take the host out of
        # DNS (the statefile writer applies the same rule).
        payload = tr.dump()
        spans, events = tr.spans_recorded, tr.events_recorded
        dump_path = (
            cfg.observability.dump_path
            if cfg.observability is not None
            else None
        )

        async def _write() -> None:
            try:
                path = await asyncio.to_thread(
                    trace_mod.write_dump, payload, dump_path
                )
            except OSError as err:
                log.error("SIGUSR2: cannot write flight-recorder dump",
                          extra={"zdata": {"err": repr(err)}})
            else:
                log.info(
                    "SIGUSR2: flight recorder dumped",
                    extra={"zdata": {"file": path,
                                     "spans": spans,
                                     "events": events}},
                )

        spawn_owned(_write(), dump_tasks)

    try:
        loop.add_signal_handler(signal.SIGUSR2, dump_flight_recorder)
    except (NotImplementedError, AttributeError):  # non-unix
        pass

    await stopping.wait()
    mode = restart_cfg.mode if restart_cfg is not None else None
    log.info(
        "registrar: shutting down",
        extra={"zdata": {"mode": mode or "close"}},
    )
    ee.stop()  # health checker first: no transition may race the exit
    if (
        exit_code == 0
        and mode == "handoff"
        and not zk.closed
        and zk.session_id != 0
    ):
        # Persist with a FRESH stamp — the successor's staleness window
        # opens here — then sever the TCP connection with the session
        # (and every ephemeral) left alive for it.  Any in-flight
        # background save must land FIRST: a worker thread finishing
        # after us would clobber this stamp with an older snapshot and
        # silently shrink (or void) the successor's resume window.
        if state_tasks:
            await asyncio.gather(*state_tasks, return_exceptions=True)
        async with state_write_lock:
            write_statefile()
        log.info(
            "restart: session handed off; ephemerals remain live for "
            "the successor",
            extra={"zdata": {"session": f"0x{zk.session_id:x}",
                             "stateFile": restart_cfg.state_file,
                             "znodes": list(ee.znodes)}},
        )
        ee.emit("handoff", restart_cfg.state_file)
        await zk.detach()
    elif exit_code == 0 and mode == "drain":
        deleted = await _drain_unregister(zk, ee.znodes, log)
        log.info("restart: drained",
                 extra={"zdata": {"znodes": deleted}})
        ee.emit("drain", deleted)
        if restart_cfg.drain_grace_s > 0:
            log.info(
                "restart: waiting drainGraceSeconds before exit",
                extra={"zdata": {"seconds": restart_cfg.drain_grace_s}},
            )
            await asyncio.sleep(restart_cfg.drain_grace_s)
        clear_statefile()
        await zk.close()
    else:
        await zk.close()  # deletes our ephemerals immediately (docstring)
        clear_statefile()  # a closed session is nothing to hand off
    if metrics_server is not None:
        # Stopped LAST so the handoff/drain counters increment while the
        # endpoint still answers (a drain's grace period is scrapeable).
        await metrics_server.stop()
    if dump_tasks:
        # An in-flight SIGUSR2 dump finishes writing (it already holds
        # its snapshot; losing it at exit is losing the evidence).
        await asyncio.gather(*dump_tasks, return_exceptions=True)
    if exit_code:
        _exit(exit_code)


async def _status_snapshot(cfg: Config, zk, ee, note: dict) -> dict:
    """One ``GET /status`` introspection snapshot.

    The runbook's first stop (docs/OPERATIONS.md "The first 5 minutes
    of an incident"): session identity and state, registration epoch,
    the owned znodes with their live mzxids, health/drift posture, and
    the config fingerprint — enough to answer "is THIS instance the
    problem" without reading a single log line.

    The mzxid read-back is best-effort with a short deadline: /status
    must keep answering while the ensemble is down (that is precisely
    when operators hit it), so a failed sweep reports ``readError``
    instead of hanging or erroring the endpoint.
    """
    znodes = list(ee.znodes)
    mzxids: dict = {p: None for p in znodes}
    read_error = None
    if znodes and zk.connected:
        try:
            results = await asyncio.wait_for(zk.get_many(znodes), timeout=2.0)
            for path, res in zip(znodes, results):
                mzxids[path] = res[1].mzxid if res is not None else None
        except asyncio.CancelledError:
            raise
        except Exception as err:  # noqa: BLE001 - status must still answer
            read_error = repr(err)
    elif znodes:
        read_error = "session not connected"
    tr = trace_mod.get_tracer()
    health = getattr(ee, "_health", None)
    return {
        "name": "registrar",
        "pid": os.getpid(),
        "version": __version__,
        # uptime_s + last_transition: the MTTR-
        # computable view — each entry is the wall stamp of the LAST
        # session/health/registration state change (empty until the
        # first change after startup).
        "uptime_s": round(time.time() - note["started"], 1),
        "last_transition": dict(note.get("transitions", {})),
        "session": {
            "id": f"0x{zk.session_id:x}",
            "state": note["zk_state"],
            "connected": zk.connected,
            "closed": zk.closed,
            "server": (
                f"{zk.connected_server[0]}:{zk.connected_server[1]}"
                if zk.connected_server
                else None
            ),
            # True while attached to a read-only (minority) member:
            # resolves/heartbeats serve, writes refuse — the
            # OPERATIONS.md "read-only mode" alert's source of truth.
            "readOnly": getattr(zk, "read_only", False),
            "negotiatedTimeoutMs": zk.negotiated_timeout_ms,
            "rebirths": zk.rebirths,
            # Connect-race outcome + failover latency: the
            # runbook's first stop for "why was recovery slow" — which
            # member the last raced pass attached (None under the serial
            # reference path), how many candidates it dialed / aborted,
            # and how long the last unexpected-teardown -> reconnect
            # window took.
            "connectRace": {
                "wins": zk.race_stats["wins"],
                "lastWinner": zk.race_stats["last_winner"],
                "lastCandidates": zk.race_stats["last_candidates"],
                "lastAborted": zk.race_stats["last_aborted"],
            },
            "lastFailoverS": (
                round(zk.last_failover_s, 4)
                if zk.last_failover_s is not None
                else None
            ),
            "watchdogDrops": zk.watchdog_drops,
        },
        "registration": {
            "epoch": ee.epoch,
            "registered": bool(znodes),
            "znodes": [
                {"path": p, "mzxid": mzxids[p]} for p in znodes
            ],
            "readError": read_error,
        },
        "health": {
            "configured": health is not None,
            "down": ee.down,
            "checkerDown": bool(health.is_down) if health else False,
        },
        "reconcile": {
            "configured": ee.reconciler is not None,
            "lastSweep": note["last_reconcile"],
            "driftSeen": (
                ee.reconciler.drift_seen if ee.reconciler else None
            ),
            "ownerConflicts": (
                ee.reconciler.owner_conflicts if ee.reconciler else None
            ),
        },
        # The daemon never resolves; the cache block is for embedders
        # (zkcli serve-view exposes the same shape via its status line).
        "cache": None,
        "config": {
            "source": cfg.source_path,
            "fingerprint": statefile.config_fingerprint(
                cfg.registration, cfg.admin_ip, cfg.zookeeper.chroot
            ),
        },
        "observability": {
            "enabled": tr.enabled,
            "spansRecorded": getattr(tr, "spans_recorded", 0),
            "eventsRecorded": getattr(tr, "events_recorded", 0),
        },
    }


def _cold_reload_changes(old: Config, new: Config) -> list:
    """Config keys changed between ``old`` and ``new`` that can NOT
    hot-apply over SIGHUP — named in the reload warning so operators
    know those changes still need a restart.  Everything that shapes the
    znode records (registration, adminIp) hot-applies; logLevel
    hot-applies separately."""
    cold = []
    if old.zookeeper != new.zookeeper:
        cold.append("zookeeper")
    if old.health_check != new.health_check:
        cold.append("healthCheck")
    if old.metrics != new.metrics:
        cold.append("metrics")
    if old.reconcile != new.reconcile:
        cold.append("reconcile")
    if old.restart != new.restart:
        cold.append("restart")
    if old.survive_session_expiry != new.survive_session_expiry:
        cold.append("surviveSessionExpiry")
    if old.max_session_rebirths != new.max_session_rebirths:
        cold.append("maxSessionRebirths")
    if old.repair_heartbeat_miss != new.repair_heartbeat_miss:
        cold.append("repairHeartbeatMiss")
    if old.heartbeat_interval_s != new.heartbeat_interval_s:
        cold.append("registration.heartbeatInterval")
    if (
        old.heartbeat_retry.max_attempts != new.heartbeat_retry.max_attempts
    ):
        cold.append("maxAttempts")
    if old.cache != new.cache:
        cold.append("cache")
    if old.observability != new.observability:
        cold.append("observability")
    return cold


def install_event_loop(cfg: Config) -> str:
    """Apply ``zookeeper.eventLoop``; returns the loop in
    effect (``"uvloop"`` or ``"asyncio"``).

    ``"uvloop"`` installs uvloop's event-loop policy when the package is
    importable; a missing/broken uvloop logs a warning and falls back to
    asyncio — the daemon never fails to start over an optional
    accelerator.  Default (absent key, or ``"asyncio"``): no policy
    change at all, byte-identical to every prior release.  The wire
    behavior is loop-independent either way (parity pinned by
    tests/test_main.py).
    """
    if cfg.zookeeper.event_loop != "uvloop":
        return "asyncio"
    try:
        import uvloop  # noqa: PLC0415 - optional, import-guarded
    except ImportError:
        logging.getLogger("registrar").warning(
            "config zookeeper.eventLoop is \"uvloop\" but uvloop is not "
            "installed; continuing on the stdlib asyncio loop"
        )
        return "asyncio"
    asyncio.set_event_loop_policy(uvloop.EventLoopPolicy())
    return "uvloop"


def main(argv=None) -> None:
    cfg = configure(argv)
    install_event_loop(cfg)
    try:
        asyncio.run(run(cfg))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
