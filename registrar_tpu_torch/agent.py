"""The registrar orchestrator: registration + heartbeat + health checking.

Rebuild of the reference's default export ``register_plus``
(lib/index.js:33-182).  Ties the three subsystems together and exposes a
lifecycle event surface:

    register(znodes)           registration (or re-registration) completed
    unregister(err, znodes)    health check declared down; znodes holds what
                               was actually deleted (a shared service node
                               with sibling hosts under it stays, and is
                               not listed)
    heartbeat(znodes)          periodic znode liveness probe succeeded
    heartbeatFailure(err)      probe failed after bounded retries
    ok()                       health check recovered (was down)
    fail(err)                  health check crossed the failure threshold
    error(err)                 unexpected error from any subsystem

Loop behavior matches the reference exactly (BASELINE.md):

  * heartbeat every ``heartbeat_interval`` (default 3 s,
    lib/index.js:132), re-armed *after* each probe completes (the
    reference's self-rescheduling setTimeout chain, not a fixed-rate timer);
  * after a heartbeat failure the loop backs off to
    ``max(heartbeat_interval, 60 s)`` (lib/index.js:146);
  * a heartbeat failure does NOT deregister or exit — recovery rides on ZK
    session expiry + supervisor restart, or a health-check ``ok``
    re-registration (SURVEY.md §3.2 note).  SURVEY.md §3.2 flags re-creating
    missing ephemerals on heartbeat NO_NODE as a worthwhile but
    behavior-changing improvement: it is available here as the **opt-in**
    ``repair_heartbeat_miss`` flag (config key ``repairHeartbeatMiss``),
    default off for reference parity.  When enabled, a heartbeat that fails
    with NO_NODE re-runs the registration pipeline — unless the health
    checker has deliberately deregistered the host (``ee.down``);
  * on health ``fail`` with ``isDown`` the znodes are unregistered; on the
    next health ``ok`` the full registration pipeline runs again
    (lib/index.js:59-116).

Two opt-in recovery layers ride above the reference loops:

  * the ZK client's ``session_reborn`` event (``surviveSessionExpiry``)
    is consumed here — a fresh in-process session has no ephemerals, so
    the idempotent registration pipeline re-runs, honoring ``ee.down``
    (a health-deregistered host is never resurrected by a rebirth);
  * a level-triggered reconciler (:mod:`registrar_tpu_torch.reconcile`, config
    ``reconcile: {intervalSeconds, repair}``) periodically diffs the
    owned znodes against the desired records and emits structured
    ``drift`` / ``driftRepaired`` / ``reconcile`` events — with
    ``repair`` on it converges through the same pipeline.

Every znode-mutating flow (heartbeat repair, rebirth re-registration,
health transitions, reconciler repair) is single-flight through one
``asyncio.Lock``, so two recovery paths can never interleave a cleanup
stage into each other's half-built registration.

Fixed here (reference warts that are unobservable in znode state):
``register_plus`` references an undefined ``cfg`` on initial-registration
failure (lib/index.js:48) — the error path here just emits ``error``; and
re-registration is guarded against overlapping ``ok`` events.
"""

from __future__ import annotations

import asyncio
import logging
import weakref
from typing import Any, List, Mapping, Optional, Sequence

from registrar_tpu_torch import registration as register_mod
from registrar_tpu_torch import trace
from registrar_tpu_torch.events import EventEmitter, spawn_owned
from registrar_tpu_torch.health import HealthCheck, create_health_check
from registrar_tpu_torch.registration import SETTLE_DELAY_S
from registrar_tpu_torch.retry import RetryPolicy
from registrar_tpu_torch.zk.client import ZKClient
from registrar_tpu_torch.zk.protocol import Err, ZKError

log = logging.getLogger("registrar_tpu_torch.agent")

#: reference lib/index.js:132
DEFAULT_HEARTBEAT_INTERVAL_S = 3.0
#: reference lib/index.js:146 — floor of the post-failure re-arm delay
HEARTBEAT_FAILURE_BACKOFF_S = 60.0


class RegistrarEvents(EventEmitter):
    """Event surface returned by :func:`register_plus` (the reference's
    EventEmitter + ``.stop()``, lib/index.js:164-171)."""

    def __init__(self) -> None:
        super().__init__()
        self.znodes: list = []
        #: True while the health checker holds the host deregistered —
        #: gates heartbeat repair so it never races a deliberate
        #: deregistration.
        self.down = False
        #: bumped every time a registration pipeline run refreshes
        #: ``znodes``.  Recovery actors queued on the single-flight lock
        #: snapshot it when they DECIDE to repair and skip if it moved by
        #: the time they hold the lock: without this, the loser of the
        #: race re-runs the pipeline over the winner's fresh registration
        #: and its cleanup stage deletes the just-repaired znodes —
        #: re-minting the very drift that queued it (an unbounded
        #: repair tug-of-war between heartbeat repair and the
        #: reconciler; regression: tests/test_e2e_options.py).
        self.epoch = 0
        self._tasks: set = set()
        self._health: Optional[HealthCheck] = None
        self._stopped = False
        #: the level-triggered reconciler, when configured (test/metrics
        #: observability; None without the ``reconcile`` config block)
        self.reconciler = None
        #: bound by _run once the initial registration lands:
        #: the SIGHUP hot-reload entry point (see :meth:`reload`)
        self._reload_fn = None
        #: reload bookkeeping: None = the live registration corresponds
        #: to the current params' desired records (every successful
        #: pipeline run resets it).  After a reload delta fails
        #: mid-apply, a ``(base_map, dirty_paths)`` pair: the
        #: desired-record map of the last SUCCESSFUL application plus
        #: the set of paths the failed delta may have half-touched —
        #: the next reload re-diffs from the base and force-rewrites
        #: every dirty path, so neither a retry nor a revert can read
        #: as a hollow "noop" while ZooKeeper holds partial state.
        self._applied_desired = None

    async def reload(self, registration, admin_ip=None) -> str:
        """Hot-apply a new registration/adminIp (SIGHUP).

        Diffs the old desired records against the new and applies ONLY
        the delta through the single-flight pipeline lock — unchanged
        znodes are never touched (no delete+recreate blip for names that
        did not change).  Returns ``"applied"`` or ``"noop"``.  Raises
        when the initial registration has not completed yet, or when a
        delta operation fails — by then the agent's desired state has
        already switched to the new config, so the heartbeat/reconciler
        recovery layers converge on it.
        """
        if self._reload_fn is None:
            raise RuntimeError(
                "initial registration has not completed; cannot reload"
            )
        return await self._reload_fn(registration, admin_ip)

    def stop(self) -> None:
        """Stop the heartbeat loop and health checker.

        Does NOT delete the znodes — like the reference, a graceful library
        stop leaves cleanup to ZK session expiry (SURVEY.md §3.4)."""
        self._stopped = True
        if self._health is not None:
            self._health.stop()
        for task in list(self._tasks):
            task.cancel()
        self._tasks.clear()

    def _track(self, coro) -> "asyncio.Task":
        """Spawn ``coro`` as a task owned until done (finished tasks drop
        out, so a daemon with a flapping health check doesn't accumulate
        them forever) and cancelled by stop()."""
        return spawn_owned(coro, self._tasks)

    @property
    def stopped(self) -> bool:
        return self._stopped


def register_plus(
    zk: ZKClient,
    registration: Mapping[str, Any],
    admin_ip: Optional[str] = None,
    health_check: Optional[Mapping[str, Any]] = None,
    heartbeat_interval: float = DEFAULT_HEARTBEAT_INTERVAL_S,
    hostname: Optional[str] = None,
    settle_delay: float = SETTLE_DELAY_S,
    heartbeat_retry: Optional[RetryPolicy] = None,
    repair_heartbeat_miss: bool = False,
    register_retry: Optional[RetryPolicy] = None,
    reconcile: Optional[Mapping[str, Any]] = None,
    resume_manifest: Optional[Sequence[str]] = None,
) -> RegistrarEvents:
    """Register, then keep the registration alive; returns the event surface.

    Must be called with a running event loop (the daemon's mainline or a
    test harness).  ``health_check`` is the config's ``healthCheck`` object
    (seconds-based keys, see :mod:`registrar_tpu_torch.config` for translation).
    ``heartbeat_retry`` overrides the per-probe retry policy (configured
    from the sample config's ``maxAttempts``, see config.py).
    ``repair_heartbeat_miss`` opts into re-registering when a heartbeat
    finds the znodes gone (module docstring; default off = reference
    behavior).  ``register_retry`` opts the registration pipeline (initial
    and every re-registration) into the transient-fault retry layer
    (:data:`registrar_tpu_torch.registration.REGISTER_RETRY` is the shipped
    policy); default None = single attempt, reference behavior.
    ``reconcile`` starts the level-triggered reconciler (module
    docstring): ``{"interval_seconds": float, "repair": bool}`` — the
    config's ``reconcile`` object, seconds-based.  Default None = no
    reconciler, reference behavior.
    ``resume_manifest`` marks a cross-process session resume:
    the client reattached a predecessor's live session whose ephemerals
    are expected intact, so the agent VERIFIES the registration (one
    read-back sweep against the desired records) instead of running the
    pipeline's delete+recreate — a watching resolver sees zero NO_NODE.
    Any drift (or a failed sweep) falls back to the normal pipeline.
    The value is the predecessor's owned-znode list (observability; the
    desired records, not the manifest, are the verification truth).
    """
    ee = RegistrarEvents()
    # Health-check construction fails HERE, synchronously: built inside
    # the spawned _run task, a bad healthCheck mapping raised ValueError
    # into a fire-and-forget task AFTER registration landed — the error
    # vanished in the loop's default handler and the host stayed
    # registered with no health checking at all (caught by checklib's
    # task-exception-blackhole rule).  The consumer still STARTS only
    # after registration completes, as before.
    health = create_health_check(**health_check) if health_check else None
    ee._track(_run(ee, zk, registration, admin_ip,
                   health, heartbeat_interval,
                   hostname, settle_delay,
                   heartbeat_retry,
                   repair_heartbeat_miss,
                   register_retry,
                   reconcile,
                   resume_manifest))
    return ee


async def _run(
    ee: RegistrarEvents,
    zk: ZKClient,
    registration: Mapping[str, Any],
    admin_ip: Optional[str],
    health_check: Optional[HealthCheck],
    heartbeat_interval: float,
    hostname: Optional[str],
    settle_delay: float,
    heartbeat_retry: Optional[RetryPolicy] = None,
    repair_heartbeat_miss: bool = False,
    register_retry: Optional[RetryPolicy] = None,
    reconcile: Optional[Mapping[str, Any]] = None,
    resume_manifest: Optional[Sequence[str]] = None,
) -> None:
    # Mutable so the SIGHUP hot-reload can swap the registration in
    # place: every later pipeline run (heartbeat repair, rebirth,
    # health recovery, reconciler) reads through this one holder.
    params = {"registration": dict(registration), "admin_ip": admin_ip}

    async def do_register() -> list:
        """The one registration pipeline call every path shares."""
        return await register_mod.register(
            zk, params["registration"], admin_ip=params["admin_ip"],
            hostname=hostname,
            settle_delay=settle_delay, retry_policy=register_retry,
        )

    #: single-flight guard over every znode-mutating recovery flow
    #: (heartbeat repair, rebirth re-registration, health transitions,
    #: reconciler repair) — see module docstring.
    repair_lock = asyncio.Lock()

    resumed = False
    znodes = None
    if resume_manifest is not None:
        znodes = await _adopt_resumed(zk, params, hostname, resume_manifest)
        resumed = znodes is not None
    if znodes is None:
        try:
            # Under the single-flight lock like every other pipeline run:
            # no recovery actor exists yet to contend, but the invariant
            # ("znode mutations hold the repair lock") is then true
            # without exception — and machine-checked (checklib's
            # await-in-lock-free-mutator rule).
            async with repair_lock:
                znodes = await do_register()
        except asyncio.CancelledError:
            raise
        except Exception as err:  # noqa: BLE001
            log.debug("registration failed: %r", err)
            ee.emit("error", err)
            return

    ee.znodes = znodes
    ee.epoch += 1
    ee._reload_fn = lambda reg, ip: _apply_reload(
        ee, zk, params, repair_lock, hostname, reg, ip
    )
    if ee.stopped:
        return

    ee._track(_heartbeat_loop(
        ee, zk, heartbeat_interval, heartbeat_retry,
        do_register if repair_heartbeat_miss else None,
        repair_lock,
    ))
    if health_check is not None:
        _start_health_consumer(ee, zk, do_register, health_check, repair_lock)

    # Session lifecycle supervisor consumer: a reborn session
    # holds none of the old session's ephemerals — re-run the idempotent
    # pipeline, unless health deliberately deregistered the host.  One
    # long-lived task consumes a signal (not a task per event), so
    # back-to-back expiries cannot stack duplicate pipelines.
    rebirth_signal = asyncio.Event()
    zk.on("session_reborn", lambda _sid: rebirth_signal.set())
    ee._track(_rebirth_loop(ee, zk, do_register, repair_lock, rebirth_signal))

    if reconcile:
        from registrar_tpu_torch.reconcile import Reconciler

        ee.reconciler = Reconciler(
            zk, ee, params["registration"],
            admin_ip=params["admin_ip"], hostname=hostname,
            interval_s=reconcile.get("interval_seconds", 60.0),
            repair=bool(reconcile.get("repair", False)),
            repair_fn=lambda epoch: _reregister_guarded(
                ee, zk, do_register, repair_lock, expect_epoch=epoch
            ),
            lock=repair_lock,
        )
        ee._track(ee.reconciler.run())
    if resume_manifest is not None:
        # "reattached": verify-not-recreate adopted the predecessor's
        # live znodes (zero NO_NODE across the restart); "repaired":
        # the sweep found drift and the pipeline re-ran instead.
        ee.emit("resume", "reattached" if resumed else "repaired")
    ee.emit("register", znodes)


async def _adopt_resumed(
    zk: ZKClient,
    params: Mapping[str, Any],
    hostname: Optional[str],
    manifest: Sequence[str],
) -> Optional[List[str]]:
    """Verify-not-recreate (handoff resume).

    The client reattached the predecessor's session, so its ephemerals
    should be sitting exactly where the desired records say — running the
    pipeline would delete and recreate them, a Binder-visible NO_NODE
    window, which is the one thing a handoff exists to avoid.  One
    read-back sweep (the reconciler's own diff engine) checks every
    desired znode: clean means the registration is adopted as-is; any
    drift — or a sweep the wire won't carry — returns None and the
    caller falls back to the normal pipeline (the registration was
    already broken, so the pipeline's blip costs nothing extra).
    """
    from registrar_tpu_torch import reconcile as reconcile_mod

    try:
        desired = reconcile_mod.desired_records(
            params["registration"], params["admin_ip"], hostname
        )
        drifts = await reconcile_mod.sweep(
            zk, desired, session_id=zk.session_id
        )
    except asyncio.CancelledError:
        raise
    except Exception as err:  # noqa: BLE001 - fall back to the pipeline
        log.warning(
            "resume verification sweep failed (%r); falling back to the "
            "registration pipeline", err,
        )
        return None
    if drifts:
        log.warning(
            "resume verification found %d drift(s) (%s); falling back to "
            "the registration pipeline",
            len(drifts), [(d.reason, d.path) for d in drifts],
        )
        return None
    adopted = [d.path for d in desired]
    extra = sorted(set(manifest) - set(adopted))
    if extra:
        # Manifest nodes the current desired records no longer cover
        # (shouldn't happen with the config-hash gate, but a manifest is
        # operator-editable): never adopt them blind — they would be
        # heartbeated and defended forever.
        log.warning(
            "resume manifest lists %s beyond the desired records; ignoring",
            extra,
        )
    log.info(
        "resumed registration verified in place (%d znodes, zero drift)",
        len(adopted),
    )
    return adopted


async def _apply_reload(
    ee: RegistrarEvents,
    zk: ZKClient,
    params: dict,
    lock: asyncio.Lock,
    hostname: Optional[str],
    new_registration: Mapping[str, Any],
    new_admin_ip: Optional[str],
) -> str:
    """Apply a SIGHUP config reload as a minimal znode delta.

    Old and new desired records are diffed path-by-path; only the
    difference touches ZooKeeper — an unchanged host ephemeral is never
    deleted or recreated, so names that didn't change never flicker in
    DNS.  The agent's desired state (``params``, the reconciler's view,
    ``ee.znodes``) switches to the new config FIRST, under the
    single-flight lock: even if a delta operation then fails (raised to
    the caller), every recovery layer is already converging on the new
    records, not fighting for the old ones.

    The diff base is what was last successfully APPLIED, not merely what
    the params hold: a delta that died mid-apply leaves
    ``ee._applied_desired`` carrying the pre-reload records plus the
    paths the failed delta may have half-touched, so a retry SIGHUP —
    or a revert back to the old config — re-computes the real remaining
    work (dirty paths are unconditionally rewritten) instead of
    comparing the new config against itself and declaring a hollow
    "noop".  The individual delta operations are idempotent (absent
    deletes, already-created creates, and missing set_data targets are
    absorbed) for exactly that replay.
    """
    from registrar_tpu_torch import reconcile as reconcile_mod

    # desired_records validates the registration on every path through
    # here, so a bad reload fails before any state is touched.
    base = ee._applied_desired
    if base is None:
        old_desired = reconcile_mod.desired_records(
            params["registration"], params["admin_ip"], hostname
        )
        base_map, dirty = {d.path: d for d in old_desired}, frozenset()
    else:
        base_map, dirty = base
    new_desired = reconcile_mod.desired_records(
        new_registration, new_admin_ip, hostname
    )
    new_map = {d.path: d for d in new_desired}

    async with lock:
        params["registration"] = dict(new_registration)
        params["admin_ip"] = new_admin_ip
        if ee.reconciler is not None:
            ee.reconciler.registration = params["registration"]
            ee.reconciler.admin_ip = new_admin_ip
        if base_map == new_map and not dirty:
            ee._applied_desired = None  # in sync with params again
            return "noop"
        if ee.stopped:
            return "noop"
        if ee.down:
            # Desired state while health-deregistered is ABSENT; the new
            # records materialize through do_register on recovery.
            log.info(
                "config reload applied while health-down: desired state "
                "updated, znodes follow on recovery"
            )
            ee.epoch += 1
            ee._applied_desired = None
            return "applied"
        try:
            await _apply_desired_delta(zk, base_map, new_map, dirty=dirty)
        except BaseException:
            # Remember the pre-reload base AND every path this delta
            # could have touched: a later reload (retry or revert) must
            # assume those are in an unknown state and rewrite them,
            # never trust the always-"noop" new-vs-new comparison the
            # already-swapped params would produce.
            touched = {
                p
                for p in set(base_map) | set(new_map)
                if base_map.get(p) != new_map.get(p)
            }
            ee._applied_desired = (base_map, dirty | touched)
            raise
        ee._applied_desired = None
        ee.znodes = [d.path for d in new_desired]
        ee.epoch += 1
        log.info(
            "config reload applied: %d znode(s) now owned (epoch %d)",
            len(ee.znodes), ee.epoch,
        )
        ee.emit("register", ee.znodes)
    return "applied"


async def _apply_desired_delta(
    zk: ZKClient, old_map, new_map, dirty=frozenset()
) -> None:
    """Converge ZooKeeper from one desired-record map to another with the
    minimum touch set.  Every operation is idempotent so a replay after a
    mid-apply failure is safe (see :func:`_apply_reload`).

    ``dirty`` paths are in an UNKNOWN state (a previous delta died while
    touching them): they are unconditionally cleared in pass 1 — a stale
    node a failed forward delta created must not survive a revert — and
    rewritten from scratch in pass 2 when the new records want them.

    Order matters: removals, shape changes, and dirty paths are cleared
    FIRST — a node flipping ephemeral <-> persistent can only be
    converged by unlink+recreate (a put cannot change ephemerality:
    leaving a service record ephemeral means it silently dies with the
    session), and a path becoming a service record may be about to grow
    children, which an ephemeral cannot hold.
    """
    # Pass 1: clear removals, shape flips, and unknown (dirty) state.
    for path in old_map:
        if path not in new_map:
            await register_mod.unlink_tolerant(zk, path)
    for path in dirty:
        if path not in old_map or path in new_map:
            await register_mod.unlink_tolerant(zk, path)
    for path, want in new_map.items():
        have = old_map.get(path)
        if (
            have is not None
            and path not in dirty
            and have.ephemeral != want.ephemeral
        ):
            await register_mod.unlink_tolerant(zk, path)

    # Pass 2: write the new records.
    for path, want in new_map.items():
        have = None if path in dirty else old_map.get(path)
        if (
            have is not None
            and have.payload == want.payload
            and have.ephemeral == want.ephemeral
        ):
            continue  # untouched: zero NO_NODE for unchanged names
        if not want.ephemeral:
            await zk.put(path, want.payload)  # service-record upsert
        elif (
            have is not None
            and have.ephemeral
            and have.payload != want.payload
        ):
            # Payload-only change on a node we own: set in place —
            # watchers see one dataChanged, never a NO_NODE.
            try:
                await zk.set_data(path, want.payload)
            except ZKError as err:
                if err.code != Err.NO_NODE:
                    raise
                await zk.create_ephemeral_plus(path, want.payload)
        else:
            try:
                await zk.create_ephemeral_plus(path, want.payload)
            except ZKError as err:
                if err.code != Err.NODE_EXISTS:
                    raise
                # replay after a half-applied delta: already created
                await zk.set_data(path, want.payload)


#: post-rebirth re-registration retry: unbounded like the connect path
#: (a live session with NO registration is a silent DNS outage — strictly
#: worse than the exit(1)+supervisor-restart the feature replaces, so the
#: agent must never give up while the client is alive), decorrelated
#: jitter so a fleet reborn by the same ensemble event does not re-run
#: its pipelines in lockstep.
REBIRTH_REREGISTER_RETRY = RetryPolicy(
    max_attempts=float("inf"), initial_delay=0.5, max_delay=30.0,
    jitter="decorrelated",
)


async def _rebirth_loop(ee, zk, do_register, lock, signal) -> None:
    """Consume ``session_reborn`` signals: re-run the idempotent pipeline
    until it lands, with jittered backoff across transient failures.

    A single attempt is not enough: rebirths happen exactly when the
    ensemble is flaky, so the first pipeline run frequently dies on the
    same turbulence that killed the session — and nothing else would
    retry it (the heartbeat loop sees NO_NODE but only repairs with the
    opt-in ``repairHeartbeatMiss``).  The loop stops retrying when the
    registration is refreshed (by this loop or any other recovery path —
    ``_reregister_guarded`` reports both as True), when health holds the
    host down (``on_recover`` owns the eventual re-registration), or
    when the client/agent is gone.  A new expiry mid-retry just re-sets
    the signal; the running retry chain continues against the newest
    session, since ``do_register`` always uses the live client.
    """
    while not ee.stopped:
        await signal.wait()
        signal.clear()
        delays = REBIRTH_REREGISTER_RETRY.schedule()
        while not ee.stopped and not zk.closed:
            try:
                done = await _reregister_guarded(ee, zk, do_register, lock)
            except asyncio.CancelledError:
                raise
            except Exception as err:  # noqa: BLE001
                delay = next(delays)
                log.warning(
                    "post-rebirth re-registration failed (%r); "
                    "retrying in %.1fs", err, delay,
                )
                ee.emit("error", err)
                await asyncio.sleep(delay)
                continue
            if not done:  # down/stopped: on_recover owns the comeback
                log.debug("post-rebirth re-registration skipped (down)")
            break


async def _reregister_guarded(
    ee, zk, do_register, lock, expect_epoch: Optional[int] = None
) -> bool:
    """Run the registration pipeline under the single-flight lock,
    honoring a health deregistration that lands at any point.

    Returns True when the registration was refreshed (``ee.znodes``
    updated, ``register`` emitted); False when the host is down/stopped —
    including the race where health crosses its threshold while the
    pipeline (1 s settle + RPCs) is in flight, in which case the freshly
    created znodes are rolled back out rather than resurrecting a host
    health just declared dead.  Pipeline errors propagate to the caller.

    ``expect_epoch`` is the ``ee.epoch`` the caller observed when it
    decided repair was needed: if another recovery actor refreshed the
    registration while this one waited on the lock, the stale repair is
    skipped (returns True — the registration IS fresh) instead of
    running the pipeline's delete+recreate over it.
    """
    if expect_epoch is None:
        expect_epoch = ee.epoch
    if ee.down or ee.stopped:
        return False
    # The span covers the lock wait AND the pipeline run: its children
    # (register.pipeline, the zk.op spans) show where the time went, and
    # the lock-wait gap is the span's own duration minus theirs.
    with trace.tracer_for(zk).span(
        "agent.repair", expect_epoch=expect_epoch
    ) as sp:
        async with lock:
            if ee.down or ee.stopped:
                return False
            if ee.epoch != expect_epoch:
                log.debug(
                    "re-registration skipped: epoch moved %d -> %d while "
                    "waiting (another recovery path already repaired)",
                    expect_epoch, ee.epoch,
                )
                sp.set_attr("outcome", "stale-epoch")
                return True
            new_znodes = await do_register()
            if ee.down or ee.stopped:
                log.debug("re-registration rolled back (health down/stopped)")
                sp.set_attr("outcome", "rolled-back")
                try:
                    await register_mod.unregister(zk, new_znodes)
                except Exception as u_err:  # noqa: BLE001
                    ee.emit("error", u_err)
                return False
            ee.znodes = new_znodes
            ee.epoch += 1
            ee._applied_desired = None  # pipeline wrote the params' records
            log.debug("re-registered %s (epoch %d)", ee.znodes, ee.epoch)
            sp.set_attr("outcome", "registered")
            ee.emit("register", new_znodes)
            return True


#: cap on how long a coalesced sweep waits for sibling services to join
#: its flush (the window is otherwise interval/10, so fast test
#: intervals stay fast); a sweep is never delayed past this.
COALESCE_WINDOW_CAP_S = 0.05


class HeartbeatCoalescer:
    """Cork concurrent heartbeat sweeps from the register_plus services
    sharing ONE ZKClient into a single pipelined EXISTS flush.

    Each service's ``_heartbeat_loop`` still owns its cadence, failure
    backoff, and NO_NODE→confirm→repair flow; what changes is only the
    wire shape: sweeps that arrive within one window ride a single
    :meth:`ZKClient.heartbeat_many` call (one corked write, one drain,
    one shared deadline) instead of one flush per service.  Per-service
    outcomes resolve the moment the client decides them (``on_outcome``),
    so a healthy service is never held behind a failing sibling's retry
    schedule.  With a single attached service the coalescer is a pure
    pass-through to :meth:`ZKClient.heartbeat` — zero added latency, and
    tests that monkeypatch ``client.heartbeat`` still intercept the
    probe.  Sweeps are reads (EXISTS only): no single-flight lock needed.
    """

    def __init__(self, zk) -> None:
        self._zk = zk
        self._attached = 0
        #: (nodes, retry, future) staged for the open window's flush
        self._staged: list = []
        self._flush_task: Optional[asyncio.Task] = None
        self._tasks: set = set()

    def attach(self) -> None:
        self._attached += 1

    def detach(self) -> None:
        self._attached -= 1

    async def sweep(self, nodes, retry, interval: float) -> None:
        """One heartbeat sweep over ``nodes``; raises what a solo
        ``zk.heartbeat(nodes, retry=retry)`` would raise."""
        if self._attached <= 1 and not self._staged:
            # Solo service: no window, no future — the daemon's common
            # shape stays byte-identical to the uncoalesced loop.
            await self._zk.heartbeat(nodes, retry=retry)
            return
        fut = asyncio.get_running_loop().create_future()
        self._staged.append((list(nodes), retry, fut))
        if self._flush_task is None or self._flush_task.done():
            window = min(COALESCE_WINDOW_CAP_S, interval / 10.0)
            self._flush_task = spawn_owned(
                self._flush_after(window), self._tasks
            )
        err = await fut
        if err is not None:
            raise err

    async def _flush_after(self, window_s: float) -> None:
        try:
            await asyncio.sleep(window_s)
        except asyncio.CancelledError:
            # Cancelled mid-window: nothing will sweep this batch — fail
            # the staged futures over to their awaiting service loops
            # (which are themselves being cancelled in the stop() case)
            # instead of leaving them parked forever.
            batch, self._staged = self._staged, []
            self._flush_task = None
            for _, _, fut in batch:
                if not fut.done():
                    fut.cancel()
            raise
        batch, self._staged = self._staged, []
        self._flush_task = None
        # Group by retry-policy identity: services configured alike (the
        # normal fleet shape) share one flush; a divergent policy gets
        # its own heartbeat_many with its own schedule — run
        # CONCURRENTLY, so one round riding a failing group's backoff
        # never head-of-line blocks another policy's healthy sweep.
        rounds: dict = {}
        for nodes, retry, fut in batch:
            rounds.setdefault(id(retry), (retry, []))[1].append((nodes, fut))

        async def run_round(retry, members) -> None:
            futs = [f for _, f in members]

            def release(i: int, err) -> None:
                if not futs[i].done():
                    futs[i].set_result(err)

            try:
                await self._zk.heartbeat_many(
                    [nodes for nodes, _ in members],
                    retry=retry,
                    on_outcome=release,
                )
            except asyncio.CancelledError:
                for f in futs:
                    if not f.done():
                        f.cancel()
                raise
            except Exception as err:  # noqa: BLE001 - fan the failure out
                for f in futs:
                    if not f.done():
                        f.set_exception(err)

        if len(rounds) == 1:
            ((retry, members),) = rounds.values()
            await run_round(retry, members)
        elif rounds:
            await asyncio.gather(
                *(run_round(r, m) for r, m in rounds.values())
            )


#: per-client coalescer registry (weak: a closed client's coalescer dies
#: with it; nothing here outlives the session it serves)
_COALESCERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _coalescer_for(zk) -> HeartbeatCoalescer:
    co = _COALESCERS.get(zk)
    if co is None:
        co = _COALESCERS[zk] = HeartbeatCoalescer(zk)
    return co


async def _heartbeat_loop(
    ee: RegistrarEvents,
    zk: ZKClient,
    interval: float,
    retry: Optional[RetryPolicy] = None,
    repair=None,
    lock: Optional[asyncio.Lock] = None,
) -> None:
    """Hot loop #1 (SURVEY.md §3.2): self-rescheduling znode liveness probe.

    ``repair``: optional coroutine factory re-running the registration
    pipeline; invoked when a probe fails with NO_NODE (znodes vanished
    without our session expiring — e.g. an operator deleted them, or a
    reattach raced a cleanup) unless the health checker holds the host
    down.  None = reference behavior: failures only back off.  ``lock``
    is the agent-wide single-flight guard the repair runs under.

    Probes route through the per-client :class:`HeartbeatCoalescer`:
    when several services share this client, sweeps landing in the same
    window fuse into one pipelined flush; solo, it is a pass-through.
    """
    if lock is None:
        lock = asyncio.Lock()
    coalescer = _coalescer_for(zk)
    coalescer.attach()
    try:
        await _heartbeat_loop_body(
            ee, zk, interval, retry, repair, lock, coalescer
        )
    finally:
        coalescer.detach()


async def _heartbeat_loop_body(
    ee: RegistrarEvents,
    zk: ZKClient,
    interval: float,
    retry: Optional[RetryPolicy],
    repair,
    lock: asyncio.Lock,
    coalescer: HeartbeatCoalescer,
) -> None:
    while not ee.stopped:
        try:
            await coalescer.sweep(ee.znodes, retry, interval)
        except asyncio.CancelledError:
            raise
        except Exception as err:  # noqa: BLE001
            log.debug("zk.heartbeat(%s) failed: %r", ee.znodes, err)
            ee.emit("heartbeatFailure", err)
            # Snapshot the registration epoch at the moment the miss was
            # observed: if another recovery path re-registers while the
            # confirm probe / lock wait is in flight, the repair below
            # becomes a no-op instead of a delete+recreate over it.
            epoch_at_miss = ee.epoch
            if (
                repair is not None
                and not ee.down
                and not ee.stopped
                and isinstance(err, ZKError)
                and err.code == Err.NO_NODE
                and await _confirm_nodes_missing(zk, ee)
            ):
                try:
                    repaired = await _reregister_guarded(
                        ee, zk, repair, lock, expect_epoch=epoch_at_miss
                    )
                except asyncio.CancelledError:
                    raise
                except Exception as r_err:  # noqa: BLE001
                    log.debug("heartbeat repair failed: %r", r_err)
                    ee.emit("error", r_err)
                else:
                    if repaired:
                        await asyncio.sleep(interval)
                        continue
            await asyncio.sleep(max(interval, HEARTBEAT_FAILURE_BACKOFF_S))
            continue
        log.debug("zk.heartbeat(%s): ok", ee.znodes)
        ee.emit("heartbeat", ee.znodes)
        await asyncio.sleep(interval)


async def _confirm_nodes_missing(zk: ZKClient, ee: RegistrarEvents) -> bool:
    """One fresh single-attempt probe before the repair pipeline runs.

    A NO_NODE from the probe retry chain can be a *transient* artifact —
    a stale read served by a lagging follower just before catch-up, or a
    probe raced with a session reattach — and the repair pipeline is not
    free: its cleanup stage deletes and re-creates the live znodes, a
    real (if brief) deregistration observable by Binder.  Repair only
    proceeds when a second, immediate probe confirms the znodes are
    really gone; any other outcome (probe passes, or fails for transient
    reasons like CONNECTION_LOSS) falls back to the reference's plain
    failure backoff.
    """
    try:
        await zk.heartbeat(ee.znodes, retry=RetryPolicy(max_attempts=1))
    except asyncio.CancelledError:
        raise
    except ZKError as err:
        return err.code == Err.NO_NODE
    except Exception:  # noqa: BLE001 - transient/unknown: do not repair
        return False
    return False


def _start_health_consumer(
    ee: RegistrarEvents,
    zk: ZKClient,
    do_register,
    check: HealthCheck,
    lock: Optional[asyncio.Lock] = None,
) -> None:
    """Hot loop #2 (SURVEY.md §3.3): health stream -> deregister/re-register.

    ``check`` is constructed by :func:`register_plus` (synchronously, so
    a bad mapping fails at the call site, not inside the task).
    Transitions run under the agent-wide single-flight ``lock`` so a
    rebirth/reconciler/heartbeat repair can never interleave its pipeline
    with a deliberate deregistration.  A failed ``unregister`` leaves
    ``ee.down`` latched with the znodes intact — the reconciler's
    down-state sweep (desired = absent) finishes the deregistration on a
    later tick (without a reconciler the error is
    surfaced for the operator, the pre-existing behavior).
    """
    ee._health = check
    if lock is None:
        lock = asyncio.Lock()
    transitioning = False

    async def on_fail(err: Exception) -> None:
        nonlocal transitioning
        ee.down = True
        transitioning = True
        try:
            log.debug("healthcheck failed, deregistering (znodes=%s)", ee.znodes)
            ee.emit("fail", err)
            try:
                async with lock:
                    deleted = await register_mod.unregister(zk, ee.znodes)
            except Exception as u_err:  # noqa: BLE001
                log.debug("healthcheck: unregister failed: %r", u_err)
                ee.emit("error", u_err)
            else:
                ee.emit("unregister", err, deleted)
        finally:
            transitioning = False

    async def on_recover() -> None:
        nonlocal transitioning
        transitioning = True
        try:
            ee.emit("ok")
            try:
                async with lock:
                    znodes = await do_register()
            except Exception as r_err:  # noqa: BLE001
                log.debug("register: reregister failed: %r", r_err)
                ee.emit("error", r_err)
            else:
                ee.znodes = znodes
                ee.epoch += 1
                ee._applied_desired = None  # pipeline wrote params' records
                ee.down = False
                ee.emit("register", znodes)
        finally:
            transitioning = False

    def on_data(record: Mapping[str, Any]) -> None:
        if ee.stopped or transitioning:
            # Mirrors the reference's implicit single-flight behavior: its
            # `down` flag only flips after the async transition completes.
            return
        rtype = record.get("type")
        if rtype == "ok":
            if ee.down:
                ee._track(on_recover())
        elif rtype == "fail":
            if (
                record.get("err") is not None
                and record.get("isDown")
                and not ee.down
            ):
                ee._track(on_fail(record["err"]))
        else:
            ee.emit("error", ValueError(f"unknown check type: {rtype!r}"))

    check.on("data", on_data)
    check.on("error", lambda err: ee.emit("error", err))
    check.start()
