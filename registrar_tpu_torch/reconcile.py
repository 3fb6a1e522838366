"""Level-triggered registration reconciler.

Everything else in the daemon is edge-triggered: the heartbeat probes
existence, the health checker reacts to threshold crossings, repair runs
when a specific event fires.  Edge triggers miss state that drifted
*between* edges — an operator's ``zkcli set`` over the host record, a
znode deleted while the probe was backing off, a service record a tool
clobbered, a deregistration that failed mid-flight.  This module closes
the loop the level-triggered way: periodically read back every znode the
registration *should* own (one pipelined ``get_many`` sweep), diff the
observed bytes/stat against the desired records, surface each divergence
as a structured ``drift`` event with a reason from :data:`REASONS`, and —
when ``reconcile.repair`` is on — converge through the existing
idempotent registration pipeline.

Desired state is a pure function of the configuration (plus the health
checker's verdict): ``ee.down`` flips the desired state to *absent*, so a
deregistration that failed mid-flight (agent.py's ``on_fail``) is
finished by the sweep instead of leaking live znodes for a host health
declared dead.

One deliberate non-goal: an ephemeral owned by a **foreign live session**
(reason ``owner``) is detected and counted but never repaired.  The
pipeline's cleanup stage would delete the foreign node — stealing a
hostname two live registrars both claim, and the pair would then steal it
back and forth forever.  That tug-of-war converges to nothing and
destroys the evidence; leaving the node (while alarming on the drift
metric) keeps exactly one registrar serving and hands operators a stable
state to debug.  See docs/DESIGN.md "Why repair never steals".

The read-only half (:func:`audit`) is also the engine behind
``zkcli verify -f config.json`` (exit 0/1/2 = in-sync/drift/unreachable)
for cron- and runbook-driven auditing from outside the daemon.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

from registrar_tpu_torch import registration as register_mod
from registrar_tpu_torch import trace
from registrar_tpu_torch.registration import (
    _validate_registration,
    registration_payloads,
)
from registrar_tpu_torch.zk.client import ZKClient
from registrar_tpu_torch.zk.protocol import Err, ZKError

log = logging.getLogger("registrar_tpu_torch.reconcile")

# -- drift reason taxonomy (docs/OPERATIONS.md carries the operator matrix) --

#: a desired znode does not exist
R_MISSING = "missing"
#: a host record exists, we own it, but its payload diverged
R_PAYLOAD = "payload"
#: a host record's ephemeral is held by a foreign session (never repaired)
R_OWNER = "owner"
#: a host record exists but is persistent — it lost its session binding,
#: so a crash would leave it in DNS forever
R_NOT_EPHEMERAL = "notEphemeral"
#: the persistent service record diverged (payload, or wrongly ephemeral)
R_STALE_SERVICE = "staleService"
#: a znode is still present while the desired state is absent
#: (health-deregistered host; finishes a failed mid-flight unregister)
R_LINGERING = "lingering"

#: every reason the sweep can emit, in stable order (metrics pre-seeding)
REASONS = (
    R_MISSING, R_PAYLOAD, R_OWNER, R_NOT_EPHEMERAL, R_STALE_SERVICE,
    R_LINGERING,
)


@dataclass(frozen=True)
class Desired:
    """One znode the registration owns, as it should read back."""

    path: str
    payload: bytes
    ephemeral: bool


@dataclass(frozen=True)
class Drift:
    """One observed divergence from the desired state."""

    path: str
    reason: str
    detail: str = ""
    #: False for divergences repair must never act on (foreign owner)
    repairable: bool = True
    #: a service record observed wrongly EPHEMERAL — needs an unlink
    #: before any put/pipeline can restore it (a put cannot change
    #: ephemeral-ness, and nothing can create children under it)
    ephemeral_service: bool = False


def desired_records(
    registration: Mapping[str, Any],
    admin_ip: Optional[str] = None,
    hostname: Optional[str] = None,
) -> List[Desired]:
    """The registration's desired znodes, byte-exact.

    Thin shaping over :func:`registration.registration_payloads` — the
    ONE shared record-construction helper the write pipeline also uses —
    so the bytes a sweep expects are definitionally the bytes
    ``register`` writes (tests/test_reconcile.py additionally pins the
    round trip against the live pipeline).
    """
    _validate_registration(registration)
    nodes, record_payload, service_path, service_payload = (
        registration_payloads(registration, admin_ip, hostname)
    )
    desired = [Desired(n, record_payload, True) for n in nodes]
    if service_path is not None:
        for i, d in enumerate(desired):
            if d.path == service_path:
                # Alias == domain collision.  The pipeline can never
                # actually register this shape (its stage-3 mkdirp
                # creates the domain node persistent as the host
                # record's parent, and stage 4's ephemeral create then
                # dies with NODE_EXISTS), so there is no converged state
                # to describe — but an *audit* of such a config must not
                # report the same path twice with conflicting
                # expectations.  One entry, the service record's,
                # matching what stage 5 would have left.
                desired[i] = Desired(service_path, service_payload, False)
                break
        else:
            desired.append(Desired(service_path, service_payload, False))
    return desired


async def sweep(
    zk: ZKClient,
    desired: List[Desired],
    session_id: Optional[int] = None,
) -> List[Drift]:
    """Read back every desired znode (one pipelined sweep) and diff.

    Pure read: nothing is mutated.  ``session_id`` enables the ownership
    check — pass the registrar's own session to flag foreign-owned
    ephemerals; pass None (an external auditor, ``zkcli verify``) to
    accept any live owner, since an auditor's session never owns the
    nodes.  Transport errors propagate (the caller decides whether a
    failed sweep is retried or reported as unreachable).
    """
    results = await zk.get_many([d.path for d in desired])
    drifts: List[Drift] = []
    for d, res in zip(desired, results):
        if res is None:
            drifts.append(Drift(d.path, R_MISSING))
            continue
        data, stat = res
        if not d.ephemeral:
            if stat.ephemeral_owner != 0:
                # A wrongly-ephemeral service record will vanish with its
                # owning session.  Repairable only when WE own it (unlink
                # + persistent put); a foreign session's ephemeral is
                # never touched — not even by a put, which would both
                # write into someone else's node and leave the
                # ephemeral-ness unconverged (see docs/DESIGN.md).
                foreign = (
                    session_id is not None
                    and stat.ephemeral_owner != session_id
                )
                drifts.append(
                    Drift(
                        d.path, R_STALE_SERVICE,
                        f"service record is ephemeral "
                        f"(owner 0x{stat.ephemeral_owner:x})",
                        repairable=not foreign,
                        ephemeral_service=True,
                    )
                )
            elif data != d.payload:
                drifts.append(
                    Drift(d.path, R_STALE_SERVICE, "payload diverged")
                )
            continue
        if stat.ephemeral_owner == 0:
            # No session owns it: safe (and necessary) to recreate as a
            # proper ephemeral — nothing will ever clean it up otherwise.
            drifts.append(Drift(d.path, R_NOT_EPHEMERAL))
            continue
        if session_id is not None and stat.ephemeral_owner != session_id:
            drifts.append(
                Drift(
                    d.path, R_OWNER,
                    f"owner 0x{stat.ephemeral_owner:x} != "
                    f"ours 0x{session_id:x}",
                    repairable=False,
                )
            )
            continue  # the foreign session's payload is not ours to judge
        if data != d.payload:
            drifts.append(Drift(d.path, R_PAYLOAD))
    return drifts


async def audit(
    zk: ZKClient,
    registration: Mapping[str, Any],
    admin_ip: Optional[str] = None,
    hostname: Optional[str] = None,
) -> List[Drift]:
    """Read-only diff of live ZooKeeper state against a config's desired
    records — the engine behind ``zkcli verify``.  No ownership claim is
    made (session_id None): any live ephemeral owner passes."""
    return await sweep(
        zk, desired_records(registration, admin_ip, hostname)
    )


class Reconciler:
    """The in-daemon periodic sweep-and-repair loop.

    Wired by :func:`registrar_tpu_torch.agent.register_plus`; ``ee`` is the
    agent's event surface (read for ``down``/``znodes``/``stopped``,
    written via ``drift`` / ``driftRepaired`` / ``reconcile`` events and
    — for a completed down-state deregistration — ``unregister``).

    ``repair_fn(expect_epoch)`` is the agent's single-flight guarded
    registration pipeline (returns True when the registration was
    refreshed); it receives the ``ee.epoch`` observed *before* the
    sweep's read-back, so a repair decided on stale observations is
    skipped if any other recovery path refreshed the registration in
    between.  The down-state repair path takes ``lock`` itself, so every
    znode-mutating flow in the daemon serializes on the one lock.
    """

    def __init__(
        self,
        zk: ZKClient,
        ee,
        registration: Mapping[str, Any],
        admin_ip: Optional[str] = None,
        hostname: Optional[str] = None,
        interval_s: float = 60.0,
        repair: bool = False,
        repair_fn=None,
        lock: Optional[asyncio.Lock] = None,
    ):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        if repair and repair_fn is None:
            raise ValueError("repair=True requires repair_fn")
        self.zk = zk
        self.ee = ee
        self.registration = registration
        self.admin_ip = admin_ip
        self.hostname = hostname
        self.interval_s = interval_s
        self.repair = repair
        self.repair_fn = repair_fn
        self.lock = lock if lock is not None else asyncio.Lock()
        #: observability (metrics read these through events; tests directly)
        self.sweeps = 0
        self.drift_seen = 0
        self.repaired = 0
        self.owner_conflicts = 0
        self.last_duration_s = 0.0
        self._sweep_epoch = 0

    async def run(self) -> None:
        """Sweep every ``interval_s`` until the agent stops.

        A failed sweep (connection blip mid-storm, reconnect in flight)
        is logged and retried at the next tick — the loop itself must
        never die, that is the whole point of level triggering.
        """
        while not self.ee.stopped:
            await asyncio.sleep(self.interval_s)
            if self.ee.stopped:
                return
            try:
                await self.sweep_once()
            except asyncio.CancelledError:
                raise
            except Exception as err:  # noqa: BLE001 - next tick retries
                log.debug("reconcile sweep failed: %r", err)

    async def sweep_once(self) -> List[Drift]:
        """One sweep: diff, emit drift, repair (when configured)."""
        with trace.tracer_for(self.zk).span("reconcile.sweep") as sp:
            drifts = await self._sweep_traced()
            sp.set_attr("drift", len(drifts))
            return drifts

    async def _sweep_traced(self) -> List[Drift]:
        start = time.monotonic()
        # Epoch BEFORE the read-back: the sweep's observations are only
        # actionable if no other recovery path refreshes the
        # registration between this point and the repair holding the
        # lock (see agent._reregister_guarded).
        self._sweep_epoch = getattr(self.ee, "epoch", 0)
        if self.lock.locked():
            # Another actor (health transition, heartbeat repair,
            # rebirth) is mid-mutation: reading now would observe its
            # pipeline's delete+settle window and report the healthy
            # in-flight refresh as "missing" drift.  Level-triggered
            # means the next tick re-reads; skip this one (no sweep
            # counted, no events — the tick observed nothing).
            return []
        if self.ee.down:
            drifts = await self._sweep_down()
        else:
            drifts = await sweep(
                self.zk,
                desired_records(
                    self.registration, self.admin_ip, self.hostname
                ),
                session_id=self.zk.session_id,
            )
        if (
            getattr(self.ee, "epoch", 0) != self._sweep_epoch
            or self.lock.locked()
        ):
            # The registration was (or is being) refreshed while we were
            # reading: the observations straddle a mutation and any
            # "drift" in them is an artifact.  Discard; next tick
            # re-reads the settled state.
            return []
        self.sweeps += 1
        self.drift_seen += len(drifts)
        self.owner_conflicts += sum(
            1 for d in drifts if d.reason == R_OWNER
        )
        for d in drifts:
            log.warning(
                "drift: %s at %s%s", d.reason, d.path,
                f" ({d.detail})" if d.detail else "",
            )
            self.ee.emit("drift", d)
        repaired: List[Drift] = []
        if self.repair and drifts and not self.ee.stopped:
            repaired = await self._repair(drifts)
            self.repaired += len(repaired)
            for d in repaired:
                self.ee.emit("driftRepaired", d)
        self.last_duration_s = time.monotonic() - start
        self.ee.emit(
            "reconcile",
            {
                "duration": self.last_duration_s,
                "drift": len(drifts),
                "repaired": len(repaired),
            },
        )
        return drifts

    async def _sweep_down(self) -> List[Drift]:
        """Desired state while health-deregistered: our znodes ABSENT.

        Catches a health-driven ``unregister`` that failed mid-flight
        (the agent leaves ``ee.down`` set with the error surfaced) —
        every still-present node we own is ``lingering`` drift and the
        repair pass finishes the deregistration.  A shared service node
        kept alive by siblings' ephemerals is not drift (deleting it is
        refused with NOT_EMPTY anyway), and a foreign-owned ephemeral is
        not ours to delete even here.
        """
        paths = list(self.ee.znodes)
        if not paths:
            return []
        results = await self.zk.get_many(paths)
        drifts = []
        for p, res in zip(paths, results):
            if res is None:
                continue
            _, stat = res
            if stat.ephemeral_owner == 0 and stat.num_children > 0:
                continue  # shared service node: siblings still live under it
            if (
                stat.ephemeral_owner
                and stat.ephemeral_owner != self.zk.session_id
            ):
                continue  # foreign-owned: never steal, even to delete
            drifts.append(Drift(p, R_LINGERING))
        return drifts

    async def _repair(self, drifts: List[Drift]) -> List[Drift]:
        """Converge: pipeline re-registration, targeted service put, or
        (down) completing the deregistration.  Returns the drifts
        actually repaired; failures are logged and retried next sweep."""
        if self.ee.down:
            lingering = [d for d in drifts if d.reason == R_LINGERING]
            if not lingering:
                return []
            try:
                async with self.lock:
                    if not self.ee.down or self.ee.stopped:
                        return []  # recovered while waiting: nothing to finish
                    deleted = await register_mod.unregister(
                        self.zk, [d.path for d in lingering]
                    )
            except asyncio.CancelledError:
                raise
            except Exception as err:  # noqa: BLE001 - next sweep retries
                log.warning("reconcile: deregistration repair failed: %r", err)
                return []
            log.info(
                "reconcile: completed pending deregistration (%s)", deleted
            )
            self.ee.emit("unregister", None, deleted)
            return lingering

        repairable = [d for d in drifts if d.repairable]
        conflicts = [d for d in drifts if d.reason == R_OWNER]
        if conflicts:
            # The pipeline's cleanup stage unlinks EVERY owned path —
            # running it now would steal the foreign-owned node.  Only
            # the targeted service-record put (which touches no
            # ephemeral) stays safe while a conflict stands.
            log.error(
                "reconcile: %d ownership conflict(s) (%s); refusing "
                "pipeline repair — two live claimants for one hostname "
                "is an operator problem",
                len(conflicts), [d.path for d in conflicts],
            )
            repairable = [
                d for d in repairable if d.reason == R_STALE_SERVICE
            ]
        if not repairable:
            return []

        if any(d.ephemeral_service for d in repairable):
            # Pre-clean: a service record that became OUR ephemeral
            # blocks every other repair — a put cannot change its
            # ephemeral-ness, and the pipeline cannot create host
            # records under it (NO_CHILDREN_FOR_EPHEMERALS) — so unlink
            # it first (it is childless by ZooKeeper's own invariant;
            # an "ephemeral with children", mintable only by test
            # controls, is refused and logged).  Live state is re-read
            # under the lock: a foreign owner (raced since the sweep)
            # is never touched.
            if not await self._unlink_ephemeral_services(
                [d for d in repairable if d.ephemeral_service]
            ):
                return []

        if all(d.reason == R_STALE_SERVICE for d in repairable):
            # Only the persistent service record drifted: a targeted put
            # converges it without the pipeline's delete+recreate of the
            # live host ephemerals (a real, Binder-visible blip).
            # Desired payloads are computed ONCE for the pass.
            payloads = {
                want.path: want.payload
                for want in desired_records(
                    self.registration, self.admin_ip, self.hostname
                )
            }
            repaired: List[Drift] = []
            try:
                async with self.lock:
                    if self.ee.down or self.ee.stopped:
                        return []
                    for d in repairable:
                        payload = payloads.get(d.path)
                        if payload is None:
                            continue
                        st = await self.zk.exists(d.path)
                        if st is not None and st.ephemeral_owner:
                            continue  # still ephemeral: pre-clean refused
                        await self.zk.put(d.path, payload)
                        repaired.append(d)
            except asyncio.CancelledError:
                raise
            except Exception as err:  # noqa: BLE001 - next sweep retries
                log.warning("reconcile: service-record repair failed: %r", err)
                return repaired
            return repaired

        try:
            refreshed = await self.repair_fn(self._sweep_epoch)
        except asyncio.CancelledError:
            raise
        except Exception as err:  # noqa: BLE001 - next sweep retries
            log.warning("reconcile: pipeline repair failed: %r", err)
            self.ee.emit("error", err)
            return []
        return repairable if refreshed else []

    async def _unlink_ephemeral_services(self, drifts: List[Drift]) -> bool:
        """Unlink OUR wrongly-ephemeral service records (see _repair's
        pre-clean comment).  Returns False when the pass failed and the
        repair should be abandoned until the next sweep."""
        try:
            async with self.lock:
                if self.ee.down or self.ee.stopped:
                    return False
                for d in drifts:
                    st = await self.zk.exists(d.path)
                    if st is None or not st.ephemeral_owner:
                        continue  # already settled
                    if st.ephemeral_owner != self.zk.session_id:
                        log.error(
                            "reconcile: service record %s is an ephemeral "
                            "owned by foreign session 0x%x; refusing to "
                            "repair", d.path, st.ephemeral_owner,
                        )
                        continue
                    try:
                        await self.zk.unlink(d.path)
                    except ZKError as err:
                        if err.code != Err.NOT_EMPTY:
                            raise
                        log.error(
                            "reconcile: %s is an ephemeral WITH children "
                            "(cannot exist in real ZooKeeper); refusing "
                            "to repair", d.path,
                        )
        except asyncio.CancelledError:
            raise
        except Exception as err:  # noqa: BLE001 - next sweep retries
            log.warning(
                "reconcile: ephemeral service pre-clean failed: %r", err
            )
            return False
        return True


def summarize(drifts: List[Drift]) -> Dict[str, int]:
    """Reason -> count rollup (zkcli verify's summary line, log fields)."""
    out: Dict[str, int] = {}
    for d in drifts:
        out[d.reason] = out.get(d.reason, 0) + 1
    return out
