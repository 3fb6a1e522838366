"""Registration engine: writes this host's service-discovery records.

The rebuild of reference lib/register.js:174-304.  ``register`` runs the
same observable five-stage pipeline against ZooKeeper:

  1. cleanup previous entries — parallel unlink of every target znode,
     ignoring NO_NODE (reference lib/register.js:78-105);
  2. settle delay — fixed 1 s pause "to be nice to watchers"
     (reference lib/register.js:232-235; configurable here, same default);
  3. setup directories — parallel mkdirp of each znode's parent
     (reference lib/register.js:108-129);
  4. register entries — parallel ephemeral-plus create of the host record
     at each znode (reference lib/register.js:132-171);
  5. register service — when a service is configured, a *persistent* put of
     the service record at the domain node itself, which is then appended
     to the owned-node list (reference lib/register.js:45-75).

``unregister`` deletes the znodes sequentially (reference
lib/register.js:254-295).  Two reference bugs are fixed here without
changing znode state (SURVEY.md §7 "faithful-vs-fixed"):

  * reference unregister invokes the *outer* callback after the first
    successful unlink (`cb()` instead of `_cb()`, lib/register.js:281), so
    callers observed completion while later deletes were still in flight —
    here completion means every node was processed;
  * the reference re-validates + mutates the caller's service config in
    place; here record construction is side-effect-free.
"""

from __future__ import annotations

import asyncio
import logging
import socket
from typing import Any, List, Mapping, Optional, Sequence

from registrar_tpu_torch import trace
from registrar_tpu_torch.records import (
    default_address,
    domain_to_path,
    host_record,
    payload_bytes,
    service_record,
)
from registrar_tpu_torch.retry import RetryPolicy, call_with_backoff, is_transient
from registrar_tpu_torch.zk.client import MultiError, Op, ZKClient
from registrar_tpu_torch.zk.protocol import Err, ZKError

log = logging.getLogger("registrar_tpu_torch.registration")

#: Stage-2 pause before re-creating nodes, reference lib/register.js:232-235.
SETTLE_DELAY_S = 1.0

#: Default transient-fault retry for the registration pipeline when a
#: caller opts in (``retry_policy=REGISTER_RETRY``): a blip of connection
#: loss / per-op timeout mid-pipeline re-runs the whole idempotent
#: pipeline (stage 1's cleanup reconciles any half-registration) after a
#: short decorrelated-jitter backoff, instead of surfacing to the
#: orchestrator as a registration failure.  SESSION_EXPIRED and semantic
#: errors stay fatal (retry.is_transient).
REGISTER_RETRY = RetryPolicy(
    max_attempts=4, initial_delay=0.25, max_delay=2.0, jitter="decorrelated"
)


def _validate_registration(registration: Mapping[str, Any]) -> None:
    """Schema check mirroring the reference's assert-plus block
    (lib/register.js:174-201)."""
    if not isinstance(registration, Mapping):
        raise ValueError("registration must be an object")
    if not isinstance(registration.get("domain"), str) or not registration["domain"]:
        raise ValueError("registration.domain must be a non-empty string")
    if not isinstance(registration.get("type"), str) or not registration["type"]:
        raise ValueError("registration.type must be a non-empty string")
    ttl = registration.get("ttl")
    if ttl is not None and (not isinstance(ttl, int) or isinstance(ttl, bool)):
        raise ValueError("registration.ttl must be an integer")
    ports = registration.get("ports")
    if ports is not None:
        if not isinstance(ports, Sequence) or isinstance(ports, (str, bytes)):
            raise ValueError("registration.ports must be an array of integers")
        for p in ports:
            if not isinstance(p, int) or isinstance(p, bool):
                raise ValueError("registration.ports must be an array of integers")
    aliases = registration.get("aliases")
    if aliases is not None:
        if not isinstance(aliases, Sequence) or isinstance(aliases, (str, bytes)):
            raise ValueError("registration.aliases must be an array of strings")
        for a in aliases:
            if not isinstance(a, str):
                raise ValueError("registration.aliases must be an array of strings")


def znode_paths(
    registration: Mapping[str, Any], hostname: Optional[str] = None
) -> List[str]:
    """The znodes a registration owns: ``$path/$(hostname)`` plus one per
    alias (aliases are full DNS names, each mapped through domain_to_path;
    reference lib/register.js:217-227)."""
    path = domain_to_path(registration["domain"])
    hostname = hostname or socket.gethostname()
    nodes = [f"{path}/{hostname}" if path != "/" else f"/{hostname}"]
    nodes.extend(domain_to_path(a) for a in registration.get("aliases") or [])
    return nodes


def registration_payloads(
    registration: Mapping[str, Any],
    admin_ip: Optional[str] = None,
    hostname: Optional[str] = None,
):
    """The registration's desired znode set and payload bytes:
    ``(host_paths, host_payload, service_path, service_payload)`` —
    service fields are None when no service is configured.

    The ONE place this is computed: the write pipeline
    (:func:`_register_once`) and the reconciler's desired-state diff
    (:func:`registrar_tpu_torch.reconcile.desired_records`) both call it, so
    the bytes the pipeline writes and the bytes the sweep expects can
    never drift apart (a formula divergence would otherwise surface as
    permanent false ``payload`` drift — and, with repair on, a rewrite
    of the live registration every interval).
    """
    service = registration.get("service")
    service_payload = (
        payload_bytes(service_record(service)) if service is not None else None
    )
    nodes = znode_paths(registration, hostname)
    address = admin_ip if admin_ip else default_address()
    ports = registration.get("ports")
    if ports is None and service is not None:
        ports = [service["service"]["port"]]
    record_payload = payload_bytes(
        host_record(
            registration["type"], address,
            ttl=registration.get("ttl"), ports=ports,
        )
    )
    service_path = (
        domain_to_path(registration["domain"]) if service is not None else None
    )
    return nodes, record_payload, service_path, service_payload


async def _fanout(coros) -> None:
    """Await a stage's parallel ops; a single op (the common host-type
    registration: one znode, one parent) runs inline without the Task +
    gather machinery."""
    coros = list(coros)
    if len(coros) == 1:
        await coros[0]
    elif coros:
        await asyncio.gather(*coros)


async def register(
    zk: ZKClient,
    registration: Mapping[str, Any],
    admin_ip: Optional[str] = None,
    hostname: Optional[str] = None,
    settle_delay: float = SETTLE_DELAY_S,
    retry_policy: Optional[RetryPolicy] = None,
) -> List[str]:
    """Run the five-stage registration pipeline; returns the owned znodes.

    ``registration`` is the config's ``registration`` object (domain, type,
    aliases?, ttl?, ports?, service?).  ``admin_ip`` overrides the
    interface-probe address (reference lib/register.js:141,148 uses
    opts.adminIp the same way).

    ``retry_policy`` opts into the transient-fault retry layer:
    a connection blip or per-operation timeout mid-pipeline re-runs the
    whole pipeline from stage 1 (whose cleanup makes re-entry idempotent)
    with the policy's backoff, while session expiry and semantic errors
    (bad config, ACLs) propagate immediately.  Default None = single
    attempt, the reference's behavior.
    """
    _validate_registration(registration)
    if retry_policy is not None:
        return await call_with_backoff(
            lambda: _register_once(
                zk, registration, admin_ip, hostname, settle_delay
            ),
            retry_policy,
            on_backoff=lambda n, delay, err: log.warning(
                "register: transient fault (%r); retrying pipeline in %.2fs "
                "(attempt %d)", err, delay, n + 1,
            ),
            # A closed client surfaces CONNECTION_LOSS too, but nothing
            # will ever reconnect it — an expired session must propagate
            # on the first failure, not after the whole backoff budget.
            retryable=lambda err: not zk.closed and is_transient(err),
        )
    return await _register_once(zk, registration, admin_ip, hostname, settle_delay)


async def _register_once(
    zk: ZKClient,
    registration: Mapping[str, Any],
    admin_ip: Optional[str],
    hostname: Optional[str],
    settle_delay: float,
) -> List[str]:
    """One pass of the five-stage pipeline (validated input)."""
    with trace.tracer_for(zk).span(
        "register.pipeline", domain=registration["domain"]
    ):
        return await _register_stages(
            zk, registration, admin_ip, hostname, settle_delay
        )


async def _register_stages(
    zk: ZKClient,
    registration: Mapping[str, Any],
    admin_ip: Optional[str],
    hostname: Optional[str],
    settle_delay: float,
) -> List[str]:
    nodes, record_payload, path, service_payload = registration_payloads(
        registration, admin_ip, hostname
    )

    log.debug("register: entered (domain=%s nodes=%s)", registration["domain"], nodes)

    # Stage 1: cleanup previous entries (parallel, NO_NODE ignored).
    async def _cleanup(node: str) -> None:
        try:
            await zk.unlink(node)
        except ZKError as err:
            if err.code != Err.NO_NODE:
                raise

    await _fanout(_cleanup(n) for n in nodes)

    # Stage 2: be nice to watchers and wait for them to catch up.
    if settle_delay > 0:
        await asyncio.sleep(settle_delay)

    # Stage 3: parent directories (parallel mkdirp).
    parents = {n.rsplit("/", 1)[0] or "/" for n in nodes}
    await _fanout(zk.mkdirp(p) for p in parents if p != "/")

    # Stage 4: ephemeral host records (parallel).
    await _fanout(zk.create_ephemeral_plus(n, record_payload) for n in nodes)

    # Stage 5: persistent service record at the domain node.
    if service_payload is not None:
        await zk.put(path, service_payload)
        if path not in nodes:
            nodes.append(path)

    log.debug("register: done (znodes=%s)", nodes)
    return nodes


async def unlink_tolerant(zk: ZKClient, path: str) -> str:
    """Delete one znode, absorbing the two benign outcomes every
    deregistration walk shares.  Returns ``"deleted"``, ``"absent"``
    (NO_NODE — already gone, e.g. deleted out-of-band or a replay of a
    half-applied delta), or ``"shared"`` (NOT_EMPTY — a service node
    with sibling hosts' ephemerals still under it, which must survive
    this host's departure).  Any other error propagates.

    The ONE copy of this tolerance: the reload delta
    (:mod:`registrar_tpu_torch.agent`), the drain shutdown
    (:mod:`registrar_tpu_torch.main`), and ``zkcli drain`` all walk with it,
    so their deregistration semantics can never drift apart.
    """
    try:
        await zk.unlink(path)
    except ZKError as err:
        if err.code == Err.NO_NODE:
            return "absent"
        if err.code == Err.NOT_EMPTY:
            return "shared"
        raise
    return "deleted"


async def unregister(
    zk: ZKClient, znodes: Sequence[str], atomic: bool = False
) -> List[str]:
    """Delete the owned znodes, sequentially (reference lib/register.js:254-295).

    Returns the nodes actually deleted — callers reporting the outcome
    (e.g. the agent's ``unregister`` event) must not claim a shared
    service node that was left in place.

    Every node is processed before this returns (the reference fires its
    callback after the first delete — fixed, see module docstring).  The
    first error aborts the walk and propagates, matching the reference's
    forEachPipeline semantics — with one deliberate exception: a node that
    fails with NOT_EMPTY is left in place and the walk continues.  The
    owned-node list includes the *persistent* service record at the domain
    node (``register`` appends it, like the reference's registerService);
    in a multi-instance domain — the normal production shape — sibling
    hosts' ephemerals still live under it, so it must survive this host's
    deregistration.  The znode outcome is identical to the reference's
    (ZooKeeper refuses the delete either way; the reference's early-callback
    bug merely hid the error), but here "shared node still in use" is
    success, not failure, so health-driven deregistration in a fleet emits
    ``unregister`` instead of ``error``.

    ``atomic=True`` (beyond the reference's surface) instead deletes all
    nodes in one ZooKeeper multi transaction: observers never see a
    half-deregistered host.  NOT_EMPTY gets the same treatment — the
    transaction is retried without the still-shared nodes (each retry drops
    at least one, so the loop terminates).  Default stays off — the
    sequential walk is the reference's observable behavior.
    """
    if not isinstance(znodes, Sequence) or isinstance(znodes, (str, bytes)):
        raise ValueError("znodes must be a sequence of paths")
    if atomic and znodes:
        log.debug("unregister: atomic delete of %s", list(znodes))
        remaining = list(znodes)
        while remaining:
            try:
                await zk.multi([Op.delete(n) for n in remaining])
                break
            except MultiError as err:
                shared = [
                    n
                    for n, code in zip(remaining, err.results)
                    if code == Err.NOT_EMPTY
                ]
                if not shared:
                    raise
                log.debug(
                    "unregister: %s still shared (children remain); retrying "
                    "without them", shared,
                )
                remaining = [n for n in remaining if n not in shared]
        log.debug("unregister: done")
        return remaining
    deleted: List[str] = []
    for node in znodes:
        log.debug("unregister: deleting %s", node)
        try:
            await zk.unlink(node)
        except ZKError as err:
            if err.code != Err.NOT_EMPTY:
                raise
            log.debug(
                "unregister: %s still has children (shared service node); "
                "left in place", node,
            )
        else:
            deleted.append(node)
    log.debug("unregister: done")
    return deleted
