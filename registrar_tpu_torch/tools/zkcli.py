"""Operator CLI for inspecting service-discovery state in ZooKeeper.

The reference's debugging docs tell operators to poke at znodes with
ZooKeeper's ``zkCli.sh`` (README.md "Debugging Notes"); this ships the
equivalent, plus a ``resolve`` command that answers exactly as Binder
would (see :mod:`registrar_tpu_torch.binderview`), so "what will DNS say?" is
one command instead of manual tree-walking::

    python -m registrar_tpu_torch.tools.zkcli -s 127.0.0.1:2181 ls /us/joyent
    python -m registrar_tpu_torch.tools.zkcli -s 127.0.0.1:2181 get /us/joyent/emy-10/authcache
    python -m registrar_tpu_torch.tools.zkcli -s 127.0.0.1:2181 stat /us/joyent/emy-10/authcache
    python -m registrar_tpu_torch.tools.zkcli -s 127.0.0.1:2181 tree /us
    python -m registrar_tpu_torch.tools.zkcli -s 127.0.0.1:2181 rm /us/joyent/emy-10/stale
    python -m registrar_tpu_torch.tools.zkcli -s 127.0.0.1:2181 resolve authcache.emy-10.joyent.us
    python -m registrar_tpu_torch.tools.zkcli -s 127.0.0.1:2181 resolve -t SRV _http._tcp.example.joyent.us
    python -m registrar_tpu_torch.tools.zkcli -s 127.0.0.1:2181 admin ruok
    python -m registrar_tpu_torch.tools.zkcli verify -f /opt/registrar/etc/config.json
    python -m registrar_tpu_torch.tools.zkcli state /var/run/registrar/state.json
    python -m registrar_tpu_torch.tools.zkcli drain -f /opt/registrar/etc/config.json
    python -m registrar_tpu_torch.tools.zkcli -s 127.0.0.1:2181 getacl /us/joyent
    python -m registrar_tpu_torch.tools.zkcli -s 127.0.0.1:2181 --auth digest:ops:pw \
        setacl /us/joyent/locked digest:ops:HASH:cdrwa world:anyone:r

With no command, zkcli enters an interactive prompt running the same
commands over ONE ZooKeeper session — the ``zkCli.sh -server`` workflow
the reference's debugging notes teach (reference README.md:785-807)::

    $ python -m registrar_tpu_torch.tools.zkcli -s 127.0.0.1:2181
    zkcli> ls /us/joyent/emy-10
    zkcli> get /us/joyent/emy-10/authcache
    zkcli> addauth digest:ops:pw
    zkcli> quit

Extra prompt-only commands: ``addauth SCHEME:CRED`` (authenticate the
live session), ``help``, ``quit``/``exit``; ``#`` starts a comment.
Because the session persists between commands, ``create -e`` ephemerals
live until the prompt exits — handy for rehearsing registrar failover.

Exit status: 0 on success, 1 on ZK errors (e.g. no such node), 2 on usage.
``verify`` refines this into its audit contract: 0 in-sync, 1 drift
detected, 2 unreachable — cron- and runbook-friendly.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from typing import List, Optional, Tuple

from registrar_tpu_torch import binderview
from registrar_tpu_torch.retry import RetryPolicy
from registrar_tpu_torch.zk.client import ZKClient
from registrar_tpu_torch.zk.quota import (
    LIMITS_LEAF,
    QUOTA_ROOT,
    STATS_LEAF,
    format_quota,
    parse_quota,
)
from registrar_tpu_torch.zk.protocol import (
    ACL,
    CreateFlag,
    Err,
    EventType,
    Perms,
    Stat,
    ZKError,
)

#: perm letter <-> bit, in zkCli.sh's display order (cdrwa)
_PERM_LETTERS = [
    ("c", Perms.CREATE),
    ("d", Perms.DELETE),
    ("r", Perms.READ),
    ("w", Perms.WRITE),
    ("a", Perms.ADMIN),
]


def _fmt_perms(perms: int) -> str:
    return "".join(ch for ch, bit in _PERM_LETTERS if perms & bit)


def _parse_acl(spec: str) -> ACL:
    """Parse ``scheme:id:perms`` (id may itself contain colons, e.g. a
    digest ``user:hash`` — the *last* segment is always the perm letters)."""
    scheme, _, rest = spec.partition(":")
    ident, _, perm_str = rest.rpartition(":")
    if not scheme or not perm_str:
        raise argparse.ArgumentTypeError(
            f"expected scheme:id:perms (e.g. world:anyone:cdrwa), got {spec!r}"
        )
    perms = 0
    for ch in perm_str:
        for letter, bit in _PERM_LETTERS:
            if ch == letter:
                perms |= bit
                break
        else:
            raise argparse.ArgumentTypeError(
                f"bad perm letter {ch!r} in {spec!r} (use [cdrwa])"
            )
    return ACL(perms=perms, scheme=scheme, id=ident)


def _parse_auth(value: str) -> Tuple[str, bytes]:
    scheme, sep, cred = value.partition(":")
    if not scheme or not sep:
        raise argparse.ArgumentTypeError(
            f"expected scheme:credential (e.g. digest:user:pass), got {value!r}"
        )
    return (scheme, cred.encode())


def _parse_servers(value: str) -> List[Tuple[str, int]]:
    servers = []
    for part in value.split(","):
        host, _, port = part.strip().rpartition(":")
        if not host:
            raise argparse.ArgumentTypeError(
                f"expected host:port[,host:port...], got {value!r}"
            )
        try:
            servers.append((host, int(port)))
        except ValueError:
            raise argparse.ArgumentTypeError(f"bad port in {part!r}")
    return servers


def _fmt_stat(stat: Stat) -> str:
    lines = [
        f"czxid = 0x{stat.czxid:x}",
        f"mzxid = 0x{stat.mzxid:x}",
        f"ctime = {stat.ctime}",
        f"mtime = {stat.mtime}",
        f"version = {stat.version}",
        f"cversion = {stat.cversion}",
        f"ephemeralOwner = 0x{stat.ephemeral_owner:x}",
        f"dataLength = {stat.data_length}",
        f"numChildren = {stat.num_children}",
        f"pzxid = 0x{stat.pzxid:x}",
    ]
    return "\n".join(lines)


async def _cmd_ls(zk: ZKClient, args) -> int:
    for child in await zk.get_children(args.path):
        print(child)
    return 0


async def _cmd_get(zk: ZKClient, args) -> int:
    data, _ = await zk.get(args.path)
    if not data:
        return 0
    try:
        print(json.dumps(json.loads(data), indent=2 if args.pretty else None,
                         separators=None if args.pretty else (",", ":")))
    except ValueError:
        sys.stdout.buffer.write(data + b"\n")
    return 0


async def _cmd_stat(zk: ZKClient, args) -> int:
    print(_fmt_stat(await zk.stat(args.path)))
    return 0


async def _cmd_tree(zk: ZKClient, args) -> int:
    async def walk(path: str, depth: int) -> None:
        name = path.rsplit("/", 1)[-1] or "/"
        data, stat = await zk.get(path)
        suffix = ""
        if stat.ephemeral_owner:
            suffix += f"  [ephemeral 0x{stat.ephemeral_owner:x}]"
        if data:
            body = data.decode("utf-8", errors="replace")
            if len(body) > 60:
                body = body[:57] + "..."
            suffix += f"  {body}"
        print("  " * depth + name + suffix)
        for child in await zk.get_children(path):
            base = path.rstrip("/")
            await walk(f"{base}/{child}", depth + 1)

    await walk(args.path, 0)
    return 0


async def _cmd_rm(zk: ZKClient, args) -> int:
    await zk.unlink(args.path, version=args.version)
    return 0


async def _cmd_watch(zk: ZKClient, args) -> int:
    """Stream change events for a path (data + children) until interrupted."""
    names = {
        EventType.NODE_CREATED: "created",
        EventType.NODE_DELETED: "deleted",
        EventType.NODE_DATA_CHANGED: "dataChanged",
        EventType.NODE_CHILDREN_CHANGED: "childrenChanged",
    }
    queue: asyncio.Queue = asyncio.Queue()
    zk.watch(args.path, queue.put_nowait)

    async def arm() -> None:
        # NO_NODE is fine (the exist-watch fires on creation); anything
        # else — above all CONNECTION_LOSS, since this client does not
        # reconnect — must surface rather than leave a silent dead watch.
        try:
            await zk.stat(args.path, watch=True)
        except ZKError as err:
            if err.code != Err.NO_NODE:
                raise
        try:
            await zk.get_children(args.path, watch=True)
        except ZKError as err:
            if err.code != Err.NO_NODE:
                raise

    await arm()
    print(f"watching {args.path} (ctrl-C to stop)", file=sys.stderr)
    deadline = asyncio.get_running_loop().time() + args.duration
    while True:
        remaining = deadline - asyncio.get_running_loop().time()
        if args.duration and remaining <= 0:
            return 0
        try:
            ev = await asyncio.wait_for(
                queue.get(), timeout=remaining if args.duration else None
            )
        except asyncio.TimeoutError:
            return 0
        print(f"{names.get(ev.type, ev.type)} {ev.path}", flush=True)
        await arm()  # watches are one-shot; re-arm


async def _cmd_create(zk: ZKClient, args) -> int:
    flags = CreateFlag.PERSISTENT
    if args.ephemeral and args.sequential:
        flags = CreateFlag.EPHEMERAL_SEQUENTIAL
    elif args.ephemeral:
        flags = CreateFlag.EPHEMERAL
    elif args.sequential:
        flags = CreateFlag.PERSISTENT_SEQUENTIAL
    path = await zk.create(
        args.path, args.data.encode(), flags,
        acls=args.acl if args.acl else None,
    )
    print(path)
    if args.ephemeral and not getattr(args, "repl", False):
        # In one-shot mode an ephemeral dies with this CLI's session the
        # moment we exit — only useful for watching the effect from
        # another session.  At the interactive prompt the session (and
        # so the node) lives until 'quit', so no warning there.
        print(
            "zkcli: note: ephemeral node is deleted when this command's "
            "session closes (now)",
            file=sys.stderr,
        )
    return 0


async def _cmd_set(zk: ZKClient, args) -> int:
    if args.version != -1:
        # Conditional set is a plain setData (no create-if-missing
        # fallback: an expected version implies the node exists).
        stat = await zk.set_data(
            args.path, args.data.encode(), version=args.version
        )
    else:
        stat = await zk.put(args.path, args.data.encode())
    print(f"version = {stat.version}")
    return 0


async def _cmd_mkdirp(zk: ZKClient, args) -> int:
    await zk.mkdirp(args.path)
    print(args.path)
    return 0


async def _cmd_rmr(zk: ZKClient, args) -> int:
    """Recursive delete, children first (zkCli.sh ``rmr``/``deleteall``).

    Not atomic: concurrent writers can race the walk.  A node that gained
    a child between listing and delete is re-walked (bounded retries), and
    nodes that vanished underneath us (ephemeral expiry) are fine.
    """
    deleted = 0

    async def walk(path: str, retries: int = 5) -> None:
        nonlocal deleted
        try:
            children = await zk.get_children(path)
        except ZKError as e:
            if e.code == Err.NO_NODE:
                return
            raise
        for child in children:
            await walk(f"{path}/{child}" if path != "/" else f"/{child}")
        try:
            await zk.unlink(path)
            deleted += 1
        except ZKError as e:
            if e.code == Err.NO_NODE:  # raced with an ephemeral expiry: fine
                return
            if e.code == Err.NOT_EMPTY and retries > 0:
                # A writer added a child after we listed; re-walk.
                await walk(path, retries - 1)
                return
            raise

    if args.path == "/":
        print("zkcli: refusing to delete /", file=sys.stderr)
        return 1
    await walk(args.path)
    print(f"deleted {deleted} node(s)")
    return 0


async def _quota_conflict(zk: ZKClient, path: str) -> "str | None":
    """A quota may not nest inside another (zkCli.sh refuses both
    directions).  Returns the conflicting target path, if any."""
    # Ancestor (or self) already quota'd?
    comps = path.strip("/").split("/")
    prefix = ""
    for comp in comps:
        prefix += "/" + comp
        if await zk.exists(f"{QUOTA_ROOT}{prefix}/{LIMITS_LEAF}"):
            return prefix

    # Descendant already quota'd?
    async def walk(qpath: str, target: str) -> "str | None":
        try:
            children = await zk.get_children(qpath)
        except ZKError as e:
            if e.code == Err.NO_NODE:
                return None
            raise
        for child in children:
            if child == LIMITS_LEAF and qpath != f"{QUOTA_ROOT}{path}":
                return target
            if child in (LIMITS_LEAF, STATS_LEAF):
                continue
            found = await walk(f"{qpath}/{child}", f"{target}/{child}")
            if found:
                return found
        return None

    return await walk(f"{QUOTA_ROOT}{path}", path)


async def _cmd_setquota(zk: ZKClient, args) -> int:
    """zkCli.sh ``setquota -n N | -b B path`` (soft limits: the server
    logs violations, it never rejects writes)."""
    if args.count is None and args.bytes is None:
        print("zkcli: setquota needs -n COUNT and/or -b BYTES", file=sys.stderr)
        return 2
    conflict = await _quota_conflict(zk, args.path)
    if conflict and conflict != args.path:
        print(
            f"zkcli: {conflict} already has a quota; nested quotas are not "
            "allowed", file=sys.stderr,
        )
        return 1
    limits_path = f"{QUOTA_ROOT}{args.path}/{LIMITS_LEAF}"
    stats_path = f"{QUOTA_ROOT}{args.path}/{STATS_LEAF}"
    existing = await zk.exists(limits_path)
    quota = {"count": -1, "bytes": -1}
    if existing:
        data, _ = await zk.get(limits_path)
        quota = parse_quota(data)
    if args.count is not None:
        quota["count"] = args.count
    if args.bytes is not None:
        quota["bytes"] = args.bytes
    await zk.mkdirp(f"{QUOTA_ROOT}{args.path}")
    await zk.put(limits_path, format_quota(quota["count"], quota["bytes"]))
    if not await zk.exists(stats_path):
        await zk.put(stats_path, format_quota(0, 0))
    print(f"quota for {args.path}: count={quota['count']},bytes={quota['bytes']}")
    return 0


async def _cmd_listquota(zk: ZKClient, args) -> int:
    """zkCli.sh ``listquota path``: the limit and the live usage."""
    limits_path = f"{QUOTA_ROOT}{args.path}/{LIMITS_LEAF}"
    try:
        data, _ = await zk.get(limits_path)
    except ZKError as e:
        if e.code == Err.NO_NODE:
            print(f"quota for {args.path} does not exist")
            return 1
        raise
    print(f"absolute path is {limits_path}")
    quota = parse_quota(data)
    print(f"Output quota for {args.path} "
          f"count={quota['count']},bytes={quota['bytes']}")
    stats, _ = await zk.get(f"{QUOTA_ROOT}{args.path}/{STATS_LEAF}")
    usage = parse_quota(stats)
    print(f"Output stat for {args.path} "
          f"count={usage['count']},bytes={usage['bytes']}")
    return 0


async def _cmd_delquota(zk: ZKClient, args) -> int:
    """zkCli.sh ``delquota [-n|-b] path``: clear one limit dimension, or
    the whole quota when no flag is given."""
    limits_path = f"{QUOTA_ROOT}{args.path}/{LIMITS_LEAF}"
    if args.count or args.bytes:
        try:
            data, _ = await zk.get(limits_path)
        except ZKError as e:
            if e.code == Err.NO_NODE:
                print(f"quota for {args.path} does not exist", file=sys.stderr)
                return 1
            raise
        quota = parse_quota(data)
        if args.count:
            quota["count"] = -1
        if args.bytes:
            quota["bytes"] = -1
        await zk.put(limits_path, format_quota(quota["count"], quota["bytes"]))
        print(f"quota for {args.path}: "
              f"count={quota['count']},bytes={quota['bytes']}")
        return 0
    for leaf in (LIMITS_LEAF, STATS_LEAF):
        try:
            await zk.unlink(f"{QUOTA_ROOT}{args.path}/{leaf}")
        except ZKError as e:
            if e.code != Err.NO_NODE:
                raise
    try:
        await zk.unlink(f"{QUOTA_ROOT}{args.path}")
    except ZKError as e:
        if e.code not in (Err.NO_NODE, Err.NOT_EMPTY):
            raise
    print(f"quota for {args.path} deleted")
    return 0


async def _cmd_admin(args) -> int:
    """Send a 4-letter-word admin command to every server, raw TCP.

    These are connection-less health probes (no ZK session), answered by
    real ZooKeeper and by the in-process test server alike — `ruok` is the
    standard "is this ensemble member alive" check in operator runbooks.
    """
    failures = 0
    for host, port in args.servers:
        if len(args.servers) > 1:
            print(f";; {host}:{port}")
        writer = None
        text = None
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port), timeout=5
            )
            writer.write(args.word.encode("ascii"))
            await writer.drain()
            # The server closes the connection after answering; read to EOF
            # (a single read() can return one TCP segment of a longer
            # mntr/dump response).
            out = await asyncio.wait_for(reader.read(), timeout=5)
            text = out.decode(errors="replace").rstrip("\n")
        except (OSError, asyncio.TimeoutError) as e:
            # Includes server-socket EPIPE/reset: a failed probe, counted.
            print(f"zkcli: {host}:{port}: {e!r}", file=sys.stderr)
            failures += 1
        finally:
            if writer is not None:
                writer.close()
                try:
                    await writer.wait_closed()
                except (OSError, asyncio.TimeoutError):
                    pass
        if text is not None:
            # Outside the network try: a BrokenPipeError here is *stdout*
            # going away (piped into head/grep that exited), which main()
            # treats as a clean exit — not a probe failure.
            print(text)
    return 1 if failures else 0


async def _cmd_sync(zk: ZKClient, args) -> int:
    """Read barrier: flush the server's commit pipeline for a path."""
    print(await zk.sync(args.path))
    return 0


async def _cmd_getacl(zk: ZKClient, args) -> int:
    """Print a node's ACL list in zkCli.sh's getAcl format."""
    acls, stat = await zk.get_acl(args.path)
    for acl in acls:
        print(f"'{acl.scheme},'{acl.id}")
        print(f": {_fmt_perms(acl.perms)}")
    print(f"aversion = {stat.aversion}")
    return 0


async def _cmd_setacl(zk: ZKClient, args) -> int:
    stat = await zk.set_acl(args.path, args.acl, version=args.version)
    print(f"aversion = {stat.aversion}")
    return 0


async def _config_session(args, what: str):
    """Load ``-f CONFIG`` and open one bounded, non-reconnecting session
    per its own ``zookeeper`` block — the shared scaffolding of every
    config-driven command (``verify``, ``drain``), so the connect/timeout
    envelope can never drift between them.

    Returns ``(cfg, zk)`` with the session connected, or ``None`` after
    printing the error (the caller exits 2: the command could not run).
    The per-operation deadline honors the config's own
    ``zookeeper.requestTimeout``, else derives one from ``--timeout`` —
    a server that accepts the handshake and then stalls replies must
    make the command exit 2, never hang a cron job forever.
    """
    from registrar_tpu_torch.config import ConfigError, load_config

    try:
        cfg = load_config(args.file)
    except ConfigError as e:
        print(f"zkcli: {what}: {e}", file=sys.stderr)
        return None
    zk = ZKClient(
        cfg.zookeeper.servers,
        timeout_ms=cfg.zookeeper.timeout_ms,
        connect_timeout_ms=cfg.zookeeper.connect_timeout_ms,
        chroot=cfg.zookeeper.chroot,
        reconnect=False,
        request_timeout_ms=(
            cfg.zookeeper.request_timeout_ms
            if cfg.zookeeper.request_timeout_ms is not None
            else max(int(args.timeout * 1000), 1)
        ),
        # Honor the config's read-only opt-in: an audit
        # (`verify`) must still answer during quorum loss — reads work
        # on a read-only member; a drain's deletes fail truthfully.
        can_be_read_only=cfg.zookeeper.can_be_read_only,
    )
    try:
        await asyncio.wait_for(zk.connect(), timeout=args.timeout)
    except Exception as e:  # noqa: BLE001 - probe failure, not a bug
        await zk.close()
        print(
            f"zkcli: {what}: cannot connect to "
            f"{cfg.zookeeper.servers}: {e!r}", file=sys.stderr,
        )
        return None
    return cfg, zk


async def _cmd_verify(args) -> int:
    """Read-only drift audit: diff live ZooKeeper state against a
    registrar config's desired records (the reconciler's sweep,
    :func:`registrar_tpu_torch.reconcile.audit`).

    Exit status is the cron/runbook contract: 0 in-sync, 1 drift
    detected, 2 unreachable (ensemble down, or the config itself
    unreadable/invalid — either way the audit could not run).  Connects
    with the config's own ``zookeeper`` block (servers, chroot), not the
    ``-s`` flag, so the audit sees exactly what the daemon would.
    """
    from registrar_tpu_torch import reconcile

    session = await _config_session(args, "verify")
    if session is None:
        return 2
    cfg, zk = session
    try:
        try:
            drifts = await reconcile.audit(
                zk, cfg.registration,
                admin_ip=cfg.admin_ip, hostname=args.hostname,
            )
        except (ZKError, ConnectionError, OSError, ValueError) as e:
            print(f"zkcli: verify: audit failed: {e}", file=sys.stderr)
            return 2
    finally:
        await zk.close()
    if not drifts:
        print(f"in sync: {args.file} matches the live ensemble")
        return 0
    for d in drifts:
        detail = f"  ({d.detail})" if d.detail else ""
        print(f"drift: {d.reason}  {d.path}{detail}")
    rollup = ", ".join(
        f"{reason}={count}"
        for reason, count in sorted(reconcile.summarize(drifts).items())
    )
    print(f"{len(drifts)} drift(s): {rollup}", file=sys.stderr)
    return 1


async def _cmd_state(args) -> int:
    """Inspect a registrar handoff state file (``restart.stateFile``).

    Prints every persisted field plus a resumability verdict: would a
    successor starting NOW (optionally with ``--config``'s fingerprint)
    attempt the session resume, or fall back to a fresh registration —
    and why.  Exit 0 = resumable, 1 = not resumable, 2 = unreadable.
    Local file inspection only; no ZooKeeper connection is made (the
    server's reattach verdict is the final authority either way).
    """
    import time as time_mod

    from registrar_tpu_torch import statefile

    try:
        state = statefile.load(args.file)
    except statefile.StateFileError as e:
        print(f"zkcli: state: {e} (reason: {e.reason})", file=sys.stderr)
        return 2
    age = time_mod.time() - state.stamp
    print(f"format = {statefile.FORMAT}")
    print(f"sessionId = 0x{state.session_id:x}")
    print(f"negotiatedTimeoutMs = {state.negotiated_timeout_ms}")
    print(f"lastZxid = 0x{state.last_zxid:x}")
    print(f"chroot = {state.chroot or '(none)'}")
    print(f"configHash = {state.config_hash}")
    print(f"pid = {state.pid}")
    print(f"stampAgeSeconds = {age:.1f}")
    print(f"znodes = {' '.join(state.znodes) or '(none)'}")
    config_hash = state.config_hash
    if args.config:
        from registrar_tpu_torch.config import ConfigError, load_config

        try:
            cfg = load_config(args.config)
        except ConfigError as e:
            print(f"zkcli: state: {e}", file=sys.stderr)
            return 2
        config_hash = statefile.config_fingerprint(
            cfg.registration, cfg.admin_ip, cfg.zookeeper.chroot
        )
    reason = statefile.check_resumable(state, config_hash)
    if reason is None:
        print("resumable = yes (a successor would attempt the reattach)")
        return 0
    print(f"resumable = no ({reason})")
    return 1


async def _cmd_drain(args) -> int:
    """Deregister a host's records from OUTSIDE the daemon.

    The external analog of the daemon's ``restart.mode: "drain"``
    shutdown — for pulling a crashed, wedged, or SIGKILLed instance out
    of DNS without waiting for its session timeout.  Connects per the
    config's own ``zookeeper`` block (like ``verify``) and deletes the
    config's desired znodes; a shared service node still holding sibling
    hosts' ephemerals is left in place, exactly as the daemon's own
    deregistration would.  Exit 0 = drained (deleted nodes printed),
    2 = unreachable or config invalid.
    """
    from registrar_tpu_torch import reconcile

    session = await _config_session(args, "drain")
    if session is None:
        return 2
    cfg, zk = session
    try:
        paths = [
            d.path
            for d in reconcile.desired_records(
                cfg.registration, cfg.admin_ip, args.hostname
            )
        ]
        from registrar_tpu_torch.registration import unlink_tolerant

        outcomes = []
        try:
            for p in paths:
                # Already absent, or a shared service node with sibling
                # hosts still under it: both are fine for an external
                # drain — the goal is THIS host out of DNS.
                outcomes.append((p, await unlink_tolerant(zk, p)))
        except (ZKError, ConnectionError, OSError) as e:
            print(f"zkcli: drain: {e}", file=sys.stderr)
            return 2
    finally:
        await zk.close()
    for node, outcome in outcomes:
        if outcome == "deleted":
            print(f"deleted {node}")
        else:
            why = "already absent" if outcome == "absent" else "shared (kept)"
            print(f"skipped {node} ({why})")
    return 0


async def _metrics_get_json(host: str, port: int, path: str, timeout: float):
    """GET a JSON payload off the daemon's metrics listener (stdlib
    asyncio only, matching the listener's HTTP/1.0 one-shot shape).
    Returns the decoded object; raises OSError/ValueError on failure."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout=timeout
    )
    try:
        writer.write(
            f"GET {path} HTTP/1.0\r\nHost: {host}\r\n\r\n".encode()
        )
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), timeout=timeout)
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    parts = head.split()
    if len(parts) < 2 or parts[1] != b"200":
        raise OSError(
            f"GET {path}: HTTP "
            f"{head.splitlines()[0].decode('latin-1', 'replace') if head else 'no response'}"
        )
    return json.loads(body)


def _metrics_endpoint(args, what: str):
    """Resolve ``-f CONFIG``'s metrics listener address, or None (after
    printing why) when the config is unreadable or has no ``metrics``
    block — the shared scaffolding of ``status`` and ``trace``."""
    from registrar_tpu_torch.config import ConfigError, load_config

    try:
        cfg = load_config(args.file)
    except ConfigError as e:
        print(f"zkcli: {what}: {e}", file=sys.stderr)
        return None
    if cfg.metrics is None:
        print(
            f"zkcli: {what}: {args.file} has no `metrics` block — the "
            "daemon serves /status and /debug/trace on the metrics "
            "listener", file=sys.stderr,
        )
        return None
    return cfg.metrics.host, cfg.metrics.port


async def _member_role(server: str, timeout: float) -> Optional[str]:
    """The connected ensemble member's replication role, read off its
    ``srvr`` admin word: leader / follower / read-only /
    standalone.  None when the probe fails — role reporting must never
    break ``status`` against a member that dropped since the snapshot.
    """
    from registrar_tpu_torch.zk.client import four_letter_word

    host, _, port_s = server.rpartition(":")
    try:
        raw = await four_letter_word(host, int(port_s), b"srvr", timeout)
    except (OSError, ValueError, asyncio.TimeoutError):
        return None
    for line in raw.decode("latin-1", "replace").splitlines():
        if line.startswith("Mode: "):
            return line[len("Mode: "):].strip()
    return None


async def _cmd_status(args) -> int:
    """One-shot daemon introspection: ``GET /status`` off the metrics
    listener, pretty-printed (the runbook's first stop).

    Exit status follows the ``verify`` contract: 0 = healthy (session
    connected, registered, not health-down), 1 = degraded (any of those
    false, read-only attach, or reconciler drift standing), 2 =
    unreachable (no metrics block, daemon not answering, or the config
    unreadable).
    """
    endpoint = _metrics_endpoint(args, "status")
    if endpoint is None:
        return 2
    host, port = endpoint
    try:
        snapshot = await _metrics_get_json(
            host, port, "/status", args.timeout
        )
    except (OSError, ValueError, asyncio.TimeoutError) as e:
        print(f"zkcli: status: {host}:{port}: {e}", file=sys.stderr)
        return 2
    print(json.dumps(snapshot, indent=2, default=str))
    # uptime + last-transition stamps: the MTTR
    # arithmetic at a glance — how long the daemon has been up and how
    # long ago each slow-moving state last changed.
    uptime = snapshot.get("uptime_s")
    transitions = snapshot.get("last_transition") or {}
    if uptime is not None or transitions:
        import time as time_mod

        bits = []
        if uptime is not None:
            bits.append(f"up {uptime}s")
        for kind in ("session", "registration", "health", "serve"):
            entry = transitions.get(kind)
            if entry and entry.get("at") is not None:
                age = max(0.0, round(time_mod.time() - entry["at"], 1))
                bits.append(f"{kind} -> {entry.get('state')} {age}s ago")
        print(f"zkcli: status: {'; '.join(bits)}", file=sys.stderr)
    if "shards" in snapshot:
        # The sharded serve tier's router: the snapshot is a
        # per-shard rollup, not a single daemon's session — degraded is
        # any shard down (its slice is failing until the respawn lands).
        shards = snapshot.get("shards") or {}
        for sid, info in sorted(shards.items(), key=lambda kv: int(kv[0])):
            sess = info.get("session") or {}
            state = "up" if info.get("up") else "DOWN"
            ro = " ro" if sess.get("readOnly") else ""
            print(
                f"zkcli: status: shard {sid} {state} "
                f"session={sess.get('id')}@{sess.get('server')}{ro} "
                f"entries={info.get('entries')} "
                f"resolves={info.get('resolves_total')} "
                f"lagMs={info.get('coherence_lag_ms_last')} "
                f"respawns={info.get('respawns')}",
                file=sys.stderr,
            )
            # Overload armor at a glance: the live dispatch
            # backlog plus deliberate rejects by reason — the runbook's
            # shed-reason taxonomy, one line per shard.
            sheds = {
                reason: count
                for reason, count in (info.get("sheds") or {}).items()
                if count
            }
            shed_bits = (
                " ".join(f"{r}={n}" for r, n in sorted(sheds.items()))
                if sheds
                else "none"
            )
            print(
                f"zkcli: status: shard {sid} "
                f"queueDepth={info.get('queue_depth', 0)} "
                f"sheds: {shed_bits}",
                file=sys.stderr,
            )
            # DNS frontend at a glance: query volume, the
            # encode cache's hit ratio (the line-rate path's health),
            # and DNS-side sheds — one line per shard.
            dns = info.get("dns")
            if dns:
                queries = dns.get("queries") or {}
                cache = dns.get("encode_cache") or {}
                hits = cache.get("hits", 0)
                lookups = hits + cache.get("misses", 0)
                ratio = f"{hits / lookups:.2f}" if lookups else "-"
                dns_sheds = sum((dns.get("sheds") or {}).values())
                print(
                    f"zkcli: status: shard {sid} "
                    f"dns port={dns.get('port')} "
                    f"queries={sum(queries.values())} "
                    f"encodeCacheHit={ratio} "
                    f"entries={cache.get('entries', 0)} "
                    f"sheds={dns_sheds}",
                    file=sys.stderr,
                )
        problems = []
        for sid in snapshot.get("shards_down") or []:
            problems.append(f"shard {sid} down")
        for sid, info in sorted(shards.items(), key=lambda kv: int(kv[0])):
            if info.get("up") and not info.get("authoritative"):
                problems.append(f"shard {sid} degraded (live reads)")
        if problems:
            print(f"zkcli: status: DEGRADED: {'; '.join(problems)}",
                  file=sys.stderr)
            return 1
        print("zkcli: status: healthy", file=sys.stderr)
        return 0
    session = snapshot.get("session") or {}
    registration = snapshot.get("registration") or {}
    health = snapshot.get("health") or {}
    reconcile_info = snapshot.get("reconcile") or {}
    # The connected ensemble member's real role, probed off its srvr
    # admin word: election outcomes at a glance.
    if session.get("server"):
        role = await _member_role(session["server"], args.timeout)
        ro = " (read-only session)" if session.get("readOnly") else ""
        print(
            f"zkcli: status: zk member {session['server']} "
            f"role={role or 'unknown'}{ro}",
            file=sys.stderr,
        )
    # Connect-race outcome: which member won the last raced
    # connect, how many candidates were in flight, and how long the last
    # failover took — the raced-connect levers at a glance.
    race = session.get("connectRace") or {}
    if race.get("wins"):
        failover = session.get("lastFailoverS")
        failover_bit = (
            f" lastFailover={failover}s" if failover is not None else ""
        )
        print(
            f"zkcli: status: connect race won by {race.get('lastWinner')} "
            f"(candidates={race.get('lastCandidates')} "
            f"aborted={race.get('lastAborted')} "
            f"wins={race.get('wins')}){failover_bit}",
            file=sys.stderr,
        )
    problems = []
    if not session.get("connected"):
        problems.append(f"session {session.get('state', 'unknown')}")
    elif session.get("readOnly"):
        # Attached, but to a read-only minority member: resolves answer,
        # writes refuse — the OPERATIONS.md read-only-mode alert.
        problems.append("read-only member (writes refused)")
    if not registration.get("registered"):
        problems.append("not registered")
    if health.get("down"):
        problems.append("health-down")
    last_sweep = reconcile_info.get("lastSweep") or {}
    if last_sweep.get("drift"):
        problems.append(f"drift={last_sweep['drift']} at last sweep")
    if problems:
        print(f"zkcli: status: DEGRADED: {'; '.join(problems)}",
              file=sys.stderr)
        return 1
    print("zkcli: status: healthy", file=sys.stderr)
    return 0


def _span_line(entry) -> str:
    """One flight-recorder entry as one grep-friendly line."""
    import datetime

    stamp = datetime.datetime.fromtimestamp(
        entry.get("time", 0), tz=datetime.timezone.utc
    ).strftime("%H:%M:%S.%f")[:-3]
    attrs = " ".join(
        f"{k}={v}" for k, v in sorted((entry.get("attrs") or {}).items())
    )
    if entry.get("kind") == "event":
        return f"{stamp}  event  {entry.get('name')}  {attrs}".rstrip()
    dur = entry.get("duration_ms")
    marks = entry.get("marks") or {}
    split = ""
    if "flushed" in marks and dur is not None:
        queue = marks["flushed"]
        split = f" queue={queue}ms wire={round(dur - queue, 3)}ms"
    ids = f"{entry.get('trace_id')}/{entry.get('span_id')}"
    status = entry.get("status", "?")
    return (
        f"{stamp}  {dur if dur is not None else '?':>9}ms  "
        f"{entry.get('name')}  [{status}]  {ids}  {attrs}{split}"
    ).rstrip()


async def _cmd_trace(args) -> int:
    """Dump the daemon's flight recorder: ``GET /debug/trace?n=`` off
    the metrics listener, one line per span/event — or, with
    ``--id TRACE_ID``, fetch ONE assembled trace tree (across
    every shard worker when the listener fronts the sharded tier) and
    pretty-print it as an indented duration tree.

    Exit 0 = entries printed, 1 = tracing disabled (no `observability`
    block) or the recorder is empty, 2 = unreachable.  ``--json`` prints
    the raw payload instead of the line rendering.
    """
    endpoint = _metrics_endpoint(args, "trace")
    if endpoint is None:
        return 2
    host, port = endpoint
    if args.id:
        from registrar_tpu_torch import traceview

        try:
            tree = await _metrics_get_json(
                host, port, f"/debug/trace?id={args.id}", args.timeout
            )
        except (OSError, ValueError, asyncio.TimeoutError) as e:
            print(f"zkcli: trace: {host}:{port}: {e}", file=sys.stderr)
            return 2
        if tree.get("error"):
            print(f"zkcli: trace: {tree['error']}", file=sys.stderr)
            return 2
        if "roots" not in tree:
            # Not an assembled tree (a daemon with custom wiring handed
            # something else back): a clean exit, never a KeyError.
            print(
                "zkcli: trace: the listener did not answer an assembled "
                "tree for --id (unexpected payload shape)",
                file=sys.stderr,
            )
            return 2
        if args.json:
            print(json.dumps(tree, indent=2, default=str))
            return 0 if tree.get("spans") else 1
        print(traceview.render_text(tree))
        for source in tree.get("sources") or ():
            if source.get("error"):
                print(
                    f"zkcli: trace: {source['proc']}: {source['error']} "
                    "(its spans, if any, are orphaned above)",
                    file=sys.stderr,
                )
        if not tree.get("spans"):
            print(
                f"zkcli: trace: no spans recorded for {args.id} (wrong "
                "id, evicted from the ring, or tracing disabled)",
                file=sys.stderr,
            )
            return 1
        return 0
    try:
        payload = await _metrics_get_json(
            host, port, f"/debug/trace?n={args.n}", args.timeout
        )
    except (OSError, ValueError, asyncio.TimeoutError) as e:
        print(f"zkcli: trace: {host}:{port}: {e}", file=sys.stderr)
        return 2
    if not payload.get("enabled"):
        print(
            "zkcli: trace: tracing is disabled (no `observability` "
            "config block on the daemon)", file=sys.stderr,
        )
        return 1
    if args.json:
        print(json.dumps(payload, indent=2, default=str))
        return 0 if payload.get("entries") else 1
    entries = payload.get("entries") or []
    for entry in entries:
        print(_span_line(entry))
    print(
        f"zkcli: trace: {len(entries)} entries "
        f"({payload.get('spans_recorded', 0)} spans, "
        f"{payload.get('events_recorded', 0)} events recorded; "
        f"sampleRate={payload.get('sample_rate')})", file=sys.stderr,
    )
    return 0 if entries else 1


def _resolution_lines(res) -> List[str]:
    """Render a Resolution the way `resolve` prints it (shared with the
    serve-view loop so the two command outputs can never drift)."""
    lines = [str(ans) for ans in res.answers]
    if res.additionals:
        lines.append(";; ADDITIONAL:")
        lines.extend(str(ans) for ans in res.additionals)
    return lines


async def _cmd_resolve(zk: ZKClient, args) -> int:
    src = zk
    cache = None
    try:
        if getattr(args, "cached", False):
            # The watch-coherent memory path: first resolve
            # fills the cache (live reads + one-shot watches), the
            # printed answer is then served entirely from memory — the
            # same plumbing the long-running `serve-view` loop keeps
            # hot.
            from registrar_tpu_torch.zkcache import ZKCache

            cache = ZKCache(zk)
            await binderview.resolve(cache, args.name, args.qtype)
            src = cache
        res = await binderview.resolve(src, args.name, args.qtype)
    finally:
        # close() even when the warm-up resolve raised: at the REPL the
        # session (and the cache's listeners on it) outlives the failed
        # command, and a leaked listener set per retry accumulates.
        if cache is not None:
            cache.close()
    if res.empty:
        print(f"no answers for {args.name} ({args.qtype})", file=sys.stderr)
        return 1
    for line in _resolution_lines(res):
        print(line)
    return 0


def _infer_qtype(name: str) -> str:
    labels = name.split(".")
    if (
        len(labels) >= 3
        and labels[0].startswith("_")
        and labels[1].startswith("_")
    ):
        return "SRV"
    return "A"


async def _dig_endpoint(args) -> Optional[Tuple[str, int]]:
    """Resolve where `dig` should send packets: --server wins, else the
    config's serve.dns block; a configured port of 0 (allocate at tier
    start) is read off the running tier's ``GET /status`` serve block,
    which carries the concrete SO_REUSEPORT port."""
    if args.server:
        host, _, port_s = args.server.rpartition(":")
        try:
            port = int(port_s)
        except ValueError:
            port = 0
        if not host or not (0 < port < 65536):
            print(f"zkcli: dig: bad --server {args.server!r} "
                  "(want HOST:PORT)", file=sys.stderr)
            return None
        return host, port
    if not args.file:
        print("zkcli: dig: need --server HOST:PORT or -f CONFIG",
              file=sys.stderr)
        return None
    from registrar_tpu_torch.config import ConfigError, load_config

    try:
        cfg = load_config(args.file)
    except ConfigError as e:
        print(f"zkcli: dig: {e}", file=sys.stderr)
        return None
    dns_cfg = cfg.serve.dns if cfg.serve is not None else None
    if dns_cfg is None:
        print(f"zkcli: dig: {args.file} has no serve.dns block",
              file=sys.stderr)
        return None
    if dns_cfg.port:
        return dns_cfg.host, dns_cfg.port
    if cfg.metrics is None:
        print(
            "zkcli: dig: serve.dns.port is 0 (allocated at tier start) "
            "and the config has no metrics block to ask the running "
            "tier — pin a port or pass --server", file=sys.stderr,
        )
        return None
    try:
        snapshot = await _metrics_get_json(
            cfg.metrics.host, cfg.metrics.port, "/status", args.timeout
        )
    except (OSError, ValueError, asyncio.TimeoutError) as e:
        print(
            f"zkcli: dig: {cfg.metrics.host}:{cfg.metrics.port}: {e} "
            "(serve.dns.port is 0; the running tier's /status has the "
            "allocated port)", file=sys.stderr,
        )
        return None
    port = ((snapshot.get("serve") or {}).get("dns") or {}).get("port")
    if not port:
        print("zkcli: dig: the running tier reports no DNS frontend",
              file=sys.stderr)
        return None
    return dns_cfg.host, int(port)


async def _cmd_dig(args) -> int:
    """Query the DNS frontend with real packets: the wire-
    level sibling of `resolve` — same answers, but through the tier's
    SO_REUSEPORT UDP socket (TCP on truncation), so it proves the whole
    serve path an actual resolver would traverse.

    Exit codes follow the probe contract: 0 = NOERROR with answers,
    1 = a well-formed negative or refusal (NXDOMAIN, NODATA, REFUSED,
    SERVFAIL), 2 = unreachable (nowhere to send, timeout, or a reply
    the codec rejects).
    """
    import random
    import time as time_mod

    from registrar_tpu_torch import dnsfront

    endpoint = await _dig_endpoint(args)
    if endpoint is None:
        return 2
    host, port = endpoint
    qtype = args.qtype or _infer_qtype(args.name)
    packet = dnsfront.build_query(
        random.randrange(1 << 16), args.name, dnsfront.TYPE_CODES[qtype],
        edns_size=dnsfront.DEFAULT_UDP_PAYLOAD_MAX,
    )
    proto = "TCP" if args.tcp else "UDP"
    t0 = time_mod.perf_counter()
    try:
        if args.tcp:
            raw = await dnsfront.query_tcp(
                host, port, packet, timeout=args.timeout)
        else:
            raw = await dnsfront.query_udp(
                host, port, packet, timeout=args.timeout)
            if dnsfront.decode_response(raw).tc:
                # The TC bit: the answer outgrew the UDP budget — retry
                # the same query over the tier's TCP listener, like any
                # real resolver would.
                print(";; truncated: retrying over TCP", file=sys.stderr)
                proto = "UDP->TCP"
                raw = await dnsfront.query_tcp(
                    host, port, packet, timeout=args.timeout)
    except (asyncio.TimeoutError, ConnectionError, OSError) as e:
        print(f"zkcli: dig: {host}:{port}: {e!r}", file=sys.stderr)
        return 2
    elapsed_ms = (time_mod.perf_counter() - t0) * 1000.0
    try:
        resp = dnsfront.decode_response(raw)
    except dnsfront.DnsError as e:
        print(f"zkcli: dig: malformed reply from {host}:{port}: {e}",
              file=sys.stderr)
        return 2
    status = dnsfront.RCODE_NAMES.get(resp.rcode, str(resp.rcode))
    flag_bits = " ".join(
        label for label, mask in (
            ("qr", dnsfront.FLAG_QR), ("aa", dnsfront.FLAG_AA),
            ("tc", dnsfront.FLAG_TC), ("rd", dnsfront.FLAG_RD),
            ("ra", dnsfront.FLAG_RA),
        ) if resp.flags & mask
    )
    print(f";; ->>HEADER<<- opcode: QUERY, status: {status}, "
          f"id: {resp.qid}")
    print(f";; flags: {flag_bits}; ANSWER: {len(resp.answers)}, "
          f"AUTHORITY: {len(resp.authorities)}, "
          f"ADDITIONAL: {len(resp.additionals)}")
    print(";; QUESTION SECTION:")
    qtname = dnsfront.QTYPE_NAMES.get(resp.qtype, str(resp.qtype))
    print(f";{resp.qname}.\t\tIN\t{qtname}")
    for title, section in (("ANSWER", resp.answers),
                           ("AUTHORITY", resp.authorities),
                           ("ADDITIONAL", resp.additionals)):
        if section:
            print(f";; {title} SECTION:")
            for name, tname, ttl, text in section:
                print(f"{name}.\t{ttl}\tIN\t{tname}\t{text}")
    print(f";; Query time: {elapsed_ms:.1f} msec")
    print(f";; SERVER: {host}#{port} ({proto})")
    return 0 if resp.rcode == dnsfront.RCODE_NOERROR and resp.answers \
        else 1


async def _cmd_serve_view(args) -> int:
    """Long-running Binder's-eye watch loop over the resolve cache.

    Warms a :class:`registrar_tpu_torch.zkcache.ZKCache` for the given names,
    prints each answer set, then re-resolves and re-prints whenever a
    watch invalidation lands — the cache stays hot and coherent exactly
    the way Binder's own zkplus cache does.  A periodic bunyan status
    line on stderr (the daemon's jlog shape) carries hit rate, entry
    count, and authority, so an operator can see a cold or degraded
    cache at a glance.  ``--duration`` bounds the run (0 = until ^C).

    Connects per ``-f CONFIG``'s own zookeeper/cache blocks when given
    (like ``verify``), else per ``-s``.
    """
    import logging

    from registrar_tpu_torch import jlog
    from registrar_tpu_torch.retry import RetryPolicy
    from registrar_tpu_torch.zkcache import DEFAULT_MAX_ENTRIES, ZKCache

    # getattr: at the interactive prompt only `servers` is copied onto
    # the parsed command; the chroot flag is a one-shot-invocation knob.
    servers = args.servers
    chroot = getattr(args, "chroot", None)
    request_timeout_ms = None
    max_entries = args.max_entries
    if args.file:
        from registrar_tpu_torch.config import ConfigError, load_config

        try:
            cfg = load_config(args.file)
        except ConfigError as e:
            print(f"zkcli: serve-view: {e}", file=sys.stderr)
            return 2
        servers = cfg.zookeeper.servers
        chroot = cfg.zookeeper.chroot
        request_timeout_ms = cfg.zookeeper.request_timeout_ms
        if max_entries is None and cfg.cache is not None:
            max_entries = cfg.cache.max_entries
    if max_entries is None:
        max_entries = DEFAULT_MAX_ENTRIES

    zk = ZKClient(
        servers,
        chroot=chroot,
        request_timeout_ms=request_timeout_ms,
        # Long-running: ride out blips like the daemon does; the cache
        # degrades to live reads while down and resumes cold after.
        reconnect_policy=RetryPolicy(
            max_attempts=float("inf"), initial_delay=0.5, max_delay=15
        ),
        # A pure reader: keep serving through a read-only minority
        # member during quorum loss.
        can_be_read_only=True,
    )
    try:
        await asyncio.wait_for(zk.connect(), timeout=10)
    except Exception as e:  # noqa: BLE001 - startup probe failure
        print(f"zkcli: cannot connect to {servers}: {e}", file=sys.stderr)
        return 1

    status_log = logging.getLogger("registrar_tpu_torch.zkcli.serve_view")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(jlog.BunyanFormatter("zkcli"))
    status_log.handlers[:] = [handler]
    status_log.propagate = False
    status_log.setLevel(logging.INFO)

    cache = ZKCache(zk, max_entries=max_entries)
    names = [(n.rstrip(".").lower(), _infer_qtype(n)) for n in args.names]
    shown = {}

    async def refresh(initial: bool = False) -> None:
        for name, qtype in names:
            res = await binderview.resolve(cache, name, qtype)
            lines = _resolution_lines(res)
            if shown.get(name) == lines and not initial:
                continue
            shown[name] = lines
            print(f";; {name} ({qtype}):")
            for line in lines or ["; no answers"]:
                print(line)
            sys.stdout.flush()

    def emit_status() -> None:
        status_log.info(
            "cache status",
            extra={
                "zdata": {
                    "hits": int(cache.stats["hits"]),
                    "misses": int(cache.stats["misses"]),
                    "hitRate": round(cache.hit_rate(), 4),
                    "invalidations": int(cache.stats["invalidations"]),
                    "entries": cache.entries,
                    "authoritative": cache.authoritative,
                    "degradedTotal": int(cache.stats["degraded_total"]),
                    "coherenceLagMsLast": round(
                        cache.stats["coherence_lag_ms_last"], 3
                    ),
                }
            },
        )

    dirty = asyncio.Event()
    cache.on("invalidated", lambda *_a: dirty.set())
    cache.on("restored", lambda *_a: dirty.set())

    loop = asyncio.get_running_loop()
    start = loop.time()
    next_status = start + args.status_interval
    try:
        await refresh(initial=True)
        emit_status()
        while True:
            now = loop.time()
            if args.duration and now - start >= args.duration:
                emit_status()
                return 0
            wait = next_status - now
            if args.duration:
                wait = min(wait, args.duration - (now - start))
            try:
                await asyncio.wait_for(dirty.wait(), timeout=max(wait, 0.01))
            except asyncio.TimeoutError:
                pass
            if dirty.is_set():
                dirty.clear()
                try:
                    await refresh()
                except (ZKError, ConnectionError, OSError) as e:
                    # Degraded (live-read) refresh against a down
                    # ensemble: keep the loop alive; the reconnect +
                    # restored event re-resolves when service returns.
                    print(f"zkcli: refresh failed: {e}", file=sys.stderr)
            if loop.time() >= next_status:
                emit_status()
                next_status += args.status_interval
    finally:
        cache.close()
        await zk.close()


async def _cmd_serve_sharded(args) -> int:
    """Run the namespace-sharded resolve tier standalone.

    Per the config's ``serve`` block: spawns ``serve.shards`` worker
    processes (each its own event loop + ZooKeeper session + watch-
    coherent cache, watch load spread per ``serve.attachSpread``),
    supervises them (crash → respawn, siblings keep serving), and
    answers the length-prefixed resolve protocol on
    ``serve.socketPath``.  SIGHUP re-reads the config and **reshards
    in place** — a shard-count change moves only ~K/N warm domains
    (consistent hashing) and every moving domain is pre-warmed by its
    new owner before the ring flips, so resolves never error and the
    tier never cold-starts.  With a ``metrics`` block, serves
    ``GET /metrics`` (``registrar_shard_*``) and the per-shard
    ``GET /status`` rollup on the configured listener.  ``--duration``
    bounds the run (0 = until SIGTERM/^C).
    """
    import signal as signal_mod

    from registrar_tpu_torch import metrics as metrics_mod
    from registrar_tpu_torch import trace as trace_mod
    from registrar_tpu_torch.config import ConfigError, load_config
    from registrar_tpu_torch.shard import ShardRouter

    try:
        cfg = load_config(args.file)
    except ConfigError as e:
        print(f"zkcli: serve-sharded: {e}", file=sys.stderr)
        return 2
    if cfg.serve is None:
        print(
            f"zkcli: serve-sharded: {args.file} has no `serve` block "
            "(serve: {shards, socketPath, attachSpread})",
            file=sys.stderr,
        )
        return 2
    # The `observability` block turns on CROSS-PROCESS tracing:
    # the router records shard.relay/shard.trace_collect spans,
    # every spawned worker gets its own recorder at the same sample
    # rate, and the wire protocol carries one trace id end to end.
    # Absent block: not a traced byte anywhere, exactly like the daemon.
    tracer = None
    obs = cfg.observability
    if obs is not None:
        tracer = trace_mod.Tracer(
            sample_rate=obs.sample_rate,
            slow_span_ms=obs.slow_span_ms,
            max_spans=obs.flight_recorder_spans,
        )
        trace_mod.set_tracer(tracer)
    router = ShardRouter(
        cfg.zookeeper.servers,
        cfg.serve.shards,
        cfg.serve.socket_path,
        attach_spread=cfg.serve.attach_spread,
        chroot=cfg.zookeeper.chroot,
        max_entries=cfg.cache.max_entries if cfg.cache is not None else None,
        timeout_ms=cfg.zookeeper.timeout_ms,
        connect_timeout_ms=cfg.zookeeper.connect_timeout_ms,
        request_timeout_ms=cfg.zookeeper.request_timeout_ms,
        worker_trace=(
            {
                "sampleRate": obs.sample_rate,
                "maxSpans": obs.flight_recorder_spans,
                "slowSpanMs": obs.slow_span_ms,
            }
            if obs is not None
            else None
        ),
        # Overload armor: admission bounds + shed policy
        # from config.serve.overload.  Absent block: None — not a knob
        # set anywhere, byte-identical to the unarmored tier.
        overload=(
            cfg.serve.overload.as_router_kwargs()
            if cfg.serve.overload is not None
            else None
        ),
        # DNS frontend: every worker binds an SO_REUSEPORT
        # UDP socket + TCP listener on config.serve.dns's host:port.
        # Absent block: None — no DNS socket anywhere.
        dns=(
            cfg.serve.dns.as_spec()
            if cfg.serve.dns is not None
            else None
        ),
    )
    try:
        await router.start()
    except Exception as e:  # noqa: BLE001 - startup failure, not a bug
        print(f"zkcli: serve-sharded: cannot start tier: {e!r}",
              file=sys.stderr)
        await router.stop()
        if tracer is not None:
            trace_mod.set_tracer(None)
        return 1

    metrics_server = None
    if cfg.metrics is not None:
        registry = metrics_mod.instrument_shards(router)
        metrics_server = metrics_mod.MetricsServer(
            registry, host=cfg.metrics.host, port=cfg.metrics.port,
            status_provider=router.status,
            trace_provider=(
                (lambda n: tracer.dump(n)) if tracer is not None else None
            ),
            # GET /debug/trace?id=<trace_id>: the OP_TRACE fan-out —
            # one assembled tree across router + every worker.
            trace_tree_provider=(
                router.collect_trace if tracer is not None else None
            ),
        )
        try:
            await metrics_server.start()
        except OSError as e:
            # Same stance as the daemon: a busy metrics port must not
            # block the tier from serving.
            print(f"zkcli: serve-sharded: metrics listener failed: {e}",
                  file=sys.stderr)
            metrics_server = None

    stop = asyncio.Event()
    reload_requested = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal_mod.SIGTERM, signal_mod.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    loop.add_signal_handler(signal_mod.SIGHUP, reload_requested.set)
    dns_note = (
        f" + dns {router.dns['host']}:{router.dns['port']}/udp+tcp"
        if router.dns
        else ""
    )
    print(
        f"zkcli: serve-sharded: {cfg.serve.shards} shards on "
        f"{cfg.serve.socket_path}{dns_note} (SIGHUP reshards)",
        file=sys.stderr,
    )
    deadline = (
        loop.time() + args.duration if args.duration else None
    )
    try:
        while not stop.is_set():
            timeout = 0.2
            if deadline is not None:
                timeout = min(timeout, max(deadline - loop.time(), 0))
            try:
                await asyncio.wait_for(stop.wait(), timeout=timeout)
            except asyncio.TimeoutError:
                pass
            if deadline is not None and loop.time() >= deadline:
                break
            if reload_requested.is_set():
                reload_requested.clear()
                try:
                    fresh = load_config(args.file)
                except ConfigError as e:
                    print(f"zkcli: serve-sharded: reload failed: {e}",
                          file=sys.stderr)
                    continue
                if fresh.serve is None:
                    print(
                        "zkcli: serve-sharded: reload dropped the "
                        "`serve` block; keeping the running shape",
                        file=sys.stderr,
                    )
                    continue
                if fresh.serve.shards != router.shards:
                    try:
                        outcome = await router.reshard(fresh.serve.shards)
                    except Exception as e:  # noqa: BLE001 - keep serving
                        # A failed reshard (a new worker missed its
                        # readiness window, the ensemble is slow) must
                        # NOT take down the healthy tier — the old ring
                        # is untouched and keeps serving; the operator
                        # retries the SIGHUP.
                        print(
                            "zkcli: serve-sharded: reshard to "
                            f"{fresh.serve.shards} failed ({e!r}); "
                            "keeping the running shape — fix and "
                            "SIGHUP again", file=sys.stderr,
                        )
                        continue
                    print(
                        "zkcli: serve-sharded: resharded to "
                        f"{outcome['shards']} shards "
                        f"({outcome['moved']} warm domains handed off "
                        f"in {outcome['duration_ms']:.0f} ms)",
                        file=sys.stderr,
                    )
                else:
                    print(
                        "zkcli: serve-sharded: reload: shard count "
                        "unchanged; nothing to do", file=sys.stderr,
                    )
    finally:
        for sig in (signal_mod.SIGTERM, signal_mod.SIGINT,
                    signal_mod.SIGHUP):
            loop.remove_signal_handler(sig)
        if metrics_server is not None:
            await metrics_server.stop()
        await router.stop()
        if tracer is not None:
            trace_mod.set_tracer(None)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="zkcli",
        description="inspect registrar service-discovery state in ZooKeeper"
        " (no command: enter the interactive prompt over one session)",
    )
    parser.add_argument(
        "-s", "--servers", type=_parse_servers,
        default=[("127.0.0.1", 2181)], metavar="HOST:PORT[,...]",
        help="ZooKeeper servers (default 127.0.0.1:2181)",
    )
    parser.add_argument(
        "--auth", type=_parse_auth, action="append", default=[],
        metavar="SCHEME:CRED",
        help="authenticate after connecting (repeatable), e.g. "
        "digest:user:password — the zkCli.sh `addauth` equivalent",
    )
    parser.add_argument(
        "--chroot", metavar="/PATH", default=None,
        help="prefix every path with this znode (the connect-string "
        "\"host:port/app\" suffix of standard ZooKeeper clients)",
    )
    sub = parser.add_subparsers(dest="command")
    _register_commands(sub)
    return parser


def _register_commands(sub) -> None:
    """Attach every zkcli command to a subparsers object — shared between
    the one-shot argv parser and the interactive prompt's line parser."""
    p = sub.add_parser("ls", help="list children of a znode")
    p.add_argument("path")
    p.set_defaults(fn=_cmd_ls)

    p = sub.add_parser("get", help="print a znode's JSON payload")
    p.add_argument("path")
    p.add_argument("--pretty", action="store_true", help="indent the JSON")
    p.set_defaults(fn=_cmd_get)

    p = sub.add_parser("stat", help="print a znode's stat")
    p.add_argument("path")
    p.set_defaults(fn=_cmd_stat)

    p = sub.add_parser("tree", help="print a subtree with payloads")
    p.add_argument("path", nargs="?", default="/")
    p.set_defaults(fn=_cmd_tree)

    # aliases = zkCli.sh's names, so operator muscle memory carries over
    p = sub.add_parser("rm", aliases=["delete"], help="delete a znode")
    p.add_argument("path")
    p.add_argument(
        "--version", type=int, default=-1,
        help="expected data version (conditional delete; default: "
        "unconditional)",
    )
    p.set_defaults(fn=_cmd_rm)

    p = sub.add_parser(
        "rmr", aliases=["deleteall"],
        help="delete a znode subtree, children first",
    )
    p.add_argument("path")
    p.set_defaults(fn=_cmd_rmr)

    p = sub.add_parser("create", help="create a znode")
    p.add_argument("path")
    p.add_argument("data", nargs="?", default="")
    p.add_argument("-e", "--ephemeral", action="store_true")
    p.add_argument("-s", "--sequential", action="store_true")
    p.add_argument(
        "-a", "--acl", type=_parse_acl, action="append", default=[],
        metavar="SCHEME:ID:PERMS",
        help="ACL entries for the new node (repeatable; default "
        "world:anyone:cdrwa)",
    )
    p.set_defaults(fn=_cmd_create)

    p = sub.add_parser(
        "set",
        help="set a znode's data (creates if missing, unless --version "
        "makes it a conditional plain set)",
    )
    p.add_argument("path")
    p.add_argument("data")
    p.add_argument(
        "--version", type=int, default=-1,
        help="expected data version (conditional set, no create-if-missing; "
        "default: unconditional upsert)",
    )
    p.set_defaults(fn=_cmd_set)

    p = sub.add_parser("mkdirp", help="create a path and missing ancestors")
    p.add_argument("path")
    p.set_defaults(fn=_cmd_mkdirp)

    p = sub.add_parser("watch", help="stream change events for a znode")
    p.add_argument("path")
    p.add_argument(
        "--duration", type=float, default=0.0, metavar="SECONDS",
        help="stop after this many seconds (default: run until ctrl-C)",
    )
    p.set_defaults(fn=_cmd_watch)

    p = sub.add_parser(
        "admin",
        help="send a 4-letter-word admin command (ruok/srvr/stat/mntr/...)",
    )
    p.add_argument(
        "word",
        choices=["ruok", "srvr", "stat", "mntr", "cons", "dump", "wchs",
                 "isro", "wchc", "wchp", "envi", "conf"],
    )
    p.set_defaults(fn=_cmd_admin, raw=True)

    p = sub.add_parser(
        "sync",
        help="flush the server's commit pipeline for a path (read barrier "
        "before read-backs in multi-server ensembles)",
    )
    p.add_argument("path", nargs="?", default="/")
    p.set_defaults(fn=_cmd_sync)

    p = sub.add_parser(
        "getacl", aliases=["getAcl"], help="print a znode's ACL list"
    )
    p.add_argument("path")
    p.set_defaults(fn=_cmd_getacl)

    p = sub.add_parser(
        "setacl", aliases=["setAcl"],
        help="replace a znode's ACL list (requires ADMIN)",
    )
    p.add_argument("path")
    p.add_argument(
        "acl", type=_parse_acl, nargs="+", metavar="SCHEME:ID:PERMS",
        help="e.g. world:anyone:cdrwa, digest:user:HASH:rw, ip:10.0.0.1:r, "
        "auth::cdrwa (expands to your authenticated identities)",
    )
    p.add_argument(
        "--version", type=int, default=-1,
        help="expected aversion (default: unconditional)",
    )
    p.set_defaults(fn=_cmd_setacl)

    p = sub.add_parser(
        "verify",
        help="diff live ZooKeeper state against a registrar config's "
        "desired records, read-only (exit 0 in-sync / 1 drift / "
        "2 unreachable) — connects per the config's own zookeeper block",
    )
    p.add_argument(
        "-f", "--file", required=True, metavar="CONFIG",
        help="registrar config file (the daemon's -f argument)",
    )
    p.add_argument(
        "--hostname", default=None,
        help="audit this hostname's records (default: this machine's "
        "hostname, matching what the daemon would register)",
    )
    p.add_argument(
        "--timeout", type=float, default=10.0, metavar="SECONDS",
        help="connect budget before reporting unreachable (default 10)",
    )
    p.set_defaults(fn=_cmd_verify, raw=True)

    p = sub.add_parser(
        "state",
        help="inspect a registrar handoff state file (restart.stateFile): "
        "fields + resumability verdict (exit 0 resumable / 1 not / "
        "2 unreadable); local only, no ZooKeeper connection",
    )
    p.add_argument("file", metavar="STATEFILE")
    p.add_argument(
        "--config", default=None, metavar="CONFIG",
        help="also check the state's config fingerprint against this "
        "registrar config (a mismatched config makes a resume fall back "
        "to a fresh registration)",
    )
    p.set_defaults(fn=_cmd_state, raw=True)

    p = sub.add_parser(
        "drain",
        help="deregister a host's records from outside the daemon — pull "
        "a crashed/wedged instance out of DNS now instead of waiting out "
        "its session timeout (connects per the config's zookeeper block)",
    )
    p.add_argument(
        "-f", "--file", required=True, metavar="CONFIG",
        help="registrar config file (the daemon's -f argument)",
    )
    p.add_argument(
        "--hostname", default=None,
        help="drain this hostname's records (default: this machine's "
        "hostname)",
    )
    p.add_argument(
        "--timeout", type=float, default=10.0, metavar="SECONDS",
        help="connect budget before reporting unreachable (default 10)",
    )
    p.set_defaults(fn=_cmd_drain, raw=True)

    p = sub.add_parser(
        "status",
        help="one-shot daemon introspection: GET /status off the "
        "config's metrics listener, pretty-printed (exit 0 healthy / "
        "1 degraded / 2 unreachable) — the incident runbook's first stop",
    )
    p.add_argument(
        "-f", "--file", required=True, metavar="CONFIG",
        help="registrar config file (its `metrics` block names the "
        "listener)",
    )
    p.add_argument(
        "--timeout", type=float, default=5.0, metavar="SECONDS",
        help="HTTP budget before reporting unreachable (default 5)",
    )
    p.set_defaults(fn=_cmd_status, raw=True)

    p = sub.add_parser(
        "trace",
        help="dump the daemon's flight recorder: GET /debug/trace off "
        "the config's metrics listener, one line per span/event (exit "
        "0 entries / 1 tracing disabled or empty / 2 unreachable); "
        "--id TRACE_ID instead fetches ONE assembled trace tree — "
        "merged across every shard worker when the listener fronts "
        "the sharded tier",
    )
    p.add_argument(
        "-f", "--file", required=True, metavar="CONFIG",
        help="registrar config file (its `metrics` block names the "
        "listener)",
    )
    p.add_argument(
        "-n", type=int, default=200,
        help="most recent N entries to fetch (default 200)",
    )
    p.add_argument(
        "--id", default=None, metavar="TRACE_ID",
        help="assemble and pretty-print ONE trace as a parent tree "
        "(the 16-hex-digit id from a log line, slo-report.json, or a "
        "flight-recorder entry)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="print the raw JSON payload instead of one line per entry",
    )
    p.add_argument(
        "--timeout", type=float, default=5.0, metavar="SECONDS",
        help="HTTP budget before reporting unreachable (default 5)",
    )
    p.set_defaults(fn=_cmd_trace, raw=True)

    p = sub.add_parser(
        "resolve", help="answer a DNS query the way Binder would"
    )
    p.add_argument("name")
    p.add_argument("-t", "--qtype", default="A", type=str.upper,
                   choices=["A", "SRV", "TXT"])
    p.add_argument(
        "--cached", action="store_true",
        help="serve the answer from a watch-coherent in-memory cache "
        "(fills on first touch, then answers without ZooKeeper reads — "
        "the Binder hot path; see serve-view for the long-running loop)",
    )
    p.set_defaults(fn=_cmd_resolve)

    p = sub.add_parser(
        "dig",
        help="query the serve tier's DNS frontend with real UDP/TCP "
        "packets, dig-style output (exit 0 answers / 1 negative or "
        "refused / 2 unreachable) — the wire-level sibling of `resolve`",
    )
    p.add_argument("name")
    p.add_argument(
        "-t", "--qtype", default=None, type=str.upper,
        choices=["A", "SRV", "TXT"],
        help="query type (default: SRV for _svc._proto. names, else A)",
    )
    p.add_argument(
        "-f", "--file", default=None, metavar="CONFIG",
        help="find the frontend per this config's serve.dns block (a "
        "configured port of 0 is read off the running tier's /status)",
    )
    p.add_argument(
        "--server", default=None, metavar="HOST:PORT",
        help="query this address instead of the config's",
    )
    p.add_argument(
        "--tcp", action="store_true",
        help="query over TCP from the start (the codec retries over TCP "
        "on a truncated UDP answer automatically)",
    )
    p.add_argument(
        "--timeout", type=float, default=3.0, metavar="SECONDS",
        help="per-exchange budget before reporting unreachable "
        "(default 3)",
    )
    p.set_defaults(fn=_cmd_dig, raw=True)

    p = sub.add_parser(
        "serve-view",
        help="long-running Binder's-eye view: warm the watch-coherent "
        "resolve cache for NAMES, re-print answers as watches "
        "invalidate, emit periodic bunyan cache-status lines on stderr",
    )
    p.add_argument(
        "names", nargs="+", metavar="NAME",
        help="domains to serve (a _svc._proto. prefix implies SRV)",
    )
    p.add_argument(
        "--duration", type=float, default=0.0, metavar="SECONDS",
        help="stop after this many seconds (default: run until ctrl-C)",
    )
    p.add_argument(
        "--status-interval", type=float, default=30.0, metavar="SECONDS",
        help="seconds between cache-status log lines (default 30)",
    )
    p.add_argument(
        "--max-entries", type=int, default=None,
        help="cache entry bound (default: config cache.maxEntries, "
        "else 4096)",
    )
    p.add_argument(
        "-f", "--file", default=None, metavar="CONFIG",
        help="connect per this registrar config's zookeeper block "
        "(and honor its cache block) instead of -s",
    )
    p.set_defaults(fn=_cmd_serve_view, raw=True)

    p = sub.add_parser(
        "serve-sharded",
        help="run the namespace-sharded resolve tier per the config's "
        "`serve` block: N worker processes (own session + watch-coherent "
        "cache each) behind a consistent-hash router on a unix socket; "
        "SIGHUP reshards in place with a warm handoff",
    )
    p.add_argument(
        "-f", "--file", required=True, metavar="CONFIG",
        help="registrar config file with a `serve` block (its zookeeper/"
        "cache/metrics blocks are honored too)",
    )
    p.add_argument(
        "--duration", type=float, default=0.0, metavar="SECONDS",
        help="stop after this many seconds (default: run until SIGTERM)",
    )
    p.set_defaults(fn=_cmd_serve_sharded, raw=True)

    p = sub.add_parser(
        "setquota", help="set a soft quota on a subtree (zkCli.sh setquota)"
    )
    p.add_argument("path")
    p.add_argument("-n", "--count", type=int, default=None,
                   help="max znodes in the subtree")
    p.add_argument("-b", "--bytes", type=int, default=None,
                   help="max total data bytes in the subtree")
    p.set_defaults(fn=_cmd_setquota)

    p = sub.add_parser(
        "listquota", help="show a subtree's quota and live usage"
    )
    p.add_argument("path")
    p.set_defaults(fn=_cmd_listquota)

    p = sub.add_parser(
        "delquota", help="delete a subtree's quota (or one dimension of it)"
    )
    p.add_argument("path")
    p.add_argument("-n", "--count", action="store_true",
                   help="clear only the znode-count limit")
    p.add_argument("-b", "--bytes", action="store_true",
                   help="clear only the byte limit")
    p.set_defaults(fn=_cmd_delquota)


def _repl_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="",
        description="zkcli interactive commands (plus: addauth "
        "SCHEME:CRED, help, quit)",
    )
    sub = parser.add_subparsers(dest="command")
    _register_commands(sub)
    return parser


async def _repl(zk: ZKClient, args) -> int:
    """Interactive prompt: every command runs over the ONE connected
    session, like a ``zkCli.sh -server host:port`` session (the workflow
    the reference's debugging notes teach, reference README.md:785-807).
    One-shot invocations pay a fresh connect per command; here ephemeral
    nodes created with ``create -e`` live exactly as long as the prompt.
    """
    import signal

    interactive = sys.stdin.isatty()
    if interactive:
        try:
            # input() below is what readline hooks for editing/history
            import readline  # noqa: F401
        except ImportError:
            pass
        host, port = zk.connected_server or zk.servers[0]
        print(
            f"connected to {host}:{port} "
            f"(session 0x{zk.session_id:x}); "
            "'help' lists commands, 'quit' leaves"
        )

    def _read_line():
        if interactive:
            try:
                return input("zkcli> ")
            except EOFError:
                return None
        raw = sys.stdin.readline()
        return raw.rstrip("\n") if raw else None

    loop = asyncio.get_running_loop()

    def _install_sigint(handler) -> bool:
        try:
            loop.add_signal_handler(signal.SIGINT, handler)
            return True
        except (NotImplementedError, RuntimeError):
            return False

    def _sigint_at_prompt() -> None:
        # ctrl-C at the idle prompt must NOT tear down the session (the
        # ephemerals the operator is rehearsing with would vanish), and
        # letting KeyboardInterrupt escape would also leave the executor
        # thread blocked in input(), hanging interpreter shutdown until
        # a stray Enter.  Consume it and point at the real exits.
        print("^C (use 'quit' or ctrl-D to leave)", file=sys.stderr)

    sigint_managed = _install_sigint(_sigint_at_prompt)

    async def _run_cancellable(coro) -> None:
        # ctrl-C aborts the running command (e.g. an open-ended `watch`)
        # and returns to the prompt; the session — and any ephemerals the
        # operator is rehearsing with — survives.  Matches zkCli.sh.
        task = asyncio.ensure_future(coro)

        def _sigint_during_command() -> None:
            # A SIGINT can land in the gap after the command finishes but
            # before the prompt handler is reinstalled below; cancelling
            # a done task is a silent no-op, so treat that case as a
            # prompt-level interrupt instead of swallowing it.
            if task.done():
                _sigint_at_prompt()
            else:
                task.cancel()

        if sigint_managed:
            _install_sigint(_sigint_during_command)
        try:
            await task
        except asyncio.CancelledError:
            print("^C", file=sys.stderr)
        finally:
            if sigint_managed:
                _install_sigint(_sigint_at_prompt)

    parser = _repl_parser()
    try:
        return await _repl_loop(
            zk, args, parser, loop, _read_line, _run_cancellable
        )
    finally:
        if sigint_managed:
            loop.remove_signal_handler(signal.SIGINT)


async def _repl_loop(zk, args, parser, loop, _read_line, _run_cancellable) -> int:
    import shlex

    while True:
        line = await loop.run_in_executor(None, _read_line)
        if line is None:
            break  # EOF
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            words = shlex.split(line)
        except ValueError as e:
            print(f"zkcli: {e}", file=sys.stderr)
            continue
        if words[0] in ("quit", "exit"):
            break
        if words[0] == "help":
            parser.print_help()
            continue
        if words[0] == "addauth":
            # zkCli.sh's addauth: authenticate the LIVE session (the
            # one-shot mode's --auth flag, but mid-session).
            if len(words) != 2:
                print("usage: addauth SCHEME:CRED (e.g. digest:user:pw)",
                      file=sys.stderr)
                continue
            try:
                scheme, cred = _parse_auth(words[1])
                await zk.add_auth(scheme, cred)
            except (ZKError, argparse.ArgumentTypeError) as e:
                print(f"zkcli: {e}", file=sys.stderr)
            continue
        try:
            cmd = parser.parse_args(words)
        except SystemExit:
            continue  # argparse reported usage; the prompt survives
        if cmd.command is None:
            continue
        cmd.repl = True
        try:
            if getattr(cmd, "raw", False):
                # raw commands build their own connections: hand them the
                # session's servers AND chroot (serve-view resolving
                # un-chrooted paths while the sibling `resolve` answers
                # through the chroot would silently disagree)
                cmd.servers = args.servers
                cmd.chroot = getattr(args, "chroot", None)
                await _run_cancellable(cmd.fn(cmd))
            else:
                await _run_cancellable(cmd.fn(zk, cmd))
        except ZKError as e:
            print(f"zkcli: {e}", file=sys.stderr)
        except ValueError as e:
            print(f"zkcli: {e}", file=sys.stderr)
    return 0


async def _amain(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "raw", False):
        # Admin probes speak raw TCP per server; no ZK session involved.
        return await args.fn(args)
    try:
        # Argument validation (e.g. a malformed --chroot) must not be
        # reported as a connectivity problem.  One-shot commands never
        # reconnect (fail fast); the interactive prompt must ride out
        # transient blips mid-investigation, like zkCli.sh.
        zk = ZKClient(
            args.servers,
            reconnect=args.command is None,
            reconnect_policy=RetryPolicy(
                max_attempts=float("inf"), initial_delay=0.5, max_delay=15
            ),
            chroot=args.chroot,
            # Read-mostly operator tooling must keep answering during
            # quorum loss: attach to a read-only member when
            # nothing better serves; a write then fails truthfully with
            # NOT_READONLY instead of the whole session being refused.
            can_be_read_only=True,
        )
    except ValueError as e:
        print(f"zkcli: {e}", file=sys.stderr)
        return 2
    try:
        await asyncio.wait_for(zk.connect(), timeout=10)
    except Exception as e:  # noqa: BLE001
        print(f"zkcli: cannot connect to {args.servers}: {e}", file=sys.stderr)
        return 1
    try:
        for scheme, cred in args.auth:
            await zk.add_auth(scheme, cred)
        if args.command is None:
            return await _repl(zk, args)
        return await args.fn(zk, args)
    except ZKError as e:
        print(f"zkcli: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        # e.g. check_path rejecting a malformed znode path — a one-line
        # error, not a traceback.
        print(f"zkcli: {e}", file=sys.stderr)
        return 1
    finally:
        await zk.close()


def main(argv=None) -> None:
    try:
        code = asyncio.run(_amain(argv))
    except KeyboardInterrupt:
        code = 0  # the documented way to stop `watch`
    except BrokenPipeError:
        # Output piped into head/grep that exited early: not an error.
        # Redirect stdout to devnull so the interpreter's shutdown flush
        # doesn't raise again.
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        code = 0
    sys.exit(code)


if __name__ == "__main__":
    main()
