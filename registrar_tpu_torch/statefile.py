"""On-disk session handoff state.

The reference's only restart story is ``process.exit(1)`` + an SMF
restart — and every restart kills the ZooKeeper session, so the host's
ephemeral znodes vanish and Binder serves NXDOMAIN until the successor
re-registers: a self-inflicted DNS outage on every deploy.  ZooKeeper
itself never required that: a session is addressed by ``(session_id,
passwd)`` and survives any number of TCP connections, including
connections from *different processes*.  The client can
reattach a live session in-process; this module carries the same trick
across a process boundary.

A handoff-mode daemon (config ``restart: {stateFile, mode: "handoff"}``)
keeps this file current — written on session establish, reattach,
rebirth, and every registration refresh, then once more with a fresh
stamp at SIGTERM — and the successor process reads it, seeds its
:class:`~registrar_tpu_torch.zk.client.ZKClient` with the saved credentials,
reattaches the *same* session, and verifies (rather than re-creates) the
registration.  The ephemerals never flicker: a watching resolver sees
zero NO_NODE across the restart.

The file is the SESSION SECRET: anyone who reads it can adopt the
session and delete or replace the host's DNS records.  It is therefore
written ``0600`` via an fsynced atomic rename, must live on a path with
the same trust domain as the ZooKeeper ACL credentials (a root-owned
/var/run subdirectory, not /tmp), and a file owned by a different uid is
refused as foreign.

Every degraded shape falls back to today's fresh-session registration —
never to a crash:

  * unreadable / non-JSON / wrong-format ("foreign") file;
  * malformed fields, including a passwd that is not 16 bytes;
  * stale stamp: older than the negotiated session timeout, so the
    server has certainly expired the session already (the SIGKILL-crash
    shape — the predecessor could not refresh the stamp on its way out);
  * config-hash mismatch: the registration this state describes is not
    the registration this config would write;
  * a reattach the server refuses (``SESSION_EXPIRED``) — handled by the
    client's seeded-resume path, not here.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import itertools
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import List, Optional

log = logging.getLogger("registrar_tpu_torch.statefile")

#: format marker; anything else in the ``format`` field is a foreign file
FORMAT = "registrar-statefile-v1"

#: check_resumable() rejection reasons (stable strings: logged, tested,
#: and printed by ``zkcli state``)
R_STALE_STAMP = "staleStamp"
R_CONFIG_HASH = "configHash"

#: temp-file uniquifier (save() may run concurrently in worker threads)
_TMP_SEQ = itertools.count()


class StateFileError(Exception):
    """The state file cannot be used; ``reason`` is a stable slug."""

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


class StateFileMissing(StateFileError):
    """No state file at the path (a normal cold start, not an error)."""

    def __init__(self, path: str):
        super().__init__(f"no state file at {path}", "missing")


class StateFileUnreadable(StateFileError):
    """The file exists but could not be read (permissions, I/O)."""

    def __init__(self, path: str, err: Exception):
        super().__init__(f"cannot read state file {path}: {err}", "unreadable")


class StateFileInvalid(StateFileError):
    """Foreign or corrupt content; ``reason`` names the first defect."""


@dataclass
class SessionState:
    """One handoff-able ZooKeeper session, as persisted.

    ``stamp`` is WALL-CLOCK (time.time()): it must be comparable across
    two different processes, which monotonic clocks are not.
    """

    session_id: int
    passwd: bytes
    negotiated_timeout_ms: int
    last_zxid: int
    chroot: str
    config_hash: str
    znodes: List[str]
    pid: int
    stamp: float


def config_fingerprint(
    registration, admin_ip: Optional[str], chroot: Optional[str]
) -> str:
    """Hash of everything that shapes the desired znode records.

    Two configs with the same fingerprint write byte-identical records at
    identical paths, so a verified resume under one is valid under the
    other.  Keys that do NOT shape the records (timeouts, healthCheck,
    metrics, the server list — a moved ensemble refuses the reattach on
    its own) are deliberately excluded: changing them must not force a
    re-registration blip across a restart.
    """
    digest = hashlib.sha256(
        json.dumps(
            {
                "registration": registration,
                "adminIp": admin_ip,
                "chroot": chroot or "",
            },
            sort_keys=True,
            separators=(",", ":"),
        ).encode()
    )
    return digest.hexdigest()


def save(path: str, state: SessionState) -> None:
    """Atomically persist ``state`` at ``path``, 0600, fsynced.

    Atomic (write-temp + rename) so a crash mid-write can never leave a
    truncated file the successor would half-parse; fsynced (file AND
    directory) so the rename survives a machine crash — a state file that
    points at a session is only useful if it is durably the *latest*
    one.  Raises OSError on failure (the caller logs and carries on: a
    broken statefile degrades the next restart to a fresh registration,
    it must never take down the running daemon).
    """
    # Imported here, not at module top: statefile is also consumed by
    # zkcli (a cold-start CLI path where pulling the tracing layer in
    # for a file inspection would be pure import weight).
    from registrar_tpu_torch import trace

    with trace.get_tracer().span("statefile.save", path=path):
        _save_atomic(path, state)


def _save_atomic(path: str, state: SessionState) -> None:
    payload = json.dumps(
        {
            "format": FORMAT,
            "sessionId": f"0x{state.session_id:x}",
            "passwd": base64.b64encode(state.passwd).decode("ascii"),
            "negotiatedTimeoutMs": state.negotiated_timeout_ms,
            "lastZxid": state.last_zxid,
            "chroot": state.chroot,
            "configHash": state.config_hash,
            "znodes": list(state.znodes),
            "pid": state.pid,
            "stamp": state.stamp,
        },
        indent=2,
        sort_keys=True,
    ).encode()
    # pid + sequence: saves may run concurrently from worker threads of
    # one process (the daemon's background writes), and two writers
    # sharing a temp name would interleave into a corrupt file before
    # the rename.
    tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_SEQ)}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    try:
        try:
            os.write(fd, payload)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def _fsync_dir(dirname: str) -> None:
    try:
        dfd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return  # e.g. a platform/filesystem that refuses O_RDONLY on dirs
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def clear(path: str) -> None:
    """Invalidate the state file (terminal expiry, clean drain).

    A session that is *known dead or closed* must not be offered to a
    successor: the reattach would be refused anyway, but fencing the file
    keeps a half-informed operator (or ``zkcli state``) from trusting it.
    """
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def load(path: str) -> SessionState:
    """Read and structurally validate a state file.

    Raises :class:`StateFileMissing` / :class:`StateFileUnreadable` /
    :class:`StateFileInvalid`; liveness (stamp age) and config matching
    are :func:`check_resumable`'s job — load answers only "is this a
    well-formed statefile of ours".
    """
    try:
        st = os.stat(path)
    except FileNotFoundError:
        raise StateFileMissing(path) from None
    except OSError as e:
        raise StateFileUnreadable(path, e) from e
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        # Not ours: a file another user planted at our configured path
        # could seed us with an attacker-chosen session.
        raise StateFileInvalid(
            f"state file {path} is owned by uid {st.st_uid}, not ours "
            f"({os.getuid()})", "foreign",
        )
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        raise StateFileUnreadable(path, e) from e
    try:
        raw = json.loads(text)
    except ValueError:
        raise StateFileInvalid(
            f"state file {path} is not JSON", "foreign"
        ) from None
    if not isinstance(raw, dict) or raw.get("format") != FORMAT:
        raise StateFileInvalid(
            f"state file {path} is not a {FORMAT} file", "foreign"
        )

    def field(name, types):
        value = raw.get(name)
        if not isinstance(value, types) or isinstance(value, bool):
            raise StateFileInvalid(
                f"state file {path}: bad field {name!r}", "malformed"
            )
        return value

    sid_text = field("sessionId", str)
    try:
        session_id = int(sid_text, 16)
    except ValueError:
        raise StateFileInvalid(
            f"state file {path}: bad field 'sessionId'", "malformed"
        ) from None
    try:
        passwd = base64.b64decode(field("passwd", str), validate=True)
    except (binascii.Error, ValueError):
        raise StateFileInvalid(
            f"state file {path}: passwd is not base64", "passwd"
        ) from None
    if len(passwd) != 16:
        # The wire protocol's session passwd is exactly 16 bytes; any
        # other length is a truncated/tampered file, and offering it to
        # the server would just burn a refused reattach.
        raise StateFileInvalid(
            f"state file {path}: passwd is {len(passwd)} bytes, not 16",
            "passwd",
        )
    znodes = field("znodes", list)
    if not all(isinstance(n, str) for n in znodes):
        raise StateFileInvalid(
            f"state file {path}: bad field 'znodes'", "malformed"
        )
    return SessionState(
        session_id=session_id,
        passwd=passwd,
        negotiated_timeout_ms=field("negotiatedTimeoutMs", int),
        last_zxid=field("lastZxid", int),
        chroot=field("chroot", str),
        config_hash=field("configHash", str),
        znodes=list(znodes),
        pid=field("pid", int),
        stamp=float(field("stamp", (int, float))),
    )


def check_resumable(
    state: SessionState,
    config_hash: str,
    now: Optional[float] = None,
) -> Optional[str]:
    """Is this state worth offering to the server?  None = yes, else the
    rejection reason (:data:`R_STALE_STAMP` / :data:`R_CONFIG_HASH`).

    The stamp check is a cheap local pre-filter, not the authority (the
    server's reattach verdict is): a stamp older than the negotiated
    session timeout means the session has certainly expired — the
    predecessor stopped refreshing it at least a full timeout ago — so
    skipping the doomed reattach saves the successor a round trip and a
    confusing refusal log.  A *fresh* stamp proves nothing (the server
    may have expired the session early); the refused-reattach fallback
    covers that.
    """
    if state.config_hash != config_hash:
        return R_CONFIG_HASH
    age = (time.time() if now is None else now) - state.stamp
    if age > state.negotiated_timeout_ms / 1000.0:
        return R_STALE_STAMP
    if age < 0 and abs(age) > state.negotiated_timeout_ms / 1000.0:
        # A stamp far in the future is a broken clock or a tampered
        # file; treat like staleness rather than trusting it forever.
        return R_STALE_STAMP
    return None
