"""ZooKeeper 3.4 client protocol records, opcodes, and error codes.

The subset of the protocol registrar needs (reference lib/zk.js call surface:
connect, create-ephemeral, setData/put, delete, exists/stat, getData,
getChildren for tooling, ping, closeSession — see SURVEY.md §1 L1), encoded
with :mod:`registrar_tpu_torch.zk.jute`.

Framing: every message on the wire is a 4-byte big-endian length followed by
that many payload bytes.  The first client message of a connection is a
ConnectRequest (no header); afterwards each request is
RequestHeader + op-specific body, each response ReplyHeader + body.
Server-initiated watch notifications arrive with xid == -1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import struct

from registrar_tpu_torch.zk.jute import JuteError, Reader, Writer

# Fixed-layout records pack/unpack their whole field list in one struct
# call — the per-field jute walk was the hottest encode/decode path in
# the wire stack (a Stat rides every exists/getData/setData reply).
_REQ_HDR = struct.Struct(">ii")    # xid, type
_REPLY_HDR = struct.Struct(">iqi")  # xid, zxid, err
_STAT = struct.Struct(">qqqqiiiqiiq")
_LEN = struct.Struct(">i")
_PW_HDR = struct.Struct(">iiii")   # frame len, xid, type, path len


# --- opcodes ---------------------------------------------------------------

class OpCode:
    NOTIFICATION = 0
    CREATE = 1
    DELETE = 2
    EXISTS = 3
    GET_DATA = 4
    SET_DATA = 5
    GET_ACL = 6
    SET_ACL = 7
    GET_CHILDREN = 8
    SYNC = 9
    PING = 11
    GET_CHILDREN2 = 12
    CHECK = 13
    MULTI = 14
    AUTH = 100
    SET_WATCHES = 101
    SASL = 102
    CREATE_SESSION = -10
    CLOSE_SESSION = -11
    ERROR = -1


# Reserved xids (client/server agreed sentinels).
XID_NOTIFICATION = -1
XID_PING = -2
XID_AUTH = -4
XID_SET_WATCHES = -8


# --- error codes -----------------------------------------------------------

class Err:
    OK = 0
    SYSTEM_ERROR = -1
    RUNTIME_INCONSISTENCY = -2
    DATA_INCONSISTENCY = -3
    CONNECTION_LOSS = -4
    MARSHALLING_ERROR = -5
    UNIMPLEMENTED = -6
    OPERATION_TIMEOUT = -7
    BAD_ARGUMENTS = -8
    API_ERROR = -100
    NO_NODE = -101
    NO_AUTH = -102
    BAD_VERSION = -103
    NO_CHILDREN_FOR_EPHEMERALS = -108
    NODE_EXISTS = -110
    NOT_EMPTY = -111
    SESSION_EXPIRED = -112
    INVALID_CALLBACK = -113
    INVALID_ACL = -114
    AUTH_FAILED = -115
    SESSION_MOVED = -118
    #: a state-changing request reached a read-only (minority/quorum-loss)
    #: member — ZooKeeper 3.4's NotReadOnlyException.  Transient by
    #: classification (retry.is_transient): the write succeeds once the
    #: client fails over to a read-write member or quorum returns.
    NOT_READONLY = -119

#: error code -> symbolic name, mirroring the names upper layers match on
#: (the reference matches `err.name !== 'NO_NODE'`, lib/register.js:88).
ERR_NAMES = {
    value: name
    for name, value in vars(Err).items()
    if not name.startswith("_")
}


# --- node create flags / ACL ----------------------------------------------

class CreateFlag:
    PERSISTENT = 0
    EPHEMERAL = 1
    PERSISTENT_SEQUENTIAL = 2
    EPHEMERAL_SEQUENTIAL = 3


class Perms:
    READ = 1
    WRITE = 2
    CREATE = 4
    DELETE = 8
    ADMIN = 16
    ALL = 31


@dataclass(frozen=True)
class ACL:
    perms: int
    scheme: str
    id: str

    def write(self, w: Writer) -> None:
        w.write_int(self.perms)
        w.write_ustring(self.scheme)
        w.write_ustring(self.id)

    @classmethod
    def read(cls, r: Reader) -> "ACL":
        return cls(perms=r.read_int(), scheme=r.read_ustring(), id=r.read_ustring())


#: world:anyone with all permissions — what zkplus (and thus the reference)
#: uses for every node it creates.
OPEN_ACL_UNSAFE = [ACL(Perms.ALL, "world", "anyone")]


def _encode_acl_vector(acls) -> bytes:
    w = Writer()
    w.write_vector(acls, lambda ww, a: a.write(ww))
    return w.to_bytes()


#: The default ACL vector's wire bytes — constant, so the CREATE fast
#: path in encode_request can append it without re-encoding.  The gate
#: compares against a snapshot taken at the same moment the blob was
#: encoded: if anything ever mutated OPEN_ACL_UNSAFE in place, creates
#: would fall back to the general path and still encode correctly.
_OPEN_ACLS_SNAPSHOT = [ACL(a.perms, a.scheme, a.id) for a in OPEN_ACL_UNSAFE]
_OPEN_ACL_BLOB = _encode_acl_vector(_OPEN_ACLS_SNAPSHOT)

#: read-only for everyone (ZooKeeper's ZooDefs.Ids.READ_ACL_UNSAFE).
READ_ACL_UNSAFE = [ACL(Perms.READ, "world", "anyone")]


def digest_auth_id(user: str, password: str) -> str:
    """``user:base64(sha1(user:password))`` — the id stored in digest ACLs.

    Matches ZooKeeper's DigestAuthenticationProvider.generateDigest, so
    ACLs minted here are interchangeable with ones from zkCli.sh.
    """
    import base64
    import hashlib

    digest = hashlib.sha1(f"{user}:{password}".encode()).digest()
    return f"{user}:{base64.b64encode(digest).decode('ascii')}"


def creator_all_acl(user: str, password: str) -> List[ACL]:
    """ALL perms for one digest identity (ZooDefs.Ids.CREATOR_ALL_ACL shape)."""
    return [ACL(Perms.ALL, "digest", digest_auth_id(user, password))]


# --- watch events ----------------------------------------------------------

class EventType:
    NONE = -1
    NODE_CREATED = 1
    NODE_DELETED = 2
    NODE_DATA_CHANGED = 3
    NODE_CHILDREN_CHANGED = 4


class KeeperState:
    DISCONNECTED = 0
    SYNC_CONNECTED = 3
    AUTH_FAILED = 4
    CONNECTED_READ_ONLY = 5
    EXPIRED = -112


# --- records ---------------------------------------------------------------

@dataclass
class ConnectRequest:
    protocol_version: int = 0
    last_zxid_seen: int = 0
    timeout_ms: int = 30000
    session_id: int = 0
    passwd: bytes = b"\x00" * 16
    read_only: bool = False

    def write(self, w: Writer) -> None:
        w.write_int(self.protocol_version)
        w.write_long(self.last_zxid_seen)
        w.write_int(self.timeout_ms)
        w.write_long(self.session_id)
        w.write_buffer(self.passwd)
        w.write_bool(self.read_only)

    @classmethod
    def read(cls, r: Reader) -> "ConnectRequest":
        req = cls(
            protocol_version=r.read_int(),
            last_zxid_seen=r.read_long(),
            timeout_ms=r.read_int(),
            session_id=r.read_long(),
            passwd=r.read_buffer() or b"\x00" * 16,
        )
        # The trailing readOnly byte was added in 3.4; tolerate its absence.
        if r.remaining() >= 1:
            req.read_only = r.read_bool()
        return req


@dataclass
class ConnectResponse:
    protocol_version: int = 0
    timeout_ms: int = 30000
    session_id: int = 0
    passwd: bytes = b"\x00" * 16
    read_only: bool = False

    def write(self, w: Writer) -> None:
        w.write_int(self.protocol_version)
        w.write_int(self.timeout_ms)
        w.write_long(self.session_id)
        w.write_buffer(self.passwd)
        w.write_bool(self.read_only)

    @classmethod
    def read(cls, r: Reader) -> "ConnectResponse":
        resp = cls(
            protocol_version=r.read_int(),
            timeout_ms=r.read_int(),
            session_id=r.read_long(),
            passwd=r.read_buffer() or b"\x00" * 16,
        )
        if r.remaining() >= 1:
            resp.read_only = r.read_bool()
        return resp


@dataclass
class RequestHeader:
    xid: int
    type: int

    def write(self, w: Writer) -> None:
        try:
            w.append_packed(_REQ_HDR.pack(self.xid, self.type))
        except struct.error as e:
            raise JuteError(str(e)) from None

    @classmethod
    def read(cls, r: Reader) -> "RequestHeader":
        xid, type_ = r.read_struct(_REQ_HDR)
        return cls(xid=xid, type=type_)


@dataclass
class ReplyHeader:
    xid: int
    zxid: int
    err: int

    def write(self, w: Writer) -> None:
        try:
            w.append_packed(_REPLY_HDR.pack(self.xid, self.zxid, self.err))
        except struct.error as e:
            raise JuteError(str(e)) from None

    @classmethod
    def read(cls, r: Reader) -> "ReplyHeader":
        xid, zxid, err = r.read_struct(_REPLY_HDR)
        return cls(xid=xid, zxid=zxid, err=err)


@dataclass
class Stat:
    czxid: int = 0
    mzxid: int = 0
    ctime: int = 0
    mtime: int = 0
    version: int = 0
    cversion: int = 0
    aversion: int = 0
    ephemeral_owner: int = 0
    data_length: int = 0
    num_children: int = 0
    pzxid: int = 0

    def _packed(self) -> bytes:
        """The wire bytes (delegates to :func:`pack_stat` — the ONE copy
        of the Stat field order, shared by the jute walk, the stat-only
        reply fast path, and the server's dataclass-free stat lane)."""
        return pack_stat(
            self.czxid,
            self.mzxid,
            self.ctime,
            self.mtime,
            self.version,
            self.cversion,
            self.aversion,
            self.ephemeral_owner,
            self.data_length,
            self.num_children,
            self.pzxid,
        )

    def write(self, w: Writer) -> None:
        w.append_packed(self._packed())

    @classmethod
    def read(cls, r: Reader) -> "Stat":
        (
            czxid,
            mzxid,
            ctime,
            mtime,
            version,
            cversion,
            aversion,
            ephemeral_owner,
            data_length,
            num_children,
            pzxid,
        ) = r.read_struct(_STAT)
        return cls(
            czxid=czxid,
            mzxid=mzxid,
            ctime=ctime,
            mtime=mtime,
            version=version,
            cversion=cversion,
            aversion=aversion,
            ephemeral_owner=ephemeral_owner,
            data_length=data_length,
            num_children=num_children,
            pzxid=pzxid,
        )


#: byte offset of ``ephemeralOwner`` inside a wire Stat: czxid, mzxid,
#: ctime, mtime (4 longs = 32) + version, cversion, aversion (3 ints =
#: 12).  Used by the stat-only reply fast path below.
STAT_OWNER_OFFSET = 44


def stat_owner_from_reply(r: Reader) -> int:
    """``ephemeralOwner`` out of a stat-only reply body (EXISTS — the
    heartbeat sweep's op) WITHOUT materializing the 11-field Stat.

    The ownership check (:meth:`registrar_tpu_torch.zk.client.ZKClient.
    heartbeat`) reads exactly one of a Stat's eleven fields, and at
    1k–10k znodes per sweep the per-reply ``ExistsResponse``+``Stat``
    construction dominated the decode profile (docs/PERF.md).
    The reader is NOT consumed (nothing reads a heartbeat reply after
    the owner check).  Raises :class:`~registrar_tpu_torch.zk.jute.JuteError`
    on a truncated body, exactly like ``Stat.read`` would.
    """
    if r.remaining() < _STAT.size:
        r.read_struct(_STAT)  # raises the canonical truncation error
    return r.long_at(STAT_OWNER_OFFSET)


@dataclass
class CreateRequest:
    path: str
    data: Optional[bytes]
    acls: List[ACL] = field(default_factory=lambda: list(OPEN_ACL_UNSAFE))
    flags: int = CreateFlag.PERSISTENT

    def write(self, w: Writer) -> None:
        w.write_ustring(self.path)
        w.write_buffer(self.data)
        w.write_vector(self.acls, lambda ww, a: a.write(ww))
        w.write_int(self.flags)

    @classmethod
    def read(cls, r: Reader) -> "CreateRequest":
        return cls(
            path=r.read_ustring(),
            data=r.read_buffer(),
            acls=r.read_vector(ACL.read) or [],
            flags=r.read_int(),
        )


@dataclass
class CreateResponse:
    path: str

    def write(self, w: Writer) -> None:
        w.write_ustring(self.path)

    @classmethod
    def read(cls, r: Reader) -> "CreateResponse":
        return cls(path=r.read_ustring())


@dataclass
class DeleteRequest:
    path: str
    version: int = -1

    def write(self, w: Writer) -> None:
        w.write_ustring(self.path)
        w.write_int(self.version)

    @classmethod
    def read(cls, r: Reader) -> "DeleteRequest":
        return cls(path=r.read_ustring(), version=r.read_int())


@dataclass
class ExistsRequest:
    path: str
    watch: bool = False

    def write(self, w: Writer) -> None:
        w.write_ustring(self.path)
        w.write_bool(self.watch)

    @classmethod
    def read(cls, r: Reader) -> "ExistsRequest":
        return cls(path=r.read_ustring(), watch=r.read_bool())


@dataclass
class ExistsResponse:
    stat: Stat

    def write(self, w: Writer) -> None:
        self.stat.write(w)

    @classmethod
    def read(cls, r: Reader) -> "ExistsResponse":
        return cls(stat=Stat.read(r))


@dataclass
class GetDataRequest:
    path: str
    watch: bool = False

    def write(self, w: Writer) -> None:
        w.write_ustring(self.path)
        w.write_bool(self.watch)

    @classmethod
    def read(cls, r: Reader) -> "GetDataRequest":
        return cls(path=r.read_ustring(), watch=r.read_bool())


@dataclass
class GetDataResponse:
    data: Optional[bytes]
    stat: Stat

    def write(self, w: Writer) -> None:
        w.write_buffer(self.data)
        self.stat.write(w)

    @classmethod
    def read(cls, r: Reader) -> "GetDataResponse":
        return cls(data=r.read_buffer(), stat=Stat.read(r))


@dataclass
class SetDataRequest:
    path: str
    data: Optional[bytes]
    version: int = -1

    def write(self, w: Writer) -> None:
        w.write_ustring(self.path)
        w.write_buffer(self.data)
        w.write_int(self.version)

    @classmethod
    def read(cls, r: Reader) -> "SetDataRequest":
        return cls(path=r.read_ustring(), data=r.read_buffer(), version=r.read_int())


@dataclass
class SetDataResponse:
    stat: Stat

    def write(self, w: Writer) -> None:
        self.stat.write(w)

    @classmethod
    def read(cls, r: Reader) -> "SetDataResponse":
        return cls(stat=Stat.read(r))


@dataclass
class GetChildrenRequest:
    path: str
    watch: bool = False

    def write(self, w: Writer) -> None:
        w.write_ustring(self.path)
        w.write_bool(self.watch)

    @classmethod
    def read(cls, r: Reader) -> "GetChildrenRequest":
        return cls(path=r.read_ustring(), watch=r.read_bool())


@dataclass
class GetChildrenResponse:
    children: List[str]

    def write(self, w: Writer) -> None:
        w.write_vector(self.children, Writer.write_ustring)

    @classmethod
    def read(cls, r: Reader) -> "GetChildrenResponse":
        return cls(children=r.read_vector(Reader.read_ustring) or [])


@dataclass
class GetChildren2Response:
    children: List[str]
    stat: Stat

    def write(self, w: Writer) -> None:
        w.write_vector(self.children, Writer.write_ustring)
        self.stat.write(w)

    @classmethod
    def read(cls, r: Reader) -> "GetChildren2Response":
        return cls(
            children=r.read_vector(Reader.read_ustring) or [], stat=Stat.read(r)
        )


@dataclass
class SetWatches:
    relative_zxid: int
    data_watches: List[str] = field(default_factory=list)
    exist_watches: List[str] = field(default_factory=list)
    child_watches: List[str] = field(default_factory=list)

    def write(self, w: Writer) -> None:
        w.write_long(self.relative_zxid)
        w.write_vector(self.data_watches, Writer.write_ustring)
        w.write_vector(self.exist_watches, Writer.write_ustring)
        w.write_vector(self.child_watches, Writer.write_ustring)

    @classmethod
    def read(cls, r: Reader) -> "SetWatches":
        return cls(
            relative_zxid=r.read_long(),
            data_watches=r.read_vector(Reader.read_ustring) or [],
            exist_watches=r.read_vector(Reader.read_ustring) or [],
            child_watches=r.read_vector(Reader.read_ustring) or [],
        )


@dataclass
class WatcherEvent:
    type: int
    state: int
    path: str

    def write(self, w: Writer) -> None:
        w.write_int(self.type)
        w.write_int(self.state)
        w.write_ustring(self.path)

    @classmethod
    def read(cls, r: Reader) -> "WatcherEvent":
        return cls(type=r.read_int(), state=r.read_int(), path=r.read_ustring())


# --- sync ------------------------------------------------------------------

@dataclass
class SyncRequest:
    path: str

    def write(self, w: Writer) -> None:
        w.write_ustring(self.path)

    @classmethod
    def read(cls, r: Reader) -> "SyncRequest":
        return cls(path=r.read_ustring())


@dataclass
class SyncResponse:
    path: str

    def write(self, w: Writer) -> None:
        w.write_ustring(self.path)

    @classmethod
    def read(cls, r: Reader) -> "SyncResponse":
        return cls(path=r.read_ustring())


# --- auth / ACL ops ---------------------------------------------------------

@dataclass
class AuthPacket:
    """Body of an OpCode.AUTH request (always sent with xid -4).

    ``type`` is unused by ZooKeeper (always 0); ``scheme`` names the
    authentication provider ("digest", "ip", ...); ``auth`` is the raw
    credential — for digest, ``b"user:password"`` (the *server* hashes it).
    """

    type: int
    scheme: str
    auth: Optional[bytes]

    def write(self, w: Writer) -> None:
        w.write_int(self.type)
        w.write_ustring(self.scheme)
        w.write_buffer(self.auth)

    @classmethod
    def read(cls, r: Reader) -> "AuthPacket":
        return cls(type=r.read_int(), scheme=r.read_ustring(), auth=r.read_buffer())


@dataclass
class GetACLRequest:
    path: str

    def write(self, w: Writer) -> None:
        w.write_ustring(self.path)

    @classmethod
    def read(cls, r: Reader) -> "GetACLRequest":
        return cls(path=r.read_ustring())


@dataclass
class GetACLResponse:
    acls: List[ACL]
    stat: Stat

    def write(self, w: Writer) -> None:
        w.write_vector(self.acls, lambda ww, a: a.write(ww))
        self.stat.write(w)

    @classmethod
    def read(cls, r: Reader) -> "GetACLResponse":
        return cls(acls=r.read_vector(ACL.read) or [], stat=Stat.read(r))


@dataclass
class SetACLRequest:
    path: str
    acls: List[ACL]
    version: int = -1  # compared against the node's aversion

    def write(self, w: Writer) -> None:
        w.write_ustring(self.path)
        w.write_vector(self.acls, lambda ww, a: a.write(ww))
        w.write_int(self.version)

    @classmethod
    def read(cls, r: Reader) -> "SetACLRequest":
        return cls(
            path=r.read_ustring(),
            acls=r.read_vector(ACL.read) or [],
            version=r.read_int(),
        )


@dataclass
class SetACLResponse:
    stat: Stat

    def write(self, w: Writer) -> None:
        self.stat.write(w)

    @classmethod
    def read(cls, r: Reader) -> "SetACLResponse":
        return cls(stat=Stat.read(r))


# --- multi (transactions) ---------------------------------------------------
#
# A multi is an atomic batch of {create, delete, setData, check} ops.  On the
# wire each op is prefixed by a MultiHeader; a header with done=True (type -1)
# terminates the sequence.  Responses mirror the structure: per-op result
# records, or ErrorResult entries when the transaction aborted (the failing
# op carries its error code, the others RUNTIME_INCONSISTENCY).  The
# reference never batches (zkplus predates multi) — this exists so the
# rebuild's transport exposes the full modern ZooKeeper 3.4 surface, e.g.
# for atomic unregistration.

@dataclass
class CheckVersionRequest:
    path: str
    version: int

    def write(self, w: Writer) -> None:
        w.write_ustring(self.path)
        w.write_int(self.version)

    @classmethod
    def read(cls, r: Reader) -> "CheckVersionRequest":
        return cls(path=r.read_ustring(), version=r.read_int())


@dataclass
class MultiHeader:
    type: int
    done: bool
    err: int

    def write(self, w: Writer) -> None:
        w.write_int(self.type)
        w.write_bool(self.done)
        w.write_int(self.err)

    @classmethod
    def read(cls, r: Reader) -> "MultiHeader":
        return cls(type=r.read_int(), done=r.read_bool(), err=r.read_int())


#: op type -> request record class admissible inside a multi
MULTI_REQUESTS = {
    OpCode.CREATE: CreateRequest,
    OpCode.DELETE: DeleteRequest,
    OpCode.SET_DATA: SetDataRequest,
    OpCode.CHECK: CheckVersionRequest,
}

_MULTI_DONE = MultiHeader(type=-1, done=True, err=-1)


@dataclass
class ErrorResult:
    """Per-op failure marker inside an aborted multi response."""

    err: int

    def write(self, w: Writer) -> None:
        w.write_int(self.err)

    @classmethod
    def read(cls, r: Reader) -> "ErrorResult":
        return cls(err=r.read_int())


@dataclass
class MultiRequest:
    """Ordered (op_type, request_record) pairs forming one transaction."""

    ops: List[tuple]

    def write(self, w: Writer) -> None:
        for op_type, record in self.ops:
            MultiHeader(type=op_type, done=False, err=-1).write(w)
            record.write(w)
        _MULTI_DONE.write(w)

    @classmethod
    def read(cls, r: Reader) -> "MultiRequest":
        ops: List[tuple] = []
        while True:
            hdr = MultiHeader.read(r)
            if hdr.done:
                return cls(ops=ops)
            req_cls = MULTI_REQUESTS.get(hdr.type)
            if req_cls is None:
                raise ValueError(f"op type {hdr.type} not allowed in multi")
            ops.append((hdr.type, req_cls.read(r)))


@dataclass
class MultiResponse:
    """Per-op results: CreateResponse | SetDataResponse | None (delete/check
    ok) | ErrorResult."""

    results: List[object]

    def write(self, w: Writer) -> None:
        for result in self.results:
            if isinstance(result, ErrorResult):
                MultiHeader(type=OpCode.ERROR, done=False, err=result.err).write(w)
                result.write(w)
                continue
            if isinstance(result, CreateResponse):
                op_type = OpCode.CREATE
            elif isinstance(result, SetDataResponse):
                op_type = OpCode.SET_DATA
            elif isinstance(result, DeleteResult):
                op_type = OpCode.DELETE
            elif isinstance(result, CheckResult):
                op_type = OpCode.CHECK
            else:
                raise ValueError(f"bad multi result {result!r}")
            MultiHeader(type=op_type, done=False, err=0).write(w)
            if not isinstance(result, (DeleteResult, CheckResult)):
                result.write(w)
        _MULTI_DONE.write(w)

    @classmethod
    def read(cls, r: Reader) -> "MultiResponse":
        results: List[object] = []
        while True:
            hdr = MultiHeader.read(r)
            if hdr.done:
                return cls(results=results)
            if hdr.type == OpCode.ERROR:
                results.append(ErrorResult.read(r))
            elif hdr.type == OpCode.CREATE:
                results.append(CreateResponse.read(r))
            elif hdr.type == OpCode.SET_DATA:
                results.append(SetDataResponse.read(r))
            elif hdr.type == OpCode.DELETE:
                results.append(DeleteResult())
            elif hdr.type == OpCode.CHECK:
                results.append(CheckResult())
            else:
                raise ValueError(f"bad multi result type {hdr.type}")


@dataclass
class DeleteResult:
    """Successful delete inside a multi (no payload on the wire)."""


@dataclass
class CheckResult:
    """Successful version check inside a multi (no payload on the wire)."""


# --- framing helpers -------------------------------------------------------

def frame(payload: bytes) -> bytes:
    """Prefix a payload with its 4-byte big-endian length."""
    return _LEN.pack(len(payload)) + payload


# --- single-pack primitives (the dataclass-free reply lane) -------
#
# The server answers a 10k-znode heartbeat sweep with 10k stat-only
# replies; building Stat + ExistsResponse dataclasses per reply just to
# struct-pack them again dominated its encode profile.  These helpers
# expose the precompiled packs directly so the hot server lanes (and any
# other caller that already holds the raw fields) can emit wire bytes
# with zero intermediates — byte-identity with the record encoders is
# pinned by tests/test_wire_golden.py.

def pack_reply_header(xid: int, zxid: int, err: int) -> bytes:
    """One-struct ReplyHeader bytes (encode twin of ``read_struct``)."""
    try:
        return _REPLY_HDR.pack(xid, zxid, err)
    except struct.error as e:
        raise JuteError(str(e)) from None


#: ReplyHeader wire size — a reply body starts at this offset
REPLY_HDR_SIZE = _REPLY_HDR.size


def unpack_reply_header(payload) -> "tuple":
    """``(xid, zxid, err)`` straight off a reply frame (bytes or view),
    no ReplyHeader dataclass — the client dispatches every received
    frame through this."""
    if len(payload) < _REPLY_HDR.size:
        raise JuteError(
            f"truncated reply header: {len(payload)} bytes"
        )
    return _REPLY_HDR.unpack_from(payload, 0)


def pack_buffer(value: Optional[bytes]) -> bytes:
    """A jute buffer (int length + raw bytes; -1 encodes null)."""
    if value is None:
        return _LEN.pack(-1)
    try:
        return _LEN.pack(len(value)) + value
    except struct.error as e:  # pragma: no cover - >2GiB payload
        raise JuteError(str(e)) from None


def pack_stat(
    czxid: int,
    mzxid: int,
    ctime: int,
    mtime: int,
    version: int,
    cversion: int,
    aversion: int,
    ephemeral_owner: int,
    data_length: int,
    num_children: int,
    pzxid: int,
) -> bytes:
    """The 68-byte wire Stat in one struct pack — the ONE copy of the
    field order (``Stat._packed`` delegates here)."""
    try:
        return _STAT.pack(
            czxid, mzxid, ctime, mtime, version, cversion, aversion,
            ephemeral_owner, data_length, num_children, pzxid,
        )
    except struct.error as e:
        raise JuteError(str(e)) from None


def encode_request(xid: int, op: int, body=None) -> bytes:
    """Encode a framed request: RequestHeader + optional body record.

    The (path, watch) request shapes — EXISTS is hot loop #1's op (the
    heartbeat sweep, SURVEY §3.2), GET_DATA the resolver's — encode in a
    single struct pack; byte-equality with the general path is pinned by
    tests/test_wire_golden.py.
    """
    t = type(body)
    if t is ExistsRequest or t is GetDataRequest:
        b = body.path.encode("utf-8")
        n = len(b)
        try:
            head = _PW_HDR.pack(n + 13, xid, op, n)
        except struct.error as e:
            raise JuteError(str(e)) from None
        return head + b + (b"\x01" if body.watch else b"\x00")
    if t is CreateRequest and body.acls == _OPEN_ACLS_SNAPSHOT:
        # The registration pipeline's op (mkdirp components + ephemeral
        # host records) always carries the default world:anyone ACL,
        # whose encoded vector is the precomputed _OPEN_ACL_BLOB.
        b = body.path.encode("utf-8")
        d = body.data
        n = len(b)
        m = -1 if d is None else len(d)
        # body = xid 4 + type 4 + pathlen 4 + path n + datalen 4 +
        #        data max(m,0) + acl blob + flags 4
        try:
            head = _PW_HDR.pack(
                20 + n + (0 if m < 0 else m) + len(_OPEN_ACL_BLOB),
                xid, op, n,
            )
            datalen = _LEN.pack(m)
            flags = _LEN.pack(body.flags)
        except struct.error as e:
            raise JuteError(str(e)) from None
        return head + b + datalen + (d or b"") + _OPEN_ACL_BLOB + flags
    w = Writer()
    RequestHeader(xid=xid, type=op).write(w)
    if body is not None:
        body.write(w)
    return frame(w.to_bytes())


def encode_reply_payload(xid: int, zxid: int, err: int, body=None) -> bytes:
    """Encode an unframed reply: ReplyHeader + body (body suppressed on error).

    Stat-only reply bodies (exists — the heartbeat answer — and setData)
    encode in two struct packs; byte-equality with the general path is
    pinned by tests/test_wire_golden.py.
    """
    if err == Err.OK:
        t = type(body)
        if t is ExistsResponse or t is SetDataResponse:
            try:
                head = _REPLY_HDR.pack(xid, zxid, err)
            except struct.error as e:
                raise JuteError(str(e)) from None
            return head + body.stat._packed()
    w = Writer()
    ReplyHeader(xid=xid, zxid=zxid, err=err).write(w)
    if body is not None and err == Err.OK:
        body.write(w)
    return w.to_bytes()


def encode_reply(xid: int, zxid: int, err: int, body=None) -> bytes:
    """Encode a framed reply: ReplyHeader + optional body record."""
    return frame(encode_reply_payload(xid, zxid, err, body))


class ZKError(Exception):
    """A ZooKeeper server-reported error, carrying the protocol code.

    ``name`` holds the symbolic code name (e.g. ``"NO_NODE"``); upper layers
    match on it exactly like the reference matches zkplus error names
    (reference lib/register.js:88).
    """

    def __init__(self, code: int, path: Optional[str] = None):
        self.code = code
        self.name = ERR_NAMES.get(code, f"ZK_ERROR_{code}")
        self.path = path
        super().__init__(f"{self.name} ({code})" + (f": {path}" if path else ""))


#: PathCache bounds (module-level so the class-body defaults resolve in
#: module scope — class attributes are invisible to the checker's
#: default-argument approximation, and to nested scopes generally).
PATH_CACHE_MAX_ENTRIES = 4096
PATH_CACHE_MAX_PATH_LEN = 256


class PathCache:
    """Paths already validated by :func:`check_path`.

    The daemon's hot loops (heartbeat sweeps, the registration pipeline)
    re-validate the same handful of paths every pass; membership here
    short-circuits the per-component walk.  Bounded in count AND entry
    size (a wire frame can carry a multi-MiB path — an unbounded-bytes
    cache would let a hostile stream pin gigabytes); validation is pure,
    so caching is safe.  FIFO eviction when full (insertion-ordered
    dict), so a long-lived daemon whose instance paths churn keeps
    caching NEW hot paths instead of freezing on the first 4096 it ever
    saw.

    Each :class:`~registrar_tpu_torch.zk.client.ZKClient` owns one; the test
    server validates client-supplied paths with NO cache at all, so a
    noisy or hostile peer streaming unique valid paths can never thrash
    the daemon's own hot entries (it only pays the per-component walk it
    asked for).
    """

    __slots__ = ("_entries", "max_entries", "max_path_len")

    def __init__(
        self,
        max_entries: int = PATH_CACHE_MAX_ENTRIES,
        max_path_len: int = PATH_CACHE_MAX_PATH_LEN,
    ):
        self._entries: dict = {}
        self.max_entries = max_entries
        self.max_path_len = max_path_len

    def __contains__(self, path) -> bool:
        return type(path) is str and path in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def add(self, path: str) -> None:
        if self.max_entries <= 0:
            return  # a zero-capacity cache is disabled, not a crash
        if len(path) > self.max_path_len:
            return
        if len(self._entries) >= self.max_entries:
            self._entries.pop(next(iter(self._entries)))  # FIFO eviction
        self._entries[path] = True


def check_path(path: str, cache: Optional[PathCache] = None) -> str:
    """Validate a znode path the way ZooKeeper's PathUtils does.

    ``cache`` (a caller-owned :class:`PathCache`) short-circuits
    re-validation of known-good paths; pass None for untrusted input
    (server-side validation of peer-supplied paths) or one-off calls.
    """
    if cache is not None and path in cache:
        return path
    if not isinstance(path, str) or not path:
        raise ValueError("path must be a non-empty string")
    if not path.startswith("/"):
        raise ValueError(f"path must start with /: {path!r}")
    if len(path) > 1 and path.endswith("/"):
        raise ValueError(f"path must not end with /: {path!r}")
    if "//" in path:
        raise ValueError(f"empty path component: {path!r}")
    for comp in path.split("/")[1:]:
        if comp in (".", ".."):
            raise ValueError(f"relative path component: {path!r}")
        if "\x00" in comp:
            raise ValueError(f"null byte in path component: {path!r}")
    if cache is not None:
        cache.add(path)
    return path
