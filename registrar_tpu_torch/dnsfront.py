"""Real DNS over the sharded serve tier.

The paper's point is that registrar writes znodes *so that Binder can
answer DNS* — yet a resolve through the shard tier alone travels a
bespoke unix-socket protocol.  This module serves real DNS as a
*performance* feature, not a gateway: every `ShardWorker` binds its own
UDP socket to the same host:port with ``SO_REUSEPORT`` so the kernel
does the fan-out (zero router hops on the hot path), plus a TCP
listener on the same port for TC-bit retries.  Correctness never
depends on which worker the kernel picks — `ZKCache` is read-through,
so any worker answers any domain (the ring is a warmth hint; see
docs/DESIGN.md "Sharded serve tier").  A dead worker's sockets close
with it and the kernel rebalances onto the survivors.

Three layers:

* **Wire codec** — dependency-free: header, QNAME parse/encode with
  compression pointers, A/SRV/TXT answers, SOA-backed NXDOMAIN/NODATA
  negatives, EDNS0 size negotiation, 0x20 case preservation (the
  response echoes the query's exact qname bytes; answer owners point
  at the question via a compression pointer, so the case propagates),
  and malformed packets rejected through the
  ``registrar_malformed_frames_total`` machinery (surface ``dns``).
  Every peer-read integer is bound-checked before it sizes a loop or
  slice — the generation-5 taint analysis enforces it (this module is
  a declared trust boundary, docs/DESIGN.md appendix).

* **Answer-encode cache** (:class:`EncodeCache`) — each warm
  `Resolution` is rendered into final RR wire bytes exactly once and
  the template is invalidated by the same ZKCache watch events that
  drop the underlying entry (including negative entries: a cached
  NXDOMAIN rides the exists-watch ZKCache arms on NO_NODE, so even
  "this name does not exist" is watch-coherent).  A warm UDP answer is
  parse-header → memcpy-template → patch-id/0x20-name → sendto.
  Answer TTLs are the record TTLs registrar itself wrote; the
  *negative* TTL derives from the cache's coherence bound (staleness
  ≤ watch delivery while authoritative), so a resolver never believes
  an absence longer than the tier itself would.  When the backing
  ZKCache *loses* authority the front serves stale (RFC 8767): the
  templates rendered before the drop keep answering for a bounded
  window (``staleTtl``, default 30 s) so a backend election is not a
  DNS outage for names whose data never changed — while nothing new is
  cached, and restoration flushes everything, because the watch events
  missed during the outage make every surviving template unprovable.

* **Overload armor** — the shard tier's discipline mapped onto DNS: a
  token-bucket rate limit and a pending-resolve bound shed with rcode
  REFUSED, *never* silence (a silent drop looks like packet loss and
  triggers client retry storms).  Warm encode-cache hits bypass the
  bounds — they cost a memcpy, and shedding them would reduce
  capacity, not protect it.

The protocol constants below are machine-checked the same way the
shard tier's are: checklib's ``opcode-dispatch-drift`` diffs the
``QTYPE_*``/``RCODE_*`` families against the dispatch tables here and
the protocol table in docs/DESIGN.md, and ``flag-bit-overlap`` proves
the header flag masks disjoint.
"""

from __future__ import annotations

import asyncio
import errno
import logging
import socket
import struct
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import malformed
from .metrics import DEFAULT_BUCKETS

log = logging.getLogger("registrar_tpu_torch.dnsfront")

# ---- protocol constants -----------------------------------------------------

QTYPE_A = 1
QTYPE_SOA = 6
QTYPE_TXT = 16
QTYPE_SRV = 33
QTYPE_OPT = 41

RCODE_NOERROR = 0
RCODE_FORMERR = 1
RCODE_SERVFAIL = 2
RCODE_NXDOMAIN = 3
RCODE_NOTIMP = 4
RCODE_REFUSED = 5

CLASS_IN = 1

#: Header flag masks (16-bit flags word).  Pairwise bit-disjoint and
#: disjoint from every code value above — checklib `flag-bit-overlap`.
FLAG_QR = 0x8000
FLAG_AA = 0x0400
FLAG_TC = 0x0200
FLAG_RD = 0x0100
FLAG_RA = 0x0080

#: Dispatch tables: code -> presentation name.  These are the codec's
#: dispatch arms (every constant above must appear as a key — checklib
#: `opcode-dispatch-drift`), and `zkcli dig` renders through them.
QTYPE_NAMES = {
    QTYPE_A: "A",
    QTYPE_SOA: "SOA",
    QTYPE_TXT: "TXT",
    QTYPE_SRV: "SRV",
    QTYPE_OPT: "OPT",
}
RCODE_NAMES = {
    RCODE_NOERROR: "NOERROR",
    RCODE_FORMERR: "FORMERR",
    RCODE_SERVFAIL: "SERVFAIL",
    RCODE_NXDOMAIN: "NXDOMAIN",
    RCODE_NOTIMP: "NOTIMP",
    RCODE_REFUSED: "REFUSED",
}
TYPE_CODES = {name: code for code, name in QTYPE_NAMES.items()}

#: The qtypes a worker actually resolves (binderview's vocabulary).
SERVED_QTYPES = (QTYPE_A, QTYPE_SRV, QTYPE_TXT)

_DNS_HDR = struct.Struct(">HHHHHH")   # id, flags, qd, an, ns, ar
_QFIXED = struct.Struct(">HH")        # qtype, qclass
_RR_FIXED = struct.Struct(">HHIH")    # type, class, ttl, rdlength
_SRV_FIXED = struct.Struct(">HHH")    # priority, weight, port
_SOA_NUMS = struct.Struct(">IIIII")   # serial, refresh, retry, expire, min
_U16 = struct.Struct(">H")

MAX_LABEL_LEN = 63
MAX_NAME_LEN = 255
MAX_RRS = 256          # bound on a query's additional records
MAX_PTR_JUMPS = 16     # compression-pointer chain bound
MIN_UDP_PAYLOAD = 512  # the classic pre-EDNS ceiling
MAX_UDP_PAYLOAD = 4096  # clamp on a peer's advertised EDNS size
MAX_TCP_MSG = 65535    # the 2-byte length prefix's own ceiling

#: A compression pointer to offset 12 — the question name.  Every
#: answer whose owner IS the queried name points here, which is also
#: how 0x20 case preservation propagates into the answer section.
QUESTION_PTR = b"\xc0\x0c"

DEFAULT_UDP_PAYLOAD_MAX = 1232  # EDNS answer-size we advertise (no frag risk)
DEFAULT_NEGATIVE_TTL = 5  # seconds; ~the cache's watch-delivery bound
DEFAULT_STALE_TTL = 30  # seconds a degraded front may serve stale (RFC 8767)
#: picks of a port-0 DNS port before the last EADDRINUSE is raised
PORT_PICK_TRIES = 32

#: Synthesized SOA timers (serial/refresh/retry/expire) for negative
#: answers.  registrar has no zone file and no serial discipline — the
#: values are conventional and fixed; only `minimum` (the negative
#: TTL) is meaningful, and it derives from the coherence bound.
SOA_TIMERS = (1, 3600, 600, 86400)


class DnsError(ValueError):
    """Any DNS wire-format violation (the codec's contract class)."""


class DnsFormatError(DnsError):
    """A parseable-enough header with garbage behind it: answer
    FORMERR (the query id is recoverable)."""

    def __init__(self, message: str, qid: Optional[int] = None):
        super().__init__(message)
        self.qid = qid


class DnsIgnore(DnsError):
    """A packet that must be dropped without a reply (a response
    echoed back at us, a header too short to even carry an id) —
    answering would risk reflection loops."""


class DnsRefused(DnsError):
    """Raised by a resolver callable to shed the query: answered
    REFUSED and counted under ``reason`` (the shard tier's shed taxonomy)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# ---- names ------------------------------------------------------------------


def encode_name(name: str) -> bytes:
    """Dotted name -> uncompressed wire form (len-prefixed labels)."""
    name = name.rstrip(".")
    if not name:
        return b"\x00"
    out = bytearray()
    for label in name.split("."):
        raw = label.encode("latin-1")
        if not raw or len(raw) > MAX_LABEL_LEN:
            raise DnsError(f"bad label {label!r} in {name!r}")
        out.append(len(raw))
        out += raw
    out.append(0)
    if len(out) > MAX_NAME_LEN:
        raise DnsError(f"name too long: {name!r}")
    return bytes(out)


def parse_name(pkt: bytes, pos: int) -> Tuple[str, int]:
    """Decode a (possibly compressed) name at ``pos``.

    Returns ``(dotted_name, end)`` where ``end`` is the offset just
    past the name *at its original location* (pointers do not move
    it).  Pointer chains are bounded and must point strictly backward,
    so a hostile packet cannot loop the parser.
    """
    labels: List[bytes] = []
    end = -1
    jumps = 0
    total = 0
    while True:
        if pos >= len(pkt):
            raise DnsFormatError("name runs off the packet")
        length = pkt[pos]
        if length & 0xC0 == 0xC0:
            if pos + 1 >= len(pkt):
                raise DnsFormatError("truncated compression pointer")
            target = ((length & 0x3F) << 8) | pkt[pos + 1]
            if end < 0:
                end = pos + 2
            jumps += 1
            if jumps > MAX_PTR_JUMPS or target >= pos:
                raise DnsFormatError("compression pointer loop")
            pos = target
            continue
        if length & 0xC0:
            raise DnsFormatError("reserved label type")
        pos += 1
        if length == 0:
            if end < 0:
                end = pos
            return b".".join(labels).decode("latin-1"), end
        total += length + 1
        if total > MAX_NAME_LEN:
            raise DnsFormatError("name exceeds 255 octets")
        if pos + length > len(pkt):
            raise DnsFormatError("label runs off the packet")
        labels.append(pkt[pos:pos + length])
        pos += length


# ---- query parsing (the server side) ----------------------------------------


class DnsQuery:
    """One parsed query: everything the serve path needs, including the
    qname's exact wire bytes for the 0x20 case echo."""

    __slots__ = ("qid", "flags", "qname_wire", "lname", "qtype", "qclass",
                 "edns_size")

    def __init__(self, qid, flags, qname_wire, lname, qtype, qclass,
                 edns_size):
        self.qid = qid
        self.flags = flags
        self.qname_wire = qname_wire  # exact case, trailing 0x00 included
        self.lname = lname            # lowercased dotted form (cache key)
        self.qtype = qtype
        self.qclass = qclass
        self.edns_size = edns_size    # clamped advertised size, or 0


def parse_query(pkt: bytes) -> DnsQuery:
    """Parse one incoming query or raise the codec's contract classes:
    :class:`DnsIgnore` (drop), :class:`DnsFormatError` (FORMERR)."""
    if len(pkt) < _DNS_HDR.size:
        raise DnsIgnore("short header")
    qid, flags, qd, an, ns, ar = _DNS_HDR.unpack_from(pkt, 0)
    if flags & FLAG_QR:
        raise DnsIgnore("QR set: a response, not a query")
    if qd != 1 or an != 0 or ns != 0:
        raise DnsFormatError("expected exactly one question", qid=qid)
    if ar > MAX_RRS:
        raise DnsFormatError("additional count out of bounds", qid=qid)
    name, pos = parse_name(pkt, _DNS_HDR.size)
    if pos + _QFIXED.size > len(pkt):
        raise DnsFormatError("truncated question", qid=qid)
    qname_wire = pkt[_DNS_HDR.size:pos]
    qtype, qclass = _QFIXED.unpack_from(pkt, pos)
    pos += _QFIXED.size
    # EDNS0: scan the additional section for an OPT RR; its CLASS field
    # is the sender's UDP payload size.  Every RR length is bound-checked
    # before it advances the cursor (taint discipline).
    edns_size = 0
    for _ in range(ar):
        if pos >= len(pkt):
            break
        _, rpos = parse_name(pkt, pos)
        if rpos + _RR_FIXED.size > len(pkt):
            raise DnsFormatError("truncated additional RR", qid=qid)
        rtype, rclass, _rttl, rdlen = _RR_FIXED.unpack_from(pkt, rpos)
        next_pos = rpos + _RR_FIXED.size
        if next_pos + rdlen > len(pkt):
            raise DnsFormatError("additional RR runs off the packet",
                                 qid=qid)
        if rtype == QTYPE_OPT:
            edns_size = max(MIN_UDP_PAYLOAD, min(rclass, MAX_UDP_PAYLOAD))
        pos = next_pos + rdlen
    return DnsQuery(qid, flags, qname_wire, name.lower(), qtype, qclass,
                    edns_size)


# ---- RR rendering -----------------------------------------------------------


def render_rdata(rtype: int, data: str) -> bytes:
    """binderview's presentation data (`Answer.data`) -> RDATA bytes.
    The single place RR bodies are rendered — the encode cache and
    `Resolution.to_wire_records()` both come through here."""
    if rtype == QTYPE_A:
        return socket.inet_aton(data)
    if rtype == QTYPE_SRV:
        prio, weight, port, target = data.split()
        return _SRV_FIXED.pack(int(prio), int(weight), int(port)) + \
            encode_name(target)
    if rtype == QTYPE_TXT:
        raw = data.encode("latin-1")
        out = bytearray()
        while True:
            chunk, raw = raw[:255], raw[255:]
            out.append(len(chunk))
            out += chunk
            if not raw:
                return bytes(out)
    raise DnsError(f"unrenderable rtype {rtype}")


def wire_records(resolution) -> Tuple[list, list]:
    """A `binderview.Resolution` -> ``(answers, additionals)`` as
    ``(name, type_code, ttl, rdata_bytes)`` tuples — the stable hook
    behind ``Resolution.to_wire_records()``."""
    def _rr(answer):
        code = TYPE_CODES[answer.rtype]
        return (answer.name, code, answer.ttl,
                render_rdata(code, answer.data))
    return ([_rr(a) for a in resolution.answers],
            [_rr(a) for a in resolution.additionals])


def _encode_rr(owner_wire: bytes, rtype: int, ttl: int,
               rdata: bytes) -> bytes:
    return owner_wire + _RR_FIXED.pack(rtype, CLASS_IN, int(ttl),
                                       len(rdata)) + rdata


def _opt_rr(payload_size: int) -> bytes:
    # root name, type OPT, class = our payload size, ttl = 0 flags, no rdata
    return b"\x00" + _RR_FIXED.pack(QTYPE_OPT, payload_size, 0, 0)


def build_answer_template(lname: str, qtype: int, resolution) -> bytes:
    """Render a Resolution into a full response template: id 0, flags
    QR|AA, canonical-lowercase question, answers/additionals.  Owners
    equal to the queried name become compression pointers at the
    question (12 bytes in), which is also how the 0x20 case echo
    propagates.  No OPT — that is appended per-query at serve time."""
    question = encode_name(lname) + _QFIXED.pack(qtype, CLASS_IN)
    answers, additionals = wire_records(resolution)
    body = bytearray()

    def owner_wire(name: str) -> bytes:
        if name.lower().rstrip(".") == lname.rstrip("."):
            return QUESTION_PTR
        return encode_name(name)

    for name, code, ttl, rdata in answers:
        body += _encode_rr(owner_wire(name), code, ttl, rdata)
    for name, code, ttl, rdata in additionals:
        body += _encode_rr(owner_wire(name), code, ttl, rdata)
    header = _DNS_HDR.pack(0, FLAG_QR | FLAG_AA, 1, len(answers), 0,
                           len(additionals))
    return header + question + bytes(body)


def build_negative_template(lname: str, qtype: int, rcode: int,
                            negative_ttl: int) -> bytes:
    """NXDOMAIN (rcode 3) or NODATA (NOERROR, zero answers), both with
    an SOA authority record so resolvers can cache the negative.  The
    SOA owner is the queried name's parent (registrar has no zone cuts;
    the parent is the closest enclosing name Binder would also pick),
    its timers are the fixed :data:`SOA_TIMERS`, and `minimum` — the
    field negative caches honor — is the coherence-bound TTL."""
    question = encode_name(lname) + _QFIXED.pack(qtype, CLASS_IN)
    apex = lname.split(".", 1)[1] if "." in lname else lname
    serial, refresh, retry, expire = SOA_TIMERS
    soa_rdata = (encode_name("ns0." + apex)
                 + encode_name("hostmaster." + apex)
                 + _SOA_NUMS.pack(serial, refresh, retry, expire,
                                  int(negative_ttl)))
    soa = _encode_rr(encode_name(apex), QTYPE_SOA, int(negative_ttl),
                     soa_rdata)
    header = _DNS_HDR.pack(0, FLAG_QR | FLAG_AA | rcode, 1, 0, 1, 0)
    return header + question + soa


def render_from_template(template: bytes, query: DnsQuery,
                         limit: int) -> bytes:
    """The warm path: copy the template, patch the query id, echo the
    exact qname bytes (0x20 case) and the RD bit, append OPT when the
    query negotiated EDNS, truncate to ``limit`` with TC if needed."""
    out = bytearray(template)
    _U16.pack_into(out, 0, query.qid)
    tflags = _U16.unpack_from(template, 2)[0] | (query.flags & FLAG_RD)
    _U16.pack_into(out, 2, tflags)
    out[12:12 + len(query.qname_wire)] = query.qname_wire
    if query.edns_size:
        out += _opt_rr(DEFAULT_UDP_PAYLOAD_MAX)
        _U16.pack_into(out, 10, _U16.unpack_from(template, 10)[0] + 1)
    if len(out) <= limit:
        return bytes(out)
    # Too big for the transport: header + question (+ OPT) with TC set,
    # zero RR counts — the client retries over TCP.
    qend = 12 + len(query.qname_wire) + _QFIXED.size
    short = bytearray(out[:qend])
    _U16.pack_into(short, 2, tflags | FLAG_TC)
    _U16.pack_into(short, 6, 0)
    _U16.pack_into(short, 8, 0)
    if query.edns_size:
        _U16.pack_into(short, 10, 1)
        short += _opt_rr(DEFAULT_UDP_PAYLOAD_MAX)
    else:
        _U16.pack_into(short, 10, 0)
    return bytes(short)


def build_error_response(query: DnsQuery, rcode: int) -> bytes:
    """A minimal answerless response carrying ``rcode`` (REFUSED,
    SERVFAIL, NOTIMP): header + the echoed question."""
    flags = FLAG_QR | rcode | (query.flags & FLAG_RD)
    header = _DNS_HDR.pack(query.qid, flags, 1, 0, 0, 0)
    return header + query.qname_wire + _QFIXED.pack(query.qtype,
                                                    query.qclass)


def build_formerr_response(qid: int) -> bytes:
    """FORMERR with an empty question section — the packet was too
    mangled to echo its question back."""
    return _DNS_HDR.pack(qid, FLAG_QR | RCODE_FORMERR, 0, 0, 0, 0)


# ---- client side (zkcli dig, the SLO probe, bench, tests) -------------------


def build_query(qid: int, name: str, qtype: int, *, rd: bool = False,
                edns_size: int = 0) -> bytes:
    """One query packet.  ``name`` is sent byte-exact (callers doing
    0x20 mixing pass the mixed-case form)."""
    flags = FLAG_RD if rd else 0
    ar = 1 if edns_size else 0
    pkt = _DNS_HDR.pack(qid, flags, 1, 0, 0, ar) + encode_name(name) + \
        _QFIXED.pack(qtype, CLASS_IN)
    if edns_size:
        pkt += _opt_rr(edns_size)
    return pkt


class DnsResponse:
    """A decoded response, presentation-ready (dig-style strings)."""

    __slots__ = ("qid", "flags", "rcode", "tc", "qname", "qtype",
                 "answers", "authorities", "additionals")

    def __init__(self, qid, flags, qname, qtype):
        self.qid = qid
        self.flags = flags
        self.rcode = flags & 0x000F
        self.tc = bool(flags & FLAG_TC)
        self.qname = qname
        self.qtype = qtype
        self.answers: List[Tuple[str, str, int, str]] = []
        self.authorities: List[Tuple[str, str, int, str]] = []
        self.additionals: List[Tuple[str, str, int, str]] = []


def _render_rr_text(pkt: bytes, rtype: int, pos: int, rdlen: int) -> str:
    """RDATA at ``pos`` -> dig-style presentation text."""
    if rtype == QTYPE_A and rdlen == 4:
        return socket.inet_ntoa(pkt[pos:pos + 4])
    if rtype == QTYPE_SRV and rdlen >= _SRV_FIXED.size:
        prio, weight, port = _SRV_FIXED.unpack_from(pkt, pos)
        target, _ = parse_name(pkt, pos + _SRV_FIXED.size)
        return f"{prio} {weight} {port} {target}."
    if rtype == QTYPE_TXT:
        chunks = []
        cur, end = pos, pos + rdlen
        while cur < end:
            n = pkt[cur]
            cur += 1
            if cur + n > end:
                raise DnsFormatError("TXT string runs off its RDATA")
            chunks.append(pkt[cur:cur + n].decode("latin-1"))
            cur += n
        return " ".join(f'"{c}"' for c in chunks)
    if rtype == QTYPE_SOA:
        mname, p = parse_name(pkt, pos)
        rname, p = parse_name(pkt, p)
        if p + _SOA_NUMS.size > pos + rdlen:
            raise DnsFormatError("truncated SOA RDATA")
        serial, refresh, retry, expire, minimum = _SOA_NUMS.unpack_from(
            pkt, p)
        return (f"{mname}. {rname}. {serial} {refresh} {retry} "
                f"{expire} {minimum}")
    return pkt[pos:pos + rdlen].hex()


def decode_response(pkt: bytes) -> DnsResponse:
    """Decode a response into presentation form.  Every peer count and
    length is bound-checked before it drives a loop or slice."""
    if len(pkt) < _DNS_HDR.size:
        raise DnsFormatError("short header")
    qid, flags, qd, an, ns, ar = _DNS_HDR.unpack_from(pkt, 0)
    # A record takes at least a root name and its fixed fields, so the
    # packet bounds the counts: an answer over TCP for a large service
    # carries thousands of A records.
    if qd > 1 or an + ns + ar > (len(pkt) - _DNS_HDR.size) // (1 + _RR_FIXED.size):
        raise DnsFormatError("RR counts out of bounds", qid=qid)
    pos = _DNS_HDR.size
    qname, qtype = "", 0
    if qd:
        qname, pos = parse_name(pkt, pos)
        if pos + _QFIXED.size > len(pkt):
            raise DnsFormatError("truncated question", qid=qid)
        qtype, _ = _QFIXED.unpack_from(pkt, pos)
        pos += _QFIXED.size
    resp = DnsResponse(qid, flags, qname, qtype)
    for section, count in ((resp.answers, an), (resp.authorities, ns),
                           (resp.additionals, ar)):
        for _ in range(count):
            name, rpos = parse_name(pkt, pos)
            if rpos + _RR_FIXED.size > len(pkt):
                raise DnsFormatError("truncated RR", qid=qid)
            rtype, _rclass, ttl, rdlen = _RR_FIXED.unpack_from(pkt, rpos)
            rstart = rpos + _RR_FIXED.size
            if rstart + rdlen > len(pkt):
                raise DnsFormatError("RDATA runs off the packet", qid=qid)
            if rtype != QTYPE_OPT:
                section.append(
                    (name, QTYPE_NAMES.get(rtype, str(rtype)), ttl,
                     _render_rr_text(pkt, rtype, rstart, rdlen)))
            pos = rstart + rdlen
    return resp


async def query_udp(host: str, port: int, packet: bytes, *,
                    timeout: float = 2.0) -> bytes:
    """One UDP exchange.  Raises ``asyncio.TimeoutError`` on silence —
    the tier's armor answers REFUSED rather than dropping, so a timeout
    here means the tier (or the path to it) is down, not busy."""
    loop = asyncio.get_running_loop()
    fut: asyncio.Future = loop.create_future()

    class _Proto(asyncio.DatagramProtocol):
        def datagram_received(self, data, addr):
            if not fut.done():
                fut.set_result(data)

        def error_received(self, exc):
            if not fut.done():
                fut.set_exception(exc)

    transport, _ = await loop.create_datagram_endpoint(
        _Proto, remote_addr=(host, port))
    try:
        transport.sendto(packet)
        return await asyncio.wait_for(fut, timeout)
    finally:
        transport.close()


async def query_tcp(host: str, port: int, packet: bytes, *,
                    timeout: float = 5.0) -> bytes:
    """One TCP exchange (2-byte length prefix both ways) — the TC-bit
    retry path."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout)
    try:
        writer.write(_U16.pack(len(packet)) + packet)
        await asyncio.wait_for(writer.drain(), timeout)
        hdr = await asyncio.wait_for(reader.readexactly(2), timeout)
        (rlen,) = _U16.unpack(hdr)
        if rlen > MAX_TCP_MSG:
            raise DnsFormatError("TCP response length out of bounds")
        return await asyncio.wait_for(reader.readexactly(rlen), timeout)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


# ---- the answer-encode cache ------------------------------------------------


class EncodeCache:
    """Warm `Resolution`s rendered to final RR wire bytes exactly once.

    Keys are ``(lname, qtype_code)``; every template is additionally
    indexed under its *base domain* — the queried name with service
    underscore labels stripped — so one ZKCache ``invalidated`` event
    (node write, instance child churn, or a negative entry's
    exists-watch firing on creation) drops every answer shape rendered
    from that znode's subtree.  Negative templates (NXDOMAIN/NODATA)
    are cached under the same contract: ZKCache arms an exists-watch on
    NO_NODE, so the creation that would change the answer fires the
    same event.  ``flush()`` empties everything; the front calls it
    when authority is *restored* after an outage — the watch events
    missed while degraded make every surviving template unprovable —
    or when the bounded serve-stale window expires.  Deliberately NOT
    at the moment of degradation: that would turn every backend
    election into a DNS outage for names whose data never changed
    (RFC 8767 serve-stale; the overload armor's stance).
    """

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._templates: Dict[Tuple[str, int], bytes] = {}
        self._by_domain: Dict[str, set] = {}
        #: base domain -> [misses resolving it, invalidations since the
        #: first of them began]: a template whose resolve overlapped an
        #: invalidation of its domain may hold what the invalidation
        #: dropped, with no watch left to drop it again, so it is not kept
        self._filling: Dict[str, List[int]] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.flushes = 0

    @staticmethod
    def base_domain(lname: str) -> str:
        """The cache-index domain: strip leading ``_service``/``_proto``
        labels so ``_http._tcp.foo`` and ``foo`` share one index slot."""
        parts = lname.rstrip(".").split(".")
        while parts and parts[0].startswith("_"):
            parts = parts[1:]
        return ".".join(parts)

    def __len__(self) -> int:
        return len(self._templates)

    def get(self, key: Tuple[str, int]) -> Optional[bytes]:
        tpl = self._templates.get(key)
        if tpl is None:
            self.misses += 1
        else:
            self.hits += 1
        return tpl

    def put(self, key: Tuple[str, int], template: bytes) -> None:
        if len(self._templates) >= self.max_entries and \
                key not in self._templates:
            # Bounded exactly like ZKCache: oldest-first eviction; an
            # evicted template transparently re-renders on next miss.
            oldest = next(iter(self._templates))
            self._drop(oldest)
        self._templates[key] = template
        self._by_domain.setdefault(self.base_domain(key[0]), set()).add(key)

    def _drop(self, key: Tuple[str, int]) -> None:
        self._templates.pop(key, None)
        dom = self.base_domain(key[0])
        keys = self._by_domain.get(dom)
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_domain[dom]

    def fill_started(self, lname: str) -> Tuple[str, int]:
        """A miss for ``lname`` starts resolving: the token that
        :meth:`fill_done` takes."""
        base = self.base_domain(lname)
        slot = self._filling.setdefault(base, [0, 0])
        slot[0] += 1
        return base, slot[1]

    def fill_done(self, token: Tuple[str, int], key: Tuple[str, int],
                  template: Optional[bytes]) -> None:
        """The miss behind ``token`` ended: keep ``template`` (None:
        nothing to keep) unless its domain was invalidated meanwhile."""
        base, seen = token
        slot = self._filling[base]
        slot[0] -= 1
        if slot[0] == 0:
            del self._filling[base]
        if template is not None and slot[1] == seen:
            self.put(key, template)

    def invalidate_domain(self, domain: str) -> None:
        """Drop every template indexed under ``domain`` — called with
        the invalidated znode's own domain AND its parent, so instance-
        child churn under a service node drops the parent's answers."""
        slot = self._filling.get(domain)
        if slot is not None:
            slot[1] += 1
        keys = self._by_domain.pop(domain, None)
        if not keys:
            return
        for key in keys:
            self._templates.pop(key, None)
        self.invalidations += len(keys)

    def flush(self) -> None:
        if self._templates:
            self.flushes += 1
        self._templates.clear()
        self._by_domain.clear()
        for slot in self._filling.values():
            slot[1] += 1

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "invalidations": self.invalidations,
            "flushes": self.flushes,
            "entries": len(self._templates),
        }


# ---- the server -------------------------------------------------------------


class _Bucket:
    """The overload armor's token bucket (rate req/s, burst = one second's refill),
    applied per front — the DNS analog of the router's per-connection
    bucket (UDP has no connections to scope it to)."""

    def __init__(self, rate: float):
        self.rate = float(rate)
        self.tokens = float(rate)
        self.stamp = time.monotonic()

    def admit(self) -> bool:
        now = time.monotonic()
        self.tokens = min(self.rate,
                          self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class DnsFront:
    """One worker's DNS presence: an SO_REUSEPORT UDP endpoint + a TCP
    listener on the same port, an :class:`EncodeCache`, and the
    overload armor.

    ``resolver(lname, qtype_name)`` is the only coupling to the serve
    tier: an async callable returning a `binderview.Resolution` (or
    raising :class:`DnsRefused` to shed) — `ShardWorker` passes its
    cache-backed resolve path; tests pass a stub.  ``source`` is the
    read source used to tell NXDOMAIN from NODATA (``read_node`` rides
    the negative cache) and whose ``authoritative`` flag gates
    template caching; ``attach_cache`` wires the watch events.
    """

    def __init__(self, resolver: Callable, *, host: str = "127.0.0.1",
                 port: int = 0, source=None,
                 udp_payload_max: int = DEFAULT_UDP_PAYLOAD_MAX,
                 negative_ttl: float = DEFAULT_NEGATIVE_TTL,
                 stale_ttl: float = DEFAULT_STALE_TTL,
                 max_entries: int = 4096,
                 max_pending: Optional[int] = None,
                 rate_limit: Optional[float] = None):
        self._resolver = resolver
        self.host = host
        self.port = port
        self._source = source
        self.udp_payload_max = int(udp_payload_max)
        self.negative_ttl = negative_ttl
        self.stale_ttl = float(stale_ttl)
        self.cache = EncodeCache(max_entries)
        # monotonic stamp of the source's authority loss; None while
        # authoritative.  Bounds the RFC 8767 serve-stale window.
        self._stale_since: Optional[float] = None
        self._max_pending = max_pending
        self._bucket = _Bucket(rate_limit) if rate_limit else None
        self._pending: set = set()
        self._udp_transport = None
        self._tcp_server = None
        self._subscribed = None
        self._unsubscribes: List[Tuple[str, Callable]] = []
        # qtype/rcode counters + a DEFAULT_BUCKETS latency ladder, the
        # shape metrics.instrument_shards aggregates across workers.
        self.queries: Dict[str, int] = {}
        self.udp_counts = [0] * (len(DEFAULT_BUCKETS) + 1)
        self.udp_sum = 0.0
        self.sheds: Dict[str, int] = {}

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> Tuple[str, int]:
        """Bind the UDP endpoint and the TCP listener on one port.  A
        requested port of 0 is picked by :func:`allocate_port`, free
        for both protocols, and picked again while a bind then finds it
        taken, up to :data:`PORT_PICK_TRIES` times; a fixed port raises
        at once.  A failed start leaves no socket bound."""
        requested = self.port
        for _ in range(PORT_PICK_TRIES):
            port = requested or allocate_port(self.host)
            try:
                await self._bind(port)
                break
            except OSError as err:
                if requested or err.errno != errno.EADDRINUSE:
                    raise
                taken = err
                log.warning("dns port %d is taken (%s); picking another",
                            port, err)
        else:
            raise taken
        if self._source is not None:
            self.attach_cache(self._source)
        return self.host, self.port

    async def _bind(self, port: int) -> None:
        """UDP on ``port``, then TCP on the number UDP got, both with
        SO_REUSEPORT.  The UDP socket is bound by hand and handed to the
        loop only once TCP is bound too, so a failed TCP bind closes it
        before the error is raised."""
        reuse = hasattr(socket, "SO_REUSEPORT")
        loop = asyncio.get_running_loop()
        family, _, _, _, addr = (await loop.getaddrinfo(
            self.host, port, type=socket.SOCK_DGRAM))[0]
        udp = socket.socket(family, socket.SOCK_DGRAM)
        try:
            if reuse:
                udp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            udp.bind(addr)
            port = udp.getsockname()[1]
            self._tcp_server = await asyncio.start_server(
                self._serve_tcp, self.host, port, reuse_port=reuse or None)
        except BaseException:
            udp.close()
            raise
        self._udp_transport, _ = await loop.create_datagram_endpoint(
            lambda: _UdpProtocol(self), sock=udp)
        self.port = port

    def attach_cache(self, zkcache) -> None:
        """Subscribe the encode cache to the watch events that keep it
        coherent.  Invalidation drops the changed znode's domain AND
        its parent: an instance child landing under a service node
        changes the parent's answers too.  An entry the cache evicts
        drops them the same way: its watch is forgotten, so no later
        change to it would reach a template built from it.  Authority
        loss does NOT flush — the front serves stale for ``stale_ttl``
        seconds (RFC 8767; new templates are already blocked by
        :meth:`_cacheable`), and the *restored* event flushes instead,
        because the invalidations missed during the outage make every
        surviving template unprovable."""
        from . import records

        def on_invalidated(path, _event=None):
            try:
                domain = records.path_to_domain(path)
            except ValueError:
                return
            self.cache.invalidate_domain(domain)
            if "." in domain:
                self.cache.invalidate_domain(domain.split(".", 1)[1])

        def on_degraded(_reason=None):
            if self._stale_since is None:
                self._stale_since = time.monotonic()

        def on_restored(*_args):
            self.cache.flush()
            self._stale_since = None

        self._subscribed = zkcache
        zkcache.on("invalidated", on_invalidated)
        zkcache.on("evicted", on_invalidated)
        zkcache.on("degraded", on_degraded)
        zkcache.on("restored", on_restored)
        self._unsubscribes.append(("invalidated", on_invalidated))
        self._unsubscribes.append(("evicted", on_invalidated))
        self._unsubscribes.append(("degraded", on_degraded))
        self._unsubscribes.append(("restored", on_restored))

    async def close(self) -> None:
        if self._subscribed is not None:
            for event, listener in self._unsubscribes:
                self._subscribed.off(event, listener)
            self._subscribed = None
        self._unsubscribes.clear()
        if self._udp_transport is not None:
            self._udp_transport.close()
            self._udp_transport = None
        if self._tcp_server is not None:
            self._tcp_server.close()
            await self._tcp_server.wait_closed()
            self._tcp_server = None
        for task in list(self._pending):
            task.cancel()
        self._pending.clear()

    # -- accounting --------------------------------------------------------

    def _count(self, qtype: int, rcode: int, started: float) -> None:
        qname = QTYPE_NAMES.get(qtype, "OTHER")
        rname = RCODE_NAMES.get(rcode, str(rcode))
        key = f"{qname} {rname}"
        self.queries[key] = self.queries.get(key, 0) + 1
        elapsed = time.perf_counter() - started
        self.udp_sum += elapsed
        for i, bound in enumerate(DEFAULT_BUCKETS):
            if elapsed <= bound:
                self.udp_counts[i] += 1
                return
        self.udp_counts[len(DEFAULT_BUCKETS)] += 1

    def _shed(self, reason: str) -> None:
        self.sheds[reason] = self.sheds.get(reason, 0) + 1

    def stats(self) -> dict:
        return {
            "port": self.port,
            "queries": dict(self.queries),
            "udp": {"counts": list(self.udp_counts),
                    "sum": round(self.udp_sum, 6)},
            "encode_cache": self.cache.stats(),
            "sheds": dict(self.sheds),
        }

    # -- the serve path ----------------------------------------------------

    def _handle_packet(self, data: bytes, reply: Callable[[bytes], None],
                       udp: bool) -> None:
        started = time.perf_counter()
        try:
            query = parse_query(data)
        except DnsFormatError as exc:
            malformed.note("dns")
            reply(build_formerr_response(exc.qid or 0))
            return
        except DnsError:
            malformed.note("dns")
            return
        limit = MAX_TCP_MSG
        if udp:
            limit = min(query.edns_size or MIN_UDP_PAYLOAD,
                        self.udp_payload_max)
        if query.qclass != CLASS_IN:
            reply(build_error_response(query, RCODE_REFUSED))
            self._count(query.qtype, RCODE_REFUSED, started)
            return
        if query.qtype not in SERVED_QTYPES:
            reply(build_error_response(query, RCODE_NOTIMP))
            self._count(query.qtype, RCODE_NOTIMP, started)
            return
        key = (query.lname, query.qtype)
        if self._stale_since is not None and \
                time.monotonic() - self._stale_since > self.stale_ttl:
            # The serve-stale window expired with authority still lost:
            # past this bound a stale answer is worse than SERVFAIL.
            self.cache.flush()
            self._stale_since = None
        template = self.cache.get(key)
        if template is not None:
            # The line-rate path: memcpy + id/0x20 patch + sendto.
            # Warm hits bypass the admission bounds on purpose.
            reply(render_from_template(template, query, limit))
            self._count(query.qtype, template[3] & 0x0F, started)
            return
        if self._bucket is not None and not self._bucket.admit():
            self._shed("rate_limited")
            reply(build_error_response(query, RCODE_REFUSED))
            self._count(query.qtype, RCODE_REFUSED, started)
            return
        if self._max_pending is not None and \
                len(self._pending) >= self._max_pending:
            self._shed("queue_full")
            reply(build_error_response(query, RCODE_REFUSED))
            self._count(query.qtype, RCODE_REFUSED, started)
            return
        task = asyncio.ensure_future(
            self._answer_miss(query, reply, limit, started))
        self._pending.add(task)
        task.add_done_callback(self._pending.discard)

    async def _answer_miss(self, query: DnsQuery, reply, limit: int,
                           started: float) -> None:
        fill = self.cache.fill_started(query.lname)
        try:
            resolution = await self._resolver(query.lname,
                                              QTYPE_NAMES[query.qtype])
            if resolution.empty:
                rcode = RCODE_NXDOMAIN if await self._is_absent(
                    query.lname) else RCODE_NOERROR
                template = build_negative_template(
                    query.lname, query.qtype, rcode, self.negative_ttl)
            else:
                rcode = RCODE_NOERROR
                template = build_answer_template(
                    query.lname, query.qtype, resolution)
            token, fill = fill, None
            self.cache.fill_done(token, (query.lname, query.qtype),
                                 template if self._cacheable() else None)
            reply(render_from_template(template, query, limit))
            self._count(query.qtype, rcode, started)
        except asyncio.CancelledError:
            raise
        except DnsRefused as exc:
            self._shed(exc.reason)
            reply(build_error_response(query, RCODE_REFUSED))
            self._count(query.qtype, RCODE_REFUSED, started)
        except Exception:
            reply(build_error_response(query, RCODE_SERVFAIL))
            self._count(query.qtype, RCODE_SERVFAIL, started)
        finally:
            if fill is not None:
                self.cache.fill_done(fill, (query.lname, query.qtype), None)

    def _cacheable(self) -> bool:
        # Only an authoritative (watch-armed) source can promise the
        # invalidation events that keep a template coherent.
        return self._source is not None and \
            getattr(self._source, "authoritative", False)

    async def _is_absent(self, lname: str) -> bool:
        """NXDOMAIN vs NODATA: does the base znode exist?  Rides the
        read source's negative cache (one live read, then watch-armed
        absence) when the source is a ZKCache."""
        if self._source is None:
            return True
        from . import records
        base = EncodeCache.base_domain(lname)
        if not base:
            return True
        try:
            node = await self._source.read_node(records.domain_to_path(base))
        except Exception:
            return True
        return node is None

    # -- transports --------------------------------------------------------

    async def _serve_tcp(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    hdr = await reader.readexactly(2)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                (length,) = _U16.unpack(hdr)
                if length < _DNS_HDR.size:
                    malformed.note("dns")
                    return
                body = await reader.readexactly(length)

                def reply(resp: bytes, _w=writer) -> None:
                    _w.write(_U16.pack(len(resp)) + resp)

                self._handle_packet(body, reply, udp=False)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            return
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass


class _UdpProtocol(asyncio.DatagramProtocol):
    def __init__(self, front: DnsFront):
        self._front = front
        self._transport = None

    def connection_made(self, transport):
        self._transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        transport = self._transport

        def reply(resp: bytes) -> None:
            if transport is not None:
                transport.sendto(resp, addr)

        self._front._handle_packet(data, reply, udp=True)

    def error_received(self, exc) -> None:
        pass


def reserve_port(host: str) -> socket.socket:
    """A TCP socket bound with ``SO_REUSEPORT`` on a port that was free
    for UDP and for TCP when it was picked.  It never listens, so it
    takes no connection; while it is open the kernel gives the port to
    no outgoing connection and to no socket without ``SO_REUSEPORT``,
    and the workers' listeners still join it.

    The picks bind without ``SO_REUSEPORT``: a UDP bind on port 0 that
    sets it may land on a port that another reuseport socket of the
    same user holds, and a TCP bind that sets it would join such a
    socket.  So a plain TCP probe tests the UDP pick first and is
    closed, and the reservation takes its place while the UDP pick is
    still held.  A probe or the reservation that finds the port taken
    on TCP (for example as an outgoing connection's local port) fails
    with EADDRINUSE, and the pick is made again, up to
    :data:`PORT_PICK_TRIES` times."""
    for _ in range(PORT_PICK_TRIES):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as udp:
            udp.bind((host, 0))
            port = udp.getsockname()[1]
            tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                with socket.socket(socket.AF_INET,
                                   socket.SOCK_STREAM) as probe:
                    probe.bind((host, port))
                if hasattr(socket, "SO_REUSEPORT"):
                    tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
                tcp.bind((host, port))
            except OSError as err:
                tcp.close()
                if err.errno != errno.EADDRINUSE:
                    raise
                taken = err
                log.warning("dns port %d is taken (%s); picking another",
                            port, err)
                continue
        return tcp
    raise taken


def allocate_port(host: str) -> int:
    """Resolve a configured port of 0 to a concrete port that was free
    for UDP and for TCP at the moment of the pick (:func:`reserve_port`,
    released at once).  The router does not release its pick: every
    worker must bind the SAME port for SO_REUSEPORT fan-out, so it
    holds :func:`reserve_port`'s socket until it stops."""
    sock = reserve_port(host)
    try:
        return sock.getsockname()[1]
    finally:
        sock.close()
