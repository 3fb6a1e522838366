"""Binder's view of the records: resolve DNS names from ZooKeeper state.

Binder (the DNS server, a separate repository) is the sole consumer of the
records registrar writes; its behavior is specified in the reference's
README ("ZooKeeper data format", README.md:443-757, and the host-record
type table at README.md:274-282).  This module implements that documented
resolution logic over our ZK client.  It is not a DNS server — it exists
so tests and operators can validate, end to end, that what registrar wrote
resolves to exactly the answers Binder would serve:

  * host-record lookups (``$zonename.$domain``) — A answers for the
    directly-queryable types only (``ops_host``/``rr_host`` resolve as if
    absent, README.md:284-287);
  * service lookups (``$domain``) — the children of the service node,
    filtered to the usable-under-service types (``db_host``/``host``
    excluded, README.md:289-293);
  * SRV lookups (``_svc._proto.$domain``) — one SRV per port per instance
    with A additionals, exactly the dig output shown at README.md:421-424;
  * the TTL precedence chains from "About TTLs" (README.md:680-757).

Used by the ``resolve`` subcommand of the zkcli operator tool and by
tests/test_binderview.py (which pins the README's worked dig examples).

Read source: every function takes any object exposing the two-call read
surface ``read_node(path)`` / ``get_many(paths)`` — a
:class:`~registrar_tpu_torch.zk.client.ZKClient` (live reads; the record get
and children listing ride ONE pipelined flush, so an uncached resolve
costs two round trips, not three) or a
:class:`~registrar_tpu_torch.zkcache.ZKCache` (watch-coherent memory; a warm
resolve touches the server zero times — the ``zkcli resolve --cached``
/ ``serve-view`` hot path).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any, Dict, List, Optional

from registrar_tpu_torch import trace
from registrar_tpu_torch.records import (
    HOST_RECORD_TYPES,
    domain_to_path,
    parse_payload,
)

#: Binder's fallback TTL when no record supplies one (typical deploys use
#: 30 s answers, reference README.md:87-89).
DEFAULT_TTL = 30

#: SRV priority/weight are fixed — "DNS SRV records also support weights,
#: but these are not supported by Registrar or Binder" (README.md:678).
SRV_PRIORITY = 0
SRV_WEIGHT = 10


@dataclass
class Answer:
    """One DNS answer (shape mirrors dig output lines)."""

    name: str
    rtype: str  # "A" | "SRV" | "TXT"
    ttl: int
    #: A: the IPv4 address.  SRV: "<prio> <weight> <port> <target>".
    data: str

    def __str__(self) -> str:
        return f"{self.name}. {self.ttl} IN {self.rtype} {self.data}"


@dataclass
class Resolution:
    answers: List[Answer] = field(default_factory=list)
    additionals: List[Answer] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.answers

    def to_wire_records(self):
        """Render to DNS wire form: ``(answers, additionals)`` as
        ``(name, type_code, ttl, rdata_bytes)`` tuples.  THE one RR
        renderer — the dnsfront encode cache and ``zkcli dig`` both
        come through here (the ``registration_payloads`` precedent:
        one stable hook instead of two drifting copies)."""
        from registrar_tpu_torch import dnsfront

        return dnsfront.wire_records(self)


def _host_ttl(record: Dict[str, Any]) -> int:
    """A-record TTL for a host record: inner ttl, then top-level ttl
    (README.md:692-697)."""
    inner = record.get(record.get("type"), {})
    if isinstance(inner, dict) and isinstance(inner.get("ttl"), int):
        return inner["ttl"]
    if isinstance(record.get("ttl"), int):
        return record["ttl"]
    return DEFAULT_TTL


def _service_ttl(record: Dict[str, Any]) -> int:
    """SRV TTL for a service record: service.service.ttl, then service.ttl,
    then top-level ttl (README.md:744-750)."""
    svc = record.get("service")
    if isinstance(svc, dict):
        inner = svc.get("service")
        if isinstance(inner, dict) and isinstance(inner.get("ttl"), int):
            return inner["ttl"]
        if isinstance(svc.get("ttl"), int):
            return svc["ttl"]
    if isinstance(record.get("ttl"), int):
        return record["ttl"]
    return DEFAULT_TTL


@lru_cache(maxsize=8192)
def _record_from_bytes(data: bytes) -> Optional[Dict[str, Any]]:
    """Parse a znode payload into a record dict (None when unusable).

    Memoized on the payload bytes: the watch-coherent cache serves the
    same payload object for every warm resolve, and re-running
    ``json.loads`` over 50 instance records per DNS answer would
    dominate the in-memory hot path.  Consumers treat the returned dict
    as immutable (every reader here only ``.get``s); a changed record
    arrives as fresh bytes and misses the memo.
    """
    if not data:
        return None
    try:
        record = parse_payload(data)
    except ValueError:
        return None
    return record if isinstance(record, dict) else None


def _queryable_directly(rtype: str) -> bool:
    entry = HOST_RECORD_TYPES.get(rtype)
    return bool(entry and entry[0])


def _usable_for_service(rtype: str) -> bool:
    entry = HOST_RECORD_TYPES.get(rtype)
    return bool(entry and entry[1])


def _host_address(record: Dict[str, Any]) -> Optional[str]:
    inner = record.get(record.get("type"), {})
    if isinstance(inner, dict) and isinstance(inner.get("address"), str):
        return inner["address"]
    return None


async def _service_instances(src, path: str, children: List[str]):
    """Fetch the usable child host records of a service node (one
    pipelined getData burst — one write and one reply sweep, not N
    task-scheduled round-trips; zero round trips from a warm cache)."""
    replies = await src.get_many(f"{path}/{child}" for child in children)
    records = [
        None if reply is None else _record_from_bytes(reply[0])
        for reply in replies
    ]
    instances = []
    for child, rec in zip(children, records):
        if rec is None or rec.get("type") == "service":
            continue
        if not _usable_for_service(rec.get("type", "")):
            continue
        addr = _host_address(rec)
        if addr is None:
            continue
        instances.append((child, rec, addr))
    return instances


async def resolve_a(src, name: str) -> Resolution:
    """Answer an A query for ``name`` the way Binder would."""
    name = name.rstrip(".").lower()
    path = domain_to_path(name)
    node = await src.read_node(path)
    res = Resolution()
    if node is None:
        return res
    data, _stat, children = node
    record = _record_from_bytes(data)
    if record is None:
        return res

    rtype = record.get("type")
    if rtype != "service":
        # Direct host-record lookup (README.md:547-552).
        if not _queryable_directly(rtype or ""):
            return res  # behaves as though it weren't there (README:284-287)
        addr = _host_address(record)
        if addr is not None:
            res.answers.append(Answer(name, "A", _host_ttl(record), addr))
        return res

    # Service lookup: one A per usable instance (README.md:522-534); the
    # A TTL is min(service-chain TTL, host-record TTL) (README.md:752-757).
    svc_ttl = _service_ttl(record)
    for _child, rec, addr in await _service_instances(src, path, children):
        res.answers.append(Answer(name, "A", min(svc_ttl, _host_ttl(rec)), addr))
    return res


async def resolve_srv(src, name: str) -> Resolution:
    """Answer an SRV query (``_service._proto.domain``) the way Binder would.

    Produces one SRV per port per instance plus A additionals for the
    instance names (README.md:406-424).
    """
    name = name.rstrip(".").lower()
    labels = name.split(".")
    res = Resolution()
    if len(labels) < 3 or not (
        labels[0].startswith("_") and labels[1].startswith("_")
    ):
        return res
    srvce, proto = labels[0], labels[1]
    domain = ".".join(labels[2:])
    path = domain_to_path(domain)
    node = await src.read_node(path)
    if node is None:
        return res
    data, _stat, children = node
    record = _record_from_bytes(data)
    if record is None or record.get("type") != "service":
        return res
    svc = record.get("service", {})
    inner = svc.get("service", {}) if isinstance(svc, dict) else {}
    if not isinstance(inner, dict):
        return res  # malformed record: resolve as absent, don't crash
    if inner.get("srvce") != srvce or inner.get("proto") != proto:
        return res

    svc_ttl = _service_ttl(record)
    default_port = inner.get("port")
    for child, rec, addr in await _service_instances(src, path, children):
        target = f"{child}.{domain}"
        rec_inner = rec.get(rec.get("type"), {})
        ports = rec_inner.get("ports") if isinstance(rec_inner, dict) else None
        if not isinstance(ports, list) or not ports:
            # "port to use for SRV answers when a child host record does
            # not contain its own array of ports" (README.md:370-372)
            ports = [default_port] if default_port is not None else []
        if not ports:
            continue  # no SRV answers for this instance -> no orphan A
        for port in ports:
            res.answers.append(
                Answer(
                    name, "SRV", svc_ttl,
                    f"{SRV_PRIORITY} {SRV_WEIGHT} {port} {target}.",
                )
            )
        res.additionals.append(Answer(target, "A", _host_ttl(rec), addr))
    return res


async def resolve_txt(src, name: str) -> Resolution:
    """Answer a TXT query for ``name``.

    Rebuild extension (the reference Binder serves TXT from the same
    records; our subset): a node that exists and parses answers one TXT
    string ``registrar-type=<type>`` — the operator-facing "what kind
    of record is actually behind this name" probe `zkcli dig -t TXT`
    uses.  TTL follows the host chain (top-level ttl, else default).
    """
    name = name.rstrip(".").lower()
    node = await src.read_node(domain_to_path(name))
    res = Resolution()
    if node is None:
        return res
    record = _record_from_bytes(node[0])
    if record is None or not isinstance(record.get("type"), str):
        return res
    ttl = record["ttl"] if isinstance(record.get("ttl"), int) else DEFAULT_TTL
    res.answers.append(
        Answer(name, "TXT", ttl, f"registrar-type={record['type']}")
    )
    return res


async def resolve(src, name: str, qtype: str = "A") -> Resolution:
    """Resolve ``name`` for query type ``qtype`` ("A", "SRV" or "TXT").

    ``src`` is the read source: a connected
    :class:`~registrar_tpu_torch.zk.client.ZKClient` for live answers, or a
    :class:`~registrar_tpu_torch.zkcache.ZKCache` for the in-memory hot path.
    """
    qtype = qtype.upper()
    if qtype not in ("A", "SRV", "TXT"):
        raise ValueError(f"unsupported query type: {qtype}")
    # source: "cached" only while a ZKCache is actually serving from
    # memory (a degraded cache falls through to live reads and is
    # honestly labeled "live"); a plain ZKClient has no `authoritative`
    # and always reads live.
    with trace.tracer_for(src).span(
        "resolve.query",
        qtype=qtype,
        source=(
            "cached" if getattr(src, "authoritative", False) else "live"
        ),
    ):
        if qtype == "A":
            return await resolve_a(src, name)
        if qtype == "TXT":
            return await resolve_txt(src, name)
        return await resolve_srv(src, name)
