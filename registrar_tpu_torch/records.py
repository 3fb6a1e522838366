"""Service-discovery record construction — the ZooKeeper data contract.

This module is the single source of truth for the JSON payloads registrar
writes into ZooKeeper and the path-mapping scheme, i.e. the contract between
registrar and Binder (the DNS server that reads these records).

Contract sources in the reference (do not change without consulting both):
  * reference lib/register.js:34-39  (domainToPath)
  * reference lib/register.js:132-171 (host record construction)
  * reference lib/register.js:45-75  (service record construction)
  * reference README.md, section "ZooKeeper data format" (README.md:443-757)

Everything here is a pure function; serialization is deliberately pinned to
the reference's observable output: Node's ``JSON.stringify`` with no
whitespace, object keys in insertion order, ``undefined`` members omitted.
``payload_bytes`` reproduces that byte-for-byte (golden tests in
tests/test_records.py assert against the README examples).
"""

from __future__ import annotations

import json
import socket
from typing import Any, Iterable, Mapping, Optional

#: Host-record subtypes understood by Binder, with their semantics
#: (direct-query vs usable-under-a-service), per reference README.md:274-282.
#: The vestigial "database" type (historically written by Manatee) is
#: intentionally not listed; it is neither produced nor consumed any more.
HOST_RECORD_TYPES = {
    #  type           (queried directly?, usable for service?)
    "db_host": (True, False),
    "host": (True, False),
    "load_balancer": (True, True),
    "moray_host": (True, True),
    "ops_host": (False, True),
    "redis_host": (True, True),
    "rr_host": (False, True),
}

#: Default TTL (seconds) injected into the inner service object when the
#: configuration does not specify one (reference lib/register.js:197).
DEFAULT_SERVICE_TTL = 60


def domain_to_path(domain: str) -> str:
    """Map a DNS domain to its ZooKeeper path.

    The domain's labels are reversed, lowercased, and joined with "/":
    ``1.moray.us-east.joyent.com`` -> ``/com/joyent/us-east/moray/1``
    (reference lib/register.js:34-39, README.md:462-469).
    """
    if not isinstance(domain, str) or not domain:
        raise ValueError("domain must be a non-empty string")
    return "/" + "/".join(reversed(domain.lower().split(".")))


def path_to_domain(path: str) -> str:
    """Inverse of :func:`domain_to_path` (rebuild addition, used by tooling)."""
    parts = [p for p in path.split("/") if p]
    return ".".join(reversed(parts))


def default_address() -> str:
    """Pick this host's first non-loopback IPv4 address.

    Fallback used only when the configuration provides no ``adminIp``
    (reference lib/register.js:22-31); the reference README explicitly
    recommends always configuring ``adminIp`` instead (README.md:180-186).
    """
    # Ask the routing table which source address would be used for an
    # outbound packet; no traffic is actually sent for SOCK_DGRAM connect.
    # (Any routable destination works; RFC 5737 TEST-NET-3 address used.)
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("203.0.113.1", 9))
            addr = s.getsockname()[0]
            if addr and not addr.startswith("127."):
                return addr
    except OSError:
        pass
    # Last resort: resolve our own hostname.
    try:
        addr = socket.gethostbyname(socket.gethostname())
        if addr and not addr.startswith("127."):
            return addr
    except OSError:
        pass
    # Refuse to register a loopback address into DNS — remote clients would
    # connect to themselves.  (The reference crashes on this path too, via
    # addrs[0] of an empty array, lib/register.js:22-31.)
    raise RuntimeError(
        "no non-loopback IPv4 address found; configure adminIp explicitly"
    )


def host_record(
    rtype: str,
    address: str,
    ttl: Optional[int] = None,
    ports: Optional[Iterable[int]] = None,
) -> dict:
    """Build a host record (the payload of an ephemeral per-instance znode).

    Shape (reference lib/register.js:139-155, README.md:585-636)::

        {
          "type": <rtype>,
          "address": <ip>,          # top-level address: unused by Binder,
                                    # kept for wire compatibility
          "ttl": <int>,             # omitted when not configured
          <rtype>: {
            "address": <ip>,
            "ports": [<int>, ...]   # omitted when not configured
          }
        }

    Key order matters for byte-exact parity and matches the reference's
    object-literal insertion order.
    """
    if not isinstance(rtype, str) or not rtype:
        raise ValueError("record type must be a non-empty string")
    if rtype == "service":
        raise ValueError('"service" is not a host-record type')
    rec: dict = {"type": rtype, "address": address}
    if ttl is not None:
        rec["ttl"] = ttl
    inner: dict = {"address": address}
    if ports is not None:
        inner["ports"] = list(ports)
    rec[rtype] = inner
    return rec


def service_record(service: Mapping[str, Any]) -> dict:
    """Build a service record (the payload of the persistent domain znode).

    ``service`` is the validated ``registration.service`` object from the
    configuration; shape of the result (reference lib/register.js:58-61,
    README.md:638-678)::

        {
          "type": "service",
          "service": {
            "type": "service",
            "service": {"srvce": ..., "proto": ..., "port": ..., "ttl": ...},
            ...any additional configured members (e.g. an outer "ttl")...
          }
        }

    The inner ``service.service.ttl`` is defaulted to 60 when absent, exactly
    as the reference does during validation (lib/register.js:197) — the
    default is *appended* to the inner object so key order matches a config
    that did not specify it.
    """
    svc = _validate_service(service)
    return {"type": "service", "service": svc}


def _validate_service(service: Mapping[str, Any]) -> dict:
    """Validate + normalize a ``registration.service`` config object.

    Mirrors the reference's assert-plus schema (lib/register.js:188-200):
    ``type`` must be the string "service"; ``service.srvce`` and
    ``service.proto`` are required strings; ``service.port`` a required
    number; ``service.ttl`` an optional number defaulted to 60.  Returns a
    deep copy; never mutates the caller's config (the reference mutates it
    in place — a wart, not contract).
    """
    if not isinstance(service, Mapping):
        raise ValueError("registration.service must be an object")
    if service.get("type") != "service":
        raise ValueError('registration.service.type must be "service"')
    inner = service.get("service")
    if not isinstance(inner, Mapping):
        raise ValueError("registration.service.service must be an object")
    if not isinstance(inner.get("srvce"), str):
        raise ValueError("registration.service.service.srvce must be a string")
    if not isinstance(inner.get("proto"), str):
        raise ValueError("registration.service.service.proto must be a string")
    if not isinstance(inner.get("port"), (int, float)) or isinstance(
        inner.get("port"), bool
    ):
        raise ValueError("registration.service.service.port must be a number")
    # Explicit null is rejected, matching the reference's assert-plus
    # optionalNumber (which only tolerates an *absent* member).
    if "ttl" in inner and (
        not isinstance(inner["ttl"], (int, float)) or isinstance(inner["ttl"], bool)
    ):
        raise ValueError("registration.service.service.ttl must be a number")

    svc = {k: (dict(v) if isinstance(v, Mapping) else v) for k, v in service.items()}
    if "ttl" not in svc["service"]:
        svc["service"]["ttl"] = DEFAULT_SERVICE_TTL
    return svc


def payload_bytes(record: Mapping[str, Any]) -> bytes:
    """Serialize a record exactly as the reference stack does.

    zkplus writes ``JSON.stringify(obj)``: UTF-8, no whitespace, insertion
    key order.  ``json.dumps`` with compact separators over Python's
    order-preserving dicts reproduces this byte-for-byte.
    """
    return json.dumps(record, separators=(",", ":"), ensure_ascii=False).encode("utf-8")


def parse_payload(data: bytes) -> Any:
    """Parse a znode payload written by registrar (or by the reference)."""
    return json.loads(data.decode("utf-8"))
