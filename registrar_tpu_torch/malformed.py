"""Malformed-peer-frame accounting — the decode boundary's tally.

Every decode surface rejects hostile or corrupt input by raising its
contract error (``JuteError``, ``ConnectionError``, ``ShardError`` —
docs/FAULTS.md), and generation 5 of the checker proves the bound
checks behind those rejections.  What the contract errors do NOT give
an operator is a rate: a peer spraying garbage at the shard socket
shows up only as connection churn in the logs.  This module is the
zero-dependency tally the decode modules can afford to import (they
sit below metrics.py in the layering):

  * :func:`note` is called at each decode-REJECT site — the exact
    statements that raise on a bad length/count/frame;
  * ``instrument()`` (metrics.py) subscribes a
    ``registrar_malformed_frames_total{surface}`` counter, pre-seeded
    per surface so the alert rate() sees a zero series from the first
    scrape (docs/OPERATIONS.md).

An "unknown op" on a well-formed shard frame is deliberately NOT noted
— the frame decoded fine; version skew is not an attack signal.
"""

from __future__ import annotations

from typing import Callable, Dict, List

#: One label value per decode surface: jute deserialization, the ZK
#: client/server frame buffer, the ZK client handshake, the shard
#: router/worker wire protocol, the DNS frontend's packet codec.
SURFACES = ("jute", "zk_framing", "zk_client", "shard", "dns")

_counts: Dict[str, int] = {surface: 0 for surface in SURFACES}
_subscribers: List[Callable[[str], None]] = []


def note(surface: str) -> None:
    """Record one rejected frame/field on ``surface``.  Total: an
    unknown surface is ignored rather than raised — this sits on error
    paths that must stay on their contract-exception rails, and a raise
    here would turn a counting typo into a dead handler task (the tests
    pin the SURFACES vocabulary instead)."""
    if surface in _counts:
        _counts[surface] += 1
        for fn in list(_subscribers):
            fn(surface)


def counts() -> Dict[str, int]:
    """Snapshot of per-surface reject counts (process lifetime)."""
    return dict(_counts)


def subscribe(fn: Callable[[str], None]) -> Callable[[], None]:
    """Call ``fn(surface)`` on every future :func:`note`; returns the
    unsubscribe callable (tests pair them to stay isolated)."""
    _subscribers.append(fn)

    def unsubscribe() -> None:
        if fn in _subscribers:
            _subscribers.remove(fn)

    return unsubscribe
