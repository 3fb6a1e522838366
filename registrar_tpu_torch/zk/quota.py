"""ZooKeeper quota layout and wire format (shared by server and CLI).

Real ZooKeeper 3.4 stores soft quotas as znodes:
``/zookeeper/quota/<target>/zookeeper_limits`` holds ``count=N,bytes=B``
(-1 = unlimited) and the server maintains live usage next to it in
``.../zookeeper_stats``.  Violations are logged, never enforced.  One
definition here keeps the test server and zkcli's
setquota/listquota/delquota agreeing on the format.
"""

from __future__ import annotations

from typing import Dict

#: root of ZooKeeper's bookkeeping subtree (pre-created like real ZK's
#: DataTree does)
QUOTA_ROOT = "/zookeeper/quota"
LIMITS_LEAF = "zookeeper_limits"
STATS_LEAF = "zookeeper_stats"


def parse_quota(data: bytes) -> Dict[str, int]:
    """Parse ``count=N,bytes=B`` (missing/garbled fields read as -1 =
    unlimited, matching StatsTrack's leniency)."""
    out = {"count": -1, "bytes": -1}
    for part in data.decode("utf-8", "replace").split(","):
        key, _, val = part.partition("=")
        key = key.strip()
        if key in out:
            try:
                out[key] = int(val)
            except ValueError:
                pass
    return out


def format_quota(count: int, nbytes: int) -> bytes:
    return f"count={count},bytes={nbytes}".encode()
