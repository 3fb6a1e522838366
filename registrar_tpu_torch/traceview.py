"""Cross-process trace assembly: fragments in, ONE causal tree out.

The tracer gives every process a span layer and a flight recorder; the
sharded tier makes the serve path multi-process — and a resolve crossing ShardRouter →
ShardWorker → ZooKeeper now leaves its spans scattered across three
recorders.  The shard protocol's trace-context extension
(:mod:`registrar_tpu_torch.shard`) makes every fragment share ONE trace id and
honest parent ids; this module is the other half — it merges dumped
flight-recorder entries from any number of processes and reconstructs
the parent tree:

  * **spans** are joined by ``span_id``/``parent_id`` across process
    boundaries (the ids are process-independent 64-bit tokens);
  * **duplicates** are dropped by span id, first occurrence wins — the
    collector may legitimately hand the same recorder in twice (the
    router's own tracer is also the SLO harness's tracer);
  * **orphans** — spans whose parent id was never collected (the parent
    process crashed, its ring evicted the span, or the parent was
    unsampled) — attach under a synthetic :data:`MISSING_PARENT` node
    instead of silently vanishing.  A crashed worker must not erase the
    subtree that survived it; an incomplete tree that SAYS it is
    incomplete is evidence, a quietly-pruned one is a lie;
  * **events** carrying the trace id ride along in timestamp order
    (they have no parent ids; they annotate the trace, not the tree).

Consumed by :meth:`registrar_tpu_torch.shard.ShardRouter.collect_trace` (the
``OP_TRACE`` fan-out behind ``GET /debug/trace?id=`` and ``zkcli trace
--id``), by the daemon's own single-process ``?id=`` view (main.py),
and by the SLO report's worst-outage dump (testing/slo.py).  The future
DNS frontend inherits this unchanged: a DNS query id maps onto the same
trace id and lands in the same tree.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

#: the synthetic node orphaned subtrees hang under — a NAME, not a span
#: id, so renderers and tests can key on it (docs/OBSERVABILITY.md
#: documents the convention)
MISSING_PARENT = "<missing parent>"


def _node(entry: Dict[str, Any]) -> Dict[str, Any]:
    node = dict(entry)
    node["children"] = []
    return node


def _sort_key(node: Dict[str, Any]):
    return (node.get("time") or 0.0, node.get("span_id") or "")


def assemble(
    entries: Iterable[Dict[str, Any]], trace_id: str
) -> Dict[str, Any]:
    """Merge flight-recorder ``entries`` (possibly from many processes,
    possibly overlapping) into one trace tree for ``trace_id``.

    Returns ``{"trace_id", "spans", "events", "orphans", "roots",
    "events_list"}`` where ``roots`` is a list of span nodes (each with
    recursive ``children``, time-ordered) — the last root is the
    synthetic :data:`MISSING_PARENT` node when any span's parent was
    not collected.
    """
    spans: Dict[str, Dict[str, Any]] = {}
    events: List[Dict[str, Any]] = []
    seen_events: set = set()
    for entry in entries:
        if entry.get("trace_id") != trace_id:
            continue
        if entry.get("kind") == "event":
            # Events carry no ids; dedupe overlapping dumps by their
            # FULL observable identity (name, timestamp, origin, attrs)
            # so a recorder handed in twice cannot double-count them —
            # while two distinct same-named events that merely share a
            # coarse-clock timestamp keep their separate attrs.
            key = (
                entry.get("name"),
                entry.get("time"),
                entry.get("proc"),
                repr(sorted((entry.get("attrs") or {}).items())),
            )
            if key in seen_events:
                continue
            seen_events.add(key)
            events.append(dict(entry))
            continue
        span_id = entry.get("span_id")
        if span_id is None or span_id in spans:
            continue  # duplicate fragment: first occurrence wins
        spans[span_id] = _node(entry)

    roots: List[Dict[str, Any]] = []
    orphaned: List[Dict[str, Any]] = []
    for node in spans.values():
        parent_id = node.get("parent_id")
        if parent_id is None:
            roots.append(node)
        elif parent_id in spans:
            spans[parent_id]["children"].append(node)
        else:
            orphaned.append(node)

    for node in spans.values():
        node["children"].sort(key=_sort_key)
    roots.sort(key=_sort_key)
    events.sort(key=lambda e: e.get("time") or 0.0)

    if orphaned:
        orphaned.sort(key=_sort_key)
        roots.append(
            {
                "kind": "span",
                "name": MISSING_PARENT,
                "trace_id": trace_id,
                "span_id": None,
                "parent_id": None,
                "synthetic": True,
                "children": orphaned,
            }
        )
    return {
        "trace_id": trace_id,
        "spans": len(spans),
        "events": len(events),
        "orphans": len(orphaned),
        "roots": roots,
        "events_list": events,
    }


def _fmt_span(node: Dict[str, Any]) -> str:
    if node.get("synthetic"):
        return f"{node['name']}  (parent span never collected)"
    dur = node.get("duration_ms")
    dur_s = f"{dur:.3f}ms" if isinstance(dur, (int, float)) else "?"
    bits = [f"{node.get('name')}  {dur_s}  [{node.get('status', '?')}]"]
    proc = node.get("proc")
    if proc:
        bits.append(f"@{proc}")
    attrs = node.get("attrs") or {}
    if attrs:
        bits.append(
            " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        )
    marks = node.get("marks") or {}
    if marks:
        bits.append(
            "marks: "
            + " ".join(f"{k}={v}ms" for k, v in sorted(marks.items()))
        )
    return "  ".join(bits)


def render_text(tree: Dict[str, Any]) -> str:
    """The operator view: one indented line per span, durations and
    marks inline, orphan subtrees visibly flagged — what ``zkcli trace
    --id`` prints and the SLO worst-outage dump ships next to
    slo-report.json."""
    lines = [
        f"trace {tree['trace_id']}: {tree['spans']} spans, "
        f"{tree['events']} events"
        + (f", {tree['orphans']} orphaned" if tree.get("orphans") else "")
    ]

    def walk(node: Dict[str, Any], depth: int) -> None:
        lines.append("  " * depth + _fmt_span(node))
        for child in node.get("children", ()):
            walk(child, depth + 1)

    for root in tree.get("roots", ()):
        walk(root, 1)
    for event in tree.get("events_list", ()):
        attrs = event.get("attrs") or {}
        suffix = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        lines.append(f"  event {event.get('name')}  {suffix}".rstrip())
    return "\n".join(lines)


def worst_span_ms(tree: Dict[str, Any]) -> Optional[float]:
    """The longest span duration in the tree (report rollups)."""
    worst: Optional[float] = None

    def walk(node: Dict[str, Any]) -> None:
        nonlocal worst
        dur = node.get("duration_ms")
        if isinstance(dur, (int, float)) and (worst is None or dur > worst):
            worst = dur
        for child in node.get("children", ()):
            walk(child)

    for root in tree.get("roots", ()):
        walk(root)
    return worst
