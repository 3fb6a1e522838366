"""Bunyan-compatible structured JSON logging.

The reference logs bunyan records to stdout (reference main.js:23-28), and
downstream Triton/Manta log tooling (`bunyan` CLI, log shippers) consumes
that shape.  This module makes Python's stdlib logging emit the same
format so existing operational tooling keeps working::

    {"v":0,"level":30,"name":"registrar","hostname":"...","pid":123,
     "time":"2026-07-29T12:00:00.000Z","msg":"...", ...extra fields...}

Level mapping (bunyan numeric levels, main.js/-v escalation semantics):

    TRACE=10  DEBUG=20  INFO=30  WARN=40  ERROR=50  FATAL=60

Python's logging has no TRACE/FATAL; they are registered here.  Extra
structured fields ride on ``logging``'s ``extra=`` dict via the ``zdata``
key: ``log.info("registered", extra={"zdata": {"znodes": [...]}})``.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import sys
import time
from typing import Any, Dict, Mapping, Optional

TRACE = 5  # python numeric; rendered as bunyan 10
FATAL = logging.CRITICAL  # rendered as bunyan 60

logging.addLevelName(TRACE, "TRACE")

#: python level -> bunyan level
_BUNYAN_LEVELS = [
    (logging.CRITICAL, 60),
    (logging.ERROR, 50),
    (logging.WARNING, 40),
    (logging.INFO, 30),
    (logging.DEBUG, 20),
    (TRACE, 10),
]

#: bunyan level name -> python level (config logLevel / LOG_LEVEL env)
LEVELS: Dict[str, int] = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}


def _bunyan_level(py_level: int) -> int:
    for py, bun in _BUNYAN_LEVELS:
        if py_level >= py:
            return bun
    return 10


class BunyanFormatter(logging.Formatter):
    def __init__(self, name: str = "registrar"):
        super().__init__()
        self.name = name
        self.hostname = socket.gethostname()

    def format(self, record: logging.LogRecord) -> str:
        rec: Dict[str, Any] = {
            "name": self.name,
            "hostname": self.hostname,
            "pid": record.process,
            "component": record.name,
            "level": _bunyan_level(record.levelno),
            "msg": record.getMessage(),
            "time": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            )
            + f".{int(record.msecs):03d}Z",
            "v": 0,
        }
        if logging.getLogger(record.name).getEffectiveLevel() <= logging.DEBUG:
            # bunyan's `src: true` — caller provenance once debugging is on
            # (the reference enables it the same way, main.js:75-76).
            rec["src"] = {
                "file": record.pathname,
                "line": record.lineno,
                "func": record.funcName,
            }
        # Trace correlation: the TraceContextFilter (installed
        # only when the `observability` block enables tracing) stamps
        # these attributes; without it nothing is set and the output is
        # byte-identical to untraced builds.
        trace_id = getattr(record, "trace_id", None)
        if trace_id is not None:
            rec["trace_id"] = trace_id
            rec["span_id"] = getattr(record, "span_id", None)
        zdata = getattr(record, "zdata", None)
        if isinstance(zdata, Mapping):
            for key, value in zdata.items():
                rec.setdefault(key, _jsonable(value))
        if record.exc_info and record.exc_info[1] is not None:
            err = record.exc_info[1]
            rec["err"] = {
                "message": str(err),
                "name": type(err).__name__,
                "stack": self.formatException(record.exc_info),
            }
        return json.dumps(rec, separators=(",", ":"), ensure_ascii=False,
                          default=str)


def _jsonable(value: Any) -> Any:
    if isinstance(value, BaseException):
        return {"message": str(value), "name": type(value).__name__}
    return value


def setup(
    name: str = "registrar",
    level: Optional[int] = None,
    stream=None,
) -> logging.Logger:
    """Configure root logging for the daemon: one bunyan line per record.

    Level resolution order (reference main.js:24,66-76): explicit ``level``
    arg > ``LOG_LEVEL`` env > info.
    """
    if level is None:
        env = os.environ.get("LOG_LEVEL", "").lower()
        level = LEVELS.get(env, logging.INFO)
    handler = logging.StreamHandler(stream or sys.stdout)
    handler.setFormatter(BunyanFormatter(name))
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)
    return logging.getLogger(name)


def escalate(levels: int) -> int:
    """Apply ``-v`` escalation: each -v drops the root level by one notch
    toward TRACE (reference main.js:69-73)."""
    order = [logging.CRITICAL, logging.ERROR, logging.WARNING, logging.INFO,
             logging.DEBUG, TRACE]
    root = logging.getLogger()
    current = root.level
    idx = min(
        range(len(order)), key=lambda i: abs(order[i] - current)
    )
    new = order[min(idx + levels, len(order) - 1)]
    root.setLevel(new)
    return new
