"""A minimal event emitter for asyncio code.

The reference's public surfaces are Node EventEmitters (lib/index.js:38,
main.js:160-198, zkplus client events); this is the idiomatic-Python
equivalent used by :mod:`registrar_tpu_torch.zk.client` and
:mod:`registrar_tpu_torch.agent`.  Listeners may be plain callables or coroutine
functions; coroutine listeners are scheduled as tasks on the running loop.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
from collections import defaultdict
from typing import Any, Callable, Dict, List

log = logging.getLogger("registrar_tpu_torch.events")

#: Strong references to in-flight coroutine-listener tasks.  The event
#: loop only weak-references running tasks, so the bare create_task()
#: handle emit() used to discard could be garbage-collected mid-dispatch
#: (the checker's dropped-task rule now flags exactly that).
_DISPATCH_TASKS: set = set()

#: The loop the last spawn_owned ran on — stranded-task eviction only
#: needs to run when this changes (see spawn_owned).
_LAST_SPAWN_LOOP = None


def spawn_owned(coro, registry: set) -> "asyncio.Task":
    """Run ``coro`` as a task strongly held by ``registry`` until done.

    THE one copy of the fire-and-forget ownership idiom the dropped-task
    rule enforces (the loop only weak-references running tasks).  The
    caller owns ``registry`` and decides the shutdown policy: the test
    server cancels its set in stop(); emit()'s dispatch tasks are never
    cancelled, because listeners for terminal events (``close``, ``end``)
    must still run while their emitter is being torn down.
    """
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        # No loop: close the already-built coroutine so the clean
        # RuntimeError isn't followed by a 'never awaited' warning.
        coro.close()
        raise
    # Evict tasks stranded by a loop that closed without draining them
    # (their done-callbacks can never fire).  Only the module-global
    # dispatch set needs this — it outlives every loop, while per-owner
    # registries die with their owners — and stranded entries can only
    # appear across a loop change, so the O(registry) scan is skipped
    # on the steady single-loop hot path (emit()'s listener dispatch).
    global _LAST_SPAWN_LOOP
    if registry is _DISPATCH_TASKS and _LAST_SPAWN_LOOP is not loop:
        for t in [t for t in registry if t.get_loop().is_closed()]:
            registry.discard(t)
        _LAST_SPAWN_LOOP = loop
    task = loop.create_task(coro)
    registry.add(task)
    task.add_done_callback(registry.discard)
    return task


class EventEmitter:
    def __init__(self) -> None:
        self._listeners: Dict[str, List[Callable]] = defaultdict(list)
        self._once: Dict[str, List[Callable]] = defaultdict(list)

    def on(self, event: str, listener: Callable) -> Callable:
        """Register ``listener`` for ``event``; returns it (decorator-friendly)."""
        self._listeners[event].append(listener)
        return listener

    def once(self, event: str, listener: Callable) -> Callable:
        self._once[event].append(listener)
        return listener

    def off(self, event: str, listener: Callable) -> None:
        for registry in (self._listeners, self._once):
            if listener in registry.get(event, []):
                registry[event].remove(listener)
            if event in registry and not registry[event]:
                # drop the empty key: per-path watch listeners come and
                # go for the process lifetime (zkcache churn), and a
                # leftover empty list per path ever watched is a slow
                # leak in the client's _watch_emitter
                del registry[event]

    def listener_count(self, event: str) -> int:
        return len(self._listeners.get(event, [])) + len(self._once.get(event, []))

    def emit(self, event: str, *args: Any) -> int:
        """Dispatch ``event``; returns the number of listeners invoked."""
        targets = list(self._listeners.get(event, []))
        once = self._once.pop(event, [])
        targets.extend(once)
        for listener in targets:
            try:
                result = listener(*args)
                if inspect.isawaitable(result):
                    try:
                        spawn_owned(_guard(event, result), _DISPATCH_TASKS)
                    except RuntimeError:
                        # No running loop: spawn_owned closed the _guard
                        # wrapper, but the listener coroutine it would
                        # have awaited needs closing too, or GC warns
                        # 'coroutine was never awaited'.
                        if inspect.iscoroutine(result):
                            result.close()
                        raise
            except Exception:
                log.exception("listener for %r raised", event)
        return len(targets)

    async def wait_for(self, event: str, timeout: float = 30.0) -> tuple:
        """Await the next emission of ``event``; returns its args (test aid)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self.once(event, lambda *a: fut.done() or fut.set_result(a))
        return await asyncio.wait_for(fut, timeout)


async def _guard(event: str, awaitable) -> None:
    try:
        await awaitable
    except Exception:
        log.exception("async listener for %r raised", event)
