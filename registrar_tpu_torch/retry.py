"""Exponential-backoff retry, mirroring the reference's `backoff` library use.

Two policies exist in the reference and both are preserved exactly
(BASELINE.md):

  * initial ZK connect: infinite attempts, exponential 1 s -> 90 s
    (reference lib/zk.js:97-101)
  * application heartbeat: 5 attempts, exponential 1 s -> 30 s
    (reference lib/zk.js:38-42)

Delay schedule matches node-backoff's ExponentialStrategy: the first retry
waits ``initial_delay``, each subsequent retry doubles it, capped at
``max_delay``.

Beyond the reference, two robustness layers ride here:

  * **Decorrelated jitter** (``jitter="decorrelated"``): pure doubling makes
    every client of a restarted ensemble reconnect in lockstep — N workers
    all retry at t+1, t+3, t+7, ... and the herd re-stampedes the servers at
    each step.  The decorrelated schedule (AWS architecture blog's
    "Exponential Backoff And Jitter") draws each delay uniformly from
    ``[initial_delay, 3 * previous_delay]`` capped at ``max_delay``, so
    retries spread out instead of synchronizing.  :data:`RECONNECT_RETRY`
    adopts it for the client's default *reconnect* policy; the initial
    connect (:data:`CONNECT_RETRY`) keeps the reference's exact schedule.
  * **Error classification** (:func:`is_transient`): the predicate the
    retry layers share for "could retrying possibly help?" — connection
    loss, per-operation timeouts, and plain socket errors are transient;
    SESSION_EXPIRED (and every other ZooKeeper semantic error) is not.
"""

from __future__ import annotations

import asyncio
import math
import random
from dataclasses import dataclass
from typing import Awaitable, Callable, Iterator, Optional, TypeVar

from registrar_tpu_torch.zk.protocol import Err, ZKError

T = TypeVar("T")

#: jitter modes accepted by :class:`RetryPolicy`
JITTER_MODES = ("none", "decorrelated")


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: float = 5  # math.inf for unbounded
    initial_delay: float = 1.0  # seconds
    max_delay: float = 30.0  # seconds
    #: "none" = the reference's pure doubling; "decorrelated" = each delay
    #: drawn from [initial_delay, 3 * previous] capped at max_delay, so a
    #: fleet that lost its ensemble together does not retry in lockstep.
    jitter: str = "none"

    def __post_init__(self) -> None:
        if self.jitter not in JITTER_MODES:
            raise ValueError(
                f"jitter must be one of {JITTER_MODES}, got {self.jitter!r}"
            )

    def delay(self, attempt: int) -> float:
        """Deterministic delay before retry number ``attempt`` (0-based) —
        the pure doubling schedule, jitter ignored (kept stable for the
        reference-parity pins in tests/test_retry.py).

        The exponent is clamped: an unbounded reconnect loop that has
        been retrying for hours reaches attempts past 1024, where a raw
        ``2**attempt`` overflows float conversion and the retry loop —
        the thing keeping a disconnected daemon alive — dies with
        OverflowError.  2**64 × any initial_delay is already beyond any
        real max_delay, so the clamp never changes a produced value.
        """
        return min(self.initial_delay * (2 ** min(attempt, 64)), self.max_delay)

    def schedule(self, rng: Optional[random.Random] = None) -> Iterator[float]:
        """Yield successive backoff delays, honoring the jitter mode.

        With ``jitter="none"`` this is exactly ``delay(0), delay(1), ...``.
        With ``jitter="decorrelated"``, each delay is drawn from
        ``uniform(initial_delay, 3 * previous)`` capped at ``max_delay``
        (``rng`` makes a schedule reproducible in tests; default is the
        module RNG).  Every jittered delay stays within
        ``[initial_delay, max_delay]`` — the same envelope operators
        already budget for.
        """
        if self.jitter == "none":
            attempt = 0
            while True:
                yield self.delay(attempt)
                attempt += 1
        else:
            uniform = (rng or random).uniform
            prev = self.initial_delay
            while True:
                prev = min(self.max_delay, uniform(self.initial_delay, prev * 3))
                yield prev


#: reference lib/zk.js:38-42
HEARTBEAT_RETRY = RetryPolicy(max_attempts=5, initial_delay=1.0, max_delay=30.0)
#: reference lib/zk.js:97-101
CONNECT_RETRY = RetryPolicy(max_attempts=math.inf, initial_delay=1.0, max_delay=90.0)
#: the client's default *reconnect* policy: the reference's 1-90 s envelope
#: with decorrelated jitter, so a fleet dropped by an ensemble restart does
#: not reconnect as a thundering herd.
RECONNECT_RETRY = RetryPolicy(
    max_attempts=math.inf, initial_delay=1.0, max_delay=90.0,
    jitter="decorrelated",
)


def is_transient(err: BaseException) -> bool:
    """True when retrying the failed operation could plausibly succeed.

    Transient: CONNECTION_LOSS (the connection died; a reconnect may
    already be in progress), OPERATION_TIMEOUT (a per-operation deadline
    tore the connection down, :class:`~registrar_tpu_torch.zk.client.
    OperationTimeoutError`), NOT_READONLY (the write reached a read-only
    minority member — it succeeds once the client fails over to a
    read-write member or quorum returns, which the client's rw-probe
    drives), and plain socket/timeout errors.

    NOT transient: SESSION_EXPIRED (a dead session cannot be retried back
    to life — the orchestrator must build a new one) and every other
    ZooKeeper semantic error (NO_NODE, NODE_EXISTS, NO_AUTH, ...), where a
    retry would just repeat the same answer.

    Explicitly FATAL: ``ValueError``/``RuntimeError`` (and subclasses —
    record validation, the interface-probe failure in
    ``records.default_address``, jute encode errors): the operation's
    *input* is wrong, so every retry replays the same failure.  These
    were always non-transient by the fall-through default; naming them
    keeps the classification deliberate — checklib's
    retry-contract-drift rule verifies every class that can reach a
    retry boundary is decided HERE, not by silence.
    """
    if isinstance(err, ZKError):
        return err.code in (
            Err.CONNECTION_LOSS, Err.OPERATION_TIMEOUT, Err.NOT_READONLY
        )
    if isinstance(err, (ValueError, RuntimeError)):
        return False
    return isinstance(err, (ConnectionError, asyncio.TimeoutError, OSError))


async def call_with_backoff(
    fn: Callable[[], Awaitable[T]],
    policy: RetryPolicy,
    on_backoff: Optional[Callable[[int, float, Exception], object]] = None,
    retryable: Optional[Callable[[Exception], bool]] = None,
    rng: Optional[random.Random] = None,
) -> T:
    """Run ``fn`` until it succeeds or the policy's attempts are exhausted.

    ``on_backoff(attempt_number, delay_seconds, error)`` is invoked before
    each sleep, mirroring node-backoff's 'backoff' event (used by the
    reference for connect-attempt logging, lib/zk.js:104-119).  Cancelling
    the awaiting task aborts the loop (the analog of `retry.abort()`).

    ``retryable(err)`` returning False makes the error fatal: it propagates
    immediately without further attempts (e.g. session expiry during a
    reconnect loop — retrying cannot resurrect an expired session).

    ``rng`` seeds a jittered policy's delay draws (tests); ignored for
    ``jitter="none"`` policies.
    """
    attempt = 0
    delays = policy.schedule(rng)
    while True:
        try:
            return await fn()
        except asyncio.CancelledError:
            raise
        except Exception as err:
            if retryable is not None and not retryable(err):
                raise
            if attempt + 1 >= policy.max_attempts:
                raise
            delay = next(delays)
            if on_backoff is not None:
                on_backoff(attempt, delay, err)
            await asyncio.sleep(delay)
            attempt += 1
