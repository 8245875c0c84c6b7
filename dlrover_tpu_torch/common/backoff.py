"""Jittered exponential backoff for polling loops — the port's copy of
``dlrover_tpu/common/backoff.py``.

Fixed-interval polling (``time.sleep(0.1)`` in a while loop) makes N
workers waiting on one slow master/storage synchronize into a
thundering herd: every retry lands in the same 100 ms window. The
waiters here start fast (low added latency when the condition resolves
quickly), grow exponentially (low steady-state load when it does not),
and jitter every delay (de-correlates the herd — deliberately NOT
seeded, unlike the chaos injector: waiters must diverge, not replay).
"""

import random
import time
from typing import Callable, Optional


class ExponentialBackoff:
    """Delay sequence: ``initial * factor^k``, capped, +/- jitter."""

    def __init__(self, initial: float = 0.05, factor: float = 2.0,
                 max_delay: float = 2.0, jitter: float = 0.25,
                 rng: Optional[random.Random] = None):
        self.initial = initial
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self._rng = rng or random
        self._next = initial

    def next_delay(self) -> float:
        base = self._next
        self._next = min(self._next * self.factor, self.max_delay)
        if not self.jitter:
            return base
        # Full +/- jitter band around the base, floored at a sliver of
        # it so the delay never collapses to ~0 (which would re-create
        # the busy-poll this class exists to remove).
        spread = base * self.jitter
        return max(base * 0.05, base + self._rng.uniform(-spread, spread))

    def sleep(self, remaining: Optional[float] = None) -> float:
        """Sleep the next delay (clipped to `remaining`); returns it."""
        delay = self.next_delay()
        if remaining is not None:
            delay = max(0.0, min(delay, remaining))
        if delay:
            time.sleep(delay)
        return delay

    def reset(self):
        self._next = self.initial


def poll_until(predicate: Callable[[], bool], timeout: float,
               initial: float = 0.05, max_delay: float = 2.0) -> bool:
    """Poll `predicate` with backoff until true or `timeout` elapses."""
    deadline = time.monotonic() + timeout
    backoff = ExponentialBackoff(initial=initial, max_delay=max_delay)
    while True:
        if predicate():
            return True
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        backoff.sleep(remaining)
