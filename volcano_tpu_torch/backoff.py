"""Shared control-plane retry pacing: decorrelated-jitter exponential backoff.

The port's copy of ``volcano_tpu/backoff.py``.  The leader elector's
candidate retry paces its store round trips through this class instead of
a fixed ``time.sleep(period)``.  Fixed-interval retries synchronize: after
an apiserver restart every candidate hammers it on the same beat (the
thundering herd the reference avoids with client-go's wait.Backoff + rate
limiters).

The schedule is "decorrelated jitter": ``next = min(cap, uniform(base,
prev * 3))``, starting at ``base`` — growth is exponential in expectation
while consecutive delays are decorrelated across replicas.  ``reset()`` on
any success returns the stream to ``base`` so a recovered dependency is
re-probed quickly.  Seedable for deterministic tests; unseeded instances
draw from the OS entropy pool, which is exactly the decorrelation wanted
in production.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

#: defaults shared by the daemon loops: first retry after ~50 ms, never
#: wait more than 5 s (the reference leader-election retryPeriod)
DEFAULT_BASE = 0.05
DEFAULT_CAP = 5.0


class Backoff:
    """Decorrelated-jitter exponential backoff (seedable, capped).

    Not thread-safe: each retry loop owns its instance, which is the
    point — sharing one stream across loops would re-correlate them.
    """

    def __init__(self, base: float = DEFAULT_BASE, cap: float = DEFAULT_CAP,
                 seed: Optional[int] = None):
        if base <= 0 or cap < base:
            raise ValueError(f"need 0 < base <= cap, got {base}, {cap}")
        self.base = base
        self.cap = cap
        self._rng = random.Random(seed)
        self._prev = 0.0

    def reset(self) -> None:
        """Back to the base delay — call on any success."""
        self._prev = 0.0

    def next(self) -> float:
        """The next delay in seconds (advances the stream)."""
        if self._prev <= 0.0:
            self._prev = self.base
        else:
            self._prev = min(self.cap, self._rng.uniform(self.base,
                                                         self._prev * 3.0))
        return self._prev

    def sleep(self, sleep: Callable[[float], None] = time.sleep) -> float:
        """Sleep for the next delay; returns the delay slept."""
        delay = self.next()
        sleep(delay)
        return delay
