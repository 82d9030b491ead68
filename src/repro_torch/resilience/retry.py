"""`RetryPolicy` — capped exponential backoff with deterministic jitter.
Counterpart of `repro.resilience.retry`.

Governs `GraphIngestor.retry_archive` (and the degraded-mode push gate)
when the graph store's connection is down: attempt k waits
``base_s * factor**k`` seconds, capped at `cap_s`, with a +/-`jitter`
fractional perturbation derived from an integer hash of
``(seed, attempt)`` — NOT from a wall-clock RNG — so two runs of the
same scenario back off at byte-identical times and checkpoint/resume
replays the exact retry schedule (the counter-determinism contract of
`repro.workloads` extended to the failure path).
"""
from __future__ import annotations

import dataclasses
import math


def _hash01(x: int) -> float:
    """lowbias32-style avalanche of an integer to uniform [0, 1)."""
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x / 4294967296.0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff: ``delay(k) ~ base_s * factor**k``.

    `jitter` is the +/- fraction applied deterministically per attempt
    (0 disables it); `seed` decorrelates the jitter streams of e.g.
    different shards retrying against one store.
    """

    base_s: float = 0.5
    factor: float = 2.0
    cap_s: float = 30.0
    jitter: float = 0.1
    seed: int = 0

    def __post_init__(self):
        if self.base_s <= 0 or self.factor < 1.0 or self.cap_s < self.base_s:
            raise ValueError("need base_s > 0, factor >= 1, cap_s >= base_s")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def raw_delay(self, attempt: int) -> float:
        """Un-jittered schedule: monotone non-decreasing, capped."""
        if attempt < 0:
            raise ValueError("attempt must be >= 0")
        if self.factor == 1.0:
            return min(self.base_s, self.cap_s)
        # compare in log space: float ** raises OverflowError long
        # before the product could be min()-ed against the cap
        if attempt * math.log(self.factor) >= math.log(self.cap_s
                                                       / self.base_s):
            return self.cap_s
        return min(self.base_s * self.factor ** float(attempt), self.cap_s)

    def delay(self, attempt: int) -> float:
        """Jittered delay for consecutive-failure count `attempt`."""
        raw = self.raw_delay(attempt)
        if self.jitter == 0.0:
            return raw
        h = _hash01((self.seed * 0x9E3779B9 + attempt) & 0xFFFFFFFF)
        return raw * (1.0 + self.jitter * (2.0 * h - 1.0))
