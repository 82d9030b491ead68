"""Consumer implementations (the store-engine load model).
Counterpart of `repro.api.consumers`.

`SimulatedConsumer` is a finite-capacity engine with a commit queue:
sustained over-delivery pins mu at 1.0 (the Fig. 2 meltdown) and builds
backlog, the system-delay term alpha of Eq. 3.  `MeasuredConsumer`
reports the busy fraction of the real commits (`GraphIngestor.occupancy`).
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.ingestor import GraphIngestor


class SimulatedConsumer:
    """Queued consumer: capacity `base_capacity * speed` instructions/s
    at mu=1, short Zabbix-style smoothing window on the occupancy."""

    def __init__(self, speed: float = 1.0, base_capacity: float = 3_000.0):
        self.speed = speed
        self.capacity = base_capacity * speed  # instructions/s at mu=1
        self._backlog = 0.0
        self._mu = 0.0

    def consume(self, instructions: int, dt: float, now: Optional[float] = None) -> float:
        self._backlog += instructions
        can = self.capacity * dt
        done = min(self._backlog, can)
        self._backlog -= done
        inst_mu = done / can
        self._mu = 0.5 * self._mu + 0.5 * inst_mu
        return min(self._mu, 1.0)

    @property
    def delay_s(self) -> float:
        """alpha (Eq. 3): seconds of work queued at the consumer."""
        return self._backlog / self.capacity

    def state(self) -> dict:
        return {"backlog": self._backlog, "mu": self._mu}

    def restore_state(self, s: dict) -> None:
        self._backlog = float(s["backlog"])
        self._mu = float(s["mu"])


class MeasuredConsumer:
    """Occupancy measured from real commits on a `GraphIngestor`."""

    def __init__(self, ingestor: GraphIngestor):
        self.ingestor = ingestor

    def consume(self, instructions: int, dt: float, now: Optional[float] = None) -> float:
        return self.ingestor.occupancy(now if now is not None else time.time())

    @property
    def delay_s(self) -> float:
        return self.ingestor.pending_work_s()
