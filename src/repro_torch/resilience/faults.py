"""Counter-deterministic fault injection for the ingest->query path.
Counterpart of `repro.resilience.faults`.

A `FaultPlan` declares WHAT goes wrong — commit `ConnectionError`
bursts (by attempt index or by simulated time), slow-commit latency
spikes, and a crash-at-tick kill — as pure data, so the same plan
replayed against the same scenario produces byte-identical failure
sequences.  A `FaultInjector` executes the plan through the
`GraphIngestor.fail_hook` slot: it keeps the attempt counter (which
checkpoints alongside the ingestor, so a resumed run continues the
fault sequence exactly where the killed run left it).

`PipelineKilled` is the kill signal of the plan's `crash_at_tick`,
which the checkpoint loop (`repro_torch.resilience.drive`) honours: a
run killed so resumes from its latest checkpoint through
`run_scenario(..., resume=True)`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple


class PipelineKilled(RuntimeError):
    """The fault plan killed the pipeline at `tick` (chaos testing)."""

    def __init__(self, tick: int):
        super().__init__(f"fault plan killed the pipeline at tick {tick}")
        self.tick = tick


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault schedule (all windows are half-open).

    fail_attempts : commit-attempt index windows ``(start, end)`` that
                    raise `ConnectionError` (index counts every commit
                    attempt the ingestor makes, including retries).
    fail_times    : simulated-time windows ``(t0, t1)`` during which
                    every commit fails — an outage of the store.
    slow_attempts : ``(start, end, seconds)`` windows that sleep before
                    the commit (latency spike; wall-clock only, never
                    touches control state).
    crash_at_tick : kill the pipeline after processing this tick
                    (honoured by the checkpoint loop, not the hook).
    """

    fail_attempts: Tuple[Tuple[int, int], ...] = ()
    fail_times: Tuple[Tuple[float, float], ...] = ()
    slow_attempts: Tuple[Tuple[int, int, float], ...] = ()
    crash_at_tick: Optional[int] = None

    def without_crash(self) -> "FaultPlan":
        """The same plan minus the kill — what a resumed run (and the
        uninterrupted reference run) must execute for bit-exactness."""
        return dataclasses.replace(self, crash_at_tick=None)


class FaultInjector:
    """`fail_hook`-shaped executor of a `FaultPlan`.

    `wants_now = True` tells the ingestor to pass the commit's
    simulated time so `fail_times` windows work; plain nullary hooks
    keep working unchanged.
    """

    wants_now = True

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.attempts = 0  # commit attempts observed so far

    def __call__(self, now: Optional[float] = None) -> bool:
        i = self.attempts
        self.attempts += 1
        for (s, e, d) in self.plan.slow_attempts:
            if s <= i < e:
                time.sleep(d)
                break
        for (s, e) in self.plan.fail_attempts:
            if s <= i < e:
                return True
        if now is not None:
            for (t0, t1) in self.plan.fail_times:
                if t0 <= now < t1:
                    return True
        return False

    # ---- checkpoint surface (rides in GraphIngestor.state()) ----
    def state(self) -> dict:
        return {"attempts": self.attempts}

    def restore_state(self, s: dict) -> None:
        self.attempts = int(s["attempts"])
