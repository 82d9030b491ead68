"""Structured metrics + event hooks for the ingestion loop.
Counterpart of `repro.api.metrics`.

The pipeline emits typed `PipelineEvent`s into a `MetricsHub`, which
keeps the per-tick `PerfSample` trace, counts events, fans out to
subscriber hooks, and assembles the final `PipelineReport`.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.buffer import PerfSample
from repro_torch.telemetry.spans import TelemetryRegistry


@dataclasses.dataclass
class PipelineEvent:
    """One loop event.  `kind` is one of: tick, push, hold, throttle,
    spill, drain, commit, commit-failed, sample, report, retry,
    degraded, pool_overflow."""

    kind: str
    t: float
    payload: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PipelineReport:
    samples: dict
    actions: List[str]
    total_records: int
    total_instructions: int
    raw_instructions: int
    spill_events: int
    drain_events: int
    compression_ratios: np.ndarray
    wall_s: float

    @property
    def mean_compression(self) -> float:
        cr = self.compression_ratios
        return float(cr.mean()) if cr.size else 1.0


class MetricsHub:
    """Event bus + trace accumulator for one pipeline run.

    Event counts live in a `TelemetryRegistry`'s always-on Counter
    (`counters`); by default the hub owns a disabled registry, so span
    calls threaded through it cost one branch and allocate nothing.  A
    `PipelineEvent` is only constructed when a hook is subscribed."""

    def __init__(self, telemetry: Optional[TelemetryRegistry] = None):
        self.trace: List[PerfSample] = []
        self.telemetry = telemetry if telemetry is not None \
            else TelemetryRegistry(enabled=False)
        self._hooks: List[Callable[[PipelineEvent], None]] = []
        # the attached repro_torch.monitor.HealthMonitor, when one is
        # wired (PipelineBuilder.with_monitor); it subscribes like any
        # other hook, and this reference lets exporters find it
        self.monitor = None
        # the attached repro_torch.lineage.LineageTracker, when one is
        # wired (PipelineBuilder.with_lineage): `controlled_tick` looks
        # it up here to tag batches; None keeps the hot path branch-only
        self.lineage = None

    @property
    def counters(self) -> collections.Counter:
        return self.telemetry.counters

    def subscribe(self, hook: Callable[[PipelineEvent], None]) -> "MetricsHub":
        self._hooks.append(hook)
        return self

    def emit(self, kind: str, t: float, **payload):
        self.counters[kind] += 1
        if self._hooks:
            ev = PipelineEvent(kind, t, payload)
            for h in self._hooks:
                h(ev)

    def record(self, sample: PerfSample):
        self.trace.append(sample)
        self.emit("sample", sample.t, action=sample.action, mu=sample.mu,
                  beta=sample.beta, spill_depth=sample.spill_depth)

    def state(self) -> dict:
        return {"trace": list(self.trace), "counters": dict(self.counters)}

    def restore_state(self, s: dict) -> None:
        self.trace = list(s["trace"])
        c = self.counters  # the registry's live Counter: mutate in place
        c.clear()
        c.update(s["counters"])

    def trace_arrays(self):
        keys = [f.name for f in dataclasses.fields(PerfSample) if f.name != "action"]
        return {k: np.asarray([getattr(s, k) for s in self.trace]) for k in keys}, [
            s.action for s in self.trace
        ]

    def build_report(self, total_records: int, total_instructions: int,
                     raw_instructions: int, compression_ratios: List[float],
                     wall_s: float) -> PipelineReport:
        samples, actions = self.trace_arrays()
        rep = PipelineReport(
            samples=samples,
            actions=actions,
            total_records=total_records,
            total_instructions=total_instructions,
            raw_instructions=raw_instructions,
            spill_events=self.counters["spill"],
            drain_events=self.counters["drain"],
            compression_ratios=np.asarray(compression_ratios),
            wall_s=wall_s,
        )
        t_last = self.trace[-1].t if self.trace else 0.0
        self.emit("report", t_last, report=rep)
        return rep
