"""`HealthMonitor` — the online judge over the ingest->query path.
Counterpart of `repro.monitor.monitor`.

Subscribes to the pipeline's `MetricsHub` (so it sees every loop
event the moment it is emitted — single-shard or the sharded fleet
through the aggregate hub) and taps the `TelemetryRegistry`'s
cumulative histograms through a `SeriesTap` for exact per-tick
latency deltas.  Each tick boundary it assembles one row of per-tick
series and feeds:

  * the `DetectorBank` (EWMA z-score + Page–Hinkley) -> `HealthEvent`
    onset/clear boundaries, so a flash-crowd onset is *detected and
    timestamped* during the run;
  * the `SLOTracker` -> error-budget accounting + multi-window
    burn-rate alerts;

and at `finish()` scores the controller audit trail
(`repro_torch.monitor.quality`) so every Algorithm-2 decision carries a
quality verdict and the run gets one **controller score**.

Wiring is one call each way::

    mon = HealthMonitor()
    pipe = (PipelineBuilder(cfg).with_source(src)
            .with_monitor(mon).build())    # implies with_telemetry
    pipe.run(max_ticks=300)
    mon.finish()
    print(mon.report()["controller_score"])

or `run_scenario(..., monitor=True)` which also lands the verdicts in
the `WorkloadReport`.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.monitor.detectors import (
    DEFAULT_SERIES,
    DetectorBank,
    HealthEvent,
    SeriesSpec,
)
from repro_torch.monitor.quality import per_action_scores, score_trail
from repro_torch.monitor.slo import SLOSpec, SLOTracker, default_slos

# per-tick series the monitor assembles (detector specs and SLO
# metrics both draw from these keys)
SERIES_KEYS = ("rate", "raw", "pushed", "drops", "commits",
               "commit_failures", "commit_ms", "commit_p99_ms", "mu",
               "spill_depth", "dict_hit", "ticks_since_checkpoint",
               "ingest_lag_ms", "queryable_lag_ms")


class HealthMonitor:
    """Standing health evaluation over one pipeline run."""

    def __init__(self,
                 series: Sequence[SeriesSpec] = DEFAULT_SERIES,
                 slos: Optional[Sequence[SLOSpec]] = None,
                 cpu_max: Optional[float] = None,
                 history: int = 512,
                 on_tick: Optional[Callable] = None):
        self.detectors = DetectorBank(series)
        self._slo_specs = list(slos) if slos is not None else None
        self.slo: Optional[SLOTracker] = \
            SLOTracker(self._slo_specs) if self._slo_specs else None
        self.cpu_max = cpu_max
        self.on_tick = on_tick
        self.tick = -1          # index of the tick being accumulated
        self.t = 0.0
        self.history: collections.deque = collections.deque(maxlen=history)
        self.last_values: Dict[str, Optional[float]] = {}
        self._acc: Optional[Dict] = None
        self._tap = None
        self._registry = None
        self._hub = None
        self._dict_seen = False
        self._finished = False
        self._quality: Dict = {}
        self._quality_by_action: Dict = {}
        self._checkpointing = False
        self._since_ckpt = 0

    # ------------------------------------------------------------------
    def bind(self, hub, cfg=None, checkpoint_every: int = 0) -> "HealthMonitor":
        """Attach to a pipeline's `MetricsHub` (+ its telemetry
        registry).  `cfg` (an `IngestConfig`) seeds `cpu_max` and the
        default SLO set; `checkpoint_every` > 0 arms the
        checkpoint-cadence SLO."""
        from repro_torch.telemetry.spans import SeriesTap

        self._hub = hub
        self._registry = hub.telemetry
        self._tap = SeriesTap(hub.telemetry)
        if cfg is not None and self.cpu_max is None:
            self.cpu_max = float(cfg.cpu_max)
        if self.slo is None:
            self.slo = SLOTracker(default_slos(
                cpu_max=self.cpu_max if self.cpu_max is not None else 0.55,
                theta2=float(getattr(cfg, "theta2", 0.25)),
                checkpoint_every=checkpoint_every))
        if checkpoint_every > 0:
            self._checkpointing = True
        hub.subscribe(self.on_event)
        return self

    # ------------------------------------------------------------------
    # event intake (MetricsHub hook)
    # ------------------------------------------------------------------
    def on_event(self, ev) -> None:
        k = ev.kind
        if k == "tick":
            # a new tick begins: judge the one that just completed
            self._finalize()
            self.tick += 1
            self.t = float(ev.t)
            self._acc = {
                "rate": float(ev.payload.get("kept", 0)),
                "raw": float(ev.payload.get("raw", 0)),
                "pushed": 0.0, "drops": 0.0, "commits": 0.0,
                "commit_failures": 0.0, "mu": [], "spill_depth": 0.0,
                "dict_hit": [],
            }
            return
        a = self._acc
        if a is None:
            return
        if k == "commit":
            a["commits"] += 1
            a["drops"] += float(ev.payload.get("dropped", 0))
            hr = ev.payload.get("dict_hit_rate")
            if hr is not None:
                if hr > 0.0 or ev.payload.get("refs", 0) > 0:
                    self._dict_seen = True
                a["dict_hit"].append(float(hr))
        elif k == "commit-failed":
            a["commit_failures"] += 1
        elif k == "push":
            a["pushed"] += float(ev.payload.get("records", 0))
        elif k == "sample":
            if "mu" in ev.payload:
                a["mu"].append(float(ev.payload["mu"]))
            a["spill_depth"] = max(a["spill_depth"],
                                   float(ev.payload.get("spill_depth", 0)))
        elif k == "watermark":
            # repro_torch.lineage staleness, re-emitted at each tick
            # boundary (the tracker's hook runs after ours, so this
            # lands in the row we just opened)
            a["ingest_lag_ms"] = ev.payload.get("ingest_lag_ms")
            a["queryable_lag_ms"] = ev.payload.get("queryable_lag_ms")
        elif k == "checkpoint":
            self._checkpointing = True
            self._since_ckpt = 0
        elif k == "report":
            # run over: close out the final tick while the hub's state
            # is still live (finish() is idempotent on top of this)
            self._finalize()

    # ------------------------------------------------------------------
    def _finalize(self) -> None:
        """Close the accumulating tick: assemble the per-tick series
        row and feed the detectors and the SLO tracker."""
        a, self._acc = self._acc, None
        if a is None:
            return
        values: Dict[str, Optional[float]] = {
            "rate": a["rate"], "raw": a["raw"], "pushed": a["pushed"],
            "drops": a["drops"], "commits": a["commits"],
            "commit_failures": a["commit_failures"],
            "spill_depth": a["spill_depth"],
            "mu": sum(a["mu"]) / len(a["mu"]) if a["mu"] else None,
            "commit_ms": None, "commit_p99_ms": None, "dict_hit": None,
            # fed once a run checkpoints; detectors and SLOs skip None
            "ticks_since_checkpoint": None,
            # None when no lineage tracker is wired: detectors and SLOs
            # skip None, so runs without lineage are unchanged
            "ingest_lag_ms": a.get("ingest_lag_ms"),
            "queryable_lag_ms": a.get("queryable_lag_ms"),
        }
        if self._tap is not None:
            h = self._tap.hist_delta("commit.upsert")
            if h.count > 0:
                values["commit_ms"] = h.mean_ns / 1e6
                values["commit_p99_ms"] = h.percentile_ns(0.99) / 1e6
        if self._dict_seen and a["dict_hit"]:
            values["dict_hit"] = sum(a["dict_hit"]) / len(a["dict_hit"])
        if self._checkpointing:
            self._since_ckpt += 1
            values["ticks_since_checkpoint"] = float(self._since_ckpt)

        self.detectors.observe(self.tick, self.t, values)
        if self.slo is not None:
            self.slo.observe(self.tick, self.t, values)
        self.last_values = values
        self.history.append({"tick": self.tick, "t": self.t, **values})
        if self.on_tick is not None:
            self.on_tick(self, self.tick, values)

    # ------------------------------------------------------------------
    def finish(self) -> "HealthMonitor":
        """Close any open tick and score the controller audit trail.
        Idempotent; called by the harness after the run (or call it
        yourself after `pipe.run`)."""
        self._finalize()
        if not self._finished:
            audit = list(self._registry.audit) if self._registry is not None \
                else []
            cpu = self.cpu_max if self.cpu_max is not None else 0.55
            self._quality = score_trail(audit, cpu_max=cpu)
            self._quality_by_action = per_action_scores(audit)
            self._finished = True
        return self

    # ---- queries ------------------------------------------------------
    @property
    def events(self) -> List[HealthEvent]:
        return self.detectors.events

    @property
    def controller_score(self) -> float:
        return float(self._quality.get("controller_score", 1.0))

    def burst_onset_tick(self, series: str = "rate") -> int:
        return self.detectors.first_onset_tick(series)

    def active_alerts(self) -> List[str]:
        out = list(self.detectors.active_alerts())
        if self.slo is not None:
            out += [f"slo:{n}" for n in self.slo.active_alerts()]
        return out

    def report(self) -> Dict:
        """The JSON-safe monitor verdict for one run (the payload the
        CLI writes with --report-out and the harness folds into
        `WorkloadReport`)."""
        if not self._finished:
            self.finish()
        slo_summary = self.slo.summary() if self.slo is not None else {}
        onsets = {s: self.detectors.first_onset_tick(s)
                  for s in self.detectors.specs
                  if self.detectors.first_onset_tick(s) >= 0}
        return {
            "ticks": self.tick + 1,
            "health_events": [e.to_dict() for e in self.events],
            "n_health_events": len(self.events),
            "onsets": onsets,
            "burst_onset_tick": self.burst_onset_tick("rate"),
            "active_alerts": self.active_alerts(),
            "slo": slo_summary,
            "slo_breaches": self.slo.total_breaches()
            if self.slo is not None else 0,
            "slo_alerts": self.slo.total_alerts()
            if self.slo is not None else 0,
            "quality": dict(self._quality),
            "quality_by_action": dict(self._quality_by_action),
            "controller_score": self.controller_score,
            "series_last": dict(self.last_values),
        }
