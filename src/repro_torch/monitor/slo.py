"""Declarative SLOs with error budgets and multi-window burn rates.
Counterpart of `repro.monitor.slo`.

An `SLOSpec` states an objective over one per-tick metric ("p99
commit latency <= 150 ms", "drops <= 0", "pushed records >= 1") plus
an **error budget**: the fraction of ticks allowed to violate it over
the run.  `SLOTracker` evaluates every spec each tick — persistent,
incremental evaluation over the stream, the same shape as the
standing queries in Pacaci et al. — and maintains the SRE-style
**burn rate** over a short and a long sliding window:

    burn = breach fraction in window / budget

A burn of 1.0 means the budget is being consumed exactly at the
sustainable rate; the tracker raises a `burn alert` (onset/clear,
hysteresis-free — the window arithmetic is its own smoothing) when
BOTH windows exceed `burn_alert`, the standard multi-window guard
against both flapping (short window alone) and staleness (long window
alone).

Everything is counter-deterministic: deques of booleans and integer
arithmetic, no clocks.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One service-level objective over a per-tick metric."""

    name: str
    metric: str            # key into the monitor's per-tick values
    op: str                # "<=" or ">="
    target: float          # per-tick threshold
    budget: float = 0.05   # allowed breaching-tick fraction over the run
    short_window: int = 12
    long_window: int = 60
    burn_alert: float = 4.0
    description: str = ""

    def ok(self, value: float) -> bool:
        if self.op == "<=":
            return value <= self.target
        if self.op == ">=":
            return value >= self.target
        raise ValueError(f"SLOSpec.op must be <= or >=, got {self.op!r}")


def default_slos(cpu_max: float = 0.55, theta2: float = 0.25,
                 checkpoint_every: int = 0) -> List[SLOSpec]:
    """The stock objectives over the ingest->query path.

    `checkpoint_every` > 0 adds the checkpoint-cadence objective
    (repro_torch.resilience); the metric is only fed on checkpointing
    runs, so the spec is inert otherwise.
    """
    slos = [
        SLOSpec("commit_p99", "commit_p99_ms", "<=", 150.0, budget=0.10,
                description="per-tick p99 commit latency stays under "
                            "150 ms (JIT warmup rides the budget)"),
        SLOSpec("no_drops", "drops", "<=", 0.0, budget=0.02,
                description="the store loses no inserts under pressure"),
        SLOSpec("throughput_floor", "pushed", ">=", 1.0, budget=0.35,
                description="the pipeline pushes data most ticks "
                            "(holds/throttles ride the budget)"),
        SLOSpec("mu_bounded", "mu", "<=", cpu_max * (1.0 + theta2),
                budget=0.10,
                description="consumer occupancy stays under the "
                            "Algorithm-2 escalation bound"),
        # the metric is only produced on lineage-tracked runs
        # (run_scenario(lineage=...)), so the spec is inert otherwise;
        # tighter windows than the latency SLOs — a stalled watermark
        # breaches consecutively, so a store outage should alert while
        # the outage is still in progress, not a long-window later
        SLOSpec("freshness", "queryable_lag_ms", "<=", 5000.0,
                budget=0.15, short_window=6, long_window=24,
                burn_alert=3.0,
                description="the graph queries see is never more than "
                            "5 s of stream time stale (queryable "
                            "watermark lag; buffering rides the budget)"),
    ]
    if checkpoint_every > 0:
        slos.append(SLOSpec(
            "checkpoint_cadence", "ticks_since_checkpoint", "<=",
            float(2 * checkpoint_every), budget=0.05,
            description="a resumable checkpoint is never more than "
                        "2 intervals stale"))
    return slos


class _SLOState:
    """Mutable tracking state for one spec (O(windows) memory)."""

    __slots__ = ("spec", "ticks", "breaches", "short", "long",
                 "max_burn_short", "max_burn_long", "alert_active",
                 "alerts", "first_breach_tick", "first_alert_tick")

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.ticks = 0
        self.breaches = 0
        self.short: collections.deque = collections.deque(
            maxlen=spec.short_window)
        self.long: collections.deque = collections.deque(
            maxlen=spec.long_window)
        self.max_burn_short = 0.0
        self.max_burn_long = 0.0
        self.alert_active = False
        self.alerts: List[Dict] = []
        self.first_breach_tick = -1
        self.first_alert_tick = -1

    def burn(self, win: collections.deque) -> float:
        if not win:
            return 0.0
        frac = sum(win) / len(win)
        return frac / max(self.spec.budget, 1e-9)


class SLOTracker:
    """Evaluate every spec each tick; summarize budgets per run."""

    def __init__(self, specs: Optional[Sequence[SLOSpec]] = None):
        self.specs = list(specs) if specs is not None else default_slos()
        self._st = {s.name: _SLOState(s) for s in self.specs}

    def observe(self, tick: int, t: float,
                values: Dict[str, Optional[float]]) -> List[Dict]:
        """Feed one tick of metrics; returns burn-alert boundaries
        fired this tick ([{slo, phase, tick, t, burn_short, burn_long}])."""
        fired: List[Dict] = []
        for st in self._st.values():
            spec = st.spec
            v = values.get(spec.metric)
            if v is None:
                continue  # metric not produced this tick: not evaluated
            bad = not spec.ok(float(v))
            st.ticks += 1
            if bad:
                st.breaches += 1
                if st.first_breach_tick < 0:
                    st.first_breach_tick = tick
            st.short.append(bad)
            st.long.append(bad)
            bs, bl = st.burn(st.short), st.burn(st.long)
            st.max_burn_short = max(st.max_burn_short, bs)
            st.max_burn_long = max(st.max_burn_long, bl)
            # multi-window alert: both windows must burn hot, and the
            # long window must have some history (avoid cold-start spikes)
            hot = (bs >= spec.burn_alert and bl >= spec.burn_alert
                   and len(st.long) >= spec.short_window)
            if hot != st.alert_active:
                st.alert_active = hot
                ev = {"slo": spec.name,
                      "phase": "onset" if hot else "clear",
                      "tick": tick, "t": float(t),
                      "burn_short": round(bs, 3), "burn_long": round(bl, 3)}
                st.alerts.append(ev)
                fired.append(ev)
                if hot and st.first_alert_tick < 0:
                    st.first_alert_tick = tick
        return fired

    # ---- queries ----
    def active_alerts(self) -> List[str]:
        return sorted(n for n, st in self._st.items() if st.alert_active)

    def total_breaches(self) -> int:
        return sum(st.breaches for st in self._st.values())

    def total_alerts(self) -> int:
        return sum(len([a for a in st.alerts if a["phase"] == "onset"])
                   for st in self._st.values())

    def summary(self) -> Dict[str, Dict]:
        """Per-SLO run summary: evaluated ticks, breaches, budget
        consumption, peak burn rates, alert boundaries."""
        out: Dict[str, Dict] = {}
        for name, st in self._st.items():
            spec = st.spec
            ratio = st.breaches / st.ticks if st.ticks else 0.0
            out[name] = {
                "metric": spec.metric,
                "objective": f"{spec.metric} {spec.op} {spec.target:g}",
                "budget": spec.budget,
                "ticks": st.ticks,
                "breaches": st.breaches,
                "breach_ratio": round(ratio, 4),
                "budget_consumed": round(ratio / max(spec.budget, 1e-9), 3),
                "max_burn_short": round(st.max_burn_short, 3),
                "max_burn_long": round(st.max_burn_long, 3),
                "first_breach_tick": st.first_breach_tick,
                "first_alert_tick": st.first_alert_tick,
                "alerts": list(st.alerts),
                "met": ratio <= spec.budget,
            }
        return out
