"""Streaming anomaly / change-point detection over per-tick series.
Counterpart of `repro.monitor.detectors`.

The paper's premise (§III) is that ingestion only survives bursty
social streams when the system *judges* its own signals online —
data rate, data content, machine resources — instead of grepping
logs after the database has fallen over.  This module is that judge:
two classic O(1)-state sequential detectors run side by side on each
tapped series and emit typed `HealthEvent`s with **onset/clear**
semantics, so a flash-crowd onset is detected and timestamped while
the run is still in flight.

  * `EwmaDetector` — exponentially weighted mean/variance with a
    z-score alarm and hysteresis (`z_on`/`z_off`, consecutive-tick
    confirmation) so a single noisy tick neither fires nor clears an
    alert.
  * `PageHinkley` — the Page–Hinkley cumulative-deviation test on the
    *normalized* residual (z-score), so one lambda works across series
    of wildly different scales (records/tick vs. milliseconds vs.
    queue depths).  Detects sustained level shifts the EWMA z-score
    adapts past.

Both are **counter-deterministic**: pure arithmetic on the values they
are fed, no wall clock, no RNG — the same per-tick series always
yields the same events, which is what makes the detector fixtures in
the tests exact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class HealthEvent:
    """One detector verdict boundary: an alert turning on or off."""

    series: str      # which per-tick series ("rate", "commit_ms", ...)
    detector: str    # "ewma" | "page_hinkley"
    phase: str       # "onset" | "clear"
    tick: int        # tick index the boundary was detected at
    t: float         # stream time of that tick
    value: float     # the observed value that crossed
    score: float     # z-score (ewma) or PH statistic at the boundary
    threshold: float  # the limit it crossed

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        arrow = "!" if self.phase == "onset" else "ok"
        return (f"[{arrow}] t={self.t:.1f} tick={self.tick} "
                f"{self.series}/{self.detector} {self.phase} "
                f"value={self.value:.3g} score={self.score:.2f} "
                f"(limit {self.threshold:.2f})")


class EwmaDetector:
    """EWMA z-score anomaly detector with onset/clear hysteresis.

    State is five floats and three small ints; `update` is O(1).  The
    alarm arms after `warmup` samples, fires when |z| >= `z_on` for
    `k_on` consecutive ticks (one-sided when `direction` is +1/-1),
    and clears when |z| <= `z_off` for `k_off` consecutive ticks —
    the EWMA keeps adapting throughout, so a decaying burst clears on
    its own once the baseline catches up.
    """

    def __init__(self, alpha: float = 0.15, z_on: float = 4.0,
                 z_off: float = 1.5, warmup: int = 8,
                 k_on: int = 1, k_off: int = 3,
                 direction: int = 0, min_std: float = 1e-9):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = float(alpha)
        self.z_on = float(z_on)
        self.z_off = float(z_off)
        self.warmup = int(warmup)
        self.k_on = max(1, int(k_on))
        self.k_off = max(1, int(k_off))
        self.direction = int(direction)  # 0 = two-sided
        self.min_std = float(min_std)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.z = 0.0
        self.active = False
        self._on_streak = 0
        self._off_streak = 0

    def _signed(self, z: float) -> float:
        """The alarm-relevant magnitude of z given the direction."""
        if self.direction > 0:
            return z
        if self.direction < 0:
            return -z
        return abs(z)

    def update(self, x: float) -> Optional[str]:
        """Feed one sample; returns "onset", "clear", or None."""
        x = float(x)
        if self.n == 0:
            self.mean, self.var = x, 0.0
            self.n = 1
            self.z = 0.0
            return None
        std = math.sqrt(max(self.var, 0.0))
        self.z = (x - self.mean) / max(std, self.min_std) \
            if self.n >= self.warmup else 0.0
        # EWMA mean/variance (West's recurrence), bias-corrected: the
        # effective weight is 1/n until n exceeds 1/alpha, so the
        # first post-warmup z-scores use a converged scale instead of
        # one still climbing from zero
        a = max(self.alpha, 1.0 / self.n)
        d = x - self.mean
        self.mean += a * d
        self.var = (1.0 - a) * (self.var + a * d * d)
        self.n += 1

        s = self._signed(self.z)
        if not self.active:
            self._on_streak = self._on_streak + 1 if s >= self.z_on else 0
            if self._on_streak >= self.k_on:
                self.active = True
                self._on_streak = 0
                self._off_streak = 0
                return "onset"
        else:
            self._off_streak = self._off_streak + 1 if s <= self.z_off else 0
            if self._off_streak >= self.k_off:
                self.active = False
                self._off_streak = 0
                return "clear"
        return None


class PageHinkley:
    """Page–Hinkley change-point test on the normalized residual.

    Classic PH accumulates `sum(x_i - mean_i - delta)` and alarms when
    the accumulator rises `lam` above its running minimum; here the
    residual is first scaled by a slowly adapting mean absolute
    deviation, so `delta` and `lam` are in z-units and one setting
    covers every series the monitor taps.  After an onset the
    accumulator resets and the detector holds `active` until the
    normalized residual stays below `z_off` for `k_off` ticks (the
    clear boundary), then resumes hunting.
    """

    def __init__(self, delta: float = 0.5, lam: float = 6.0,
                 alpha: float = 0.05, warmup: int = 8,
                 z_off: float = 1.0, k_off: int = 3,
                 direction: int = 1, min_scale: float = 1e-9):
        self.delta = float(delta)
        self.lam = float(lam)
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.z_off = float(z_off)
        self.k_off = max(1, int(k_off))
        self.direction = 1 if direction >= 0 else -1
        self.min_scale = float(min_scale)
        self.mean = 0.0
        self.scale = 0.0   # EWMA of |residual|
        self.n = 0
        self.cum = 0.0
        self.cum_min = 0.0
        self.stat = 0.0    # cum - cum_min (the alarm statistic)
        self.z = 0.0
        self.active = False
        self._off_streak = 0

    def update(self, x: float) -> Optional[str]:
        x = float(x)
        if self.n == 0:
            self.mean = x
            self.n = 1
            return None
        resid = (x - self.mean) * self.direction
        self.z = resid / max(self.scale, self.min_scale) \
            if self.n >= self.warmup else 0.0
        # bias-corrected adaptation (weight 1/n until n > 1/alpha):
        # without it the scale estimate is still climbing from zero
        # right after warmup and inflates every residual into a false
        # change-point
        a = max(self.alpha, 1.0 / self.n)
        self.mean += a * (x - self.mean)
        self.scale += a * (abs(resid) - self.scale)
        self.n += 1
        if self.n <= self.warmup:
            return None

        if not self.active:
            self.cum += self.z - self.delta
            self.cum_min = min(self.cum_min, self.cum)
            self.stat = self.cum - self.cum_min
            if self.stat > self.lam:
                self.active = True
                self.cum = self.cum_min = 0.0
                self._off_streak = 0
                return "onset"
        else:
            self._off_streak = self._off_streak + 1 \
                if self.z <= self.z_off else 0
            if self._off_streak >= self.k_off:
                self.active = False
                self._off_streak = 0
                return "clear"
        return None


@dataclasses.dataclass(frozen=True)
class SeriesSpec:
    """Detector configuration for one tapped per-tick series."""

    name: str
    direction: int = 1        # +1 watch increases, -1 decreases, 0 both
    ewma_alpha: float = 0.15
    z_on: float = 4.0
    z_off: float = 1.5
    warmup: int = 8
    k_on: int = 1
    k_off: int = 3
    ph_delta: float = 0.5
    ph_lambda: float = 6.0


# the default bank: the signals Algorithm 2 itself watches, plus the
# store-side ones the commit path reports (drops, spill backlog, dict hits)
DEFAULT_SERIES: Tuple[SeriesSpec, ...] = (
    SeriesSpec("rate", direction=1),                 # kept records/tick
    SeriesSpec("commit_ms", direction=1, z_on=5.0),  # mean commit latency
    SeriesSpec("drops", direction=1, z_on=3.0),      # lost inserts/tick
    SeriesSpec("spill_depth", direction=1, z_on=3.0),  # disk backlog
    SeriesSpec("mu", direction=1, z_on=4.0),         # consumer occupancy
    SeriesSpec("dict_hit", direction=-1),            # compressibility drop
    SeriesSpec("queryable_lag_ms", direction=1, z_on=4.0),  # freshness
    # (query-surface staleness spike: only fed on lineage-tracked runs,
    # which the port does not have yet; absent values are skipped)
)


class DetectorBank:
    """One EWMA + one Page–Hinkley detector per tapped series.

    `observe(tick, t, values)` feeds every series present in `values`
    (None/absent values are skipped — e.g. `commit_ms` on a tick with
    no commit) and returns the `HealthEvent` boundaries that fired.
    All events are also accumulated on `.events`.
    """

    def __init__(self, specs: Sequence[SeriesSpec] = DEFAULT_SERIES):
        self.specs = {s.name: s for s in specs}
        self._ewma: Dict[str, EwmaDetector] = {}
        self._ph: Dict[str, PageHinkley] = {}
        for s in specs:
            self._ewma[s.name] = EwmaDetector(
                alpha=s.ewma_alpha, z_on=s.z_on, z_off=s.z_off,
                warmup=s.warmup, k_on=s.k_on, k_off=s.k_off,
                direction=s.direction)
            self._ph[s.name] = PageHinkley(
                delta=s.ph_delta, lam=s.ph_lambda, warmup=s.warmup,
                k_off=s.k_off, direction=s.direction if s.direction else 1)
        self.events: List[HealthEvent] = []

    def observe(self, tick: int, t: float,
                values: Dict[str, Optional[float]]) -> List[HealthEvent]:
        fired: List[HealthEvent] = []
        for name, spec in self.specs.items():
            v = values.get(name)
            if v is None:
                continue
            ew = self._ewma[name]
            phase = ew.update(v)
            if phase is not None:
                fired.append(HealthEvent(
                    series=name, detector="ewma", phase=phase, tick=tick,
                    t=t, value=float(v), score=float(ew.z),
                    threshold=ew.z_on if phase == "onset" else ew.z_off))
            ph = self._ph[name]
            phase = ph.update(v)
            if phase is not None:
                fired.append(HealthEvent(
                    series=name, detector="page_hinkley", phase=phase,
                    tick=tick, t=t, value=float(v),
                    score=float(ph.stat if phase == "onset" else ph.z),
                    threshold=ph.lam if phase == "onset" else ph.z_off))
        self.events.extend(fired)
        return fired

    # ---- post-run queries ----
    def onsets(self, series: Optional[str] = None) -> List[HealthEvent]:
        return [e for e in self.events if e.phase == "onset"
                and (series is None or e.series == series)]

    def first_onset_tick(self, series: str) -> int:
        """Earliest onset tick for `series` from either detector
        (-1 when the series never alerted)."""
        ticks = [e.tick for e in self.onsets(series)]
        return min(ticks) if ticks else -1

    def active_alerts(self) -> List[str]:
        """Series currently in alert, as "series/detector" labels."""
        out = [f"{n}/ewma" for n, d in self._ewma.items() if d.active]
        out += [f"{n}/page_hinkley" for n, d in self._ph.items() if d.active]
        return sorted(out)
