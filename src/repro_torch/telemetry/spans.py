"""Span/timer API + streaming-safe histograms (`TelemetryRegistry`).

The diagnostic substrate for the whole ingest->query path: every
instrumented stage wraps its hot section in ``registry.span("name")``
(context-manager or ``@registry.timed`` decorator form) and the
registry accumulates the durations into **fixed log-bucket
histograms** — 64 power-of-two latency buckets over integer
nanoseconds, so a run of any length costs O(1) memory per stage and
bucket assignment is *exact* integer math (``bit_length``), never a
float-log off-by-one at a boundary.

Overhead discipline:

  * disabled registry (``enabled=False``, the default everywhere a
    registry is merely threaded through): ``span()`` returns the one
    preallocated ``NULL_SPAN`` singleton — **no Span object is
    constructed**, no histogram touched, no event appended.  The whole
    per-call cost is one attribute read and one branch.
  * enabled registry: one ``time.perf_counter_ns`` pair per span, an
    O(1) histogram update, and one bounded event-list append (the
    Chrome-trace timeline; capped at ``max_events``, overflow counted
    in ``events_dropped`` — never an unbounded list).

Shard fan-out uses **child registries** (`child(shard)`): a child
shares the root's histogram/event/audit storage (spans it records are
tagged with its shard) but owns its *own* ``counters`` — so N
per-shard ``MetricsHub``s keep independent event counts while their
span timelines land in one trace.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Tuple

NBUCKETS = 64  # bucket i (i>=1) holds durations in [2^(i-1), 2^i) ns


def bucket_index(ns: int) -> int:
    """Exact log2 bucket for an integer-nanosecond duration.

    ``0 -> 0``; otherwise ``ns.bit_length()`` clipped to the last
    bucket: a duration of exactly ``2**k`` ns lands in bucket ``k+1``
    (the half-open bucket ``[2**k, 2**(k+1))``) — pure integer math,
    exact at every boundary."""
    if ns <= 0:
        return 0
    return min(ns.bit_length(), NBUCKETS - 1)


def bucket_lower_ns(i: int) -> int:
    """Inclusive lower bound of bucket `i` in ns (0 for bucket 0)."""
    return 0 if i <= 0 else 1 << (i - 1)


def bucket_upper_ns(i: int) -> int:
    """Exclusive upper bound of bucket `i` in ns."""
    return 1 if i <= 0 else 1 << i


class Histogram:
    """Fixed-size log-bucket latency histogram (streaming-safe).

    Exact ``count``/``sum``/``max`` plus 64 power-of-two buckets;
    percentiles are conservative (they report the matching bucket's
    upper bound, so p95 never under-reports)."""

    __slots__ = ("counts", "count", "sum_ns", "max_ns")

    def __init__(self):
        self.counts = [0] * NBUCKETS
        self.count = 0
        self.sum_ns = 0
        self.max_ns = 0

    def record_ns(self, ns: int) -> None:
        self.counts[bucket_index(ns)] += 1
        self.count += 1
        self.sum_ns += ns
        if ns > self.max_ns:
            self.max_ns = ns

    def merge(self, other: "Histogram") -> "Histogram":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum_ns += other.sum_ns
        self.max_ns = max(self.max_ns, other.max_ns)
        return self

    def copy(self) -> "Histogram":
        h = Histogram()
        h.counts = list(self.counts)
        h.count = self.count
        h.sum_ns = self.sum_ns
        h.max_ns = self.max_ns
        return h

    def since(self, prev: "Histogram") -> "Histogram":
        """The delta histogram vs an earlier snapshot of this series
        (`prev` must be a previous cumulative state).  Bucket counts
        and count/sum subtract exactly; `max_ns` is the cumulative max
        (a true window max is not recoverable from snapshots) — the
        conservative-percentile property is preserved because the
        delta's percentile clamp still uses a max >= any window value."""
        h = Histogram()
        h.counts = [a - b for a, b in zip(self.counts, prev.counts)]
        h.count = self.count - prev.count
        h.sum_ns = self.sum_ns - prev.sum_ns
        h.max_ns = self.max_ns
        return h

    def percentile_ns(self, q: float) -> int:
        """Upper bound of the bucket holding the q-quantile (q in [0,1])."""
        if self.count == 0:
            return 0
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target and c:
                return min(bucket_upper_ns(i), self.max_ns) if i else 0
        return self.max_ns

    @property
    def mean_ns(self) -> float:
        return self.sum_ns / self.count if self.count else 0.0

    def stats(self) -> Dict[str, float]:
        ms = 1e-6
        return {
            "count": self.count,
            "mean_ms": round(self.mean_ns * ms, 6),
            "p50_ms": round(self.percentile_ns(0.50) * ms, 6),
            "p95_ms": round(self.percentile_ns(0.95) * ms, 6),
            "p99_ms": round(self.percentile_ns(0.99) * ms, 6),
            "max_ms": round(self.max_ns * ms, 6),
            "total_s": round(self.sum_ns * 1e-9, 6),
        }


class _NullSpan:
    """The disabled-path span: one preallocated, reusable no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Span:
    """An open timing span; records into the registry on ``__exit__``."""

    __slots__ = ("_reg", "name", "shard", "t0")

    def __init__(self, reg: "TelemetryRegistry", name: str,
                 shard: Optional[int]):
        self._reg = reg
        self.name = name
        self.shard = shard

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._reg._finish(self.name, self.shard, self.t0,
                          time.perf_counter_ns())
        return False


class TelemetryRegistry:
    """Typed span/histogram/counter/audit store for one run.

    * ``span(name)`` / ``timed(name)`` — the timer API (gated: the
      disabled path allocates nothing).
    * ``observe(name, seconds)`` — record an externally measured
      duration (gated like spans).
    * ``counters`` — a plain ``collections.Counter`` that is ALWAYS
      live (MetricsHub event counts ride here even when span telemetry
      is off; incrementing a dict int is the pre-telemetry cost).
    * ``audit`` — the controller decision trail (`repro_torch.telemetry.audit`
      appends; stored here so exporters see one object).
    * ``child(shard)`` — shard-tagged view sharing this registry's
      span/event/audit storage but owning its own ``counters``.
    """

    def __init__(self, enabled: bool = True, max_events: int = 200_000):
        self._root: "TelemetryRegistry" = self
        self._enabled = enabled
        self.shard: Optional[int] = None
        self.counters: collections.Counter = collections.Counter()
        self._hists: Dict[Tuple[str, Optional[int]], Histogram] = {}
        self.events: List[Tuple[str, Optional[int], int, int]] = []
        self.max_events = max_events
        self.events_dropped = 0
        self.audit: list = []  # AuditRecord list (repro_torch.telemetry.audit)
        self.max_audit = max_events
        self.t0_ns = time.perf_counter_ns()

    # ---- enable state lives on the root (children mirror it) ----
    @property
    def enabled(self) -> bool:
        return self._root._enabled

    @enabled.setter
    def enabled(self, v: bool) -> None:
        self._root._enabled = bool(v)

    def child(self, shard: int) -> "TelemetryRegistry":
        c = TelemetryRegistry.__new__(TelemetryRegistry)
        c._root = self._root
        c.shard = shard
        c.counters = collections.Counter()
        return c

    # ---- span API ----
    def span(self, name: str, shard: Optional[int] = None):
        root = self._root
        if not root._enabled:
            return NULL_SPAN
        return Span(root, name, self.shard if shard is None else shard)

    def timed(self, name: str, shard: Optional[int] = None) -> Callable:
        """Decorator form: time every call of the wrapped function."""

        def deco(fn):
            import functools

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(name, shard=shard):
                    return fn(*a, **kw)

            return wrapper

        return deco

    def observe(self, name: str, seconds: float,
                shard: Optional[int] = None) -> None:
        root = self._root
        if not root._enabled:
            return
        ns = int(seconds * 1e9)
        t1 = time.perf_counter_ns()
        root._finish(name, self.shard if shard is None else shard,
                     t1 - ns, t1)

    def count(self, name: str, n: int = 1) -> None:
        if self._root._enabled:
            self.counters[name] += n

    # ---- storage (root only) ----
    def _finish(self, name: str, shard: Optional[int],
                t0: int, t1: int) -> None:
        key = (name, shard)
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram()
        h.record_ns(t1 - t0)
        if len(self.events) < self.max_events:
            self.events.append((name, shard, t0, t1))
        else:
            self.events_dropped += 1

    def hist(self, name: str, shard: Optional[int] = None) -> Histogram:
        """The (name, shard) histogram (empty one if never recorded)."""
        return self._root._hists.get((name, shard)) or Histogram()

    # ---- aggregation ----
    def stage_names(self) -> List[str]:
        return sorted({n for (n, _) in self._root._hists})

    def shards(self) -> List[int]:
        return sorted({s for (_, s) in self._root._hists if s is not None})

    def aggregate(self, name: str) -> Histogram:
        """One histogram for `name` merged across all shards."""
        out = Histogram()
        for (n, _), h in self._root._hists.items():
            if n == name:
                out.merge(h)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-stage stats aggregated across shards: count, mean,
        p50/p95/p99, max, total — the `WorkloadReport`/CLI payload."""
        return {n: self.aggregate(n).stats() for n in self.stage_names()}


class SeriesTap:
    """Incremental reader over a registry's cumulative state.

    The online-monitoring primitive (repro_torch.monitor): histograms and
    counters accumulate for the whole run, but a standing detector
    needs *per-interval* values.  A tap remembers the last snapshot it
    took of each series and returns exact deltas:

        tap = SeriesTap(reg)
        ...                                   # one tick elapses
        d = tap.hist_delta("commit.upsert")   # this interval only
        d.count, d.mean_ns, d.percentile_ns(0.99)
        n = tap.counter_delta("commit")       # counter increments

    Deltas are exact integer subtraction on the fixed log-bucket
    state — O(NBUCKETS) per poll, no per-event cost, and polling never
    perturbs the registry.  Histogram reads aggregate across shards
    (the monitor watches the fleet, not one shard).
    """

    def __init__(self, registry: "TelemetryRegistry"):
        self.registry = registry._root
        self._hist_prev: Dict[str, Histogram] = {}
        self._counter_prev: Dict[str, int] = {}

    def hist_delta(self, name: str) -> Histogram:
        """Delta histogram for `name` (all shards) since the last poll."""
        cur = self.registry.aggregate(name)
        prev = self._hist_prev.get(name)
        self._hist_prev[name] = cur
        return cur if prev is None else cur.since(prev)

    def counter_delta(self, name: str) -> int:
        """Increment of `registry.counters[name]` since the last poll."""
        cur = int(self.registry.counters.get(name, 0))
        d = cur - self._counter_prev.get(name, 0)
        self._counter_prev[name] = cur
        return d


# The module-wide disabled registry: instrumented classes default
# their ``telemetry`` attribute to this so the hot path needs no None
# check.  Span/observe/count are all no-ops on it (``count`` is gated
# by `enabled`, so the shared singleton never accumulates state).
NULL_REGISTRY = TelemetryRegistry(enabled=False)
