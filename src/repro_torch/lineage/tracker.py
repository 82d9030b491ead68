"""Batch provenance + event-time watermarks (`LineageTracker`).
Counterpart of `repro.lineage.tracker`.

The third observability layer (after the telemetry spans and the
monitor's per-tick series): record-level freshness.  Every batch the pipeline commits
gets a `BatchTag` — a monotone ``batch_id``, the batch's event-time
envelope (stamped by the counter-deterministic simulated clock at the
source), and a hop log of everywhere the batch dwelled on its way to
the store (buffer, spill, ingestion pool, archive, commit, snapshot/
sketch).  The tracker folds tags into:

  * a **committed low watermark** — the oldest event time not yet
    landed in the graph store — and a **queryable watermark** that
    only advances once the commit's ``CommitDelta`` has been absorbed
    by the snapshot maintainer / sketch (the `commit_hook` fan-out),
    i.e. once a query could actually see the data;
  * **per-path freshness histograms** — direct-push vs buffered vs
    spilled vs archived-retry batches get separate ingest-lag and
    queryable-lag distributions (the log-bucket `Histogram` from
    `repro_torch.telemetry`), so a lag spike is attributable to the hop
    that caused it;
  * **conservation counters** — ``records_in`` at buffer intake vs
    committed/dropped/in-flight at the end of a run (silent loss on
    the spill/archive/degraded paths shows up as an imbalance).

Everything is keyed on the *simulated* stream clock, so watermarks
and freshness histograms are deterministic for a given scenario seed,
and equal between the card and the host; host wall-clock only rides
along in the hop log for Chrome-trace flow events.  On the card a
hop's wall stamp is taken where the host reaches it: `commit` after
the commit's device wait, `queryable` after the commit hooks have
ENQUEUED their device work (the snapshot absorb, the sketch update),
not after it ran, as with every span.

Zero-cost when absent: every integration point guards on the tracker
reference being non-None, and nothing here is constructed unless
`PipelineBuilder.with_lineage()` / `run_scenario(lineage=...)` asked
for it.
"""
from __future__ import annotations

import heapq
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.telemetry.spans import Histogram

# Commit routes a batch can take (ordered by precedence when flags
# overlap: an archived batch that was also spilled reports "archived"
# — the dominant detour is the one that set its freshness).
PATHS = ("direct", "buffered", "spilled", "archived")


@dataclass
class BatchTag:
    """Provenance for one committed batch (picklable; rides through
    `state()/restore_state()` checkpoints alongside its batch)."""

    batch_id: int
    n_records: int
    event_t_min: float          # oldest record event time in the batch
    event_t_max: float          # newest record event time in the batch
    t_open: float               # stream time the batch left the buffer
    ts_counts: Dict[float, int]  # event time -> record count (watermarks)
    shard: Optional[int] = None
    spilled: bool = False       # detoured through the disk spill store
    buffered: bool = False      # waited >= a tick in the record buffer
    pooled: bool = False        # held in the ingestion pool (busy store)
    archived: bool = False      # archived after a failed commit
    degraded: bool = False      # archived by degraded-mode direct put
    replays: int = 0            # archive replay attempts
    dropped: bool = False       # terminally lost (no archive available)
    t_commit: Optional[float] = None     # stream time the store took it
    t_queryable: Optional[float] = None  # ... and queries could see it
    # hop log: (hop name, stream time, host perf_counter_ns) — the
    # wall-clock column exists only to place Chrome-trace flow events
    # onto the telemetry span timeline; nothing compares it across runs
    hops: List[Tuple[str, float, int]] = field(default_factory=list)

    @property
    def path(self) -> str:
        """The dominant commit route (archive > spill > buffer > direct)."""
        if self.archived or self.degraded:
            return "archived"
        if self.spilled:
            return "spilled"
        if self.buffered or self.pooled:
            return "buffered"
        return "direct"

    def hop(self, name: str, now: float) -> None:
        self.hops.append((name, float(now), time.perf_counter_ns()))

    def to_dict(self) -> Dict:
        return {
            "batch_id": self.batch_id, "shard": self.shard,
            "path": self.path, "n_records": self.n_records,
            "event_t_min": self.event_t_min, "event_t_max": self.event_t_max,
            "t_open": self.t_open, "t_commit": self.t_commit,
            "t_queryable": self.t_queryable, "replays": self.replays,
            "dropped": self.dropped, "degraded": self.degraded,
            "hops": [{"hop": h, "t": t, "wall_ns": ns}
                     for (h, t, ns) in self.hops],
        }


class _WatermarkSet:
    """Multiset of pending event times with an O(log n) running min.

    ``add`` at buffer intake, ``remove`` when the records land; the
    watermark is the oldest still-pending event time — or, once the
    set drains empty, the newest event time ever seen (the stream is
    fully caught up).  Lazy-deletion heap: stale heads are popped on
    read, duplicate pushes are harmless.
    """

    __slots__ = ("pending", "_heap", "max_seen", "seen")

    def __init__(self):
        self.pending: Dict[float, int] = {}
        self._heap: List[float] = []
        self.max_seen = 0.0
        self.seen = False

    def add(self, ts_counts: Dict[float, int]) -> None:
        for ts, c in ts_counts.items():
            if ts not in self.pending:
                heapq.heappush(self._heap, ts)
            self.pending[ts] = self.pending.get(ts, 0) + c
            if not self.seen or ts > self.max_seen:
                self.max_seen = ts
            self.seen = True

    def remove(self, ts_counts: Dict[float, int]) -> None:
        for ts, c in ts_counts.items():
            left = self.pending.get(ts, 0) - c
            if left > 0:
                self.pending[ts] = left
            else:
                self.pending.pop(ts, None)

    def watermark(self) -> Optional[float]:
        while self._heap and self._heap[0] not in self.pending:
            heapq.heappop(self._heap)
        if self._heap:
            return self._heap[0]
        return self.max_seen if self.seen else None

    @property
    def depth(self) -> int:
        return sum(self.pending.values())

    def state(self) -> Dict:
        return {"pending": dict(self.pending), "max_seen": self.max_seen,
                "seen": self.seen}

    def restore_state(self, s: Dict) -> None:
        self.pending = dict(s["pending"])
        self._heap = list(self.pending)
        heapq.heapify(self._heap)
        self.max_seen = float(s["max_seen"])
        self.seen = bool(s["seen"])


def _ts_counts(records: List[dict]) -> Dict[float, int]:
    return dict(Counter(float(r.get("ts", 0.0)) for r in records))


class LineageTracker:
    """Watermarks + per-path freshness + per-batch hop logs for a run.

    Wiring (done by `PipelineBuilder.with_lineage`): the buffer
    stage(s) call `observe_intake` on every `extend`; `controlled_tick`
    opens a tag per batch and hands it to the ingestor; the ingestor
    marks pool/archive/commit/queryable transitions as the batch moves
    through GRAPHPUSH; `bind(hub)` subscribes the tracker so every
    ``"tick"`` event re-emits a ``"watermark"`` event carrying the
    current ingest/queryable staleness (the `freshness` SLO input).
    """

    def __init__(self, sample_rate: float = 0.25,
                 min_sampled_per_path: int = 3, dt: float = 1.0,
                 buffered_slack: float = 0.5, max_tags: int = 4096,
                 max_timeline: int = 4096):
        self.sample_rate = float(sample_rate)
        self.min_sampled_per_path = int(min_sampled_per_path)
        self.dt = float(dt)
        self.buffered_slack = float(buffered_slack)
        self.max_tags = int(max_tags)
        # conservation counters (records)
        self.records_in = 0
        self.records_committed = 0
        self.records_dropped = 0
        # batch counters
        self.batches_opened = 0
        self.batches_committed = 0
        self.batches_dropped = 0
        self.replays = 0
        self._next_batch_id = 0
        # watermark state
        self._commit_ws = _WatermarkSet()
        self._query_ws = _WatermarkSet()
        self._wm_committed: Optional[float] = None
        self._wm_queryable: Optional[float] = None
        # per-path freshness: ("ingest"|"queryable", path) -> Histogram
        self._hists: Dict[Tuple[str, str], Histogram] = {}
        self.path_counts: Dict[str, int] = {}
        # finished tags (bounded) + watermark timeline rows
        self.completed: Deque[BatchTag] = deque(maxlen=self.max_tags)
        self.completed_dropped = 0
        self.open_tags: Dict[int, BatchTag] = {}
        self.timeline: Deque[Dict] = deque(maxlen=int(max_timeline))
        self._hub = None

    # ------------------------------------------------------------------
    # intake + tagging (pipeline side)
    # ------------------------------------------------------------------
    def observe_intake(self, records: List[dict]) -> None:
        """Records entered the buffer: both watermarks now owe them."""
        if not records:
            return
        counts = _ts_counts(records)
        self.records_in += len(records)
        self._commit_ws.add(counts)
        self._query_ws.add(counts)

    def open_batch(self, records: List[dict], now: float,
                   shard: Optional[int] = None,
                   spilled: bool = False) -> BatchTag:
        """A batch left the buffer toward the sink; tag it."""
        counts = _ts_counts(records)
        tag = BatchTag(
            batch_id=self._next_batch_id,
            n_records=len(records),
            event_t_min=min(counts) if counts else float(now),
            event_t_max=max(counts) if counts else float(now),
            t_open=float(now),
            ts_counts=counts,
            shard=shard,
            spilled=bool(spilled),
        )
        self._next_batch_id += 1
        self.batches_opened += 1
        # records stamped this tick have ts == now exactly; anything
        # older than the slack sat in the buffer at least one decide
        tag.buffered = (now - tag.event_t_max) > self.buffered_slack * self.dt
        tag.hop("open", now)
        self.open_tags[tag.batch_id] = tag
        return tag

    def stage_commit(self, tag: BatchTag, sink) -> bool:
        """Hand the tag to the sink's ingestor (if it has one) for the
        upcoming `commit`.  Returns True when an ingestor took custody
        (it will apply the pool/archive/commit marks itself)."""
        ing = getattr(sink, "ingestor", None)
        if ing is not None and hasattr(ing, "_lineage_next"):
            ing._lineage_next = tag
            return True
        return False

    def after_commit(self, tag: BatchTag, out: Optional[Dict],
                     now: float, handed: bool = False) -> None:
        """Resolve a tag no ingestor took custody of (custom sinks):
        the commit result is all the provenance there is."""
        if handed:
            return
        if out and out.get("committed"):
            self.mark_committed(tag, now)
            self.mark_queryable(tag, now)
        else:
            self.mark_dropped(tag, now)

    # ------------------------------------------------------------------
    # hop marks (ingestor side)
    # ------------------------------------------------------------------
    def mark_pooled(self, tag: BatchTag, now: float) -> None:
        tag.pooled = True
        tag.hop("pool", now)

    def mark_archived(self, tag: BatchTag, now: float,
                      degraded: bool = False) -> None:
        tag.archived = True
        tag.degraded = tag.degraded or degraded
        tag.hop("archive", now)

    def mark_replay(self, tag: BatchTag, now: float) -> None:
        tag.replays += 1
        self.replays += 1
        tag.hop("retry", now)

    def mark_committed(self, tag: BatchTag, now: float) -> None:
        if tag.t_commit is not None:
            return
        tag.t_commit = float(now)
        tag.hop("commit", now)
        self.records_committed += tag.n_records
        self.batches_committed += 1
        self._commit_ws.remove(tag.ts_counts)
        lag_ns = int(max(0.0, now - tag.event_t_min) * 1e9)
        self._hist("ingest", tag.path).record_ns(lag_ns)
        self._advance()

    def mark_queryable(self, tag: BatchTag, now: float) -> None:
        """The commit's delta landed in the snapshot/sketch: queries
        can now see these records — the queryable watermark moves."""
        if tag.t_queryable is not None:
            return
        tag.t_queryable = float(now)
        tag.hop("queryable", now)
        self._query_ws.remove(tag.ts_counts)
        lag_ns = int(max(0.0, now - tag.event_t_min) * 1e9)
        self._hist("queryable", tag.path).record_ns(lag_ns)
        self.path_counts[tag.path] = self.path_counts.get(tag.path, 0) + 1
        self._advance()
        self._finish(tag)

    def mark_dropped(self, tag: BatchTag, now: float) -> None:
        if tag.dropped:
            return
        tag.dropped = True
        tag.hop("drop", now)
        self.records_dropped += tag.n_records
        self.batches_dropped += 1
        if tag.t_commit is None:
            self._commit_ws.remove(tag.ts_counts)
        if tag.t_queryable is None:
            self._query_ws.remove(tag.ts_counts)
        self._advance()
        self._finish(tag)

    def _finish(self, tag: BatchTag) -> None:
        self.open_tags.pop(tag.batch_id, None)
        if len(self.completed) == self.completed.maxlen:
            self.completed_dropped += 1
        self.completed.append(tag)

    def _hist(self, kind: str, path: str) -> Histogram:
        h = self._hists.get((kind, path))
        if h is None:
            h = self._hists[(kind, path)] = Histogram()
        return h

    # ------------------------------------------------------------------
    # watermarks
    # ------------------------------------------------------------------
    def _advance(self) -> None:
        wc = self._commit_ws.watermark()
        if wc is not None:
            self._wm_committed = wc if self._wm_committed is None \
                else max(self._wm_committed, wc)
        wq = self._query_ws.watermark()
        if wq is not None:
            self._wm_queryable = wq if self._wm_queryable is None \
                else max(self._wm_queryable, wq)
        # Wq <= Wc by construction (query pending is a superset of
        # commit pending); the clamp keeps it an invariant even if a
        # custom sink marks out of order
        if self._wm_queryable is not None and self._wm_committed is not None:
            self._wm_queryable = min(self._wm_queryable, self._wm_committed)

    def watermarks(self) -> Dict:
        return {
            "committed": self._wm_committed,
            "queryable": self._wm_queryable,
            "max_event_t": self._commit_ws.max_seen
            if self._commit_ws.seen else None,
            "pending_commit": self._commit_ws.depth,
            "pending_queryable": self._query_ws.depth,
        }

    def current_lags_ms(self, now: float) -> Dict[str, Optional[float]]:
        """Staleness of the store (ingest) and of the query surface
        (queryable) at stream time `now`, in milliseconds."""
        c = None if self._wm_committed is None else \
            max(0.0, (now - self._wm_committed) * 1e3)
        q = None if self._wm_queryable is None else \
            max(0.0, (now - self._wm_queryable) * 1e3)
        return {"ingest_lag_ms": c, "queryable_lag_ms": q}

    # ------------------------------------------------------------------
    # per-tick hook (freshness SLI feed)
    # ------------------------------------------------------------------
    def bind(self, hub) -> "LineageTracker":
        """Subscribe to `hub` so every tick re-emits the watermark
        staleness as a ``"watermark"`` event (picked up by the monitor
        as the `queryable_lag_ms` / `ingest_lag_ms` series).  Bind
        AFTER the monitor so the nested emit lands in the tick row the
        monitor just opened."""
        self._hub = hub
        hub.subscribe(self.on_event)
        return self

    def on_event(self, ev) -> None:
        if ev.kind != "tick":
            return
        lags = self.current_lags_ms(ev.t)
        if lags["queryable_lag_ms"] is None:
            return
        row = {
            "t": float(ev.t),
            "committed": self._wm_committed,
            "queryable": self._wm_queryable,
            "ingest_lag_ms": lags["ingest_lag_ms"],
            "queryable_lag_ms": lags["queryable_lag_ms"],
            "pending_commit": self._commit_ws.depth,
            "pending_queryable": self._query_ws.depth,
        }
        self.timeline.append(row)
        if self._hub is not None:
            payload = {k: v for k, v in row.items() if k != "t"}
            self._hub.emit("watermark", ev.t, **payload)

    # ------------------------------------------------------------------
    # aggregation / reporting
    # ------------------------------------------------------------------
    def aggregate_hist(self, kind: str) -> Histogram:
        out = Histogram()
        for (k, _), h in self._hists.items():
            if k == kind:
                out.merge(h)
        return out

    def freshness(self) -> Dict[str, Dict]:
        """Per-path freshness table: ingest + queryable lag stats."""
        out: Dict[str, Dict] = {}
        for path in PATHS:
            ing = self._hists.get(("ingest", path))
            qry = self._hists.get(("queryable", path))
            if ing is None and qry is None:
                continue
            out[path] = {
                "batches": self.path_counts.get(path, 0),
                "ingest": (ing or Histogram()).stats(),
                "queryable": (qry or Histogram()).stats(),
            }
        return out

    def lag_percentiles_ms(self) -> Dict[str, float]:
        ing = self.aggregate_hist("ingest")
        qry = self.aggregate_hist("queryable")
        ms = 1e-6
        return {
            "ingest_lag_ms_p50": round(ing.percentile_ns(0.50) * ms, 6),
            "ingest_lag_ms_p99": round(ing.percentile_ns(0.99) * ms, 6),
            "queryable_lag_ms_p99": round(qry.percentile_ns(0.99) * ms, 6),
        }

    def in_flight_records(self) -> int:
        """Records inside open tags (pool / archive / mid-commit)."""
        return sum(t.n_records for t in self.open_tags.values())

    def conservation(self, buffered_records: int = 0) -> Dict:
        """The end-of-run invariant: everything that entered the
        buffer is committed, dropped, or demonstrably still in flight
        (stage buffers + spill are passed in as `buffered_records`)."""
        in_flight = int(buffered_records) + self.in_flight_records()
        imbalance = self.records_in - (self.records_committed
                                       + self.records_dropped + in_flight)
        return {
            "records_in": self.records_in,
            "records_committed": self.records_committed,
            "records_dropped": self.records_dropped,
            "records_in_flight": in_flight,
            "imbalance": imbalance,
        }

    # ------------------------------------------------------------------
    # checkpoint surface
    # ------------------------------------------------------------------
    def state(self) -> Dict:
        return {
            "records_in": self.records_in,
            "records_committed": self.records_committed,
            "records_dropped": self.records_dropped,
            "batches_opened": self.batches_opened,
            "batches_committed": self.batches_committed,
            "batches_dropped": self.batches_dropped,
            "replays": self.replays,
            "next_batch_id": self._next_batch_id,
            "commit_ws": self._commit_ws.state(),
            "query_ws": self._query_ws.state(),
            "wm_committed": self._wm_committed,
            "wm_queryable": self._wm_queryable,
            "path_counts": dict(self.path_counts),
            "hists": {k: {"counts": list(h.counts), "count": h.count,
                          "sum_ns": h.sum_ns, "max_ns": h.max_ns}
                      for k, h in self._hists.items()},
            "completed": list(self.completed),
            "completed_dropped": self.completed_dropped,
            "open_tags": dict(self.open_tags),
            "timeline": list(self.timeline),
        }

    def restore_state(self, s: Dict) -> None:
        self.records_in = int(s["records_in"])
        self.records_committed = int(s["records_committed"])
        self.records_dropped = int(s["records_dropped"])
        self.batches_opened = int(s["batches_opened"])
        self.batches_committed = int(s["batches_committed"])
        self.batches_dropped = int(s["batches_dropped"])
        self.replays = int(s["replays"])
        self._next_batch_id = int(s["next_batch_id"])
        self._commit_ws = _WatermarkSet()
        self._commit_ws.restore_state(s["commit_ws"])
        self._query_ws = _WatermarkSet()
        self._query_ws.restore_state(s["query_ws"])
        self._wm_committed = s["wm_committed"]
        self._wm_queryable = s["wm_queryable"]
        self.path_counts = dict(s["path_counts"])
        self._hists = {}
        for k, hs in s["hists"].items():
            h = Histogram()
            h.counts = list(hs["counts"])
            h.count = int(hs["count"])
            h.sum_ns = int(hs["sum_ns"])
            h.max_ns = int(hs["max_ns"])
            self._hists[tuple(k)] = h
        self.completed = deque(s["completed"], maxlen=self.max_tags)
        self.completed_dropped = int(s["completed_dropped"])
        self.open_tags = dict(s["open_tags"])
        self.timeline = deque(s["timeline"], maxlen=self.timeline.maxlen)
