"""Port parity: batch lineage and freshness watermarks
(`repro_torch.lineage`), the fault plan and retry policy
(`repro_torch.resilience`), the lineage hooks in the buffer stage and
the ingestor, and `launch.lineage`.

  * Tracker: the same synthetic records (a numpy seed) through the same
    intake, open, pool, archive, replay, commit, queryable and drop
    marks in `repro.lineage.LineageTracker` and the port's give equal
    `state()` (the hop log's host `perf_counter_ns` column masked: it
    places flow events on the span timeline and differs in every run),
    watermarks, freshness histograms, conservation and timeline.  The
    cases mirror tests/test_lineage.py: the watermark set, the path
    precedence, the buffered classification, a dropped batch releasing
    both watermarks, watermark stalls under out-of-order commits, the
    `state()` round trip, and a random mix of marks.
  * Exporters: `sample_tags`, `flow_events` (timestamps masked),
    `validate_flow_events` (with its refusals), `write_lineage_jsonl`
    (the exporter's name and the wall column masked), `freshness_table`,
    `watermark_timeline` and `prometheus_lines` on trackers driven the
    same way.
  * `RetryPolicy.delay` over attempts 0 to 64 and `FaultInjector` over
    attempts and a time window, with its `state()` round trip.
  * The buffer stage's spill flags and the ingestor's tag custody
    (pool, overflow, degraded and failed-commit archive, spilled
    archive, replays with a failed head) against the reference's.
  * One reference run at `launch.lineage --dryrun`'s deployment (60
    ticks, 2^12/2^14, a store outage over 20:26, the default
    `RetryPolicy`, the monitor and a trace), replayed, records and
    decisions (tests/test_torch_workloads.py: ROADMAP F1 and F2), by
    the port's `run_scenario` and by `launch.lineage --dryrun --device
    cpu`: equal reports, tracker state, timeline, freshness SLO, files,
    Prometheus lines and printed output, wall-clock parts masked.
The two-shard run is in tests/test_torch_monitor.py, which makes that
reference run with lineage on.
"""
import contextlib
import copy
import dataclasses
import io
import json
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import repro.lineage as RL
import repro.monitor as RM
import repro.resilience as RR
import repro_torch.lineage as L
import repro_torch.monitor as M
import repro_torch.resilience as R
from repro.api import MetricsHub as RefHub
from repro.api.stages import BufferControlStage as RefBufferStage
from repro.configs.paper_ingest import IngestConfig as RefIngestConfig
from repro.core.edge_table import from_raw_batch as ref_from_raw
from repro.core.ingestor import GraphIngestor as RefIngestor
from repro.core.transform import create_edges as ref_create_edges
from repro.core.transform import tweet_mapping as ref_tweet_mapping
from repro.graphstore.store import init_store as ref_init_store
from repro.lineage.tracker import _WatermarkSet as RefWatermarkSet
from repro.resilience.retry import _hash01 as ref_hash01
from repro_torch.api import MetricsHub
from repro_torch.api.stages import BufferControlStage
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.core.edge_table import from_raw_batch
from repro_torch.core.ingestor import GraphIngestor
from repro_torch.core.transform import create_edges, tweet_mapping
from repro_torch.graphstore.store import init_store
from repro_torch.launch import lineage as cli
from repro_torch.lineage.tracker import _WatermarkSet
from repro_torch.resilience.retry import _hash01
from repro_torch.workloads import harness
from test_torch_monitor import WALL_SLOS, _steady_events
from test_torch_telemetry import PRINTED_ATOL, _mask_monitor
from test_torch_workloads import CAPS, SCENARIO, SEED, TICKS, WALL_FIELDS, _reference_run, \
    _replaying

PORT = SimpleNamespace(pkg=L, Hub=MetricsHub, WS=_WatermarkSet)
REF = SimpleNamespace(pkg=RL, Hub=RefHub, WS=RefWatermarkSet)
OUTAGE = (20.0, 26.0)  # launch.lineage --dryrun's store outage


# ---------------------------------------------------------------------------
# masking the wall column
# ---------------------------------------------------------------------------


def _tag(tag):
    """A BatchTag as a dict, its hops without the wall column."""
    d = dataclasses.asdict(tag)
    d["hops"] = [(h, t) for h, t, _ in tag.hops]
    return d


def norm_state(s):
    """`LineageTracker.state()` with every tag as `_tag` gives it."""
    return {**s, "completed": [_tag(t) for t in s["completed"]],
            "open_tags": {k: _tag(t) for k, t in s["open_tags"].items()}}


def tracker_view(trk):
    """Everything a tracker reports, the wall column masked."""
    return {"state": norm_state(trk.state()), "watermarks": trk.watermarks(),
            "freshness": trk.freshness(), "lags": trk.lag_percentiles_ms(),
            "conservation": trk.conservation(), "path_counts": dict(trk.path_counts),
            "in_flight": trk.in_flight_records()}


def _recs(*ts):
    return [{"ts": float(t)} for t in ts]


# ---------------------------------------------------------------------------
# the tracker, driven the same way in both packages
# ---------------------------------------------------------------------------


def _commit_then_queryable(side, rng):
    trk = side.pkg.LineageTracker(dt=1.0)
    recs = _recs(1.0, 1.0, 2.0)
    trk.observe_intake(recs)
    tag = trk.open_batch(recs, now=2.0)
    trk.mark_committed(tag, 2.0)
    trk.mark_queryable(tag, 3.0)
    return trk


def _buffered_classification(side, rng):
    trk = side.pkg.LineageTracker(dt=1.0, buffered_slack=0.5)
    for now in (5.0, 6.0, 7.5):
        recs = _recs(*rng.integers(0, 8, size=3))
        trk.observe_intake(recs)
        trk.open_batch(recs, now=now)
        trk.open_batch(_recs(now), now=now)
    return trk


def _dropped_releases_both(side, rng):
    trk = side.pkg.LineageTracker()
    recs = _recs(1.0, 4.0)
    trk.observe_intake(recs)
    tag = trk.open_batch(recs, now=4.0)
    trk.mark_dropped(tag, 5.0)
    trk.mark_dropped(tag, 6.0)  # a second drop is a no-op
    late = _recs(2.0)
    trk.observe_intake(late)
    t2 = trk.open_batch(late, now=6.0)
    trk.mark_committed(t2, 6.0)
    trk.mark_dropped(t2, 7.0)  # committed, never queryable: releases the query side
    return trk


def _out_of_order_stall(side, rng):
    trk = side.pkg.LineageTracker()
    old, new = _recs(1.0), _recs(2.0, 3.0)
    trk.observe_intake(old)
    trk.observe_intake(new)
    t_old = trk.open_batch(old, now=3.0)
    t_new = trk.open_batch(new, now=3.0)
    trk.mark_committed(t_new, 3.0)
    trk.mark_queryable(t_new, 3.0)
    assert trk.watermarks()["committed"] == 1.0  # stalled on the old batch
    trk.mark_committed(t_old, 4.0)
    trk.mark_queryable(t_old, 4.0)
    return trk


def _path_precedence(side, rng):
    """One batch down each route, and the overlaps: archived beats
    spilled beats buffered (or pooled) beats direct; a degraded put
    counts as archived."""
    trk = side.pkg.LineageTracker(dt=1.0)
    for i, marks in enumerate([(), ("pool",), ("spill",), ("spill", "pool"), ("archive",),
                               ("spill", "archive"), ("degraded",), ("pool", "archive"),
                               ("stale",)]):
        now = 10.0 + i
        recs = _recs(now - 3.0 if "stale" in marks else now)
        trk.observe_intake(recs)
        tag = trk.open_batch(recs, now=now, shard=i % 3 or None, spilled="spill" in marks)
        if "pool" in marks:
            trk.mark_pooled(tag, now)
        if "archive" in marks:
            trk.mark_archived(tag, now)
            trk.mark_replay(tag, now + 1.0)
        if "degraded" in marks:
            trk.mark_archived(tag, now, degraded=True)
        trk.mark_committed(tag, now + 2.0)
        trk.mark_queryable(tag, now + 2.5)
    return trk


def _conservation_open_tags(side, rng):
    trk = side.pkg.LineageTracker()
    recs = _recs(1.0, 2.0, 3.0, 4.0)
    trk.observe_intake(recs)
    tag = trk.open_batch(recs[:2], now=2.0)
    trk.mark_committed(tag, 2.0)
    trk.mark_queryable(tag, 2.0)
    trk.open_batch(recs[2:3], now=3.0)  # left open: in flight
    assert trk.conservation(buffered_records=1)["imbalance"] == 0
    assert trk.conservation(buffered_records=0)["imbalance"] == 1
    return trk


def _random_marks(side, rng, n=60):
    """A random mix: intake, open (some spilled, some sharded), then a
    mark on a random open tag (pool, archive, replay, commit, commit
    and queryable, drop, or nothing), out of order; after every mark the
    watermarks are monotone and Wq <= Wc, as tests/test_lineage.py's
    property asks."""
    trk = side.pkg.LineageTracker(sample_rate=0.3, max_tags=32, max_timeline=40)
    open_tags = []
    last = (None, None)
    for i in range(n):
        now = float(i)
        recs = _recs(*(now - rng.integers(0, 4, size=int(rng.integers(1, 5)))))
        trk.observe_intake(recs)
        open_tags.append(trk.open_batch(recs, now=now, shard=int(rng.integers(0, 3)) or None,
                                        spilled=bool(rng.random() < 0.2)))
        pick = open_tags[int(rng.integers(len(open_tags)))]
        action = ("pool", "archive", "replay", "commit", "query", "drop",
                  "hold")[int(rng.integers(7))]
        if action == "pool":
            trk.mark_pooled(pick, now)
        elif action == "archive":
            trk.mark_archived(pick, now, degraded=bool(rng.random() < 0.3))
        elif action == "replay":
            trk.mark_replay(pick, now)
        elif action in ("commit", "query"):
            trk.mark_committed(pick, now)
            if action == "query":
                trk.mark_queryable(pick, now + float(rng.random()))
        elif action == "drop":
            trk.mark_dropped(pick, now)
        if pick.t_queryable is not None or pick.dropped:
            open_tags.remove(pick)
        wm = trk.watermarks()
        wc, wq = wm["committed"], wm["queryable"]
        assert last[0] is None or wc is None or wc >= last[0]
        assert last[1] is None or wq is None or wq >= last[1]
        assert wc is None or wq is None or wq <= wc
        last = (wc if wc is not None else last[0], wq if wq is not None else last[1])
    return trk


def _state_round_trip(side, rng):
    """Half the random mix, `state()` into a fresh tracker, then the
    rest of the marks on the restored one."""
    first = _random_marks(side, rng, n=30)
    trk = side.pkg.LineageTracker(sample_rate=0.3, max_tags=32, max_timeline=40)
    trk.restore_state(copy.deepcopy(first.state()))
    assert norm_state(trk.state()) == norm_state(first.state())
    for tag in list(trk.open_tags.values())[::2]:
        trk.mark_committed(tag, 40.0)
        trk.mark_queryable(tag, 41.0)
    return trk


def _timeline_via_hub(side, rng):
    """Bound to a hub: each tick event re-emits the watermarks as a
    "watermark" event and a timeline row."""
    hub = side.Hub()
    trk = side.pkg.LineageTracker(dt=1.0).bind(hub)
    seen = []
    hub.subscribe(lambda ev: seen.append((ev.kind, ev.t, dict(ev.payload))))
    pending = []
    for i in range(1, 30):
        now = float(i)
        hub.emit("tick", now, raw=1, kept=1)
        recs = _recs(*([now] * int(rng.integers(1, 4))))
        trk.observe_intake(recs)
        pending.append(trk.open_batch(recs, now=now))
        if not 10 <= i < 16:  # an outage: nothing lands for six ticks
            for tag in pending:
                trk.mark_committed(tag, now)
                trk.mark_queryable(tag, now)
            pending = []
    trk.seen_events = seen
    return trk


TRACKER_CASES = {
    "commit_then_queryable": _commit_then_queryable,
    "buffered_classification": _buffered_classification,
    "dropped_releases_both": _dropped_releases_both,
    "out_of_order_stall": _out_of_order_stall,
    "path_precedence": _path_precedence,
    "conservation_open_tags": _conservation_open_tags,
    "random_marks": _random_marks,
    "state_round_trip": _state_round_trip,
    "timeline_via_hub": _timeline_via_hub,
}


@pytest.mark.parametrize("case", sorted(TRACKER_CASES))
def test_tracker_matches_reference(case):
    got, want = (TRACKER_CASES[case](side, np.random.default_rng(11))
                 for side in (PORT, REF))
    assert tracker_view(got) == tracker_view(want)
    assert list(got.timeline) == list(want.timeline)
    if case == "timeline_via_hub":
        assert got.seen_events == want.seen_events
        assert len(got.timeline) == 28  # none before the first commit
        stalled = [r["queryable"] for r in got.timeline if 11.0 <= r["t"] <= 15.0]
        assert len(set(stalled)) == 1
    if case == "path_precedence":
        assert got.path_counts == {"direct": 1, "buffered": 2, "spilled": 2, "archived": 4}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watermark_set_matches_reference(seed):
    """add/remove of random event-time counts, late duplicates and
    partial removes: the same watermark, depth and state each step."""
    rng = np.random.default_rng(seed)
    sets = [side.WS() for side in (PORT, REF)]
    assert [s.watermark() for s in sets] == [None, None]
    added = []
    for _ in range(80):
        if added and rng.random() < 0.45:
            counts = added.pop(int(rng.integers(len(added))))
            if rng.random() < 0.3:  # remove part of it
                counts = {ts: max(1, c // 2) for ts, c in counts.items()}
            for s in sets:
                s.remove(counts)
        else:
            counts = {float(t): int(c) for t, c in
                      zip(rng.integers(0, 20, size=3), rng.integers(1, 4, size=3))}
            added.append(counts)
            for s in sets:
                s.add(counts)
        got, want = sets
        assert (got.watermark(), got.depth, got.state()) == \
            (want.watermark(), want.depth, want.state())
    again = _WatermarkSet()
    again.restore_state(sets[0].state())
    assert (again.watermark(), again.depth, again.max_seen) == \
        (sets[1].watermark(), sets[1].depth, sets[1].max_seen)


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


def _exported(side):
    trk = _random_marks(side, np.random.default_rng(5), n=80)
    hub = side.Hub()
    trk.bind(hub)
    for i in range(80, 100):
        hub.emit("tick", float(i), raw=1, kept=1)
    return trk


def _flows(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def _jsonl(path):
    out = []
    for line in open(path):
        x = json.loads(line)
        x.pop("exporter", None)
        for h in x.get("hops", ()):
            h.pop("wall_ns")
        out.append(x)
    return out


EXPORTERS = ("sample_tags", "flow_events", "validate_flow_events", "write_lineage_jsonl",
             "freshness_table", "watermark_timeline", "prometheus_lines", "empty_tracker")


@pytest.mark.parametrize("name", EXPORTERS)
def test_exporter_matches_reference(name, tmp_path):
    got, want = _exported(PORT), _exported(REF)
    if name == "sample_tags":
        for rate in (None, 0.05, 0.5, 1.0):
            g, w = L.sample_tags(got, rate=rate), RL.sample_tags(want, rate=rate)
            assert [_tag(t) for t in g] == [_tag(t) for t in w]
        assert {t.path for t in L.sample_tags(got, rate=0.0)} == set(got.path_counts)
    elif name == "flow_events":
        for rate in (None, 1.0):
            g, w = L.flow_events(got, 0, rate=rate), RL.flow_events(want, 0, rate=rate)
            assert _flows(g) == _flows(w) and len(g) > 10
    elif name == "validate_flow_events":
        trace = {"traceEvents": L.flow_events(got, 0)}
        path = tmp_path / "t.json"
        path.write_text(json.dumps(trace))
        paths = sorted(got.path_counts)
        for arg in (trace, str(path), json.dumps(trace)):
            assert L.validate_flow_events(arg, require_paths=paths) == \
                RL.validate_flow_events(arg, require_paths=paths)
        assert L.validate_flow_events(trace, require_paths=paths)[0]
        chain = {"traceEvents": [{"name": "batch:direct", "cat": "lineage", "ph": "s",
                                  "id": 1, "pid": 0, "tid": 0, "ts": 0.0}]}
        bad = [chain, {"traceEvents": []}, {"x": 1}, "{not json", str(tmp_path / "none"),
               {"traceEvents": [{"cat": "lineage", "ph": "s"}]}]
        for arg in bad:
            g = L.validate_flow_events(arg, require_paths=["direct"])
            w = RL.validate_flow_events(arg, require_paths=["direct"])
            assert not g[0] and g == w
    elif name == "write_lineage_jsonl":
        g, w = tmp_path / "g.jsonl", tmp_path / "w.jsonl"
        for rate in (None, 1.0):
            L.write_lineage_jsonl(got, str(g), meta={"scenario": "x"}, rate=rate)
            RL.write_lineage_jsonl(want, str(w), meta={"scenario": "x"}, rate=rate)
            assert _jsonl(g) == _jsonl(w)
        assert json.loads(open(g).readline())["exporter"] == "repro_torch.lineage"
        assert {x["type"] for x in _jsonl(g)} == {"meta", "batch", "freshness", "watermark"}
    elif name == "freshness_table":
        assert L.freshness_table(got) == RL.freshness_table(want)
        assert "archived" in L.freshness_table(got)
    elif name == "watermark_timeline":
        for rows in (5, 20, 100):
            assert L.watermark_timeline(got, max_rows=rows) == \
                RL.watermark_timeline(want, max_rows=rows)
    elif name == "prometheus_lines":
        assert L.prometheus_lines(got) == RL.prometheus_lines(want)
        assert len(L.prometheus_lines(got)) > 8
    else:
        empty = (L.LineageTracker(), RL.LineageTracker())
        assert L.freshness_table(empty[0]) == RL.freshness_table(empty[1])
        assert L.watermark_timeline(empty[0]) == RL.watermark_timeline(empty[1])
        assert L.prometheus_lines(empty[0]) == RL.prometheus_lines(empty[1])
        assert L.flow_events(empty[0], 0) == RL.flow_events(empty[1], 0) == []


# ---------------------------------------------------------------------------
# resilience: RetryPolicy and FaultInjector
# ---------------------------------------------------------------------------


POLICIES = [dict(), dict(jitter=0.0), dict(factor=1.0), dict(base_s=0.1, factor=3.0, cap_s=7.0),
            dict(seed=7, jitter=0.5), dict(base_s=1.0, factor=1.0 + 1e-9, cap_s=1e300)]


@pytest.mark.parametrize("kw", POLICIES, ids=[str(i) for i in range(len(POLICIES))])
def test_retry_policy_matches_reference(kw):
    got, want = R.RetryPolicy(**kw), RR.RetryPolicy(**kw)
    assert [got.delay(k) for k in range(65)] == [want.delay(k) for k in range(65)]
    assert [got.raw_delay(k) for k in range(65)] == [want.raw_delay(k) for k in range(65)]
    assert got.delay(10**9) == want.delay(10**9)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for k in (0, 1, 2**31, 2**40 + 3):
        assert _hash01(k) == ref_hash01(k)


@pytest.mark.parametrize("kw", [dict(base_s=0.0), dict(factor=0.5), dict(cap_s=0.1),
                                dict(jitter=1.0), dict(jitter=-0.1)])
def test_retry_policy_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError):
        RR.RetryPolicy(**kw)
    with pytest.raises(ValueError):
        R.RetryPolicy(**kw)
    with pytest.raises(ValueError):
        R.RetryPolicy().raw_delay(-1)


def test_fault_injector_matches_reference():
    """Attempt windows, simulated-time windows (the ingestor passes its
    commit's `now`), zero-length slow windows, and the attempt counter's
    `state()` round trip mid-sequence."""
    kw = dict(fail_attempts=((3, 6), (40, 41)), fail_times=((20.0, 26.0), (50.5, 51.0)),
              slow_attempts=((1, 4, 0.0),), crash_at_tick=30)
    plans = R.FaultPlan(**kw), RR.FaultPlan(**kw)
    assert dataclasses.asdict(plans[0].without_crash()) == \
        dataclasses.asdict(plans[1].without_crash())
    assert plans[0].without_crash().crash_at_tick is None and plans[0].crash_at_tick == 30
    injectors = [R.FaultInjector(plans[0]), RR.FaultInjector(plans[1])]
    assert all(i.wants_now for i in injectors)
    calls = [(float(t) / 2.0 if t % 5 else None) for t in range(130)]
    got, want = [], []
    for j, now in enumerate(calls):
        if j == 64:  # resume the port's from its state
            fresh = R.FaultInjector(plans[0])
            fresh.restore_state(injectors[0].state())
            injectors[0] = fresh
        got.append(injectors[0](now) if now is not None else injectors[0]())
        want.append(injectors[1](now) if now is not None else injectors[1]())
        assert injectors[0].state() == injectors[1].state()
    assert got == want and any(got) and not all(got)
    killed = (R.PipelineKilled(7), RR.PipelineKilled(7))
    assert (str(killed[0]), killed[0].tick) == (str(killed[1]), killed[1].tick)


# ---------------------------------------------------------------------------
# the hooks: buffer stage and ingestor
# ---------------------------------------------------------------------------


def _stage_ops(stage, rng, trk):
    """extend/take/spill/drain in a random order; the stage's flags and
    counts after each op."""
    stage.lineage = trk
    stage.controller.beta = 7
    seen = []
    for i in range(40):
        op = ("extend", "extend", "take", "spill", "drain", "take_all")[int(rng.integers(6))]
        if op == "extend":
            stage.extend(_recs(*([float(i)] * int(rng.integers(1, 9)))))
        elif op == "take":
            batch = stage.take_batch()
            if batch:
                trk.open_batch(batch, float(i), spilled=stage.last_take_spilled)
        elif op == "spill":
            stage.spill_all()
        elif op == "drain":
            stage.drain_spill()
        else:
            stage.take_all()
        seen.append((op, len(stage), list(stage._spill_flags), stage.spilled_records,
                     stage.last_take_spilled, stage.spill_depth))
    return seen, stage.state()


def test_buffer_stage_spill_flags_match_reference(tmp_path):
    got = _stage_ops(BufferControlStage(cfg=IngestConfig(), spill_dir=str(tmp_path / "p"),
                                        device="cpu"), np.random.default_rng(2),
                     gtrk := L.LineageTracker())
    with jax.enable_x64(True):
        want = _stage_ops(RefBufferStage(cfg=RefIngestConfig(), spill_dir=str(tmp_path / "r")),
                          np.random.default_rng(2), wtrk := RL.LineageTracker())
    assert got[0] == want[0]
    assert any(s[4] for s in got[0]) and any(s[3] for s in got[0])
    for key in ("buffer", "max_buffered", "spill_flags", "spilled_records"):
        assert got[1][key] == want[1][key], key
    # drained records are not observed twice
    assert tracker_view(gtrk) == tracker_view(wtrk)
    again = BufferControlStage(cfg=IngestConfig(), spill_dir=str(tmp_path / "q"), device="cpu")
    again.restore_state(got[1])
    assert (again._spill_flags, again.spilled_records) == \
        (got[1]["spill_flags"], got[1]["spilled_records"])


def _tweets(tag, n):
    return [{"id": f"{tag}{i}", "user": f"u{tag}{i % 3}", "hashtags": ["x"], "mentions": [],
             "ts": float(tag)} for i in range(n)]


class _Sink:
    def __init__(self, ingestor):
        self.ingestor = ingestor


def _ingest_script(ing, et_of, pkg, resilience):
    """Pushes at t = 1..40 with tags staged by the tracker, under a
    store outage over [8, 20) and failed attempts 2 and 3: the pool
    (max_pool_size 0 for t 3 to 5, pool_cap 2: two pooled, one
    overflow), the failed-commit and degraded archives, the archive
    spilled to disk past 2 batches, replays with the backoff gate and a
    failed head.  Returns the tracker and the ingestor's accounting
    after each step."""
    trk = pkg.LineageTracker(dt=1.0)
    ing.lineage = trk
    ing.fail_hook = resilience.FaultInjector(resilience.FaultPlan(
        fail_attempts=((2, 4),), fail_times=((8.0, 20.0),)))
    ing.retry_policy = resilience.RetryPolicy(jitter=0.0, base_s=1.0)
    sink = _Sink(ing)
    steps = []
    for t in range(1, 41):
        now = float(t)
        ing.max_pool_size = 0 if 3 <= t <= 5 else 4
        ing.pool_cap = 2
        recs = _tweets(t, 3 + t % 4)
        trk.observe_intake(recs)
        tag = trk.open_batch(recs, now)
        handed = trk.stage_commit(tag, sink)
        out = ing.push(et_of(recs), now=now)
        trk.after_commit(tag, out, now, handed=handed)
        ing.retry_archive(now)
        assert ing.archived_total == ing.replayed + ing.archive_depth
        steps.append((sorted(out), ing.attempts, ing.archived_total, ing.replayed,
                      ing.archive_depth, len(ing.archive), len(ing.pool), ing.pool_overflows,
                      ing.consecutive_failures, ing.next_retry_t,
                      [x.batch_id for x in ing._pool_tags],
                      [x.batch_id for x in ing._archive_tags]))
    return trk, steps


def test_ingestor_tag_custody_matches_reference(tmp_path):
    ing = GraphIngestor(init_store(512, 2048, device="cpu"), max_archive=2,
                        archive_dir=str(tmp_path / "p"))
    gtrk, got = _ingest_script(
        ing, lambda recs: from_raw_batch(create_edges(recs, tweet_mapping()), 64, device="cpu"),
        L, R)
    with jax.enable_x64(True):
        ref = RefIngestor(ref_init_store(512, 2048), max_archive=2,
                          archive_dir=str(tmp_path / "r"))
        wtrk, want = _ingest_script(
            ref, lambda recs: ref_from_raw(ref_create_edges(recs, ref_tweet_mapping()), 64),
            RL, RR)
    assert got == want
    assert tracker_view(gtrk) == tracker_view(wtrk)
    assert set(gtrk.path_counts) == {"direct", "buffered", "archived"}
    assert gtrk.replays > 0 and ing.pool_overflows > 0 and any(s[5] < s[4] for s in got)
    tags = [t for t in gtrk.completed if t.degraded]
    assert tags and all(t.path == "archived" for t in tags)
    state = ing.state()
    assert state["archive_tags"] == list(ing._archive_tags)
    again = GraphIngestor(init_store(512, 2048, device="cpu"), archive_dir=str(tmp_path / "q"))
    again.restore_state(state)
    assert list(again._pool_tags) == list(ing._pool_tags)
    assert list(again._archive_tags) == list(ing._archive_tags)


# ---------------------------------------------------------------------------
# launch.lineage --dryrun's deployment, both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """The reference's `run_scenario` at `launch.lineage --dryrun`'s
    deployment (lineage, the monitor, a trace and the lineage JSONL, a
    store outage over 20:26 with the default RetryPolicy).  Then,
    replaying it on the CPU, the port's `run_scenario` with the same
    options and `launch.lineage --dryrun --device cpu`."""
    tmp = tmp_path_factory.mktemp("lineage")
    ref_trk, ref_mon = RL.LineageTracker(), RM.HealthMonitor()
    ref = _reference_run(tmp, False, lineage=ref_trk, monitor=ref_mon,
                         trace=str(tmp / "ref.json"), lineage_jsonl=str(tmp / "ref.jsonl"),
                         fault_plan=RR.FaultPlan(fail_times=(OUTAGE,)))
    trk, mon = L.LineageTracker(), M.HealthMonitor()
    argv = ["--dryrun", "--device", "cpu", "--trace-out", str(tmp / "cli.json"),
            "--jsonl-out", str(tmp / "cli.jsonl"), "--prom-out", str(tmp / "cli.prom")]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        built = _replaying(mp, tmp, ref)
        run = harness.run_scenario(SCENARIO, ticks=TICKS, seed=SEED, device="cpu",
                                   lineage=trk, monitor=mon, trace=str(tmp / "run.json"),
                                   lineage_jsonl=str(tmp / "run.jsonl"),
                                   fault_plan=R.FaultPlan(fail_times=(OUTAGE,)), **CAPS)
        run_pipe = built["pipe"]
        with contextlib.redirect_stdout(out):
            code, rep, cli_trk, cli_mon = cli.run(argv)
        cli_pipe = built["pipe"]
    return dict(ref=ref, ref_trk=ref_trk, ref_mon=ref_mon, run=run, trk=trk, mon=mon,
                run_pipe=run_pipe, code=code, rep=rep, cli_trk=cli_trk, cli_mon=cli_mon,
                cli_pipe=cli_pipe, out=out.getvalue(), tmp=tmp)


# report fields that a wall clock or the monitor's wall-clock series set
WALL_REPORT = WALL_FIELDS + ("stage_latency_ms", "health_events", "slo_summary",
                             "slo_breaches", "slo_alerts", "controller_score",
                             "decision_quality")


@pytest.mark.parametrize("which", ["run", "rep"])
def test_dryrun_report_matches_reference(dryrun, which):
    """Every field but the wall-clock ones, the store and snapshot digests
    included (the run is resilient, so both packages fill them); the
    detector events and SLOs but the wall-clock ones; the controller
    score within F2's printed tolerance."""
    rep, want = dryrun[which], dryrun["ref"]["report"]
    g, w = rep.to_dict(), want.to_dict()
    for k in WALL_REPORT:
        g.pop(k), w.pop(k)
    assert g == w
    assert rep.lineage_enabled and rep.path_mix["archived"] > 0 and rep.path_mix["direct"] > 0
    assert rep.commit_failures > 0 and rep.retries_replayed == rep.archived_total > 0
    assert rep.records_in == rep.records_committed + rep.records_dropped + rep.records_in_flight
    assert not rep.conservation_warning and rep.watermark_final["queryable"] is not None
    assert (rep.store_digest, rep.snapshot_digest) == (want.store_digest, want.snapshot_digest)
    assert rep.store_digest and rep.snapshot_digest
    assert _steady_events(rep.health_events) == _steady_events(want.health_events)
    for name, s in rep.slo_summary.items():
        if name not in WALL_SLOS:
            assert s == want.slo_summary[name], name
    assert rep.controller_score == pytest.approx(want.controller_score, abs=PRINTED_ATOL)


@pytest.mark.parametrize("which", ["trk", "cli_trk"])
def test_dryrun_tracker_matches_reference(dryrun, which):
    """State, watermarks, freshness histograms, timeline and conservation;
    the queryable watermark holds through the outage and moves after it."""
    got, want = dryrun[which], dryrun["ref_trk"]
    assert tracker_view(got) == tracker_view(want)
    assert list(got.timeline) == list(want.timeline) and len(got.timeline) == TICKS - 1
    held = {r["queryable"] for r in got.timeline if OUTAGE[0] + 1 <= r["t"] <= OUTAGE[1]}
    assert len(held) == 1 and got.watermarks()["queryable"] > held.pop()
    fresh = got.freshness()
    assert fresh["archived"]["queryable"]["p99_ms"] > fresh["direct"]["queryable"]["p99_ms"]


def test_dryrun_freshness_slo_and_series_match_reference(dryrun):
    """The monitor's lag series come from the tracker's watermark events
    in the tick row the monitor just opened; the freshness SLO's
    breaches and burn alerts land on the reference's ticks."""
    got, want = dryrun["mon"], dryrun["ref_mon"]
    rows = [(r["tick"], r["ingest_lag_ms"], r["queryable_lag_ms"]) for r in got.history]
    assert rows == [(r["tick"], r["ingest_lag_ms"], r["queryable_lag_ms"])
                    for r in want.history]
    assert sum(q is not None for _, _, q in rows) == TICKS - 1
    slo = dryrun["run"].slo_summary["freshness"]
    assert slo == dryrun["ref"]["report"].slo_summary["freshness"]
    onsets = [a for a in slo["alerts"] if a["phase"] == "onset"]
    assert onsets and slo["breaches"] > 0
    assert M.prometheus_text(monitor=got, lineage=dryrun["trk"]).endswith(
        "\n".join(RL.prometheus_lines(dryrun["ref_trk"])) + "\n")


def test_dryrun_ingestor_accounting_matches_reference(dryrun):
    ref_ing = dryrun["ref"]["pipe"].sink.ingestor
    for pipe in (dryrun["run_pipe"], dryrun["cli_pipe"]):
        ing = pipe.sink.ingestor
        assert (ing.attempts, ing.archived_total, ing.replayed, ing.archive_depth,
                ing.pool_overflows, ing.fail_hook.attempts) == \
            (ref_ing.attempts, ref_ing.archived_total, ref_ing.replayed,
             ref_ing.archive_depth, ref_ing.pool_overflows, ref_ing.fail_hook.attempts)
        assert [c.ok for c in ing.commits] == [c.ok for c in ref_ing.commits]
        assert ing.archived_total == ing.replayed + ing.archive_depth


def _trace_flows(path):
    with open(path) as f:
        trace = json.load(f)
    return _flows(e for e in trace["traceEvents"] if e.get("cat") == "lineage")


def test_dryrun_files_match_reference(dryrun):
    """The lineage JSONL (exporter name and wall column masked), the
    trace's flow events (timestamps masked) and their validation, and
    the Prometheus exposition's lineage gauges."""
    tmp = dryrun["tmp"]
    want = _jsonl(tmp / "ref.jsonl")
    assert _jsonl(tmp / "run.jsonl") == want
    assert _trace_flows(tmp / "run.json") == _trace_flows(tmp / "ref.json")
    assert _trace_flows(tmp / "cli.json") == _trace_flows(tmp / "ref.json")
    paths = sorted(dryrun["ref"]["report"].path_mix)
    ok, msg = RL.validate_flow_events(str(tmp / "ref.json"), require_paths=paths)
    assert ok and L.validate_flow_events(str(tmp / "run.json"), require_paths=paths) == (ok, msg)
    lines = RL.prometheus_lines(dryrun["ref_trk"])
    with open(tmp / "cli.prom") as f:
        prom = f.read()
    assert prom.endswith("\n".join(lines) + "\n")
    assert L.prometheus_lines(dryrun["cli_trk"]) == lines


def _cli_printout(ref, trk, tmp, msg):
    """What the reference's `launch.lineage --dryrun` prints for its run,
    built from its report and exporters (importing the reference's CLI
    would flip x64 for the whole worker)."""
    rep = ref["report"]
    slo = rep.slo_summary["freshness"]
    alerts = [a for a in slo["alerts"] if a["phase"] == "onset"]
    return "\n".join([
        rep.summary(), "", RL.freshness_table(trk), "", RL.watermark_timeline(trk, max_rows=20),
        "",
        f"conservation: in={rep.records_in} committed={rep.records_committed} "
        f"dropped={rep.records_dropped} in_flight={rep.records_in_flight} -> BALANCED",
        f"freshness SLO: {slo['objective']} — {slo['breaches']}/{slo['ticks']} breaching "
        f"ticks (budget consumed {slo['budget_consumed']:.2f}x), {len(alerts)} burn alerts"
        + (f", first onset tick {slo['first_alert_tick']}" if alerts else ""),
        f"(wrote Prometheus exposition to {tmp / 'cli.prom'})",
        f"(wrote Chrome trace with flow events to {tmp / 'cli.json'})",
        f"(wrote lineage JSONL to {tmp / 'cli.jsonl'})",
        f"dryrun ok: {msg}", ""])


def test_dryrun_cli_prints_the_reference_output(dryrun):
    """`launch.lineage --dryrun --device cpu` prints what the reference's
    CLI prints for its run, the wall-clock parts masked (as
    tests/test_torch_telemetry.py masks the monitor CLI's)."""
    assert dryrun["code"] == 0
    tmp = dryrun["tmp"]
    paths = sorted(dryrun["ref"]["report"].path_mix)
    ok, msg = RL.validate_flow_events(str(tmp / "ref.json"), require_paths=paths)
    want = _cli_printout(dryrun["ref"], dryrun["ref_trk"], tmp, msg)
    got_text, got_num = _mask_monitor(dryrun["out"])
    want_text, want_num = _mask_monitor(want)
    assert got_text == want_text
    assert len(got_num) == len(want_num) > 0
    np.testing.assert_allclose(got_num, want_num, rtol=0, atol=PRINTED_ATOL)
    assert re.search(r"^lineage: \d+ in -> .* paths: archived=\d+ direct=\d+ \| Wq=",
                     dryrun["out"], re.M)
    assert "dryrun ok" in dryrun["out"]


def test_crash_at_tick_waits_for_the_checkpoint_slice():
    """A plan's `crash_at_tick` is the checkpoint loop's to honour: the run
    is killed with `PipelineKilled` once that tick is processed, rather
    than running on past it (the resume is in test_torch_checkpoint.py)."""
    plan = R.FaultPlan(fail_times=((2.0, 4.0),), crash_at_tick=6)
    with pytest.raises(R.PipelineKilled) as killed:
        harness.run_scenario(SCENARIO, ticks=20, device="cpu", lineage=True, fault_plan=plan,
                             **CAPS)
    assert killed.value.tick == 6
    rep = harness.run_scenario(SCENARIO, ticks=8, device="cpu", **CAPS,
                               fault_plan=plan.without_crash())
    assert rep.commit_failures > 0


def test_retry_false_leaves_the_archive_unreplayed():
    rep = harness.run_scenario(SCENARIO, ticks=12, device="cpu", lineage=True, retry=False,
                               fault_plan=R.FaultPlan(fail_times=((2.0, 5.0),)), **CAPS)
    assert rep.commit_failures > 0 and rep.retries_replayed == 0
    assert rep.archive_remaining == rep.archived_total > 0
    assert rep.path_mix.get("archived", 0) == 0 and not rep.conservation_warning
