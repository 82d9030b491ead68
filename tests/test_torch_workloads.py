"""Port parity: the workload harness (`launch.workload`'s path), raw and
with GraphZip dictionary compression.

The reference runs `repro.workloads.run_scenario("flash_crowd",
ticks=60, seed=0, node_cap=2**12, edge_cap=2**14)` (the CLI's
`--dryrun` size, x64) once without and once with `dict_compress`,
recording the records its `ScenarioSource` yields and the controller's
per-tick (action, beta).

  * Record streams: the port's `ScenarioSource` on the CPU yields the
    same ticks with the same record counts.  Records are built from the
    sampled ids, whose Zipf ranks may differ from the reference's on a
    few lanes (ROADMAP F1: on this stream 12 of the 17,308 records the
    reference generates).  A record carries three sampled ranks, and a
    duplicate repeats an earlier record's, so the bound is twice the
    per-lane bound of tests/test_torch_sampler.py: 2 in 10^3 records.
  * The port's `run_scenario` then replays the reference's records and
    decisions (as tests/test_torch_pipeline.py does: the float32 RLS
    sums in another order, F2), and must give the same report (every
    field but the wall-clock ones), the same store, and with
    compression the same dictionary, bit for bit.
  * `launch.workload --dryrun --device cpu --dict-compress` under the
    same replay prints the reference's report, wall-clock numbers aside.
  * `run_scenario(shards=2, sketch_guided=True)` under per-shard replay
    gives the reference's report and store.
  * `state()`/`restore_state()` resumes a stream mid-chunk exactly.
"""
import copy
import dataclasses
import re

import jax
import numpy as np
import pytest

from repro.api import PipelineBuilder as RefBuilder
from repro.workloads import harness as ref_harness
from repro.workloads.source import ScenarioSource as RefScenarioSource
from repro_torch import convert
from repro_torch.api import PipelineBuilder
from repro_torch.core.buffer import BufferController
from repro_torch.ingest.sources import StreamTick
from repro_torch.launch import workload
from repro_torch.workloads import ScenarioSource
from repro_torch.workloads import harness

SCENARIO, TICKS, SEED = "flash_crowd", 60, 0
CAPS = dict(node_cap=1 << 12, edge_cap=1 << 14)
RECORD_MISMATCH_MAX = 2e-3  # F1: twice the per-lane bound
WALL_FIELDS = ("wall_s", "records_per_wall_s", "commit_ms_mean")


class ReplayController(BufferController):
    """Takes the reference's decisions, tick by tick, in place of its own.
    The audit trail records the controller's own decision first, so the
    open record is rewritten to the one taken.  A restored controller
    (a resumed run) skips the decisions its state has taken already."""

    def __init__(self, cfg, decisions, **kw):
        super().__init__(cfg, **kw)
        self._decisions = iter(decisions)

    def restore_state(self, s):
        super().restore_state(s)
        for _ in range(sum(s["decision_counts"].values())):
            next(self._decisions)

    def decide(self, edge_table_size, density, now=None):
        dec = super().decide(edge_table_size, density, now)
        action, beta, reason = next(self._decisions)
        self.beta = beta
        rec = None if self.audit is None else self.audit._open
        if rec is not None:
            rec.action, rec.beta, rec.reason = action, beta, reason
        return dataclasses.replace(dec, action=action, beta=beta, reason=reason)


class ReplaySource:
    """Yields recorded ticks (copies, so a run cannot alter them).  Its
    cursor is the stream time of the last tick yielded, so it restores
    from its own `state()` or from a `ScenarioSource`'s of either
    package (a resumed run)."""

    def __init__(self, ticks, dt=1.0):
        self._ticks, self.dt = ticks, dt
        self._next = 0

    def ticks(self):
        while self._next < len(self._ticks):
            t, records = self._ticks[self._next]
            self._next += 1
            yield StreamTick(t, copy.deepcopy(records))

    def state(self):
        return {"t": self._ticks[self._next - 1][0] if self._next else 0.0}

    def restore_state(self, s):
        self._next = sum(1 for t, _ in self._ticks if t <= s["t"])


def _reference_run(tmp, dict_compress, shards=1, sketch_guided=False, ticks=TICKS, x64=True,
                   **options):
    """The reference's `run_scenario` over `ticks` (`options` passed on),
    recording its ticks, each shard's (action, beta, reason) decisions,
    the built pipeline, its store and its dictionary.  It keys the graph
    with uint64 under x64 and with uint32 with `x64=False`."""
    rec = {"ticks": [], "decisions": [[] for _ in range(shards)]}

    class RecordingSource(RefScenarioSource):
        def ticks(self):
            for tick in super().ticks():
                rec["ticks"].append((tick.t, copy.deepcopy(tick.records)))
                yield tick

    class RecordingBuilder(RefBuilder):
        def build(self):
            pipe = super().build()
            ctrls = [s.controller for s in pipe.shards] if shards > 1 else [pipe.controller]
            for c, dec in zip(ctrls, rec["decisions"]):
                c.on_decision = lambda d, dec=dec: dec.append((d.action, d.beta, d.reason))
            rec["pipe"], rec["dict"] = pipe, self.dictionary_stage
            return pipe

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_harness, "ScenarioSource", RecordingSource)
        mp.setattr(ref_harness, "PipelineBuilder", RecordingBuilder)
        with jax.enable_x64(x64):
            rec["report"] = ref_harness.run_scenario(
                SCENARIO, ticks=ticks, seed=SEED, dict_compress=dict_compress, shards=shards,
                sketch_guided=sketch_guided,
                spill_dir=str(tmp / f"ref_{dict_compress}_{shards}"), **CAPS, **options)
            store = rec["pipe"].store
            rec["store"] = {f.name: np.asarray(getattr(store, f.name))
                            for f in dataclasses.fields(store)}
            if dict_compress:
                rec["dict_stats"] = rec["dict"].stats()
                rec["dict_arrays"] = {f.name: np.asarray(getattr(rec["dict"].dct, f.name))
                                      for f in dataclasses.fields(rec["dict"].dct)}
    return rec


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("workloads")
    return {dc: _reference_run(tmp, dc) for dc in (False, True)}


def _replaying(mp, tmp, ref):
    """Patch the port's harness to replay `ref`'s records and decisions;
    returns the dict the built pipeline and dictionary stage land in."""
    got = {}

    class ReplayBuilder(PipelineBuilder):
        def build(self):
            def replay(si):
                return ReplayController(self.cfg, ref["decisions"][si], device=self.device,
                                        spill_dir=str(tmp / f"port_spill{si}"))

            if len(ref["decisions"]) == 1:
                self.with_controller(replay(0))
            got["pipe"] = super().build()
            if len(ref["decisions"]) > 1:
                for si, shard in enumerate(got["pipe"].shards):
                    ctrl = replay(si)
                    ctrl.audit = shard.controller.audit  # the trail PipelineBuilder attached
                    shard.controller = ctrl
            got["dict"] = self.dictionary_stage
            return got["pipe"]

    mp.setattr(harness, "ScenarioSource",
               lambda scn, seed, rate_scale, device: ReplaySource(ref["ticks"]))
    mp.setattr(harness, "PipelineBuilder", ReplayBuilder)
    return got


def _records(ticks):
    return [r for _, recs in ticks for r in recs]


def test_scenario_source_stream_matches_reference(reference):
    want = reference[False]["ticks"]
    src = ScenarioSource(SCENARIO, seed=SEED, device="cpu")
    got = [(t.t, t.records) for t, _ in zip(src.ticks(), range(len(want)))]
    assert [(t, len(r)) for t, r in got] == [(t, len(r)) for t, r in want]
    g, w = _records(got), _records(want)
    differ = sum(a != b for a, b in zip(g, w))
    assert differ <= RECORD_MISMATCH_MAX * len(w), (differ, len(w))
    # only the sampled ids can differ: ids, texts and timestamps agree
    assert [(a["id"], a["text"], a["ts"]) for a in g] == [(b["id"], b["text"], b["ts"]) for b in w]


def test_scenario_source_state_round_trip():
    src = ScenarioSource("celebrity_cascade", seed=3, device="cpu")
    it = src.ticks()
    for _ in range(70):  # past the first 64-tick chunk: a cursor mid-chunk
        next(it)
    state = copy.deepcopy(src.state())
    assert state["pending"]
    tail = [next(it) for _ in range(10)]
    again = ScenarioSource("celebrity_cascade", seed=3, device="cpu")
    again.restore_state(state)
    it2 = again.ticks()
    for want in tail:
        got = next(it2)
        assert (got.t, got.records) == (want.t, want.records)


@pytest.mark.parametrize("dict_compress", [False, True])
def test_run_scenario_under_replay_matches_reference(reference, tmp_path, monkeypatch,
                                                     dict_compress):
    ref = reference[dict_compress]
    got = _replaying(monkeypatch, tmp_path, ref)
    rep = harness.run_scenario(SCENARIO, ticks=TICKS, seed=SEED, dict_compress=dict_compress,
                               device="cpu", **CAPS)
    g, w = rep.to_dict(), ref["report"].to_dict()
    for k in WALL_FIELDS:
        g.pop(k), w.pop(k)
    assert g == w
    assert rep.total_records > 0 and rep.transitions
    store = convert.store_to_numpy(got["pipe"].store)
    for name, arr in ref["store"].items():
        np.testing.assert_array_equal(store[name], arr.astype(store[name].dtype), err_msg=name)
    if dict_compress:
        assert rep.pattern_refs > 0
        assert got["dict"].stats() == ref["dict_stats"]
        arrays = convert.dictionary_to_numpy(got["dict"].dct)
        for name, arr in ref["dict_arrays"].items():
            np.testing.assert_array_equal(arrays[name], arr.astype(arrays[name].dtype),
                                          err_msg=name)


def _mask_wall(text):
    text = re.sub(r"[\d.]+/s wall", "<wall>", text)
    return re.sub(r"commit_ms=[\d.]+", "commit_ms=<wall>", text)


def test_dryrun_cli_prints_the_reference_report(reference, tmp_path, monkeypatch, capsys):
    ref = reference[True]
    _replaying(monkeypatch, tmp_path, ref)
    code, rep = workload.run(["--dryrun", "--device", "cpu", "--dict-compress"])
    assert code == 0
    r = ref["report"]
    lines = [r.summary(), f"buffer-mode timeline (first {min(12, r.n_transitions)} of "
                          f"{r.n_transitions} transitions):"]
    lines += [f"  t={tr['t']:7.1f}  {tr['from']} -> {tr['to']}" for tr in r.transitions[:12]]
    lines.append("dryrun ok")
    assert _mask_wall(capsys.readouterr().out) == _mask_wall("\n".join(lines) + "\n")


def test_sharded_run_scenario_under_replay_matches_reference(tmp_path_factory, monkeypatch):
    """shards=2 with sketch-guided control: each port shard replays its
    reference shard's decisions; the report (transitions tagged by
    shard, actions and throttles over all shards) and the shared store
    must be equal."""
    ref = _reference_run(tmp_path_factory.mktemp("sharded"), False, shards=2,
                         sketch_guided=True)
    got = _replaying(monkeypatch, tmp_path_factory.mktemp("port_sharded"), ref)
    rep = harness.run_scenario(SCENARIO, ticks=TICKS, seed=SEED, shards=2, sketch_guided=True,
                               device="cpu", **CAPS)
    g, w = rep.to_dict(), ref["report"].to_dict()
    for k in WALL_FIELDS:
        g.pop(k), w.pop(k)
    assert g == w
    assert rep.shards == 2 and {tr["shard"] for tr in rep.transitions} == {0, 1}
    assert [tr["t"] for tr in rep.transitions] == sorted(tr["t"] for tr in rep.transitions)
    store = convert.store_to_numpy(got["pipe"].store)
    for name, arr in ref["store"].items():
        np.testing.assert_array_equal(store[name], arr.astype(store[name].dtype), err_msg=name)


@pytest.mark.parametrize("option", ["telemetry", "monitor", "trace", "trace_jsonl", "lineage",
                                    "lineage_jsonl", "fault_plan", "retry", "checkpoint_dir",
                                    "resume"])
def test_options_of_this_slice_run_and_fill_the_report(option, tmp_path):
    """The ops layer's options run on the host (the whole comparison with
    the reference is in test_torch_telemetry.py, test_torch_monitor.py,
    test_torch_lineage.py and test_torch_checkpoint.py).  telemetry,
    monitor, trace and trace_jsonl each turn telemetry on, and the report
    carries the stage latencies and one audit record a decision; the
    monitor adds its verdict, and the exporters their files.  lineage and
    lineage_jsonl fill the report's lineage fields, the JSONL its hop
    logs; a fault plan (arming the default retry policy) and a retry
    policy alone fill the retry and archive accounting; a checkpoint
    directory fills the checkpoint count and the digests.  `resume`
    without a checkpoint directory is refused, as in the reference."""
    from repro_torch.resilience import FaultPlan, RetryPolicy

    if option == "resume":
        with pytest.raises(ValueError, match="checkpoint_dir"):
            harness.run_scenario(SCENARIO, ticks=2, device="cpu", resume=True, **CAPS)
        return
    value = {"telemetry": True, "monitor": True, "trace": str(tmp_path / "t.json"),
             "trace_jsonl": str(tmp_path / "t.jsonl"), "lineage": True,
             "lineage_jsonl": str(tmp_path / "l.jsonl"),
             "fault_plan": FaultPlan(fail_times=((2.0, 4.0),)),
             "retry": RetryPolicy(jitter=0.0), "checkpoint_dir": str(tmp_path / "ck")}[option]
    cadence = {"checkpoint_every": 4} if option == "checkpoint_dir" else {}
    rep = harness.run_scenario(SCENARIO, ticks=8, device="cpu", **CAPS, **cadence,
                               **{option: value})
    traced = option in ("telemetry", "monitor", "trace", "trace_jsonl")
    assert rep.telemetry_enabled == traced
    assert rep.monitor_enabled == (option == "monitor")
    assert rep.lineage_enabled == (option in ("lineage", "lineage_jsonl"))
    if traced:
        assert rep.audit_decisions == 8
        assert {"tick", "filter", "decide"} <= set(rep.stage_latency_ms)
        assert "telemetry:" in rep.summary()
    if option == "monitor":
        assert set(rep.slo_summary) == {"commit_p99", "no_drops", "throughput_floor",
                                        "mu_bounded", "freshness"}
        assert rep.decision_quality["decisions"] == 8 and 0.0 <= rep.controller_score <= 1.0
        assert "monitor:" in rep.summary()
    if option in ("trace", "trace_jsonl", "lineage_jsonl"):
        with open(value) as f:
            assert f.read().strip()
    if rep.lineage_enabled:
        assert rep.records_in == rep.total_records > 0 and not rep.conservation_warning
        assert rep.records_in == rep.records_committed + rep.records_in_flight
        assert rep.path_mix and rep.watermark_final["queryable"] is not None
        assert "lineage:" in rep.summary()
    if option == "fault_plan":
        assert rep.commit_failures > 0 and rep.archived_total > 0
        assert rep.archived_total == rep.retries_replayed + rep.archive_remaining
    if option == "retry":
        assert rep.commit_failures == rep.archived_total == 0
    resilient = option in ("fault_plan", "retry", "checkpoint_dir")
    assert bool(rep.store_digest) == bool(rep.snapshot_digest) == resilient
    assert rep.checkpoints_saved == (2 if option == "checkpoint_dir" else 0)
    assert rep.resumed_from_tick == -1
