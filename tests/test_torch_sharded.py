"""Port parity: scale-out ingest (`ShardedPipeline`, `PipelineBuilder.sharded`,
`launch.ingest --shards`) and the compat `core.pipeline.IngestionPipeline`,
each against its counterpart in the reference.

The reference runs `repro.api.ShardedPipeline` (x64, as
`python -m repro.launch.ingest --shards N` runs it) and the port runs
`repro_torch.api.ShardedPipeline` on the CPU, on the same
`BurstyTweetSource(seed=42)` stream for 40 ticks with a 2^12-node,
2^14-edge store.  Each shard's float32 RLS drifts from the reference's
(ROADMAP F2), so each port shard's controller replays its reference
shard's per-tick (action, beta), as tests/test_torch_pipeline.py does
for one controller.  Then everything must be equal exactly: the store,
every shard's report, the `ShardedReport`, and the events the caller's
hub sees, each tagged with its shard.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.api import PipelineBuilder as RefBuilder
from repro.api import ShardedPipeline as RefShardedPipeline
from repro.configs.paper_ingest import IngestConfig as RefIngestConfig
from repro.core.pipeline import IngestionPipeline as RefIngestionPipeline
from repro.core.transform import tweet_mapping as ref_tweet_mapping
from repro.ingest.sources import BurstyTweetSource as RefSource
from repro_torch.api import PipelineBuilder, ShardedPipeline, ShardedReport, StreamPipeline
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.convert import store_to_numpy
from repro_torch.core.buffer import BufferController
from repro_torch.core import pipeline as compat
from repro_torch.core.pipeline import IngestionPipeline
from repro_torch.core.transform import tweet_mapping
from repro_torch.ingest.sources import BurstyTweetSource
from repro_torch.launch import ingest

TICKS, SEED = 40, 42
CAPS = dict(store_nodes=1 << 12, store_edges=1 << 14)


class ReplayController(BufferController):
    """Takes the reference's decisions, tick by tick, in place of its own."""

    def __init__(self, cfg, decisions, **kw):
        super().__init__(cfg, **kw)
        self._decisions = iter(decisions)

    def decide(self, edge_table_size, density, now=None):
        dec = super().decide(edge_table_size, density, now)
        action, beta = next(self._decisions)
        self.beta = beta
        return dataclasses.replace(dec, action=action, beta=beta)


def _number(v):
    try:
        return float(np.asarray(v))
    except (TypeError, ValueError):
        return None


def _event(ev):
    """(kind, t, payload) with the payload's numbers as floats; objects
    (the final report) are left out."""
    payload = {k: _number(v) for k, v in ev.payload.items()}
    return ev.kind, float(ev.t), {k: v for k, v in payload.items() if v is not None}


def _reference(tmp_path, n_shards, seed=SEED, ticks=TICKS, dict_compress=False):
    events, decisions = [], [[] for _ in range(n_shards)]
    with jax.enable_x64(True):
        b = (RefBuilder(RefIngestConfig(**CAPS)).with_source(RefSource(seed=seed))
             .sharded(n_shards).spill_dir(str(tmp_path / f"ref_spill{n_shards}"))
             .on_event(lambda ev: events.append(_event(ev))))
        if dict_compress:
            b = b.with_compression(capacity=4096)
        pipe = b.build()
        for si, shard in enumerate(pipe.shards):
            shard.controller.on_decision = \
                lambda d, si=si: decisions[si].append((d.action, d.beta))
        rep = pipe.run(max_ticks=ticks)
        store = {f.name: np.asarray(getattr(pipe.store, f.name))
                 for f in dataclasses.fields(pipe.store)}
        dict_stats = b.dictionary_stage.stats() if dict_compress else None
    return {"report": rep, "store": store, "events": events, "decisions": decisions,
            "commits": pipe.sink.ingestor.commits, "dict_stats": dict_stats}


def _replay(pipe, cfg, decisions, tmp_path):
    for si, shard in enumerate(pipe.shards):
        shard.controller = ReplayController(cfg, decisions[si], device="cpu",
                                            spill_dir=str(tmp_path / f"port_spill{si}"))


@pytest.fixture(scope="module", params=[2, 4])
def reference(request, tmp_path_factory):
    return request.param, _reference(tmp_path_factory.mktemp("sharded"), request.param)


def _commit_rows(commits):
    return [(c.ok, c.instructions, c.new_nodes, c.batch_nodes, c.probe_rounds, c.dropped)
            for c in commits]


def test_sharded_loop_under_replay_matches_reference(reference, tmp_path):
    n_shards, want = reference
    assert all(len(d) == TICKS for d in want["decisions"])
    events = []
    cfg = IngestConfig(**CAPS)
    b = (PipelineBuilder(cfg, device="cpu").with_source(BurstyTweetSource(seed=SEED))
         .sharded(n_shards).spill_dir(str(tmp_path / "spill"))
         .on_event(lambda ev: events.append(_event(ev))))
    pipe = b.build()
    assert isinstance(pipe, ShardedPipeline) and len(pipe.shards) == n_shards
    _replay(pipe, cfg, want["decisions"], tmp_path)
    rep = pipe.run(max_ticks=TICKS)
    wrep = want["report"]
    assert isinstance(rep, ShardedReport)
    for name in ("total_records", "total_instructions", "raw_instructions", "max_buffered",
                 "spill_events", "drain_events", "mean_compression"):
        assert getattr(rep, name) == getattr(wrep, name), name
    assert rep.total_records == sum(r.total_records for r in rep.shards) > 0
    for si, (g, w) in enumerate(zip(rep.shards, wrep.shards)):
        assert g.actions == w.actions, si
        assert (g.total_records, g.total_instructions, g.raw_instructions) == \
            (w.total_records, w.total_instructions, w.raw_instructions), si
        assert (g.spill_events, g.drain_events) == (w.spill_events, w.drain_events), si
        np.testing.assert_array_equal(g.compression_ratios, w.compression_ratios)
        for k in g.samples:
            np.testing.assert_array_equal(g.samples[k], w.samples[k], err_msg=f"{si} {k}")
    for g, w in zip(rep.mu_arrays(), wrep.mu_arrays()):
        np.testing.assert_array_equal(g, w)
    assert _commit_rows(pipe.sink.ingestor.commits) == _commit_rows(want["commits"])
    store = store_to_numpy(pipe.store)
    for name, w in want["store"].items():
        np.testing.assert_array_equal(store[name], w.astype(store[name].dtype), err_msg=name)
    assert events == want["events"]
    tags = {e[2].get("shard") for e in events if e[0] == "sample"}
    assert tags == set(range(n_shards))
    # the caller's hub counts every shard's events
    assert pipe.metrics.counters["sample"] == sum(len(r.actions) for r in rep.shards)


def test_partition_matches_reference():
    records = [r for t, _ in zip(BurstyTweetSource(seed=7).ticks(), range(20))
               for r in t.records]
    records += [{"author": "a1"}, {"id": 99}, {}]
    for n in (2, 3, 4):
        with jax.enable_x64(True):
            want = RefShardedPipeline(RefIngestConfig(**CAPS), n_shards=n)._partition(records)
        got = ShardedPipeline(IngestConfig(**CAPS), n_shards=n, device="cpu")._partition(records)
        assert [[id(r) for r in p] for p in got] == [[id(r) for r in p] for p in want]
        assert all(len(p) for p in got)


def test_builder_sharded_build_and_its_errors(tmp_path):
    b = PipelineBuilder(IngestConfig(**CAPS), device="cpu").sharded(3, shard_key=lambda r: "x")
    pipe = b.with_compression(capacity=64).sketch_guided().build()
    assert isinstance(pipe, ShardedPipeline) and pipe.n_shards == 3
    assert pipe.shard_key({"user": "u"}) == "x"
    assert len({id(s.controller) for s in pipe.shards}) == 3
    assert pipe.stages == [b.dictionary_stage]  # one dictionary, shared by every shard
    with pytest.raises(ValueError, match="n_shards"):
        PipelineBuilder(device="cpu").sharded(0)
    with pytest.raises(ValueError, match="always controlled"):
        PipelineBuilder(IngestConfig(**CAPS), device="cpu").sharded(2).uncontrolled().build()
    with pytest.raises(ValueError, match="single-shard"):
        (PipelineBuilder(IngestConfig(**CAPS), device="cpu").sharded(2)
         .with_controller(BufferController(IngestConfig(), device="cpu")).build())
    single = PipelineBuilder(IngestConfig(**CAPS), device="cpu").sharded(1).build()
    assert isinstance(single, StreamPipeline)


def test_sketch_guided_hint_reaches_every_shard_controller():
    pipe = (PipelineBuilder(IngestConfig(**CAPS), device="cpu")
            .with_source(BurstyTweetSource(seed=1)).sharded(2)
            .sketch_guided().build())
    seen = []
    for shard in pipe.shards:
        observe = shard.controller.observe_sketch
        shard.controller.observe_sketch = lambda p, f=observe: (seen.append(p), f(p))
    pipe.run(max_ticks=10)
    assert len(seen) > 0 and len(seen) % 2 == 0  # each sketch event to both controllers


def test_state_round_trip_resumes_the_loop(tmp_path):
    def build(name):
        return (PipelineBuilder(IngestConfig(**CAPS), device="cpu").sharded(2)
                .spill_dir(str(tmp_path / name)).build())

    ticks = [t for t, _ in zip(BurstyTweetSource(seed=3).ticks(), range(20))]
    whole = build("whole")
    whole.run(iter(ticks), max_ticks=20)
    first = build("first")
    first.run(iter(ticks[:12]), max_ticks=12)
    second = build("second")
    second.sink, second.consumer = first.sink, first.consumer  # the store lives on
    second.restore_state(first.state())
    rep = second.run(iter(ticks[12:]), max_ticks=8)
    want = whole.state()
    got = second.state()
    assert got["loops"] == want["loops"]
    # each run() ends with one "report" event; everything else carries over
    counters = [[{k: v for k, v in h["counters"].items() if k != "report"} for h in s["hubs"]]
                for s in (got, want)]
    assert counters[0] == counters[1]
    assert rep.total_records == sum(st["records"] for st in want["loops"])


COMPAT_CASES = {
    "controlled": dict(),
    "controlled-options": dict(keywords=("h1", "h2"), compress=False, consumer_speed=0.5,
                               edges=2),
    "uncontrolled": dict(uncontrolled=True, consumer_speed=2.0, edges=3),
}


@pytest.mark.parametrize("case", list(COMPAT_CASES))
def test_compat_pipeline_matches_reference(case, tmp_path, monkeypatch):
    """The seed-era constructor against `repro.core.pipeline.IngestionPipeline`
    on the same stream and options (a mapping cut to its first `edges` edge
    kinds, keywords, compress, consumer speed), the port's controller
    replaying the reference's decisions."""
    kw = dict(COMPAT_CASES[case])
    edges = kw.pop("edges", None)
    src = dict(seed=9, mean_rate=60, burst_multiplier=5.0)

    def cut(mapping):
        return mapping if edges is None else dataclasses.replace(mapping,
                                                                  edges=mapping.edges[:edges])

    decisions = []
    with jax.enable_x64(True):
        ref = RefIngestionPipeline(RefIngestConfig(**CAPS), mapping=cut(ref_tweet_mapping()),
                                   spill_dir=str(tmp_path / "ref"), **kw)
        ref.controller.on_decision = lambda d: decisions.append((d.action, d.beta))
        want = ref.run(RefSource(**src).ticks(), max_ticks=50)
        wstore = {f.name: np.asarray(getattr(ref.store, f.name))
                  for f in dataclasses.fields(ref.store)}
    monkeypatch.setattr(compat, "BufferController",
                        lambda cfg, **ckw: ReplayController(cfg, decisions, **ckw))
    cfg = IngestConfig(**CAPS)
    old = IngestionPipeline(cfg, mapping=cut(tweet_mapping()), spill_dir=str(tmp_path / "a"),
                            device="cpu", **kw)
    assert isinstance(old.controller, ReplayController)
    assert old.controller.spill.path == str(tmp_path / "a")
    got = old.run(BurstyTweetSource(**src).ticks(), max_ticks=50)
    assert got.total_records == want.total_records > 0
    assert (got.total_instructions, got.raw_instructions) == \
        (want.total_instructions, want.raw_instructions)
    assert (got.spill_events, got.drain_events) == (want.spill_events, want.drain_events)
    assert got.actions == want.actions
    np.testing.assert_array_equal(got.compression_ratios, want.compression_ratios)
    for k in ("mu", "delay_s", "beta"):
        np.testing.assert_array_equal(got.samples[k], want.samples[k], err_msg=k)
    assert float(old.system_delay_s) == float(ref.system_delay_s)
    assert _commit_rows(old.ingestor.commits) == _commit_rows(ref.ingestor.commits)
    assert old.store.node_keys.device.type == "cpu"
    store = store_to_numpy(old.store)
    for name, w in wstore.items():
        np.testing.assert_array_equal(store[name], w.astype(store[name].dtype), err_msg=name)


def test_cli_sharded_printout_matches_reference(tmp_path, monkeypatch, capsys):
    """`launch.ingest --shards 2 --dict-compress`, its config cut to the
    test's store, under replay of a reference pipeline built the way the
    reference CLI builds it."""
    want = _reference(tmp_path, 2, seed=0, dict_compress=True)
    built = {}

    class ReplayBuilder(PipelineBuilder):
        def build(self):
            pipe = super().build()
            _replay(pipe, self.cfg, want["decisions"], tmp_path)
            built["pipe"] = pipe
            return pipe

    monkeypatch.setattr(ingest, "PipelineBuilder", ReplayBuilder)
    monkeypatch.setattr(ingest, "IngestConfig", lambda **kw: IngestConfig(**kw, **CAPS))
    rep, pipe = ingest.main(["--shards", "2", "--dict-compress", "--ticks", str(TICKS),
                             "--device", "cpu"])
    assert pipe is built["pipe"]
    w, store = want["report"], want["store"]
    lines = ["mode=sharded x2 compress=True",
             f"records={w.total_records} instructions={w.total_instructions} "
             f"raw={w.raw_instructions}"]
    for i, (sr, hwm) in enumerate(zip(w.shards, w.max_buffered)):
        mu = sr.samples["mu"]
        lines.append(f"shard {i}: records={sr.total_records} mu_mean={mu.mean():.3f} "
                     f"mu_max={mu.max():.3f} buffer_hwm={hwm}")
    lines += [f"compression: mean={w.mean_compression:.3f} spills={w.spill_events} "
              f"drains={w.drain_events}",
              f"store: {int(store['n_nodes'])} nodes, {int(store['n_edges'])} edges",
              f"dict: {want['dict_stats']}"]
    assert capsys.readouterr().out == "\n".join(lines) + "\n"
    assert rep.total_records > 0 and want["dict_stats"]["refs_total"] > 0


@pytest.mark.parametrize("argv", [["--shards", "0"], ["--shards", "2", "--uncontrolled"]])
def test_cli_rejects_what_the_reference_rejects(argv):
    with pytest.raises(SystemExit):
        ingest.main(argv + ["--device", "cpu", "--ticks", "1"])
