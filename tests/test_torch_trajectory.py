"""Port parity: the ingest trajectory, end to end, with telemetry and the
health monitor on.

The configuration is `benchmarks/bench_ingestion.py::
bench_ingest_trajectory`'s: `BurstyTweetSource(seed=7, mean_rate=60.0)`
into a 2^12-node, 2^14-edge store behind a query sink (depth 4, width
256), the maintained snapshot served every 10 commits, 120 ticks.  It
runs live through `repro.api` (x64) and through `repro_torch.api` on the
CPU, both with `with_telemetry()` and `with_monitor()`, and the runs must
agree on: commits, records, dropped inserts, the largest probe budget,
the snapshot's full builds and delta applies, every mu sample, and the
audit trail's length and actions; and both record the
`snapshot.apply_delta` and `commit.*` spans.

The source is host code both packages share, so the records are equal.
Free-running, the float32 RLS predictors drift (ROADMAP F2); should the
drift ever flip a decision, the port's run is made again replaying the
reference's decisions, and must then agree.  The comparison is with the
reference's live run, never with a recorded benchmark file (ROADMAP F15).
"""
import jax
import numpy as np
import pytest

from repro.api import GraphStoreSink as RefSink
from repro.api import PipelineBuilder as RefBuilder
from repro.configs.paper_ingest import IngestConfig as RefIngestConfig
from repro.ingest.sources import BurstyTweetSource as RefSource
from repro_torch.api import GraphStoreSink, PipelineBuilder
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.ingest.sources import BurstyTweetSource
from test_torch_workloads import ReplayController

TICKS = 120
CAPS = dict(node_cap=1 << 12, edge_cap=1 << 14)
SNAPSHOT_EVERY = 10  # commits between served snapshots


def _run(parts, tmp, controller=None):
    """One trajectory run; `parts` makes the builder (from a config),
    the sink, the config and the source.  Returns the figures the
    benchmark reports, with the audit actions, span names and monitor
    report, and the decisions."""
    builder, sink, cfg, source = parts
    b = (builder(cfg(store_nodes=CAPS["node_cap"], store_edges=CAPS["edge_cap"]))
         .with_source(source(seed=7, mean_rate=60.0))
         .with_sink(sink(**CAPS))
         .with_query_sink(depth=4, width=256, answer_every=10**9)
         .spill_dir(str(tmp))
         .with_telemetry()
         .with_monitor())
    if controller is not None:
        b = b.with_controller(controller)
    pipe = b.build()
    qsink, commits = pipe.sink, [0]

    def every_commit(ev):
        if ev.kind == "commit":
            commits[0] += 1
            if commits[0] % SNAPSHOT_EVERY == 0:
                qsink.snapshot()

    pipe.metrics.subscribe(every_commit)
    decisions = []
    pipe.controller.on_decision = lambda d: decisions.append((d.action, d.beta, d.reason))
    rep = pipe.run(max_ticks=TICKS)
    ok = [c for c in qsink.ingestor.commits if c.ok]
    reg = pipe.telemetry
    return {
        "commits": len(ok),
        "records": rep.total_records,
        "dropped_total": sum(c.dropped for c in ok),
        "probe_rounds_max": max((c.probe_rounds for c in ok), default=0),
        "snapshot_full_builds": qsink.maintainer.full_builds,
        "snapshot_delta_applies": qsink.maintainer.delta_applies,
        "mu": np.asarray(rep.samples["mu"]),
        "audit_actions": [r.action for r in reg.audit],
        "spans": set(reg.stage_names()),
        "monitor": pipe.monitor.report(),
    }, decisions


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    with jax.enable_x64(True):
        return _run((RefBuilder, RefSink, RefIngestConfig, RefSource),
                    tmp_path_factory.mktemp("ref_trajectory"))


PORT = (lambda cfg: PipelineBuilder(cfg, device="cpu"),
        lambda **kw: GraphStoreSink(device="cpu", **kw), IngestConfig, BurstyTweetSource)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    """The port free-running; replaying the reference's decisions if a
    decision differs (F2)."""
    got, decisions = _run(PORT, tmp_path_factory.mktemp("port_trajectory"))
    replayed = decisions != reference[1]
    if replayed:
        ctl = ReplayController(IngestConfig(store_nodes=CAPS["node_cap"],
                                            store_edges=CAPS["edge_cap"]),
                               reference[1], device="cpu",
                               spill_dir=str(tmp_path_factory.mktemp("port_replay")))
        got, decisions = _run(PORT, tmp_path_factory.mktemp("port_trajectory_replay"),
                              controller=ctl)
    return got, decisions, replayed


@pytest.mark.parametrize("figure", ["commits", "records", "dropped_total", "probe_rounds_max",
                                    "snapshot_full_builds", "snapshot_delta_applies"])
def test_trajectory_figure_matches_reference(reference, port, figure):
    got, want = port[0][figure], reference[0][figure]
    assert got == want
    assert want > 0


def test_trajectory_mu_samples_and_decisions_match_reference(reference, port):
    (got, decisions, _), (want, want_decisions) = port, reference
    np.testing.assert_array_equal(got["mu"], want["mu"])
    assert decisions == want_decisions
    assert len(got["mu"]) == TICKS


def test_trajectory_audit_trail_and_spans_match_reference(reference, port):
    got, want = port[0], reference[0]
    assert len(got["audit_actions"]) == len(want["audit_actions"]) == TICKS
    assert got["audit_actions"] == want["audit_actions"]
    for spans in (got["spans"], want["spans"]):
        assert "snapshot.apply_delta" in spans
        assert {"commit.upsert", "commit.wait", "commit.hooks"} <= spans
    assert got["spans"] == want["spans"]
    assert got["monitor"]["ticks"] == want["monitor"]["ticks"] == TICKS
    assert got["monitor"]["quality"]["decisions"] == TICKS
