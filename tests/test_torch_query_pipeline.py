"""Port parity: the query loop end to end (`launch.query`'s path).

BurstyTweetSource(seed=0) -> filter -> SketchStage -> buffer ->
transform -> QuerySink(GraphStoreSink) with an incrementally maintained
snapshot and live "sketch" events, at the query CLI's `--dryrun` size
(25 ticks, a 2^11-node, 2^12-edge store, W=256), built through
`repro.api.PipelineBuilder` (x64) and `repro_torch.api.PipelineBuilder`
on the CPU.  Uncontrolled, as tests/test_torch_pipeline.py explains, so
the two runs must agree exactly: stores, both sketches, the "sketch"
event payloads, the maintainer's counts and the served snapshot.

The run is also `sketch_guided()`: both controllers see those equal
payloads, so the sketch's diversity hint `sketch_rho` must be equal, and
the controller's prediction equal within the float32 tolerance of
tests/test_torch_controller.py (ROADMAP fault F2).  Uncontrolled, the
hint cannot feed back into the run.
"""
import jax
import numpy as np
import pytest

from repro.api import GraphStoreSink as RefGraphStoreSink
from repro.api import PipelineBuilder as RefBuilder
from repro.configs.paper_ingest import IngestConfig as RefIngestConfig
from repro.ingest.sources import BurstyTweetSource as RefSource
from repro.query import SketchStage as RefSketchStage
from repro_torch import convert
from repro_torch.api import GraphStoreSink, PipelineBuilder
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.ingest.sources import BurstyTweetSource
from repro_torch.query import SketchStage

TICKS, NODE_CAP, EDGE_CAP, D, W = 25, 1 << 11, 1 << 12, 4, 256
QS = dict(depth=D, width=W, answer_every=5, top_k=5, exact_topk=3)
BETA_PRED_RTOL, MU_ATOL = 2.5e-3, 1.5e-2  # tests/test_torch_controller.py (F2)


def _build(builder, sink, stage, events):
    """`launch.query`'s chain, uncontrolled and sketch-guided."""
    return (builder.with_sink(sink).uncontrolled().with_sketch(stage)
            .with_query_sink(**QS).sketch_guided()
            .on_event(lambda ev: events.append(ev.payload) if ev.kind == "sketch" else None)
            .build())


def _reference(tmp_path):
    events = []
    cfg = RefIngestConfig(store_nodes=NODE_CAP, store_edges=EDGE_CAP)
    with jax.enable_x64(True):
        stage = RefSketchStage(depth=D, width=W)
        b = RefBuilder(cfg).with_source(RefSource(seed=0)).spill_dir(str(tmp_path / "ref"))
        pipe = _build(b, RefGraphStoreSink(node_cap=NODE_CAP, edge_cap=EDGE_CAP), stage, events)
        rep = pipe.run(max_ticks=TICKS)
        snap = pipe.sink.snapshot()
    return pipe, stage, rep, snap, events


def _port(tmp_path):
    events = []
    cfg = IngestConfig(store_nodes=NODE_CAP, store_edges=EDGE_CAP)
    stage = SketchStage(depth=D, width=W, device="cpu")
    b = (PipelineBuilder(cfg, device="cpu").with_source(BurstyTweetSource(seed=0))
         .spill_dir(str(tmp_path / "port")))
    pipe = _build(b, GraphStoreSink(node_cap=NODE_CAP, edge_cap=EDGE_CAP, device="cpu"),
                  stage, events)
    rep = pipe.run(max_ticks=TICKS)
    return pipe, stage, rep, pipe.sink.snapshot(), events


def _assert_fields_equal(got: dict, want, msg):
    for name, g in got.items():
        w = np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f"{msg}{name}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("query")
    return _reference(tmp), _port(tmp)


def test_query_loop_matches_reference_exactly(runs):
    (rpipe, rstage, rrep, rsnap, revents), (ppipe, pstage, prep, psnap, pevents) = runs
    assert prep.total_records == rrep.total_records > 0
    assert prep.total_instructions == rrep.total_instructions
    _assert_fields_equal(convert.store_to_numpy(ppipe.store), rpipe.store, "store.")
    _assert_fields_equal(convert.sketch_to_numpy(pstage.sketch), rstage.sketch, "filter sketch.")
    _assert_fields_equal(convert.sketch_to_numpy(ppipe.sink.sketch), rpipe.sink.sketch,
                         "commit sketch.")
    _assert_fields_equal(convert.snapshot_to_numpy(psnap), rsnap, "snapshot.")
    rm, pm = rpipe.sink.maintainer, ppipe.sink.maintainer
    assert (pm.full_builds, pm.delta_applies) == (rm.full_builds, rm.delta_applies)
    assert pm.delta_applies > 0 and ppipe.sink.commits == rpipe.sink.commits == TICKS
    assert pevents == revents and len(pevents) == TICKS // QS["answer_every"]
    assert all(len(e["exact_keys"]) == QS["exact_topk"] for e in pevents)
    # the sketches upper-bound the store they summarise
    assert int(pstage.sketch.n_updates) >= int(ppipe.sink.sketch.n_updates) > 0


def test_sketch_guided_controller_hint_matches_reference(runs):
    (rpipe, *_), (ppipe, *_) = runs
    rpm, ppm = rpipe.controller.perfmon, ppipe.controller.perfmon
    assert ppm.sketch_rho is not None and ppm.sketch_rho == rpm.sketch_rho
    assert 0.0 < ppm.sketch_rho < 1.0
    # edge-table sizes below the model's estimate, so the estimate shows
    inputs = ((0.0, 0.01), (1.0, 0.2))
    with jax.enable_x64(True):
        want = [rpm.predict(size, density) for size, density in inputs]
    got = [ppm.predict(size, density) for size, density in inputs]
    for (gb, gm, gs), (wb, wm, ws) in zip(got, want):
        assert gb == pytest.approx(wb, rel=BETA_PRED_RTOL)
        assert gm == pytest.approx(wm, abs=MU_ATOL)
        assert gs == pytest.approx(ws, abs=MU_ATOL)
    # the hint moves the prediction: without it the blend is gone
    rho, ppm.sketch_rho = ppm.sketch_rho, None
    unguided = ppm.predict(*inputs[0])[0]
    ppm.sketch_rho = rho
    assert unguided != pytest.approx(got[0][0], rel=BETA_PRED_RTOL)


def test_sketch_rho_survives_controller_state_round_trip(runs):
    (rpipe, *_), (ppipe, *_) = runs
    ctl = ppipe.controller
    state = ctl.state()
    assert state["perfmon"]["sketch_rho"] == ctl.perfmon.sketch_rho
    ctl.perfmon.sketch_rho = 0.123
    ctl.restore_state(state)
    assert ctl.perfmon.sketch_rho == state["perfmon"]["sketch_rho"]
    # the reference's state loads too
    ctl.perfmon.sketch_rho = None
    ctl.perfmon.restore_state(rpipe.controller.perfmon.state())
    assert ctl.perfmon.sketch_rho == rpipe.controller.perfmon.sketch_rho


def test_builder_made_sketch_stage_inherits_the_builder():
    cfg = IngestConfig(store_nodes=64, store_edges=64, max_edges_per_batch=512)
    b = PipelineBuilder(cfg, device="cpu").with_sketch(depth=2, width=128).with_query_sink()
    pipe = b.build()
    stage = b.sketch_stage
    assert pipe.stages == [stage] and isinstance(stage, SketchStage)
    assert stage.max_edges_per_batch == 512 and stage.sketch.device.type == "cpu"
    assert stage.sketch.edge_w.shape == (2, 128, 128)
    assert pipe.sink.sketch.device.type == "cpu" and pipe.sink.inner.store.device.type == "cpu"
