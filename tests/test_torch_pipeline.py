"""Port parity: the paper's ingest loop end to end (`launch.ingest`'s path).

BurstyTweetSource(seed=0) -> filter -> buffer/controller -> transform ->
GraphStoreSink/GraphIngestor -> ingest_step -> SimulatedConsumer, for
40 ticks with a 2^12-node, 2^14-edge store, through `repro.api` (x64,
as `python -m repro.launch.ingest` runs it) and through `repro_torch.api`
on the CPU.

  * Uncontrolled, the loop has no float feedback, so the two runs must
    agree exactly: records, instructions, raw instructions, every
    compression ratio and mu sample, every commit and every store array.
  * Controlled, the float32 RLS predictors drift apart (see
    test_torch_controller.py), so the port's controller replays the
    reference's per-tick (action, beta), and then everything above must
    again be equal.
"""
import dataclasses

import jax
import numpy as np

from repro.api import PipelineBuilder as RefBuilder
from repro.configs.paper_ingest import IngestConfig as RefIngestConfig
from repro.ingest.sources import BurstyTweetSource as RefSource
from repro_torch.api import PipelineBuilder
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.convert import store_to_numpy
from repro_torch.core.buffer import BufferController
from repro_torch.ingest.sources import BurstyTweetSource

TICKS = 40
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


def _reference(tmp_path, uncontrolled):
    decisions = []
    with jax.enable_x64(True):
        pipe = (RefBuilder(RefIngestConfig(**CAPS)).with_source(RefSource(seed=0))
                .uncontrolled(uncontrolled).spill_dir(str(tmp_path / "ref_spill")).build())
        pipe.controller.on_decision = lambda d: decisions.append((d.action, d.beta))
        rep = pipe.run(max_ticks=TICKS)
        store = {f.name: np.asarray(getattr(pipe.store, f.name))
                 for f in dataclasses.fields(pipe.store)}
    return rep, pipe.sink.ingestor.commits, store, decisions


def _port(tmp_path, uncontrolled, controller=None):
    b = (PipelineBuilder(IngestConfig(**CAPS), device="cpu").with_source(BurstyTweetSource(seed=0))
         .uncontrolled(uncontrolled).spill_dir(str(tmp_path / "port_spill")))
    if controller is not None:
        b = b.with_controller(controller)
    pipe = b.build()
    rep = pipe.run(max_ticks=TICKS)
    return rep, pipe.sink.ingestor.commits, store_to_numpy(pipe.store)


def _assert_runs_equal(got, want):
    (grep, gcommits, gstore), (wrep, wcommits, wstore) = got, want[:3]
    assert grep.total_records == wrep.total_records > 0
    assert grep.total_instructions == wrep.total_instructions
    assert grep.raw_instructions == wrep.raw_instructions
    assert (grep.spill_events, grep.drain_events) == (wrep.spill_events, wrep.drain_events)
    np.testing.assert_array_equal(grep.compression_ratios, wrep.compression_ratios)
    for k in ("mu", "delay_s", "beta"):
        np.testing.assert_array_equal(grep.samples[k], wrep.samples[k], err_msg=k)
    assert [(c.ok, c.instructions, c.new_nodes, c.batch_nodes, c.probe_rounds, c.dropped)
            for c in gcommits] == \
           [(c.ok, c.instructions, c.new_nodes, c.batch_nodes, c.probe_rounds, c.dropped)
            for c in wcommits]
    for name, w in wstore.items():
        np.testing.assert_array_equal(gstore[name], w.astype(gstore[name].dtype), err_msg=name)


def test_uncontrolled_loop_matches_reference_exactly(tmp_path):
    want = _reference(tmp_path, uncontrolled=True)
    got = _port(tmp_path, uncontrolled=True)
    _assert_runs_equal(got, want)
    assert len(want[1]) == TICKS  # one commit per tick
    assert sum(c.dropped for c in want[1]) > 0  # the small store saturates


def test_controlled_loop_under_decision_replay_matches_reference(tmp_path):
    want = _reference(tmp_path, uncontrolled=False)
    decisions = want[3]
    assert {a for a, _ in decisions} >= {"push"} and len(decisions) == TICKS
    ctl = ReplayController(IngestConfig(**CAPS), decisions,
                           spill_dir=str(tmp_path / "port_ctl_spill"), device="cpu")
    got = _port(tmp_path, uncontrolled=False, controller=ctl)
    _assert_runs_equal(got, want)
    assert 0 < len(want[1]) < TICKS  # the controller held or throttled some ticks
