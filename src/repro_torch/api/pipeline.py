"""`StreamPipeline`: the paper's closed control loop over pluggable parts.
Counterpart of `repro.api.pipeline`.

Each tick: Source -> FilterStage -> BufferControlStage; the controller
(Algorithm 2) decides push/hold/throttle/drain from the predictive
models; pushed buckets go through TransformStage (Algorithm 1 + graph
compression) into the Sink (Algorithm 3 GRAPHPUSH), and the Consumer
absorbs the instruction load and reports occupancy mu back to the
controller.  `uncontrolled=True` bypasses the controller, the paper's
meltdown baseline (Figs. 1-3, 7).
"""
from __future__ import annotations

import time
from typing import Iterable, Optional, Sequence, Tuple

import torch

from repro_torch.api.consumers import SimulatedConsumer
from repro_torch.api.metrics import MetricsHub, PipelineReport
from repro_torch.api.protocols import Source, TickContext
from repro_torch.api.sinks import GraphStoreSink
from repro_torch.api.stages import BufferControlStage, FilterStage, TransformStage
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.core.buffer import PerfSample


def table_metrics(et) -> Tuple[float, float, float]:
    """(compression ratio, density, size) of an edge table, fetched
    from the device in one copy."""
    cr, density, size = torch.stack([
        et.compression_ratio().to(torch.float64), et.density().to(torch.float64),
        et.size().to(torch.float64)]).tolist()
    return cr, density, size


def maybe_retry_archive(sink, hub: MetricsHub, now: float) -> int:
    """Backoff-governed archive replay: runs every tick, but ONLY when
    the sink's ingestor carries a retry policy; without one, archived
    batches wait for a manual `retry_archive()`."""
    ing = getattr(sink, "ingestor", None)
    if ing is None or getattr(ing, "retry_policy", None) is None:
        return 0
    if not getattr(ing, "archive_depth", 0):
        return 0
    with hub.telemetry.span("retry.archive"):
        n = sink.retry_archive(now) if hasattr(sink, "retry_archive") \
            else ing.retry_archive(now)
    if n:
        hub.emit("retry", now, replayed=n, remaining=ing.archive_depth)
    return n


def _emit_commit(hub: MetricsHub, now: float, out: dict, n_instr: int,
                 raw_i: int, rho: float, cr: float) -> None:
    hub.emit("commit" if out.get("committed", False) else "commit-failed", now,
             instructions=n_instr, raw=raw_i, rho=rho, cr=cr,
             dropped=out.get("dropped", 0),
             probe_rounds=out.get("probe_rounds", 0),
             pressure=out.get("pressure", 0.0),
             refs=out.get("refs", 0),
             dict_hit_rate=out.get("dict_hit_rate", 0.0))


def controlled_tick(buf: BufferControlStage, transform, sink, consumer,
                    hub: MetricsHub, state: dict, now: float, dt: float,
                    consume_dt: Optional[float] = None):
    """One controlled tick (Algorithm 2 steps 2-7) on one buffer.

    `consume_dt` is the slice of the tick this buffer may drain from
    the consumer.  `state` carries the cross-tick scalars: last_beta_e/
    last_mu for the mu-model updates, and the records/instr/raw/crs
    totals."""
    cdt = dt if consume_dt is None else consume_dt
    tel = hub.telemetry
    pm = buf.perfmon
    aud = buf.controller.audit
    lineage = getattr(hub, "lineage", None)
    with tel.span("decide"):
        dec = buf.decide(len(buf) * 4.0, 0.0, now=now)

    if dec.action in ("push", "drain+push") and len(buf) >= 1:
        if dec.action == "drain+push" and buf.spill_depth:
            with tel.span("spill.drain"):
                buf.drain_spill()
            hub.emit("drain", now, depth=buf.spill_depth)
        batch = buf.take_batch()
        if batch:
            tag = handed = None
            if lineage is not None:
                tag = lineage.open_batch(batch, now, shard=getattr(tel, "shard", None),
                                         spilled=buf.last_take_spilled)
            et, n_instr, raw_i = transform.encode(batch)
            if tag is not None:
                handed = lineage.stage_commit(tag, sink)
            out = sink.commit(et, now=now)
            if tag is not None:
                lineage.after_commit(tag, out, now, handed=handed)
            with tel.span("consume"):
                mu = consumer.consume(n_instr, cdt, now=now)
            committed = out.get("committed", False)
            rho = out.get("rho", 1.0) if committed else 1.0
            cr, density, size = table_metrics(et)
            _emit_commit(hub, now, out, n_instr, raw_i, rho, cr)
            if out.get("pool_overflow"):
                hub.emit("pool_overflow", now, total=out["pool_overflow"])
            if out.get("degraded"):
                hub.emit("degraded", now, archived=out.get("archived", 0))
            if committed:
                # table pressure -> Algorithm-2 controller (back-pressure)
                pm.observe_pressure(out.get("pressure", 0.0), out.get("dropped", 0))
                if "dict_hit_rate" in out:
                    # compressibility -> the controller's "data content"
                    # input (GraphZip dictionary compression)
                    pm.observe_compression(out["dict_hit_rate"], cr)
            pm.observe_mu(mu)
            if aud is not None:
                # predicted-vs-realized for the audit trail
                aud.resolve(mu, size)
            pm.observe_bucket(rho, density, size)
            pm.observe_mu_outcome(state["last_mu"], state["last_beta_e"], mu)
            state["last_beta_e"], state["last_mu"] = size, mu
            state["instr"] += n_instr
            state["raw"] += raw_i
            state["crs"].append(cr)
            hub.emit("push", now, records=len(batch))
            hub.record(PerfSample(now, mu, rho, density, len(buf), size,
                                  *pm.velocity(), dec.action,
                                  buf.spill_depth, cr, consumer.delay_s))
    elif dec.action == "throttle":
        # spill the whole buffer to disk (data throttling)
        if len(buf):
            with tel.span("spill.flush"):
                buf.spill_all()
            hub.emit("spill", now, depth=buf.spill_depth)
        mu = consumer.consume(0, cdt, now=now)
        pm.observe_mu(mu)
        if aud is not None:
            aud.resolve(mu, 0.0)
        hub.emit("throttle", now)
        hub.record(PerfSample(now, mu, 0.0, 0.0, 0, dec.beta_e, *pm.velocity(),
                              "throttle", buf.spill_depth, 1.0, consumer.delay_s))
    else:  # hold
        mu = consumer.consume(0, cdt, now=now)
        pm.observe_mu(mu)
        if aud is not None:
            aud.resolve(mu, 0.0)
        hub.emit("hold", now, buffered=len(buf))
        hub.record(PerfSample(now, mu, 0.0, 0.0, len(buf), dec.beta_e, *pm.velocity(),
                              "hold", buf.spill_depth, 1.0, consumer.delay_s))

    # archived batches replay on every action (the connection may be
    # back while the controller holds/throttles), policy-gated above
    maybe_retry_archive(sink, hub, now)


class StreamPipeline:
    def __init__(
        self,
        cfg: Optional[IngestConfig] = None,
        source: Optional[Source] = None,
        filter_stage: Optional[FilterStage] = None,
        transform: Optional[TransformStage] = None,
        buffer_stage: Optional[BufferControlStage] = None,
        consumer=None,
        sink=None,
        uncontrolled: bool = False,
        metrics: Optional[MetricsHub] = None,
        spill_dir: Optional[str] = None,
        stages: Sequence = (),
        device=None,
    ):
        self.cfg = cfg or IngestConfig()
        self.source = source
        self.filter_stage = filter_stage or FilterStage()
        self.stages = list(stages)  # extra Stage-protocol record stages
        self.transform = transform or TransformStage(
            max_edges_per_batch=self.cfg.max_edges_per_batch, device=device)
        # explicit None check: an empty BufferControlStage is falsy
        self.buffer_stage = BufferControlStage(
            cfg=self.cfg, spill_dir=spill_dir, device=device) \
            if buffer_stage is None else buffer_stage
        self.consumer = consumer or SimulatedConsumer()
        self.sink = sink or GraphStoreSink(
            node_cap=self.cfg.store_nodes, edge_cap=self.cfg.store_edges,
            device=device)
        self.uncontrolled = uncontrolled
        self.metrics = metrics or MetricsHub()
        self.telemetry = self.metrics.telemetry
        # cross-tick loop scalars, owned by the pipeline so a resumed
        # run continues the totals
        self.loop_state: Optional[dict] = None

    @property
    def controller(self):
        return self.buffer_stage.controller

    @property
    def buffer(self):
        return self.buffer_stage.buffer

    @property
    def store(self):
        return self.sink.store

    @property
    def system_delay_s(self) -> float:
        """alpha (Eq. 3): seconds of work queued at the consumer."""
        return self.consumer.delay_s

    def _uncontrolled_tick(self, state: dict, now: float, dt: float) -> None:
        """Paper Figs. 1-3/7: push every tick, no control."""
        buf, pm, hub = self.buffer_stage, self.buffer_stage.perfmon, self.metrics
        if len(buf):
            batch = buf.take_all()
            lineage = getattr(hub, "lineage", None)
            tag = handed = None
            if lineage is not None:
                tag = lineage.open_batch(batch, now, spilled=buf.last_take_spilled)
            et, n_instr, raw_i = self.transform.encode(batch)
            if tag is not None:
                handed = lineage.stage_commit(tag, self.sink)
            out = self.sink.commit(et, now=now)
            if tag is not None:
                lineage.after_commit(tag, out, now, handed=handed)
            mu = self.consumer.consume(n_instr, dt, now=now)
            rho = out.get("rho", 1.0) if out.get("committed", False) else 1.0
            cr, density, size = table_metrics(et)
            _emit_commit(hub, now, out, n_instr, raw_i, rho, cr)
            pm.observe_mu(mu)
            state["instr"] += n_instr
            state["raw"] += raw_i
            state["crs"].append(cr)
            hub.emit("push", now, records=len(batch))
            hub.record(PerfSample(now, mu, rho, density, len(buf), size,
                                  *pm.velocity(), "push", buf.spill_depth, cr,
                                  self.consumer.delay_s))
        maybe_retry_archive(self.sink, hub, now)

    def run(self, source_ticks: Optional[Iterable] = None,
            max_ticks: int = 300) -> PipelineReport:
        if source_ticks is None:
            if self.source is None:
                raise ValueError("no source: pass source_ticks or set source")
            source_ticks = self.source.ticks()
        buf = self.buffer_stage
        hub = self.metrics
        t_start = time.time()
        state = self.loop_state
        if state is None:
            state = {"last_beta_e": self.cfg.beta_init, "last_mu": 0.0,
                     "records": 0, "instr": 0, "raw": 0, "crs": []}
            self.loop_state = state

        tel = self.telemetry
        for i, tick in enumerate(source_ticks):
            if i >= max_ticks:
                break
            now, dt = tick.t, 1.0
            ctx = TickContext(t=now, dt=dt, index=i)
            with tel.span("tick"):
                with tel.span("filter"):
                    recs = self.filter_stage(tick.records, ctx)
                for stage in self.stages:
                    recs = stage(recs, ctx)
                state["records"] += len(recs)
                buf.perfmon.observe_rate(now, len(recs))
                hub.emit("tick", now, raw=len(tick.records), kept=len(recs))
                buf.extend(recs)
                if self.uncontrolled:
                    self._uncontrolled_tick(state, now, dt)
                else:
                    controlled_tick(buf, self.transform, self.sink,
                                    self.consumer, hub, state, now, dt)

        return hub.build_report(state["records"], state["instr"],
                                state["raw"], state["crs"],
                                time.time() - t_start)

    def state(self) -> dict:
        """Host-side resumable state (the store's tensors excluded)."""
        s: dict = {
            "loop": None if self.loop_state is None else
                {**self.loop_state, "crs": list(self.loop_state["crs"])},
            "buffer": self.buffer_stage.state(),
            "metrics": self.metrics.state(),
            "stages": [st.state() if hasattr(st, "state") else None
                       for st in self.stages],
        }
        if hasattr(self.consumer, "state"):
            s["consumer"] = self.consumer.state()
        if hasattr(self.sink, "state"):
            s["sink"] = self.sink.state()
        tracker = getattr(self.metrics, "lineage", None)
        if tracker is not None:
            s["lineage"] = tracker.state()
        return s

    def restore_state(self, s: dict) -> None:
        self.loop_state = None if s["loop"] is None else dict(s["loop"])
        self.buffer_stage.restore_state(s["buffer"])
        self.metrics.restore_state(s["metrics"])
        for st, st_s in zip(self.stages, s["stages"]):
            if st_s is not None and hasattr(st, "restore_state"):
                st.restore_state(st_s)
        if "consumer" in s and hasattr(self.consumer, "restore_state"):
            self.consumer.restore_state(s["consumer"])
        if "sink" in s and hasattr(self.sink, "restore_state"):
            self.sink.restore_state(s["sink"])
        tracker = getattr(self.metrics, "lineage", None)
        if tracker is not None and "lineage" in s:
            tracker.restore_state(s["lineage"])
