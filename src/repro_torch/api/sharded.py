"""`ShardedPipeline`: scale-out ingest.  Counterpart of `repro.api.sharded`.

Hash-partitions the filtered record stream by user across N shards,
each with its own adaptive buffer and Algorithm-2 controller (its own
spill store and PerfMon), all feeding one shared sink and consumer: the
paper's bounded ingestion pool fronted by parallel collectors.  The
consumer is shared, so every shard's controller observes the aggregate
occupancy mu and they back off together under load; the control law
needs no change to go multi-collector.  Every shard commits into the
one store on the pipeline's device.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.api.consumers import SimulatedConsumer
from repro_torch.api.metrics import MetricsHub, PipelineEvent, PipelineReport
from repro_torch.api.pipeline import controlled_tick
from repro_torch.api.protocols import Source, TickContext
from repro_torch.api.sinks import GraphStoreSink
from repro_torch.api.stages import BufferControlStage, FilterStage, TransformStage
from repro_torch.configs.paper_ingest import IngestConfig


def default_shard_key(rec: dict) -> str:
    """Partition by user (graph locality: a user's edges co-locate)."""
    return str(rec.get("user") or rec.get("author") or rec.get("id") or "")


@dataclasses.dataclass
class ShardedReport:
    shards: List[PipelineReport]
    total_records: int
    total_instructions: int
    raw_instructions: int
    max_buffered: List[int]  # per-shard buffer high-water mark
    spill_events: int
    drain_events: int
    wall_s: float

    @property
    def mean_compression(self) -> float:
        crs = np.concatenate([r.compression_ratios for r in self.shards]) \
            if self.shards else np.asarray([])
        return float(crs.mean()) if crs.size else 1.0

    def mu_arrays(self) -> List[np.ndarray]:
        return [r.samples["mu"] for r in self.shards]


class ShardedPipeline:
    """N controlled shards over one sink and consumer.  Parts not given
    are the paper defaults on `device` (default the card); a shard
    spills under `{spill_dir}/shard{i}`, or in a fresh directory of its
    own when `spill_dir` is None."""

    def __init__(
        self,
        cfg: Optional[IngestConfig] = None,
        n_shards: int = 2,
        source: Optional[Source] = None,
        filter_stage: Optional[FilterStage] = None,
        transform: Optional[TransformStage] = None,
        consumer=None,
        sink=None,
        spill_dir: Optional[str] = None,
        shard_key: Optional[Callable[[dict], str]] = None,
        metrics: Optional[MetricsHub] = None,
        stages: Sequence = (),
        device=None,
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.cfg = cfg or IngestConfig()
        self.n_shards = n_shards
        self.source = source
        self.filter_stage = filter_stage or FilterStage()
        self.stages = list(stages)  # extra Stage-protocol record stages
        self.transform = transform or TransformStage(
            max_edges_per_batch=self.cfg.max_edges_per_batch, device=device)
        self.consumer = consumer or SimulatedConsumer()
        self.sink = sink or GraphStoreSink(
            node_cap=self.cfg.store_nodes, edge_cap=self.cfg.store_edges, device=device)
        self.shard_key = shard_key or default_shard_key
        self.metrics = metrics or MetricsHub()
        self.telemetry = self.metrics.telemetry
        self.shards = [
            BufferControlStage(cfg=self.cfg, device=device,
                               spill_dir=None if spill_dir is None else f"{spill_dir}/shard{i}")
            for i in range(n_shards)
        ]
        # per-shard hubs: own counters (ShardedReport sums them), but
        # spans land in the aggregate registry tagged with the shard
        self._hubs = [MetricsHub(telemetry=self.telemetry.child(i)) for i in range(n_shards)]
        # forward every shard event to the caller's hub, tagged with the
        # shard index, so on_event() subscribers see the whole fleet
        for si, hub in enumerate(self._hubs):
            hub.subscribe(lambda ev, si=si: self._forward(ev, si))
        # per-shard cross-tick loop scalars, owned by the pipeline so a
        # resumed run continues the totals
        self.loop_states: Optional[List[dict]] = None

    def _forward(self, ev: PipelineEvent, shard: int):
        # through emit (not the hooks directly), so the aggregate hub's
        # counters see shard-level spill/drain/commit events too
        self.metrics.emit(ev.kind, ev.t, **{**ev.payload, "shard": shard})

    @property
    def store(self):
        return self.sink.store

    def _partition(self, records: List[dict]) -> List[List[dict]]:
        parts: List[List[dict]] = [[] for _ in range(self.n_shards)]
        for r in records:
            h = zlib.crc32(self.shard_key(r).encode("utf-8"))
            parts[h % self.n_shards].append(r)
        return parts

    def _shard_step(self, si: int, part: List[dict], now: float, dt: float, state: dict):
        """One controlled tick on shard `si`: the single-shard loop body
        (`controlled_tick`) with this shard's slice of the shared
        consumer's capacity (dt/N, so N shards together drain one
        consumer-tick, not N)."""
        buf = self.shards[si]
        buf.perfmon.observe_rate(now, len(part))
        state["records"] += len(part)
        buf.extend(part)
        with self.telemetry.span("shard.tick", shard=si):
            controlled_tick(buf, self.transform, self.sink, self.consumer, self._hubs[si],
                            state, now, dt, consume_dt=dt / self.n_shards)

    def run(self, source_ticks: Optional[Iterable] = None,
            max_ticks: int = 300) -> ShardedReport:
        if source_ticks is None:
            if self.source is None:
                raise ValueError("no source: pass source_ticks or set source")
            source_ticks = self.source.ticks()
        t_start = time.time()
        states = self.loop_states
        if states is None:
            states = [{"last_beta_e": self.cfg.beta_init, "last_mu": 0.0,
                       "records": 0, "instr": 0, "raw": 0, "crs": []}
                      for _ in range(self.n_shards)]
            self.loop_states = states
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
                self.metrics.emit("tick", now, raw=len(tick.records), kept=len(recs))
                with tel.span("partition"):
                    parts = self._partition(recs)
                for si, part in enumerate(parts):
                    self._shard_step(si, part, now, dt, states[si])

        wall = time.time() - t_start
        # the partition is total: per-shard record counts sum to the
        # filtered stream
        reports = [hub.build_report(total_records=st["records"],
                                    total_instructions=st["instr"],
                                    raw_instructions=st["raw"],
                                    compression_ratios=st["crs"], wall_s=wall)
                   for hub, st in zip(self._hubs, states)]
        return ShardedReport(
            shards=reports,
            total_records=sum(st["records"] for st in states),
            total_instructions=sum(st["instr"] for st in states),
            raw_instructions=sum(st["raw"] for st in states),
            max_buffered=[b.max_buffered for b in self.shards],
            spill_events=sum(h.counters["spill"] for h in self._hubs),
            drain_events=sum(h.counters["drain"] for h in self._hubs),
            wall_s=wall,
        )

    def state(self) -> dict:
        """Host-side resumable state (the store's tensors excluded)."""
        s: dict = {
            "loops": None if self.loop_states is None else
                [{**st, "crs": list(st["crs"])} for st in self.loop_states],
            "shards": [b.state() for b in self.shards],
            "hubs": [h.state() for h in self._hubs],
            "metrics": self.metrics.state(),
            "stages": [st.state() if hasattr(st, "state") else None for st in self.stages],
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
        self.loop_states = None if s["loops"] is None else [dict(st) for st in s["loops"]]
        for b, b_s in zip(self.shards, s["shards"]):
            b.restore_state(b_s)
        for h, h_s in zip(self._hubs, s["hubs"]):
            h.restore_state(h_s)
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
