"""`PipelineBuilder` — the fluent facade over the composable API.
Counterpart of `repro.api.builder` (the core methods, extra record
stages, the query path: the sketch stage, the query sink and
sketch-guided control, GraphZip dictionary compression, sharding, span
telemetry with the controller audit trail, the health monitor, batch
lineage with its watermarks, and fault injection with commit retry).

    pipe = (PipelineBuilder(IngestConfig(cpu_max=0.55), device="cuda")
            .with_source(BurstyTweetSource(seed=0))
            .with_keywords(["memo"])
            .simulated_consumer(speed=0.5)
            .spill_dir("/path/to/spill")
            .build())
    report = pipe.run(max_ticks=300)

`sharded(n)` switches `build()` to a `ShardedPipeline`.  Every part not
set explicitly gets the paper default, made on the builder's `device`
(default the card) with the builder's `key_dtype`: torch.int64 (the
default) keeps uint64 keys, as the reference under x64; torch.int32 keeps
uint32 keys (the low 32 bits of each id), as the reference without it.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Union

import torch

from repro_torch.api.consumers import MeasuredConsumer, SimulatedConsumer
from repro_torch.api.metrics import MetricsHub, PipelineEvent
from repro_torch.api.pipeline import StreamPipeline
from repro_torch.api.sharded import ShardedPipeline
from repro_torch.api.sinks import GraphStoreSink
from repro_torch.api.stages import BufferControlStage, FilterStage, TransformStage
from repro_torch.compress import CompressingTransform, DictionaryStage
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.core.buffer import BufferController
from repro_torch.core.compression import check_key_dtype
from repro_torch.core.transform import MappingSpec
from repro_torch.device import resolve
from repro_torch.lineage import LineageTracker
from repro_torch.monitor import HealthMonitor
from repro_torch.query.stage import QuerySink, SketchStage
from repro_torch.resilience import FaultInjector, FaultPlan, RetryPolicy
from repro_torch.telemetry import AuditTrail, TelemetryRegistry

# placeholders in the stage list for stages constructed at build time
_SKETCH_SLOT = object()
_DICT_SLOT = object()


class PipelineBuilder:
    def __init__(self, cfg: Optional[IngestConfig] = None,
                 device: Union[str, torch.device, None] = None,
                 key_dtype: torch.dtype = torch.int64):
        self.cfg = cfg or IngestConfig()
        self.device = resolve(device)
        self.key_dtype = check_key_dtype(key_dtype)
        self._source = None
        self._filter: Optional[FilterStage] = None
        self._keywords: Sequence[str] = ()
        self._mapping: Optional[MappingSpec] = None
        self._transform: Optional[TransformStage] = None
        self._compress = True
        self._uncontrolled = False
        self._consumer = None
        self._sink = None
        self._controller: Optional[BufferController] = None
        self._spill_dir: Optional[str] = None
        self._n_shards = 1
        self._shard_key: Optional[Callable[[dict], str]] = None
        self._metrics: Optional[MetricsHub] = None
        self._hooks = []
        self._stages = []
        self._sketch_stage: Optional[SketchStage] = None
        self._sketch_kw = {}
        self._query_sink_opts = None
        self._sketch_guided = False
        self._dict_stage: Optional[DictionaryStage] = None
        self._compression_kw = None
        self._telemetry: Optional[TelemetryRegistry] = None
        self._monitor = None
        self._monitor_kw = None
        self._lineage: Optional[LineageTracker] = None
        self._lineage_kw = None
        self._fault_plan = None
        self._fault_injector: Optional[FaultInjector] = None
        self._retry = None

    # ---- parts ----
    def with_source(self, source) -> "PipelineBuilder":
        self._source = source
        return self

    def with_filter(self, stage: FilterStage) -> "PipelineBuilder":
        self._filter = stage
        return self

    def with_keywords(self, keywords: Iterable[str]) -> "PipelineBuilder":
        self._keywords = list(keywords)
        return self

    def with_mapping(self, mapping: MappingSpec) -> "PipelineBuilder":
        self._mapping = mapping
        return self

    def with_transform(self, transform: TransformStage) -> "PipelineBuilder":
        self._transform = transform
        return self

    def with_stage(self, stage) -> "PipelineBuilder":
        """Append an extra Stage-protocol record stage (runs after the
        filter, before the buffer), e.g. a `repro_torch.query.SketchStage`."""
        self._stages.append(stage)
        return self

    def with_sketch(self, sketch_stage: Optional[SketchStage] = None,
                    **kw) -> "PipelineBuilder":
        """Keep an ingestion-time graph sketch: adds a `SketchStage`
        after the filter.  When no stage is passed, one is made at build
        time on the builder's device, inheriting its mapping and the
        config's max_edges_per_batch (so the sketch observes exactly the
        edges the transform commits); read it back via `.sketch_stage`."""
        self._sketch_stage = sketch_stage
        self._sketch_kw = dict(kw)
        self._stages.append(_SKETCH_SLOT)
        return self

    @property
    def sketch_stage(self) -> Optional[SketchStage]:
        """The `SketchStage` added by `with_sketch` (after build())."""
        return self._sketch_stage

    def with_query_sink(self, **kw) -> "PipelineBuilder":
        """Wrap the sink in a `repro_torch.query.QuerySink` at build
        time: a commit-consistent sketch, an incrementally maintained
        snapshot and live "sketch" MetricsHub events.  Keyword args go
        to `QuerySink` (depth, width, answer_every, top_k, exact_topk,
        ...)."""
        self._query_sink_opts = dict(kw)
        return self

    def sketch_guided(self, flag: bool = True) -> "PipelineBuilder":
        """Sketch-guided control: feed the QuerySink's live heavy-hitter
        signal back into the Algorithm-2 controller through the
        MetricsHub "sketch" events.  Implies `with_query_sink()` when
        none was configured."""
        self._sketch_guided = flag
        return self

    def with_compression(self, stage: Optional[DictionaryStage] = None,
                         **kw) -> "PipelineBuilder":
        """Ingestion-time dictionary compression (GraphZip): mines
        star/cascade/hot patterns per bucket, rewrites recurring edges
        into `(pattern_id, bindings)` references against a dictionary on
        the device, and commits them through `commit_compressed`.  When
        no stage is passed, one is made at build time on the builder's
        device from the keyword args (capacity, star_min, hot_min, ttl);
        read it back via `.dictionary_stage`."""
        self._dict_stage = stage
        self._compression_kw = dict(kw)
        self._stages.append(_DICT_SLOT)
        return self

    @property
    def dictionary_stage(self) -> Optional[DictionaryStage]:
        """The `DictionaryStage` added by `with_compression` (after build())."""
        return self._dict_stage

    def with_consumer(self, consumer) -> "PipelineBuilder":
        self._consumer = consumer
        return self

    def simulated_consumer(self, speed: float = 1.0) -> "PipelineBuilder":
        self._consumer = SimulatedConsumer(speed=speed)
        return self

    def measured_consumer(self) -> "PipelineBuilder":
        """Use the real commit busy-fraction as mu (set at build time,
        once the sink's ingestor exists)."""
        self._consumer = "measured"
        return self

    def with_sink(self, sink) -> "PipelineBuilder":
        self._sink = sink
        return self

    def with_controller(self, controller: BufferController) -> "PipelineBuilder":
        self._controller = controller
        return self

    def sharded(self, n_shards: int,
                shard_key: Optional[Callable[[dict], str]] = None) -> "PipelineBuilder":
        """Build a `ShardedPipeline` of `n_shards` controlled shards,
        partitioned by `shard_key` (default: the record's user)."""
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self._n_shards = n_shards
        self._shard_key = shard_key
        return self

    # ---- behaviour knobs ----
    def uncontrolled(self, flag: bool = True) -> "PipelineBuilder":
        self._uncontrolled = flag
        return self

    def compressed(self, flag: bool = True) -> "PipelineBuilder":
        self._compress = flag
        return self

    def spill_dir(self, path: str) -> "PipelineBuilder":
        self._spill_dir = path
        return self

    def with_metrics(self, hub: MetricsHub) -> "PipelineBuilder":
        self._metrics = hub
        return self

    def with_telemetry(self, registry: Optional[TelemetryRegistry] = None
                       ) -> "PipelineBuilder":
        """Span telemetry + controller audit trail: threads one
        `TelemetryRegistry` through every layer (the MetricsHub's event
        counters and loop spans, the transform, the sink's ingestor, the
        sketch and dictionary stages, the snapshot maintainer) and gives
        each controller an `AuditTrail` tagged with its shard.  Pass a
        registry to share one across pipelines, or nothing to make one;
        read it back via `pipe.telemetry` / `pipe.metrics.telemetry`."""
        if registry is None or registry is True:
            registry = TelemetryRegistry()
        self._telemetry = registry
        return self

    def with_monitor(self, monitor=None, **kw) -> "PipelineBuilder":
        """Online health monitoring: subscribe a
        `repro_torch.monitor.HealthMonitor` to the pipeline's MetricsHub
        and tap the telemetry registry for per-tick series (EWMA and
        Page–Hinkley `HealthEvent`s, SLO error budgets with burn-rate
        alerts, controller decision-quality scoring).  Implies
        `with_telemetry()`.  Pass a configured monitor, or keyword args
        for `HealthMonitor` (series, slos, cpu_max, on_tick); read it
        back via `.health_monitor` (also `pipe.monitor` / `hub.monitor`
        after build)."""
        self._monitor = monitor
        self._monitor_kw = dict(kw)
        if self._telemetry is None:
            self.with_telemetry()
        return self

    @property
    def health_monitor(self):
        """The `HealthMonitor` wired by `with_monitor` (after build())."""
        return self._monitor

    def with_lineage(self, tracker: Optional[LineageTracker] = None,
                     **kw) -> "PipelineBuilder":
        """Batch provenance + event-time watermarks: tag every batch at
        the buffer with a monotone id and its event-time envelope,
        follow it through spill, pool and archive to the queryable
        snapshot, and keep the committed/queryable watermark pair with
        per-path freshness histograms.  Pass a configured
        `repro_torch.lineage.LineageTracker`, or keyword args for one
        (sample_rate, dt, buffered_slack, ...); read it back via
        `.lineage_tracker` (also `pipe.lineage` / `hub.lineage` after
        build)."""
        self._lineage = tracker if tracker is not None and tracker is not True else None
        self._lineage_kw = dict(kw)
        return self

    @property
    def lineage_tracker(self) -> Optional[LineageTracker]:
        """The `LineageTracker` wired by `with_lineage` (after build())."""
        return self._lineage

    def on_event(self, hook: Callable[[PipelineEvent], None]) -> "PipelineBuilder":
        self._hooks.append(hook)
        return self

    # ---- resilience ----
    def with_faults(self, plan) -> "PipelineBuilder":
        """Counter-deterministic fault injection: wire a
        `repro_torch.resilience.FaultPlan` (or a ready `FaultInjector`)
        as the sink ingestor's `fail_hook` at build time.  Read the
        injector back via `.fault_injector`."""
        self._fault_plan = plan
        return self

    @property
    def fault_injector(self) -> Optional[FaultInjector]:
        """The `FaultInjector` wired by `with_faults` (after build())."""
        return self._fault_injector

    def with_retry(self, policy: Optional[RetryPolicy] = None, *,
                   max_archive: Optional[int] = None, pool_cap: Optional[int] = None,
                   archive_dir: Optional[str] = None,
                   degrade_after: Optional[int] = None) -> "PipelineBuilder":
        """Backoff-governed commit retry: attach a `RetryPolicy` (the
        default one when none is given) to the sink's ingestor at build
        time.  This arms the per-tick archive replay in the loop, the
        exponential-backoff gate, the degraded push mode, and, through
        the keyword overrides, the bounded archive (`max_archive`
        batches in memory, spilled to `archive_dir` beyond) and the
        pool's hard cap."""
        self._retry = (policy if policy is not None else RetryPolicy(), {
            "max_archive": max_archive, "pool_cap": pool_cap,
            "archive_dir": archive_dir, "degrade_after": degrade_after,
        })
        return self

    # ---- assembly ----
    def _resolve_stages(self):
        """Materialise the sketch slot with the builder's mapping, cap
        and device."""
        stages = []
        for st in self._stages:
            if st is _SKETCH_SLOT:
                if self._sketch_stage is None:
                    kw = dict(self._sketch_kw)
                    kw.setdefault("mapping", self._mapping)
                    kw.setdefault("max_edges_per_batch", self.cfg.max_edges_per_batch)
                    kw.setdefault("device", self.device)
                    kw.setdefault("key_dtype", self.key_dtype)
                    self._sketch_stage = SketchStage(**kw)
                stages.append(self._sketch_stage)
            elif st is _DICT_SLOT:
                stages.append(self._dict_stage)  # made by build()
            else:
                stages.append(st)
        return stages

    def build(self) -> Union[StreamPipeline, ShardedPipeline]:
        dev = self.device
        filt = self._filter or FilterStage(self._keywords)
        transform = self._transform or TransformStage(
            mapping=self._mapping,
            max_edges_per_batch=self.cfg.max_edges_per_batch,
            compress=self._compress, device=dev, key_dtype=self.key_dtype)
        sink = self._sink or GraphStoreSink(
            node_cap=self.cfg.store_nodes, edge_cap=self.cfg.store_edges, device=dev,
            key_dtype=self.key_dtype)
        consumer = self._consumer
        if consumer == "measured":
            if not isinstance(sink, GraphStoreSink):
                raise ValueError("measured_consumer() needs a GraphStoreSink")
            consumer = MeasuredConsumer(sink.ingestor)
        elif consumer is None:
            consumer = SimulatedConsumer()
        metrics = self._metrics or MetricsHub(telemetry=self._telemetry)
        if self._metrics is not None and self._telemetry is not None:
            metrics.telemetry = self._telemetry
        for h in self._hooks:
            metrics.subscribe(h)
        qs_opts = self._query_sink_opts
        if self._sketch_guided and qs_opts is None:
            qs_opts = {}  # sketch events need a QuerySink
        if qs_opts is not None:
            sink = QuerySink(sink, hub=metrics, **qs_opts)
        if self._compression_kw is not None:
            if self._dict_stage is None:
                kw = dict(self._compression_kw)
                kw.setdefault("device", dev)
                self._dict_stage = DictionaryStage(**kw)
            # the rewrite runs in the transform (after Algorithm 1); the
            # dictionary learns from SUCCESSFUL commits only, through the
            # ingestor's commit hooks (`.ingestor` passes through a
            # QuerySink)
            transform = CompressingTransform(transform, self._dict_stage)
            ingestor = getattr(sink, "ingestor", None)
            if ingestor is not None and hasattr(ingestor, "commit_hooks"):
                ingestor.commit_hooks.append(self._dict_stage.observe_commit)
        if self._fault_plan is not None or self._retry is not None:
            ingestor = getattr(sink, "ingestor", None)
            if ingestor is None:
                raise ValueError("with_faults()/with_retry() need a sink "
                                 "with a GraphIngestor underneath")
            if self._fault_plan is not None:
                self._fault_injector = (FaultInjector(self._fault_plan)
                                        if isinstance(self._fault_plan, FaultPlan)
                                        else self._fault_plan)
                ingestor.fail_hook = self._fault_injector
            if self._retry is not None:
                policy, overrides = self._retry
                ingestor.retry_policy = policy
                for name, val in overrides.items():
                    if val is not None:
                        setattr(ingestor, name, val)
        if self._n_shards > 1:
            if self._uncontrolled:
                raise ValueError("sharded pipelines are always controlled")
            if self._controller is not None:
                raise ValueError("with_controller() is single-shard only: "
                                 "each shard builds its own controller")
            pipe = ShardedPipeline(
                cfg=self.cfg,
                n_shards=self._n_shards,
                source=self._source,
                filter_stage=filt,
                transform=transform,
                consumer=consumer,
                sink=sink,
                spill_dir=self._spill_dir,
                shard_key=self._shard_key,
                metrics=metrics,
                stages=self._resolve_stages(),
                device=dev,
            )
            controllers = [s.controller for s in pipe.shards]
        else:
            buffer_stage = BufferControlStage(
                controller=self._controller, cfg=self.cfg,
                spill_dir=self._spill_dir, device=dev)
            pipe = StreamPipeline(
                cfg=self.cfg,
                source=self._source,
                filter_stage=filt,
                transform=transform,
                buffer_stage=buffer_stage,
                consumer=consumer,
                sink=sink,
                uncontrolled=self._uncontrolled,
                metrics=metrics,
                stages=self._resolve_stages(),
            )
            controllers = [buffer_stage.controller]
        if self._sketch_guided:
            # live sketch events -> every controller's diversity hint
            def _guide(ev):
                if ev.kind == "sketch":
                    for c in controllers:
                        c.observe_sketch(ev.payload)

            metrics.subscribe(_guide)
        if self._telemetry is not None:
            self._wire_telemetry(pipe, transform, sink, controllers)
        if self._monitor is not None or self._monitor_kw is not None:
            if self._monitor is None:
                self._monitor = HealthMonitor(**self._monitor_kw)
            self._monitor.bind(metrics, cfg=self.cfg)
            metrics.monitor = self._monitor
            pipe.monitor = self._monitor
        if self._lineage is not None or self._lineage_kw is not None:
            if self._lineage is None:
                self._lineage = LineageTracker(**(self._lineage_kw or {}))
            tracker = self._lineage
            metrics.lineage = tracker
            pipe.lineage = tracker
            # intake observation at every buffer stage, tag custody at
            # the ingestor, and the per-shard hubs `controlled_tick`
            # actually receives
            if isinstance(pipe, ShardedPipeline):
                for b in pipe.shards:
                    b.lineage = tracker
                for h in pipe._hubs:
                    h.lineage = tracker
            else:
                pipe.buffer_stage.lineage = tracker
            ingestor = getattr(sink, "ingestor", None)
            if ingestor is not None and hasattr(ingestor, "lineage"):
                ingestor.lineage = tracker
            # bind AFTER the monitor, so that the per-tick "watermark"
            # event lands in the tick row the monitor just opened
            tracker.bind(metrics)
        return pipe

    def _wire_telemetry(self, pipe, transform, sink, controllers):
        """Thread the registry through every instrumented layer."""
        reg = self._telemetry
        if hasattr(transform, "telemetry"):
            transform.telemetry = reg  # a CompressingTransform forwards it
        for st in pipe.stages:  # SketchStage, DictionaryStage, custom stages
            if hasattr(st, "telemetry"):
                st.telemetry = reg
        # the sink chain: the QuerySink wrapper, its maintainer, and the
        # GraphStoreSink's ingestor underneath (commit sub-spans)
        if hasattr(sink, "telemetry"):
            sink.telemetry = reg
        maintainer = getattr(sink, "maintainer", None)
        if maintainer is not None:
            maintainer.telemetry = reg
        ingestor = getattr(sink, "ingestor", None)
        if ingestor is not None and hasattr(ingestor, "telemetry"):
            ingestor.telemetry = reg
        # one audit trail per controller, tagged with its shard
        for si, c in enumerate(controllers):
            c.audit = AuditTrail(reg, shard=si)

    def run(self, max_ticks: int = 300):
        """Build and run in one call (source must be set)."""
        return self.build().run(max_ticks=max_ticks)
