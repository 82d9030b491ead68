"""`PipelineBuilder` — the fluent facade over the composable API.
Counterpart of `repro.api.builder` (the core methods).

    pipe = (PipelineBuilder(IngestConfig(cpu_max=0.55), device="cuda")
            .with_source(BurstyTweetSource(seed=0))
            .with_keywords(["memo"])
            .simulated_consumer(speed=0.5)
            .spill_dir("/path/to/spill")
            .build())
    report = pipe.run(max_ticks=300)

Every part not set explicitly gets the paper default, made on the
builder's `device` (default the card).
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Union

import torch

from repro_torch.api.consumers import MeasuredConsumer, SimulatedConsumer
from repro_torch.api.metrics import MetricsHub, PipelineEvent
from repro_torch.api.pipeline import StreamPipeline
from repro_torch.api.sinks import GraphStoreSink
from repro_torch.api.stages import BufferControlStage, FilterStage, TransformStage
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.core.buffer import BufferController
from repro_torch.core.transform import MappingSpec
from repro_torch.device import resolve


class PipelineBuilder:
    def __init__(self, cfg: Optional[IngestConfig] = None,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg or IngestConfig()
        self.device = resolve(device)
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
        self._metrics: Optional[MetricsHub] = None
        self._hooks = []

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

    def on_event(self, hook: Callable[[PipelineEvent], None]) -> "PipelineBuilder":
        self._hooks.append(hook)
        return self

    # ---- assembly ----
    def build(self) -> StreamPipeline:
        dev = self.device
        filt = self._filter or FilterStage(self._keywords)
        transform = self._transform or TransformStage(
            mapping=self._mapping,
            max_edges_per_batch=self.cfg.max_edges_per_batch,
            compress=self._compress, device=dev)
        sink = self._sink or GraphStoreSink(
            node_cap=self.cfg.store_nodes, edge_cap=self.cfg.store_edges, device=dev)
        consumer = self._consumer
        if consumer == "measured":
            if not isinstance(sink, GraphStoreSink):
                raise ValueError("measured_consumer() needs a GraphStoreSink")
            consumer = MeasuredConsumer(sink.ingestor)
        elif consumer is None:
            consumer = SimulatedConsumer()
        metrics = self._metrics or MetricsHub()
        for h in self._hooks:
            metrics.subscribe(h)
        buffer_stage = BufferControlStage(
            controller=self._controller, cfg=self.cfg,
            spill_dir=self._spill_dir, device=dev)
        return StreamPipeline(
            cfg=self.cfg,
            source=self._source,
            filter_stage=filt,
            transform=transform,
            buffer_stage=buffer_stage,
            consumer=consumer,
            sink=sink,
            uncontrolled=self._uncontrolled,
            metrics=metrics,
        )

    def run(self, max_ticks: int = 300):
        """Build and run in one call (source must be set)."""
        return self.build().run(max_ticks=max_ticks)
