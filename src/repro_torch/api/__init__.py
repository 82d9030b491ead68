"""Composable streaming-ingestion API (counterpart of `repro.api`).

The paper's pipeline decomposed into swappable protocols: `Source`,
`Stage` (`FilterStage`, `TransformStage`, `BufferControlStage`),
`Consumer` (`SimulatedConsumer`, `MeasuredConsumer`) and `Sink`
(`GraphStoreSink`).  `StreamPipeline` wires one of each into the
paper's control loop; `PipelineBuilder` is the fluent facade;
`MetricsHub` carries the per-tick trace and event hooks;
`ShardedPipeline` runs one controller per user-hash shard over one
shared sink and consumer.
"""
from repro_torch.api.protocols import Consumer, Sink, Source, Stage, TickContext
from repro_torch.api.consumers import MeasuredConsumer, SimulatedConsumer
from repro_torch.api.sinks import GraphStoreSink
from repro_torch.api.stages import BufferControlStage, FilterStage, TransformStage
from repro_torch.api.metrics import MetricsHub, PipelineEvent, PipelineReport
from repro_torch.api.pipeline import StreamPipeline
from repro_torch.api.sharded import ShardedPipeline, ShardedReport, default_shard_key
from repro_torch.api.builder import PipelineBuilder

__all__ = [
    "Source", "Stage", "Consumer", "Sink", "TickContext",
    "SimulatedConsumer", "MeasuredConsumer",
    "GraphStoreSink",
    "FilterStage", "TransformStage", "BufferControlStage",
    "MetricsHub", "PipelineEvent", "PipelineReport",
    "StreamPipeline", "PipelineBuilder",
    "ShardedPipeline", "ShardedReport", "default_shard_key",
]
