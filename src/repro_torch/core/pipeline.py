"""The seed-era `IngestionPipeline` over the composable API.
Counterpart of `repro.core.pipeline`.

The seven-step loop (Fig. 4) is `repro_torch.api.StreamPipeline`,
composed from Source/Stage/Consumer/Sink parts.  This module keeps the
original constructor and `run()` contract (the same reports and the
same mu/delay numerics for a fixed seed) for existing callers, with a
`device` (default the card); new code should use
`repro_torch.api.PipelineBuilder`.
"""
from __future__ import annotations

from typing import Iterable, Optional, Union

import torch

from repro_torch.api.consumers import SimulatedConsumer
from repro_torch.api.metrics import PipelineReport
from repro_torch.api.pipeline import StreamPipeline
from repro_torch.api.sinks import GraphStoreSink
from repro_torch.api.stages import BufferControlStage, FilterStage, TransformStage
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.core.buffer import BufferController
from repro_torch.core.transform import MappingSpec
from repro_torch.device import resolve

__all__ = ["IngestionPipeline", "PipelineReport"]


class IngestionPipeline:
    """The paper pipeline with its original (seed) signature.  A
    `spill_dir` of None spills to a fresh directory."""

    def __init__(
        self,
        cfg: IngestConfig = IngestConfig(),
        mapping: Optional[MappingSpec] = None,
        keywords: Iterable[str] = (),
        uncontrolled: bool = False,
        compress: bool = True,
        spill_dir: Optional[str] = None,
        consumer_speed: float = 1.0,
        device: Union[str, torch.device, None] = None,
    ):
        dev = resolve(device)
        self.cfg = cfg
        self.uncontrolled = uncontrolled
        self.compress = compress
        self.consumer_speed = consumer_speed
        controller = BufferController(cfg, spill_dir=spill_dir, device=dev)
        self._pipe = StreamPipeline(
            cfg=cfg,
            filter_stage=FilterStage(keywords),
            transform=TransformStage(mapping=mapping,
                                     max_edges_per_batch=cfg.max_edges_per_batch,
                                     compress=compress, device=dev),
            buffer_stage=BufferControlStage(controller=controller),
            consumer=SimulatedConsumer(speed=consumer_speed),
            sink=GraphStoreSink(node_cap=cfg.store_nodes, edge_cap=cfg.store_edges,
                                device=dev),
            uncontrolled=uncontrolled,
        )

    # ---- seed-era accessors ----
    @property
    def controller(self) -> BufferController:
        return self._pipe.controller

    @property
    def ingestor(self):
        return self._pipe.sink.ingestor

    @property
    def store(self):
        return self._pipe.store

    @property
    def buffer(self):
        return self._pipe.buffer

    @property
    def mapping(self):
        return self._pipe.transform.mapping

    @property
    def system_delay_s(self) -> float:
        """alpha (Eq. 3): seconds of work queued at the consumer."""
        return self._pipe.system_delay_s

    def run(self, source_ticks, max_ticks: int = 300) -> PipelineReport:
        return self._pipe.run(source_ticks, max_ticks=max_ticks)
