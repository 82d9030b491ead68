"""Stage implementations: the swappable steps of the seven-step loop.
Counterpart of `repro.api.stages`.

  FilterStage        — two-stage filtering (§II-A).
  TransformStage     — model transformation (Algorithm 1 CREATEEDGE) on
                       the host, then graph compression into an edge
                       table on the device; owns the instruction
                       accounting for both paths.
  BufferControlStage — the adaptive buffer + Algorithm 2 controller.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.api.protocols import TickContext
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.core.buffer import BufferController, ControllerDecision
from repro_torch.core.compression import check_key_dtype
from repro_torch.core.edge_table import EdgeTable, from_raw_batch
from repro_torch.core.transform import MappingSpec, create_edges, tweet_mapping
from repro_torch.device import resolve
from repro_torch.ingest.filter import analysis_filter, api_keyword_filter, apply_filters
from repro_torch.telemetry.spans import NULL_REGISTRY


class FilterStage:
    """§II-A two-stage filter as one record stage."""

    name = "filter"

    def __init__(self, keywords: Sequence[str] = (),
                 stage2: Callable[[dict], bool] = analysis_filter):
        self.stage1 = api_keyword_filter(list(keywords))
        self.stage2 = stage2

    def __call__(self, records: List[dict], ctx: Optional[TickContext] = None) -> List[dict]:
        return apply_filters(records, self.stage1, self.stage2)


class TransformStage:
    """Records -> compressed edge table on `device` (default the card),
    with `key_dtype` keys (torch.int64: uint64 bits, torch.int32: the low
    32 bits of each id), + instruction counts.

    `compress=False` keeps the compressed table for the store but
    accounts the ingestion load at the raw instruction stream, the
    paper's uncompressed baseline."""

    name = "transform"

    def __init__(self, mapping: Optional[MappingSpec] = None,
                 max_edges_per_batch: int = 8_192, compress: bool = True,
                 telemetry=None, device: Union[str, torch.device, None] = None,
                 key_dtype: torch.dtype = torch.int64):
        self.mapping = mapping or tweet_mapping()
        self.max_edges_per_batch = max_edges_per_batch
        self.compress = compress
        self.telemetry = telemetry or NULL_REGISTRY
        self.device = resolve(device)
        self.key_dtype = check_key_dtype(key_dtype)

    def encode(self, records: List[dict]) -> Tuple[EdgeTable, int, int]:
        tel = self.telemetry
        with tel.span("transform.map"):
            raw = create_edges(records, self.mapping)
        cap = max(64, 1 << int(np.ceil(np.log2(max(raw.n_edges, 1)))))
        cap = min(cap, self.max_edges_per_batch)
        with tel.span("transform.dedup"):
            et = from_raw_batch(raw, cap, device=self.device, key_dtype=self.key_dtype)
        raw_instr = 3 * raw.n_edges
        if not self.compress:
            n_instr = raw_instr
        else:
            n_instr = int(et.size())
        return et, n_instr, raw_instr


class BufferControlStage:
    """The adaptive buffer (Algorithm 2) as a pipeline stage: owns the
    in-memory record buffer, the spill store, and the controller."""

    name = "buffer"

    def __init__(self, controller: Optional[BufferController] = None,
                 cfg: Optional[IngestConfig] = None,
                 spill_dir: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
        self.controller = controller or BufferController(
            cfg or IngestConfig(), spill_dir=spill_dir, device=device)
        self.buffer: List[dict] = []
        self.max_buffered = 0  # high-water mark
        # provenance (repro_torch.lineage): per-record came-back-from-spill
        # flags parallel to `buffer`, the count of records currently
        # detoured to disk, and whether the last take touched spill
        self._spill_flags: List[bool] = []
        self.spilled_records = 0
        self.last_take_spilled = False
        self.lineage = None  # LineageTracker (set by builder wiring)

    def extend(self, records: List[dict]):
        if self.lineage is not None:
            self.lineage.observe_intake(records)
        self.buffer.extend(records)
        self._spill_flags.extend([False] * len(records))
        self.max_buffered = max(self.max_buffered, len(self.buffer))

    def take_batch(self) -> List[dict]:
        """Pop up to beta records (the controller's current bucket)."""
        batch = self.buffer[: self.controller.beta]
        self.buffer = self.buffer[self.controller.beta:]
        taken = self._spill_flags[: len(batch)]
        self._spill_flags = self._spill_flags[len(batch):]
        self.last_take_spilled = any(taken)
        return batch

    def take_all(self) -> List[dict]:
        batch, self.buffer = self.buffer, []
        self.last_take_spilled = any(self._spill_flags)
        self._spill_flags = []
        return batch

    def spill_all(self) -> int:
        """Data throttling: flush the whole buffer to disk."""
        n = len(self.buffer)
        if self.buffer:
            self.controller.spill.flush(self.buffer)
            self.buffer = []
            self._spill_flags = []
            self.spilled_records += n
        return n

    def drain_spill(self):
        """Step 6: reload spilled data into the buffer (their intake
        was observed when they first entered it)."""
        drained = self.controller.spill.drain()
        self.spilled_records = max(0, self.spilled_records - len(drained))
        self.buffer.extend(drained)
        self._spill_flags.extend([True] * len(drained))
        self.max_buffered = max(self.max_buffered, len(self.buffer))

    def state(self) -> dict:
        return {
            "buffer": list(self.buffer),
            "max_buffered": self.max_buffered,
            "controller": self.controller.state(),
            "spill_flags": list(self._spill_flags),
            "spilled_records": self.spilled_records,
        }

    def restore_state(self, s: dict) -> None:
        self.buffer = list(s["buffer"])
        self.max_buffered = int(s["max_buffered"])
        self.controller.restore_state(s["controller"])
        # .get: states saved without lineage's keys
        self._spill_flags = list(s.get("spill_flags", [False] * len(self.buffer)))
        self.spilled_records = int(s.get("spilled_records", 0))

    def decide(self, size_est: float, density: float,
               now: Optional[float] = None) -> ControllerDecision:
        return self.controller.decide(size_est, density, now=now)

    @property
    def perfmon(self):
        return self.controller.perfmon

    @property
    def spill_depth(self) -> int:
        return self.controller.spill.depth

    def __len__(self) -> int:
        return len(self.buffer)
