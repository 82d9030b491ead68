"""Sink implementations (graph-store commit targets).
Counterpart of `repro.api.sinks`.

`GraphStoreSink` binds the pipeline to the device-resident property
graph through `GraphIngestor` (Algorithm 3 GRAPHPUSH: bounded pool,
archive-and-retry on commit failure).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.core.ingestor import GraphIngestor
from repro_torch.graphstore.store import GraphStore, init_store


class GraphStoreSink:
    """GRAPHPUSH into the device hash-table store via the ingestion
    pool.  A new store is made on `device` (default the card) with
    `key_dtype` keys (torch.int64: uint64 bits, torch.int32: uint32)."""

    def __init__(self, ingestor: Optional[GraphIngestor] = None,
                 store: Optional[GraphStore] = None,
                 node_cap: int = 1 << 20, edge_cap: int = 1 << 21,
                 max_pool_size: int = 4, fail_hook=None,
                 occupancy_window: float = 8.0,
                 device: Union[str, torch.device, None] = None,
                 key_dtype: torch.dtype = torch.int64):
        if ingestor is None:
            if store is None:
                store = init_store(node_cap, edge_cap, device=device, key_dtype=key_dtype)
            ingestor = GraphIngestor(store, max_pool_size=max_pool_size,
                                     fail_hook=fail_hook,
                                     occupancy_window=occupancy_window)
        self.ingestor = ingestor

    def commit(self, et, now: Optional[float] = None) -> Dict:
        return self.ingestor.push(et, now=now)

    def retry_archive(self, now: Optional[float] = None) -> int:
        return self.ingestor.retry_archive(now)

    @property
    def store(self) -> GraphStore:
        return self.ingestor.store

    def state(self) -> Dict:
        return {"ingestor": self.ingestor.state()}

    def restore_state(self, s: Dict) -> None:
        self.ingestor.restore_state(s["ingestor"])
