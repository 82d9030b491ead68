"""Ingestion-time sketch maintenance: the pipeline plug-ins.
Counterpart of `repro.query.stage`.

  * `SketchStage`: a record stage (records -> records pass-through)
    that maps each tick's filtered records through the transform's
    `MappingSpec` and absorbs the resulting edge tables into its sketch.
    It sees the stream at filter time, before the buffer and the
    controller, so its answers are live even while batches are held or
    spilled, and its totals upper-bound the store's.
  * `QuerySink`: a sink wrapper that updates its sketch only on
    COMMITTED edge tables (commit-consistent with the store), keeps an
    incrementally maintained exact CSR snapshot, and publishes live
    answers as `"sketch"` events on the `MetricsHub`.

Both expose the reference's numpy surface: `degree`, `edge_weight`,
`heavy_hitters` (keys as uint64 or uint32, the sketch's width) and
`error_bound`.  Query keys are taken at the sketch's width, as the
reference's `jnp.asarray(keys, hh_keys.dtype)`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.compression import key_tensor, unsigned_view
from repro_torch.core.edge_table import from_raw_batch
from repro_torch.core.transform import MappingSpec, create_edges, tweet_mapping
from repro_torch.query.engine import top_k_degree
from repro_torch.query.sketch import (
    GraphSketch,
    init_sketch,
    sketch_degree,
    sketch_edge_weight,
    sketch_error_bound,
    sketch_heavy_hitters,
    sketch_update,
)
from repro_torch.query.snapshot import SnapshotMaintainer, build_snapshot
from repro_torch.telemetry.spans import NULL_REGISTRY


def _slice_raw(raw, lo: int, hi: int):
    return dataclasses.replace(
        raw, src=raw.src[lo:hi], dst=raw.dst[lo:hi], etype=raw.etype[lo:hi],
        src_type=raw.src_type[lo:hi], dst_type=raw.dst_type[lo:hi])


def keys_to_numpy(keys: torch.Tensor) -> np.ndarray:
    """Key bits on any device -> uint64 or uint32 numpy by their width
    (the reference's)."""
    return unsigned_view(keys.cpu().numpy())


class _SketchQueries:
    """Shared numpy-facing query surface over `self.sketch`."""

    sketch: GraphSketch

    def _keys(self, keys) -> torch.Tensor:
        return key_tensor(keys, self.sketch.device, self.sketch.hh_keys.dtype)

    def degree(self, keys, mode: str = "total") -> np.ndarray:
        return sketch_degree(self.sketch, self._keys(keys), mode=mode).cpu().numpy()

    def edge_weight(self, src, dst) -> np.ndarray:
        return sketch_edge_weight(self.sketch, self._keys(src),
                                  self._keys(dst)).cpu().numpy()

    def heavy_hitters(self, k: int = 10):
        hk, hc = sketch_heavy_hitters(self.sketch, k)
        return keys_to_numpy(hk), hc.cpu().numpy()

    def error_bound(self) -> float:
        return sketch_error_bound(self.sketch)


class SketchStage(_SketchQueries):
    """Stage-protocol pass-through observer keeping a graph sketch at
    filter time, on `device` (default the card), for `key_dtype` keys
    (a sketch given keeps its own width)."""

    name = "sketch"

    def __init__(self, sketch: Optional[GraphSketch] = None,
                 mapping: Optional[MappingSpec] = None,
                 depth: int = 4, width: int = 256, hh_slots: int = 64,
                 max_edges_per_batch: int = 8_192,
                 device: Union[str, torch.device, None] = None,
                 key_dtype: torch.dtype = torch.int64):
        self.sketch = sketch if sketch is not None else init_sketch(
            depth=depth, width=width, hh_slots=hh_slots, device=device, key_dtype=key_dtype)
        self.device = self.sketch.device
        self.mapping = mapping or tweet_mapping()
        self.max_edges_per_batch = max_edges_per_batch
        self.ticks_seen = 0
        self.telemetry = NULL_REGISTRY

    def __call__(self, records: List[dict], ctx=None) -> List[dict]:
        if records:
            with self.telemetry.span("sketch.update"):
                raw = create_edges(records, self.mapping)
                # absorb in <= cap chunks: a burst tick larger than the
                # device batch must never be silently cut off, or the
                # sketch would no longer upper-bound the store
                for lo in range(0, raw.n_edges, self.max_edges_per_batch):
                    hi = min(lo + self.max_edges_per_batch, raw.n_edges)
                    cap = max(64, 1 << int(np.ceil(np.log2(hi - lo))))
                    et = from_raw_batch(_slice_raw(raw, lo, hi), cap, device=self.device,
                                        key_dtype=self.sketch.hh_keys.dtype)
                    self.sketch = sketch_update(self.sketch, et)
        self.ticks_seen += 1
        return records

    def state(self) -> dict:
        return {"ticks_seen": self.ticks_seen}

    def restore_state(self, s: dict) -> None:
        self.ticks_seen = int(s["ticks_seen"])


class QuerySink(_SketchQueries):
    """Sink wrapper: commit-consistent sketch, live `"sketch"` events and
    an incrementally maintained exact CSR snapshot.

    Delegates `commit` to the wrapped sink and absorbs every edge table
    the store actually commits: when the wrapped sink exposes a
    `GraphIngestor` (`.ingestor.commit_hook`), the sketch hooks its
    successful-commit callback, which also sees pooled batches drained
    by later pushes and archived batches replayed by `retry_archive`.
    Otherwise it absorbs the pushed table when the commit reports
    success.  Every `answer_every` commits a `"sketch"` event with the
    current top-k heavy hitters goes to `hub` (when given);
    `exact_topk > 0` adds the exact top-k degrees from the maintained
    snapshot.  A new sketch is made on the device of the wrapped sink's
    store, where the committed edge tables live, for keys of its width."""

    def __init__(self, inner, sketch: Optional[GraphSketch] = None,
                 depth: int = 4, width: int = 256, hh_slots: int = 64,
                 hub=None, answer_every: int = 10, top_k: int = 5,
                 incremental: bool = True, exact_topk: int = 0):
        self.telemetry = NULL_REGISTRY
        self.inner = inner
        self.sketch = sketch if sketch is not None else init_sketch(
            depth=depth, width=width, hh_slots=hh_slots, device=inner.store.device,
            key_dtype=inner.store.node_keys.dtype)
        self.hub = hub
        self.answer_every = max(1, answer_every)
        self.top_k = top_k
        self.exact_topk = exact_topk
        self.commits = 0
        self._now = None
        self._hooked = False
        self.maintainer = SnapshotMaintainer() if incremental else None
        ingestor = getattr(inner, "ingestor", None)
        if ingestor is not None and hasattr(ingestor, "commit_hook"):
            ingestor.commit_hook = self._absorb
            self._hooked = True

    def snapshot(self):
        """Exact CSR snapshot of the committed store: incrementally
        maintained when `incremental`, else a fresh build."""
        if self.maintainer is None:
            return build_snapshot(self.store)
        return self.maintainer.snapshot(self.store)

    def _absorb(self, et, stats):
        # the maintainer must see the commit's delta BEFORE any
        # exact_topk emission below serves snapshot(), or the served
        # view lags the store by one commit
        if self.maintainer is not None:
            self.maintainer.absorb(et, stats)
        with self.telemetry.span("sketch.absorb"):
            self.sketch = sketch_update(self.sketch, et)
        self.commits += 1
        if self.hub is not None and self.commits % self.answer_every == 0:
            hk, hc = self.heavy_hitters(self.top_k)
            payload = dict(
                commits=self.commits,
                absorbed=int(self.sketch.n_updates),
                hh_keys=hk.tolist(), hh_counts=hc.tolist(),
                error_bound=self.error_bound(),
            )
            if self.exact_topk > 0 and self.maintainer is not None:
                keys, degs = top_k_degree(self.snapshot(), self.exact_topk)
                payload["exact_keys"] = keys_to_numpy(keys).tolist()
                payload["exact_degrees"] = degs.cpu().numpy().tolist()
            self.hub.emit("sketch", self._now if self._now is not None else 0.0,
                          **payload)

    def commit(self, et, now: Optional[float] = None) -> Dict:
        self._now = now
        out = self.inner.commit(et, now=now)
        if not self._hooked and out.get("committed", False):
            self._absorb(et, out.get("stats"))
        return out

    def state(self) -> Dict:
        s: Dict = {"commits": self.commits}
        if hasattr(self.inner, "state"):
            s["inner"] = self.inner.state()
        return s

    def restore_state(self, s: Dict) -> None:
        self.commits = int(s["commits"])
        self._now = None
        if self.maintainer is not None:
            # cheaper than saving the CSR: force one full rebuild
            # (apply_delta is bit-exact against build_snapshot)
            self.maintainer.reset()
        if "inner" in s and hasattr(self.inner, "restore_state"):
            self.inner.restore_state(s["inner"])

    # ---- passthrough of the wrapped sink's surface ----
    def retry_archive(self, now: Optional[float] = None) -> int:
        self._now = now
        return self.inner.retry_archive(now)

    @property
    def store(self):
        return self.inner.store

    @property
    def ingestor(self):
        return self.inner.ingestor
