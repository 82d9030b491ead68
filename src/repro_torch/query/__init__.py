"""Streaming query & analytics engine, the read path over the store.
Counterpart of `repro.query`.

  * **Ingestion-time sketch** (`query.sketch`): a count-min sketch of
    the edge-weight matrix plus per-node degree counters and a
    heavy-hitter table, updated as batches flow through the pipeline
    (`SketchStage` / `QuerySink`); it answers edge-weight, degree and
    top-k queries live, as upper bounds.  Its update runs the
    hand-written `sketch_scatter` kernel on the card.
  * **Snapshot engine** (`query.snapshot` + `query.engine`): the hash
    tables compacted into a device-resident CSR snapshot, maintained
    incrementally per commit, and exact queries over it: degree
    distribution, top-k heavy nodes, k-hop expansion, triangle count,
    edge lookups.

CLI: ``python -m repro_torch.launch.query``.
"""
from repro_torch.query.sketch import (
    GraphSketch,
    init_sketch,
    sketch_degree,
    sketch_edge_weight,
    sketch_error_bound,
    sketch_heavy_hitters,
    sketch_update,
)
from repro_torch.query.snapshot import (
    GraphSnapshot,
    SnapshotMaintainer,
    apply_delta,
    build_snapshot,
    node_index,
)
from repro_torch.query.engine import (
    degree_distribution,
    edge_lookup,
    k_hop,
    top_k_degree,
    triangle_count,
)
from repro_torch.query.stage import QuerySink, SketchStage

__all__ = [
    "GraphSketch", "init_sketch", "sketch_update",
    "sketch_edge_weight", "sketch_degree", "sketch_heavy_hitters",
    "sketch_error_bound",
    "GraphSnapshot", "build_snapshot", "apply_delta",
    "SnapshotMaintainer", "node_index",
    "degree_distribution", "top_k_degree", "k_hop", "triangle_count",
    "edge_lookup",
    "SketchStage", "QuerySink",
]
