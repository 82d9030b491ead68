"""Vectorised query ops over a `GraphSnapshot` (all exact).
Counterpart of `repro.query.engine`.

  * `degree_distribution`: histogram of node degrees (scatter-add).
  * `top_k_degree`: exact top-k heaviest nodes.
  * `k_hop`: frontier expansion, one O(E) gather plus one scatter into
    the destination mask per hop.
  * `triangle_count`: dense-adjacency trace(A^3)/6 (guarded to small
    node capacities).
  * `edge_lookup`: total weight of (src, dst) over all edge types: two
    vectorised binary searches into the sorted edge list plus one
    prefix-sum gather.

The store's orientation is src -> dst; `directed=False` also walks the
reverse CSR.  Slot Ncap is a trash slot wherever the reference drops a
write.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.query.sketch import stable_top_k
from repro_torch.query.snapshot import GraphSnapshot, node_index


def _live_nodes(snap: GraphSnapshot) -> torch.Tensor:
    return torch.arange(snap.node_cap, device=snap.node_key.device) < snap.n_nodes


def degree_distribution(snap: GraphSnapshot, num_bins: int = 64) -> torch.Tensor:
    """Histogram of node degrees: bin i counts nodes with degree i
    (degrees >= num_bins-1 land in the last bin)."""
    b = snap.node_degree.clamp(0, num_bins - 1)
    b = torch.where(_live_nodes(snap), b, torch.full_like(b, num_bins))
    hist = torch.zeros(num_bins + 1, dtype=torch.int32, device=b.device)
    hist.index_add_(0, b.to(torch.int64), torch.ones_like(b))
    return hist[:num_bins]


def top_k_degree(snap: GraphSnapshot, k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (node_key, degree), heaviest first; among equal
    degrees the lower compact index (the smaller key) comes first."""
    score = torch.where(_live_nodes(snap), snap.node_degree,
                        torch.full_like(snap.node_degree, -1))
    v, i = stable_top_k(score, k)
    keys = snap.node_key[i]
    return torch.where(v >= 0, keys, torch.zeros_like(keys)), v.clamp(min=0)


def k_hop(snap: GraphSnapshot, seed_keys: torch.Tensor, hops: int = 2,
          directed: bool = False) -> torch.Tensor:
    """Nodes within `hops` edges of the seeds: a (Ncap,) bool mask over
    compact node indices (seeds included).  Invalid edges point at the
    trash slot Ncap on both ends, so they absorb themselves."""
    ncap = snap.node_cap
    found, idx = node_index(snap, seed_keys)
    visited = torch.zeros(ncap + 1, dtype=torch.int32, device=snap.node_key.device)
    visited[torch.where(found, idx, torch.full_like(idx, ncap)).to(torch.int64)] = 1

    def reach(vis, nxt, rows, cols):
        hit = vis[rows.to(torch.int64)] > 0
        nxt[torch.where(hit, cols, torch.full_like(cols, ncap)).to(torch.int64)] = 1

    for _ in range(hops):
        # both reaches read the start-of-hop mask, so one hop traverses
        # exactly one edge (in either direction)
        nxt = visited.clone()
        reach(visited, nxt, snap.edge_row, snap.edge_col)
        if not directed:
            reach(visited, nxt, snap.redge_row, snap.redge_col)
        visited = nxt
    return (visited[:ncap] > 0) & _live_nodes(snap)


def triangle_count(snap: GraphSnapshot, max_dense_nodes: int = 4096) -> int:
    """Exact triangle count of the undirected simple graph (directions
    and multiplicities collapsed, self-loops dropped): trace(A^3)/6 via
    a dense product.  At Ncap <= 4096 every wedge count is exact in
    float32 accumulation (TF32 must stay off, PyTorch's default)."""
    if snap.node_cap > max_dense_nodes:
        raise ValueError(
            f"triangle_count is dense: node capacity {snap.node_cap} exceeds "
            f"max_dense_nodes={max_dense_nodes}; build the store (or pass "
            f"max_dense_nodes) accordingly")
    return int(_triangle_row_sums(snap).to(torch.int64).sum()) // 6


def _triangle_row_sums(snap: GraphSnapshot) -> torch.Tensor:
    """Per-row sums of (A @ A) * A, int32."""
    ncap = snap.node_cap
    dev = snap.node_key.device
    live = snap.edge_row < ncap
    trash = torch.full_like(snap.edge_row, ncap)
    a = torch.zeros((ncap + 1, ncap + 1), dtype=torch.float32, device=dev)
    a[torch.where(live, snap.edge_row, trash).to(torch.int64),
      torch.where(live, snap.edge_col, trash).to(torch.int64)] = 1.0
    a = a[:ncap, :ncap]
    a = torch.maximum(a, a.T) * (1.0 - torch.eye(ncap, dtype=torch.float32, device=dev))
    wedges = torch.matmul(a, a) * a
    return wedges.to(torch.int32).sum(1, dtype=torch.int32)


def _bsearch_range(arr: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   target: torch.Tensor, side: str) -> torch.Tensor:
    """Vectorised binary search of `target` within arr[lo:hi] (bounds
    per query), a fixed log2(len) + 1 steps."""
    n = arr.shape[0]
    steps = int(math.ceil(math.log2(max(n, 2)))) + 1
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = arr[mid.clamp(0, n - 1)]
        go_right = (v < target) if side == "left" else (v <= target)
        open_ = lo < hi
        lo, hi = (torch.where(open_ & go_right, mid + 1, lo),
                  torch.where(open_ & ~go_right, mid, hi))
    return lo


def edge_lookup(snap: GraphSnapshot, src_keys: torch.Tensor,
                dst_keys: torch.Tensor) -> torch.Tensor:
    """Exact total edge weight src->dst over edge types (0 when either
    endpoint or the edge is absent)."""
    fs, si = node_index(snap, src_keys)
    fd, di = node_index(snap, dst_keys)
    row = si.clamp(0, snap.node_cap - 1).to(torch.int64)
    lo, hi = snap.indptr[row], snap.indptr[row + 1]
    left = _bsearch_range(snap.edge_col, lo, hi, di, side="left")
    right = _bsearch_range(snap.edge_col, lo, hi, di, side="right")
    total = snap.edge_prefix[right] - snap.edge_prefix[left]
    return torch.where(fs & fd, total, torch.zeros_like(total))
