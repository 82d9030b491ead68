"""Ingestion-time graph sketch (GSS/TCM-style, fixed shapes).
Counterpart of `repro.query.sketch`.

Summarises the edge stream as it is ingested, so edge-weight, degree
and top-k queries are answered live without touching the store:

  * `edge_w`: a (D, W, W) count-min matrix sketch of the weighted
    adjacency matrix.  Depth d hashes src to a row and dst to a column
    and adds the edge's `count` there; a point query takes the min over
    the D cells, an upper bound on the true weight.
  * `out_deg` / `in_deg`: (D, W) count-min rows of the weighted out-
    and in-degree per node.
  * `hh_keys` / `hh_counts`: a K-slot heavy-hitter table.  Each batch's
    nodes compete by their current sketch degree estimate; the K
    largest survive.

One update absorbs one compressed `EdgeTable`, the batch the store
commits.  Its hashing and scatter go through `kernels.ops.sketch_absorb`:
one launch of the hand-written kernel on the card, the plain version
(`node_hash` twice, then `sketch_scatter_ref`) on the CPU.

Keys are int64 tensors holding uint64 bits or int32 tensors holding
uint32 bits (`init_sketch(key_dtype=)` sets the heavy-hitter table's;
an update follows the edge table's); `node_hash` (from `kernels.sketch`)
hashes them in uint32 arithmetic carried in int64.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import torch

from repro_torch.core import compression as C
from repro_torch.core.counters import sum_dtype
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.kernels.sketch import node_hash, sketch_scatter_ref

__all__ = [
    "GraphSketch", "init_sketch", "node_hash", "sketch_scatter_ref", "sketch_update",
    "sketch_edge_weight", "sketch_degree", "sketch_heavy_hitters", "sketch_error_bound",
]

_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


@dataclasses.dataclass
class GraphSketch:
    edge_w: torch.Tensor  # (D, W, W) int32 count-min of edge weights
    out_deg: torch.Tensor  # (D, W) int32 count-min of weighted out-degree
    in_deg: torch.Tensor  # (D, W) int32 count-min of weighted in-degree
    hh_keys: torch.Tensor  # (K,) key bits of heavy-hitter candidates; 0 = empty
    hh_counts: torch.Tensor  # (K,) int32 their degree estimates
    n_updates: torch.Tensor  # 0-d total edge count absorbed (core.counters)

    @property
    def depth(self) -> int:
        return self.edge_w.shape[0]

    @property
    def width(self) -> int:
        return self.edge_w.shape[1]

    @property
    def device(self) -> torch.device:
        return self.edge_w.device


def init_sketch(depth: int = 4, width: int = 256, hh_slots: int = 64,
                device: Union[str, torch.device, None] = None,
                key_dtype: torch.dtype = torch.int64) -> GraphSketch:
    """Fresh sketch on `device` (default the card) for `key_dtype` keys;
    depth * width^2 * 4 bytes of edge weights (1 MB at the defaults)."""
    dev = resolve(device)
    kd = C.check_key_dtype(key_dtype)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return GraphSketch(
        edge_w=z((depth, width, width), torch.int32),
        out_deg=z((depth, width), torch.int32),
        in_deg=z((depth, width), torch.int32),
        hh_keys=z((hh_slots,), kd),
        hh_counts=z((hh_slots,), torch.int32),
        n_updates=z((), torch.int32),
    )


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------


def stable_top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values and their indices, the lower index first
    among equal values (`jax.lax.top_k`'s order; `torch.topk` promises
    none): a stable descending sort."""
    v, i = torch.sort(values, descending=True, stable=True)
    return v[:k], i[:k]


def _merge_top_k(hh_keys, hh_counts, cand_keys, cand_counts):
    """Merge candidates into the K-slot heavy-hitter table.

    Concat, dedup by key keeping the max count (CMS estimates only
    grow, so the max is the freshest), then top-K.  Key 0 marks empty
    slots on both sides."""
    K = hh_keys.shape[0]
    dev = hh_keys.device
    keys = torch.cat([hh_keys, cand_keys])
    cnts = torch.cat([hh_counts.to(torch.int32), cand_counts.to(torch.int32)])
    m = keys.shape[0]
    masked = torch.where(keys != 0, keys, torch.full_like(keys, C.SENTINEL))
    order = torch.sort(C.flip_sign(masked), stable=True).indices
    sk, sc = masked[order], cnts[order]
    is_valid = sk != C.SENTINEL
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sk[1:] != sk[:-1]]) & is_valid
    run = (torch.cumsum(head.to(torch.int32), 0) - 1).clamp(0, m - 1).to(torch.int64)
    best = torch.full((m,), _INT32_MIN, dtype=torch.int32, device=dev).scatter_reduce_(
        0, run, torch.where(is_valid, sc, torch.full_like(sc, -1)), "amax",
        include_self=False)
    pos = torch.arange(m, device=dev)
    first = torch.full((m,), _INT32_MAX, dtype=torch.int64, device=dev).scatter_reduce_(
        0, run, torch.where(head, pos, torch.full_like(pos, m)), "amin", include_self=False)
    fp = first.clamp(0, m - 1)
    live = pos < head.sum()
    run_keys = torch.where(live, sk[fp], torch.zeros_like(sk))
    run_best = torch.where(live, best, torch.full_like(best, -1))
    top_c, top_i = stable_top_k(run_best, K)
    keep = top_c > 0
    top_k = run_keys[top_i]
    return (torch.where(keep, top_k, torch.zeros_like(top_k)),
            torch.where(keep, top_c, torch.zeros_like(top_c)).to(torch.int32))


def sketch_update(sketch: GraphSketch, et) -> GraphSketch:
    """Absorb one compressed `EdgeTable` (the batch the store commits).

    Returns a new `GraphSketch`: the kernel adds into copies of the
    count arrays, so a sketch the caller still holds is unchanged."""
    D, W = sketch.depth, sketch.width
    cnt = torch.where(et.edge_valid, et.count, torch.zeros_like(et.count)).to(torch.int32)
    ew, od, idg = ops.sketch_absorb(sketch.edge_w.clone(), sketch.out_deg.clone(),
                                    sketch.in_deg.clone(), et.src.contiguous(),
                                    et.dst.contiguous(), cnt.contiguous())

    # heavy hitters: this batch's (deduplicated) nodes compete by their
    # post-update CMS degree estimate
    nh = node_hash(et.node_ids, D, W).to(torch.int64)
    est = (od.gather(1, nh) + idg.gather(1, nh)).amin(0)
    cand_keys = torch.where(et.node_valid, et.node_ids, torch.zeros_like(et.node_ids))
    cand_cnt = torch.where(et.node_valid, est, torch.full_like(est, -1))
    hh_keys, hh_counts = _merge_top_k(sketch.hh_keys, sketch.hh_counts, cand_keys, cand_cnt)
    return GraphSketch(edge_w=ew, out_deg=od, in_deg=idg, hh_keys=hh_keys,
                       hh_counts=hh_counts,
                       n_updates=sketch.n_updates + cnt.sum(dtype=sum_dtype(hh_keys)))


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def sketch_edge_weight(sketch: GraphSketch, src: torch.Tensor,
                       dst: torch.Tensor) -> torch.Tensor:
    """Upper bound on the total edge weight src->dst (over etypes)."""
    D, W = sketch.depth, sketch.width
    r = node_hash(src, D, W).to(torch.int64)
    c = node_hash(dst, D, W).to(torch.int64)
    drow = torch.arange(D, device=r.device).unsqueeze(1)
    return sketch.edge_w[drow, r, c].amin(0)


def sketch_degree(sketch: GraphSketch, keys: torch.Tensor,
                  mode: str = "total") -> torch.Tensor:
    """Upper bound on the weighted degree ("out", "in" or "total")."""
    h = node_hash(keys, sketch.depth, sketch.width).to(torch.int64)
    if mode == "out":
        v = sketch.out_deg.gather(1, h)
    elif mode == "in":
        v = sketch.in_deg.gather(1, h)
    else:
        v = sketch.out_deg.gather(1, h) + sketch.in_deg.gather(1, h)
    return v.amin(0)


def sketch_heavy_hitters(sketch: GraphSketch, k: int = 10
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k node keys by estimated degree from the heavy-hitter table."""
    if k > sketch.hh_keys.shape[0]:
        raise ValueError(f"k={k} exceeds the {sketch.hh_keys.shape[0]} heavy-hitter slots")
    score = torch.where(sketch.hh_keys != 0, sketch.hh_counts,
                        torch.full_like(sketch.hh_counts, -1))
    v, i = stable_top_k(score, k)
    keys = sketch.hh_keys[i]
    return (torch.where(v > 0, keys, torch.zeros_like(keys)),
            v.clamp(min=0))


def sketch_error_bound(sketch: GraphSketch) -> float:
    """Classic CMS additive-error bound: with probability >= 1 - e^-D a
    point query overestimates by at most e * N / W (N = the total edge
    count absorbed so far).  Reads `n_updates` on the host."""
    return math.e * float(sketch.n_updates) / float(sketch.width)
