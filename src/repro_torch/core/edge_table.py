"""The in-memory edge-centric structure of Algorithm 1 / Figs. 8-9.

`EdgeTable` is the fixed-capacity, device-resident deduplicated edge
list with a `count` property per edge, the indexed node list, and the
table-level metadata the controller reads (§III-A).  Counterpart of
`repro.core.edge_table`.

Keys are int64 (uint64 bits) or int32 (uint32 bits): `from_raw_batch`
takes the width as `key_dtype=`, and `build_edge_table` follows the
dtype of the ids it is given.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.core.transform import RawEdgeBatch


@dataclasses.dataclass
class EdgeTable:
    """Fixed-capacity deduplicated edge table + node index."""

    # edges
    src: torch.Tensor  # (cap,) key bits (int64 or int32)
    dst: torch.Tensor
    etype: torch.Tensor  # (cap,) int32
    count: torch.Tensor  # (cap,) int32   duplicate-edge multiplicity
    edge_valid: torch.Tensor  # (cap,) bool
    # node index: (2*cap,) so every endpoint of a valid edge is present
    node_ids: torch.Tensor  # (2*cap,) sorted unique keys (unsigned order), sentinel tail
    node_valid: torch.Tensor  # (2*cap,) bool
    # per-edge endpoint positions in `node_ids`: the store reuses the
    # node-upsert slots through these instead of re-probing
    src_node_idx: torch.Tensor  # (cap,) int32
    dst_node_idx: torch.Tensor  # (cap,) int32
    # metadata
    n_edges: torch.Tensor  # scalar int32 (unique)
    n_nodes: torch.Tensor  # scalar int32 (unique)
    n_raw: torch.Tensor  # scalar int32 (pre-compression edge instructions)

    # ---- table-level metadata (PerfMon inputs, Alg. 2 lines 17-19) ----
    def density(self) -> torch.Tensor:
        v = self.n_nodes.to(torch.float32).clamp(min=2.0)
        return 2.0 * self.n_edges.to(torch.float32) / (v * (v - 1.0))

    def size(self) -> torch.Tensor:
        """PerfMon `e = edgeTable.size() + nodeIndex.size()`."""
        return self.n_edges + self.n_nodes

    def compression_ratio(self) -> torch.Tensor:
        return C.compression_ratio(self.n_nodes, self.n_edges, self.n_raw)


def build_edge_table(src, dst, etype, valid) -> EdgeTable:
    """Model transformation output -> compressed edge table (Alg. 1)."""
    cap = src.shape[0]
    ecomp = C.dedup_with_counts(C.mix_keys(src, dst, etype), valid)
    ncomp = C.unique_nodes(src, dst, valid)
    idx = ecomp.index
    zero = torch.zeros_like(src)
    esrc = torch.where(ecomp.valid, src[idx], zero)
    edst = torch.where(ecomp.valid, dst[idx], zero)
    # endpoint -> node-index position: `node_ids` is sorted unique in
    # unsigned order with a sentinel tail, so the position is one binary
    # search on sign-flipped keys; every valid endpoint is present
    sorted_ids = C.flip_sign(ncomp.keys)

    def nidx(k):
        pos = torch.searchsorted(sorted_ids, C.flip_sign(k))
        return pos.clamp(0, 2 * cap - 1).to(torch.int32)

    return EdgeTable(
        src=esrc,
        dst=edst,
        etype=torch.where(ecomp.valid, etype[idx], torch.zeros_like(etype)),
        count=ecomp.counts,
        edge_valid=ecomp.valid,
        node_ids=ncomp.keys,
        node_valid=ncomp.valid,
        src_node_idx=nidx(esrc),
        dst_node_idx=nidx(edst),
        n_edges=ecomp.n_unique,
        n_nodes=ncomp.n_unique,
        n_raw=ecomp.n_input,
    )


def from_raw_batch(raw: RawEdgeBatch, capacity: int,
                   device: Union[str, torch.device] = "cuda",
                   key_dtype: torch.dtype = torch.int64) -> EdgeTable:
    """Host RawEdgeBatch -> padded device tensors -> EdgeTable with
    `key_dtype` keys.  At 32 bits an id keeps its low 32 bits, as the
    reference's uint32 conversion does (0x1234567890ABCDEF becomes
    0x90ABCDEF)."""
    n = min(raw.n_edges, capacity)
    unsigned = C.numpy_unsigned(key_dtype)

    def prep(a, dtype):
        out = np.zeros(capacity, dtype)
        out[:n] = a[:n]  # a uint64 id into uint32 keeps its low 32 bits
        return out

    # one host->device copy per array; unsigned ids travel as signed bits
    src = torch.from_numpy(C.signed_view(prep(raw.src, unsigned))).to(device)
    dst = torch.from_numpy(C.signed_view(prep(raw.dst, unsigned))).to(device)
    et = torch.from_numpy(prep(raw.etype, np.int32)).to(device)
    valid = torch.arange(capacity, device=device) < n
    return build_edge_table(src, dst, et, valid)
