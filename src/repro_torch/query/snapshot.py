"""Store -> device-resident CSR snapshot (compaction + incremental
maintenance).  Counterpart of `repro.query.snapshot`.

`build_snapshot` compacts the open-addressing hash tables into a CSR
form the query engine traverses with gathers and segment ops:

  * nodes sorted by key in unsigned order (invalid slots carry the
    all-ones sentinel and sort last), so key -> compact index is a
    binary search;
  * edges relabelled to compact indices and sorted lexicographically by
    (src, dst, etype), with `indptr` row offsets (forward CSR) and the
    reverse orientation (`rindptr`, sorted by (dst, src, etype));
  * a prefix sum over the sorted edge counts.

Shapes stay at the store capacities; validity is carried by masks.

`apply_delta` merges ONE commit's `CommitDelta` into an existing
snapshot with rank merges (new position = own index + rank in the other
sorted list) and is bit-exact against a fresh `build_snapshot`.
`SnapshotMaintainer` buffers pending deltas and falls back to a full
rebuild when the buffer overflows or the store holds edges the merge
cannot place.

torch has no `mode="drop"` scatter: where the reference drops writes to
index `cap`, the port scatters into arrays one slot longer and slices
the trash slot off, so a dropped write never races with a real one.
Keys are int64 tensors of uint64 bits or int32 tensors of uint32 bits,
the store's; every key search runs on sign-flipped values (unsigned
order).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.core import compression as C
from repro_torch.core.counters import widen
from repro_torch.graphstore.store import CommitDelta, GraphStore
from repro_torch.telemetry.spans import NULL_REGISTRY


@dataclasses.dataclass
class GraphSnapshot:
    # nodes, sorted by key; slots >= n_nodes hold the sentinel
    node_key: torch.Tensor  # (Ncap,) key bits at the store's width
    node_count: torch.Tensor  # (Ncap,) int32
    node_degree: torch.Tensor  # (Ncap,) int32 (unique-edge endpoints, from store)
    # forward CSR: edges sorted by (src_idx, dst_idx, etype); invalid rows = Ncap
    indptr: torch.Tensor  # (Ncap+1,) int32
    edge_row: torch.Tensor  # (Ecap,) int32 compact src index
    edge_col: torch.Tensor  # (Ecap,) int32 compact dst index
    edge_type: torch.Tensor  # (Ecap,) int32
    edge_count: torch.Tensor  # (Ecap,) int32
    edge_prefix: torch.Tensor  # (Ecap+1,) int32 cumsum of edge_count
    # reverse CSR: same edges sorted by (dst_idx, src_idx, etype)
    rindptr: torch.Tensor  # (Ncap+1,) int32
    redge_row: torch.Tensor  # (Ecap,) int32 compact dst index (the row)
    redge_col: torch.Tensor  # (Ecap,) int32 compact src index
    redge_type: torch.Tensor  # (Ecap,) int32
    # sizes
    n_nodes: torch.Tensor  # scalar int32
    n_edges: torch.Tensor  # scalar int32 (unique (src,dst,etype) triples)

    @property
    def node_cap(self) -> int:
        return self.node_key.shape[0]

    @property
    def edge_valid(self) -> torch.Tensor:
        return self.edge_row < self.node_cap


def _search_keys(sorted_keys: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Left insertion points (int32) of unsigned `keys` in unsigned-sorted
    `sorted_keys` (one width)."""
    return torch.searchsorted(C.flip_sign(sorted_keys), C.flip_sign(keys)).to(torch.int32)


def _sort_keys(keys: torch.Tensor) -> torch.Tensor:
    return C.flip_sign(torch.sort(C.flip_sign(keys)).values)


def _lex_sort3(primary: torch.Tensor, secondary: torch.Tensor,
               tertiary: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (primary, secondary, tertiary), stable."""
    o = torch.argsort(tertiary, stable=True)
    o = o[torch.argsort(secondary[o], stable=True)]
    return o[torch.argsort(primary[o], stable=True)]


def _row_offsets(sorted_rows: torch.Tensor, ncap: int) -> torch.Tensor:
    rows = torch.arange(ncap + 1, dtype=torch.int32, device=sorted_rows.device)
    return torch.searchsorted(sorted_rows, rows).to(torch.int32)


def _prefix(counts: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=counts.device),
                      torch.cumsum(counts, 0, dtype=torch.int32)])


def _masked(mask: torch.Tensor, x: torch.Tensor, fill) -> torch.Tensor:
    return torch.where(mask, x, torch.full_like(x, fill))


def build_snapshot(store: GraphStore) -> GraphSnapshot:
    """Compact the hash-table store into a CSR snapshot."""
    ncap = store.node_keys.shape[0]

    # ---- nodes: sort by key, invalid last ----
    masked = _masked(store.node_keys != 0, store.node_keys, C.SENTINEL)
    order = torch.sort(C.flip_sign(masked), stable=True).indices
    node_key = masked[order]
    svalid = node_key != C.SENTINEL
    node_count = _masked(svalid, store.node_count[order], 0)
    node_degree = _masked(svalid, store.node_degree[order], 0)
    n_nodes = svalid.sum(dtype=torch.int32)

    # ---- edges: relabel endpoints to compact indices ----
    evalid = store.edge_keys != 0

    def to_idx(keys):
        ci = _search_keys(node_key, keys).clamp(0, ncap - 1)
        found = node_key[ci] == keys
        return _masked(evalid & found, ci, ncap)

    src_idx = to_idx(store.edge_src)
    dst_idx = to_idx(store.edge_dst)
    # an edge is in the snapshot only if BOTH endpoints resolved (a
    # saturated node table can leave dangling endpoints)
    dangling = (src_idx == ncap) | (dst_idx == ncap)
    src_idx = _masked(~dangling, src_idx, ncap)
    dst_idx = _masked(~dangling, dst_idx, ncap)

    # forward: lexicographic (src, dst, etype); invalid (row = Ncap)
    # sort last.  The etype tiebreak makes the order fully deterministic,
    # which `apply_delta` relies on for exact merges.
    perm = _lex_sort3(src_idx, dst_idx, store.edge_type)
    edge_row = src_idx[perm]
    edge_col = dst_idx[perm]
    live = edge_row < ncap
    edge_type = _masked(live, store.edge_type[perm], 0)
    edge_count = _masked(live, store.edge_count[perm], 0)
    indptr = _row_offsets(edge_row, ncap)

    # reverse: lexicographic (dst, src, etype)
    rperm = _lex_sort3(dst_idx, src_idx, store.edge_type)
    redge_row = dst_idx[rperm]
    rlive = redge_row < ncap
    snap = GraphSnapshot(
        node_key=node_key,
        node_count=node_count,
        node_degree=node_degree,
        indptr=indptr,
        edge_row=edge_row,
        edge_col=edge_col,
        edge_type=edge_type,
        edge_count=edge_count,
        edge_prefix=_prefix(edge_count),
        rindptr=_row_offsets(redge_row, ncap),
        redge_row=redge_row,
        redge_col=_masked(rlive, src_idx[rperm], ncap),
        redge_type=_masked(rlive, store.edge_type[rperm], 0),
        n_nodes=n_nodes,
        n_edges=indptr[-1],
    )
    return widen(snap, node_key, ("n_nodes",))  # core.counters


def node_index(snap: GraphSnapshot, keys: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key -> compact index lookup: (found (bool), idx (int32, -1 if
    not found))."""
    ci = _search_keys(snap.node_key, keys).clamp(0, snap.node_cap - 1)
    found = (snap.node_key[ci] == keys) & (keys != 0)
    return found, _masked(found, ci, -1)


# ---------------------------------------------------------------------------
# Incremental maintenance: merge one CommitDelta without recompacting
# ---------------------------------------------------------------------------


def _searchsorted3(ar, ac, at_, qr, qc, qt) -> torch.Tensor:
    """Vectorised 'left' binary search over a lexicographically sorted
    triple (ar, ac, at_): the rank of each query triple.  A fixed number
    of steps, so the host never waits for the device."""
    n = ar.shape[0]
    steps = int(math.ceil(math.log2(max(n, 2)))) + 1
    lo = torch.zeros(qr.shape, dtype=torch.int32, device=qr.device)
    hi = torch.full(qr.shape, n, dtype=torch.int32, device=qr.device)
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        m = mid.clamp(0, n - 1)
        vr, vc, vt = ar[m], ac[m], at_[m]
        lt = (vr < qr) | ((vr == qr) & ((vc < qc) | ((vc == qc) & (vt < qt))))
        open_ = lo < hi
        lo = torch.where(open_ & lt, mid + 1, lo)
        hi = torch.where(open_ & ~lt, mid, hi)
    return lo


def _scatter_set(fill, size: int, dtype, parts, device) -> torch.Tensor:
    """A (size,) array of `fill` with each (positions, values) of `parts`
    written in turn; positions >= size are dropped (into a trash slot
    that is sliced off)."""
    out = torch.full((size + 1,), fill, dtype=dtype, device=device)
    for pos, vals in parts:
        out[pos.clamp(max=size).to(torch.int64)] = vals
    return out[:size]


def _scatter_add(dst: torch.Tensor, pos: torch.Tensor, vals) -> torch.Tensor:
    """dst[pos] += vals with positions >= len(dst) dropped."""
    size = dst.shape[0]
    out = torch.cat([dst, dst.new_zeros(1)])
    vals = torch.as_tensor(vals, dtype=dst.dtype, device=dst.device).expand(pos.shape)
    out.index_add_(0, pos.clamp(max=size).to(torch.int64), vals)
    return out[:size]


def apply_delta(snap: GraphSnapshot, delta: CommitDelta
                ) -> Tuple[GraphSnapshot, torch.Tensor]:
    """Merge one commit's delta into the CSR without recompaction.

    Returns (snapshot', unplaced): `unplaced` (an int32 tensor) counts
    committed edges the merge could not place (dangling endpoints, or
    count increments to edges absent from the base CSR); callers must
    fall back to `build_snapshot` when it is nonzero.  The output is
    bit-exact against `build_snapshot` of the post-commit store."""
    dev = snap.node_key.device
    ncap = snap.node_cap
    ecap = snap.edge_row.shape[0]
    big = ncap + 1  # sorts after every live row AND the ncap tail
    i32 = torch.int32

    # ---- nodes: sorted-insert the new keys ----
    new_keys = _sort_keys(_masked(delta.node_new, delta.node_ids, C.SENTINEL))
    live_new = new_keys != C.SENTINEL
    k_new = live_new.sum(dtype=i32)
    nb = snap.node_key.shape[0]
    # base entry i shifts right by the number of new keys below it
    shift = _search_keys(new_keys, snap.node_key)
    base_valid = snap.node_key != C.SENTINEL
    pos_base = _masked(base_valid, torch.arange(nb, dtype=i32, device=dev) + shift, ncap)
    # new key j lands at (rank among base) + j
    rank_new = _search_keys(snap.node_key, new_keys)
    pos_new = _masked(live_new, rank_new + torch.arange(new_keys.shape[0], dtype=i32,
                                                        device=dev), ncap)

    node_key = _scatter_set(C.SENTINEL, ncap, snap.node_key.dtype,
                            [(pos_base, snap.node_key), (pos_new, new_keys)], dev)
    node_count = _scatter_set(0, ncap, i32, [(pos_base, snap.node_count)], dev)
    node_degree = _scatter_set(0, ncap, i32, [(pos_base, snap.node_degree)], dev)

    def find_node(keys):
        p = _search_keys(node_key, keys).clamp(0, ncap - 1)
        return p, node_key[p] == keys

    # per-commit property updates: +1 count per committed node, +1
    # degree per endpoint of a new edge (masks prepared by ingest_step)
    pc, _ = find_node(delta.node_ids)
    node_count = _scatter_add(node_count, _masked(delta.node_placed, pc, ncap), 1)
    ps, sok = find_node(delta.src)
    pd, dok = find_node(delta.dst)
    node_degree = _scatter_add(node_degree, _masked(delta.src_deg, ps, ncap), 1)
    node_degree = _scatter_add(node_degree, _masked(delta.dst_deg, pd, ncap), 1)

    # old compact index -> new compact index (monotone, so relabelled
    # base edges KEEP their lexicographic order: a pure gather)
    ar = torch.arange(nb, dtype=i32, device=dev)
    o2n = torch.cat([_masked(ar < snap.n_nodes, ar + shift, ncap),
                     torch.full((1,), ncap, dtype=i32, device=dev)])

    # ---- delta edges: endpoints -> new compact indices ----
    live_d = delta.edge_new & sok & dok
    drow = _masked(live_d, ps, big)
    dcol = _masked(live_d, pd, big)
    det = _masked(live_d, delta.etype, 0)
    dcnt = _masked(live_d, delta.count, 0)
    nd = drow.shape[0]

    def merge(base_row, base_col, base_et, base_cnt, delta_a, delta_b):
        """Rank-merge the delta edges (sorted by (delta_a, delta_b,
        etype), `a` this orientation's row) into the relabelled base.
        Only dead delta rows tie on all three keys, and they are equal,
        so any sort stable by the three keys gives the reference's."""
        brow = o2n[base_row.to(torch.int64)]
        bcol = o2n[base_col.to(torch.int64)]
        dperm = _lex_sort3(delta_a, delta_b, det)
        sa, sb, set_, scnt = delta_a[dperm], delta_b[dperm], det[dperm], dcnt[dperm]
        slive = live_d[dperm]
        rank_d = _searchsorted3(brow, bcol, base_et, sa, sb, set_)
        pos_d = _masked(slive, rank_d + torch.arange(nd, dtype=i32, device=dev), ecap)
        rank_b = _searchsorted3(sa, sb, set_, brow, bcol, base_et)
        pos_b = torch.arange(ecap, dtype=i32, device=dev) + rank_b
        row = _scatter_set(ncap, ecap, i32, [(pos_b, brow), (pos_d, sa)], dev)
        col = _scatter_set(ncap, ecap, i32, [(pos_b, bcol), (pos_d, sb)], dev)
        et = _scatter_set(0, ecap, i32, [(pos_b, base_et), (pos_d, set_)], dev)
        cnt = None
        if base_cnt is not None:
            cnt = _scatter_set(0, ecap, i32, [(pos_b, base_cnt), (pos_d, scnt)], dev)
        return row, col, et, cnt

    # forward orientation: sort/merge by (row, col, etype)
    edge_row, edge_col, edge_type, edge_count = merge(
        snap.edge_row, snap.edge_col, snap.edge_type, snap.edge_count, drow, dcol)

    # count increments for pre-existing edges: locate their triple
    inc = delta.edge_placed & ~delta.edge_new & sok & dok
    q = _searchsorted3(edge_row, edge_col, edge_type, _masked(inc, ps, big),
                       _masked(inc, pd, big), _masked(inc, delta.etype, 0))
    qc = q.clamp(0, ecap - 1).to(torch.int64)
    match = inc & (edge_row[qc] == ps) & (edge_col[qc] == pd) & \
        (edge_type[qc] == delta.etype)
    edge_count = _scatter_add(edge_count, _masked(match, q, ecap), delta.count)
    indptr = _row_offsets(edge_row, ncap)

    # reverse orientation: sort/merge by (col, row, etype)
    redge_row, redge_col, redge_type, _ = merge(
        snap.redge_row, snap.redge_col, snap.redge_type, None, dcol, drow)

    # anything the merge could not place? (a dangling new edge, or a
    # count increment whose edge is not in the base CSR)
    unplaced = (delta.edge_new & ~live_d).sum(dtype=i32) + \
        (inc & ~match).sum(dtype=i32) + \
        (delta.edge_placed & ~delta.edge_new & ~(sok & dok)).sum(dtype=i32)

    out = GraphSnapshot(
        node_key=node_key,
        node_count=node_count,
        node_degree=node_degree,
        indptr=indptr,
        edge_row=edge_row,
        edge_col=edge_col,
        edge_type=edge_type,
        edge_count=edge_count,
        edge_prefix=_prefix(edge_count),
        rindptr=_row_offsets(redge_row, ncap),
        redge_row=redge_row,
        redge_col=redge_col,
        redge_type=redge_type,
        n_nodes=snap.n_nodes + k_new,
        n_edges=indptr[-1],
    )
    return widen(out, node_key, ("n_nodes",)), unplaced  # core.counters


class SnapshotMaintainer:
    """Keeps a CSR snapshot current across commits without a full
    `build_snapshot` per query.

    `absorb(et, stats)` (the `GraphIngestor.commit_hooks` shape) buffers
    each commit's `CommitDelta`; `snapshot(store)` applies the pending
    deltas to the cached snapshot and falls back to a full rebuild only
    when (a) there is no snapshot yet, (b) the pending buffer overflowed
    `max_pending`, or (c) the store holds edges the merge cannot place
    (dangling endpoints under node-table saturation).  `full_builds` /
    `delta_applies` count both paths."""

    def __init__(self, max_pending: int = 32):
        self.max_pending = max_pending
        self._snap: Optional[GraphSnapshot] = None
        self._pending: List[CommitDelta] = []
        self._force_rebuild = True
        self.full_builds = 0
        self.delta_applies = 0
        self.telemetry = NULL_REGISTRY

    def absorb(self, et, stats) -> None:
        delta = None if stats is None else stats.get("delta")
        if delta is None:
            self._force_rebuild = True  # opaque commit: cannot merge
        else:
            self._pending.append(delta)

    def reset(self) -> None:
        """Drop cached and pending state so the next `snapshot()` is a
        full rebuild."""
        self._snap = None
        self._pending = []
        self._force_rebuild = True

    def snapshot(self, store: GraphStore) -> GraphSnapshot:
        tel = self.telemetry
        pending, self._pending = self._pending, []
        snap = self._snap
        if snap is None or self._force_rebuild or len(pending) > self.max_pending:
            with tel.span("snapshot.rebuild"):
                snap = build_snapshot(store)
            self.full_builds += 1
        else:
            for d in pending:
                with tel.span("snapshot.apply_delta"):
                    snap, unplaced = apply_delta(snap, d)
                self.delta_applies += 1
                if int(unplaced):
                    with tel.span("snapshot.rebuild"):
                        snap = build_snapshot(store)
                    self.full_builds += 1
                    break
        self._snap = snap
        # dangling edges (store committed, CSR excluded) can be
        # resurrected by later node inserts: only a rebuild sees that
        self._force_rebuild = int(store.n_edges) != int(snap.n_edges)
        return snap
