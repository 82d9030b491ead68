"""Device-resident property-graph store (counterpart of
`repro.graphstore.store`).

Open-addressing hash tables in torch tensors (linear probing, vectorised
over the batch).  The store ingests compressed edge-table batches
(Algorithm 3 GRAPHPUSH): MERGE semantics for nodes (insert-if-absent),
CREATE-or-count for edges (duplicate edges accumulate `count`).

A commit runs exactly two fused upsert sweeps (`kernels.ops.fused_upsert`,
nodes then edges); degree updates reuse the node slots through the edge
table's dedup index.  The probe budget is adaptive (x2 past 0.6 load,
x4 past 0.8) and stays a device scalar, which the kernel reads itself.

`commit_compressed` commits a GraphZip `CompressedCommit`: the residual
through `ingest_step`, the dictionary references by direct scatter.

`make_distributed_ingest` spreads the store over the `data` dimension of
a `torch.distributed` device mesh: each rank holds a slice of the table
rows, routes its raw edges to their owners with one `all_to_all_single`
and commits what it receives through `ingest_step`.
`ingest_ranks` runs the same ranks in one process, without a process
group.

Unlike the reference, `ingest_step` and `commit_compressed` update the
store's tensors IN PLACE and return the same `GraphStore`: the tables
are the largest state on the device, and a functional copy would move
them on every commit.

Keys are 64-bit (int64 holding uint64 bits) or 32-bit (int32 holding
uint32 bits), chosen by `init_store(..., key_dtype=)`; the commit path
follows the dtype of the tables and of the edge tables it is given.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from repro_torch.core.compression import check_key_dtype, flip_sign, lsr, mix_keys
from repro_torch.core.counters import sum_dtype, widen
from repro_torch.core.edge_table import build_edge_table
from repro_torch.device import resolve
from repro_torch.kernels import ops

MAX_PROBES = 32


@dataclasses.dataclass
class GraphStore:
    node_keys: torch.Tensor  # (Ncap,) key bits (int64 or int32); 0 = empty
    node_count: torch.Tensor  # (Ncap,) int32  (times seen, a node property)
    node_degree: torch.Tensor  # (Ncap,) int32
    edge_keys: torch.Tensor  # (Ecap,) key bits
    edge_src: torch.Tensor  # (Ecap,) key bits
    edge_dst: torch.Tensor  # (Ecap,) key bits
    edge_type: torch.Tensor  # (Ecap,) int32
    edge_count: torch.Tensor  # (Ecap,) int32
    n_nodes: torch.Tensor  # scalar int32
    n_edges: torch.Tensor  # scalar int32

    @property
    def device(self) -> torch.device:
        return self.node_keys.device


@dataclasses.dataclass
class CommitDelta:
    """What one commit changed: the incremental-snapshot input.

    Node arrays are (2*cap,), edge arrays (cap,) at the edge-table
    capacity.  `*_placed` marks entries that reached the store;
    `*_new` marks first insertions; `src_deg`/`dst_deg` mark the
    endpoints that received a +1 degree."""

    node_ids: torch.Tensor
    node_placed: torch.Tensor
    node_new: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    etype: torch.Tensor
    count: torch.Tensor
    edge_placed: torch.Tensor
    edge_new: torch.Tensor
    src_deg: torch.Tensor
    dst_deg: torch.Tensor


def init_store(node_cap: int, edge_cap: int,
               device: Union[str, torch.device] = "cuda",
               key_dtype: torch.dtype = torch.int64) -> GraphStore:
    """An empty store on `device` whose key tables hold `key_dtype` keys
    (torch.int64: uint64 bits, torch.int32: uint32 bits)."""
    dev = resolve(device)
    kd = check_key_dtype(key_dtype)

    def z(c, dtype):
        return torch.zeros(c, dtype=dtype, device=dev)

    return GraphStore(
        node_keys=z(node_cap, kd),
        node_count=z(node_cap, torch.int32),
        node_degree=z(node_cap, torch.int32),
        edge_keys=z(edge_cap, kd),
        edge_src=z(edge_cap, kd),
        edge_dst=z(edge_cap, kd),
        edge_type=z(edge_cap, torch.int32),
        edge_count=z(edge_cap, torch.int32),
        n_nodes=z((), torch.int32),
        n_edges=z((), torch.int32),
    )


def probe_budget(n_used: torch.Tensor, cap: int) -> torch.Tensor:
    """Adaptive probe rounds from the table load factor: MAX_PROBES
    below 0.6 load, x2 past 0.6, x4 past 0.8 (int32 scalar tensor)."""
    load = n_used.to(torch.float32) / float(cap)
    mult = 1 + (load >= 0.6).to(torch.int32) + 2 * (load >= 0.8).to(torch.int32)
    return MAX_PROBES * mult


def _masked_add(dst: torch.Tensor, index: torch.Tensor, mask: torch.Tensor,
                values: torch.Tensor) -> None:
    """dst[index[mask]] += values[mask] without a host sync: masked
    lanes add 0 to slot 0 (a no-op), which the reference gets by
    scattering them to the dropped out-of-range index."""
    idx = torch.where(mask, index, torch.zeros_like(index)).to(torch.int64)
    dst.index_add_(0, idx, torch.where(mask, values, torch.zeros_like(values)))


def ingest_step(store: GraphStore, et) -> Tuple[GraphStore, dict]:
    """GRAPHPUSH (Algorithm 3): commit one compressed edge table.

    Updates `store` in place and returns (store, stats).  stats carries
    the controller signals: new-node count (diversity rho numerator),
    sizes, the effective instruction count, the table-pressure signals
    (dropped_inserts, loads, probe budget), the per-entry slots and the
    `CommitDelta`.  Every value is a tensor on the store's device."""
    ncap = store.node_keys.shape[0]
    ecap = store.edge_keys.shape[0]
    n_probes_n = probe_budget(store.n_nodes, ncap)
    n_probes_e = probe_budget(store.n_edges, ecap)
    one = torch.ones_like(et.count)

    # ---- nodes: MERGE (one fused probe sweep) ----
    _, nslot, n_isnew = ops.fused_upsert(
        store.node_keys, et.node_ids, et.node_valid, n_probes_n)
    node_placed = et.node_valid & (nslot >= 0)
    is_new = n_isnew & et.node_valid
    _masked_add(store.node_count, nslot, node_placed, torch.ones_like(nslot))
    n_new_nodes = is_new.sum(dtype=torch.int32)
    dropped_nodes = (et.node_valid & ~node_placed).sum(dtype=torch.int32)

    # ---- edges: CREATE-or-count (one fused probe sweep) ----
    ekey = mix_keys(et.src, et.dst, et.etype)
    _, eslot, e_isnew = ops.fused_upsert(
        store.edge_keys, ekey, et.edge_valid, n_probes_e)
    edge_placed = et.edge_valid & (eslot >= 0)
    e_new = e_isnew & et.edge_valid
    # new edges won distinct slots; masked lanes must write nothing (a
    # clamped index would race with a real write), so select them
    new_lanes = e_new.nonzero().squeeze(1)
    new_slots = eslot[new_lanes].to(torch.int64)
    store.edge_src[new_slots] = et.src[new_lanes]
    store.edge_dst[new_slots] = et.dst[new_lanes]
    store.edge_type[new_slots] = et.etype[new_lanes]
    _masked_add(store.edge_count, eslot, edge_placed, et.count)
    n_new_edges = e_new.sum(dtype=torch.int32)
    dropped_edges = (et.edge_valid & ~edge_placed).sum(dtype=torch.int32)

    # ---- degree update (both endpoints of new edges), no re-probing:
    # the dedup index maps each endpoint to its already-upserted slot
    sslot = nslot[et.src_node_idx]
    dslot = nslot[et.dst_node_idx]
    src_deg = e_new & (sslot >= 0)
    dst_deg = e_new & (dslot >= 0)
    _masked_add(store.node_degree, sslot, src_deg, one)
    _masked_add(store.node_degree, dslot, dst_deg, one)

    store.n_nodes += n_new_nodes
    store.n_edges += n_new_edges
    widen(store, store.node_keys, ("n_nodes", "n_edges"))  # core.counters
    batch_edges = et.edge_valid.sum(dtype=torch.int32)
    minus1 = torch.full_like(nslot, -1)
    stats = {
        "new_nodes": n_new_nodes,
        "new_edges": n_new_edges,
        "batch_nodes": et.node_valid.sum(dtype=torch.int32),
        "batch_edges": batch_edges,
        "instructions": n_new_nodes + batch_edges,
        "store_nodes": store.n_nodes.clone(),
        "store_edges": store.n_edges.clone(),
        # table-pressure signals (MetricsHub -> Algorithm-2 controller)
        "dropped_nodes": dropped_nodes,
        "dropped_edges": dropped_edges,
        "dropped_inserts": dropped_nodes + dropped_edges,
        "probe_rounds": torch.maximum(n_probes_n, n_probes_e),
        "node_load": store.n_nodes.to(torch.float32) / float(ncap),
        "edge_load": store.n_edges.to(torch.float32) / float(ecap),
        # per-entry store slots (-1 = dropped)
        "nslot": torch.where(node_placed, nslot, minus1),
        "eslot": torch.where(edge_placed, eslot, torch.full_like(eslot, -1)),
        # incremental snapshot maintenance input
        "delta": CommitDelta(
            node_ids=et.node_ids,
            node_placed=node_placed,
            node_new=is_new,
            src=et.src,
            dst=et.dst,
            etype=et.etype,
            count=et.count,
            edge_placed=edge_placed,
            edge_new=e_new,
            src_deg=src_deg,
            dst_deg=dst_deg,
        ),
    }
    return store, stats


def commit_compressed(store: GraphStore, cc) -> Tuple[GraphStore, dict]:
    """Pattern-aware GRAPHPUSH for a `repro_torch.compress.CompressedCommit`.

    The residual edge table takes the normal two-sweep `ingest_step`;
    dictionary references then land by direct scatter on their cached
    store slots, with no probing.  Referenced edges are already present
    (their slots were cached at an earlier successful commit, and slots
    are never freed), so the result equals committing the full raw
    batch: counts accumulate on the same slots, no degree changes, and
    each unique batch node still gets exactly one `node_count` increment
    (reference-only endpoints are counted here, once each, against the
    residual's node set).

    Updates `store` in place.  The stats keep the raw path's keys with
    full-batch meaning, plus `dict_refs` and `dict_hit_rate`; the
    `CommitDelta` carries the reference edges as placed, not new."""
    store, s = ingest_step(store, cc.residual)
    ncap = store.node_keys.shape[0]

    # ---- reference edges: count accumulation on cached slots ----
    rv = cc.ref_valid & (cc.ref_eslot >= 0)
    _masked_add(store.edge_count, cc.ref_eslot, rv, cc.ref_count)
    n_refs = rv.sum(dtype=torch.int32)

    # ---- reference-only endpoints: one node_count +1 per unique batch
    # node, as on the raw path.  The residual's node ids are sorted
    # unique (unsigned order, sentinel tail): one binary search each
    res_nodes = cc.residual.node_ids
    ref_keys = torch.cat([cc.ref_src, cc.ref_dst])
    ref_slots = torch.cat([cc.ref_sslot, cc.ref_dslot])
    pos = torch.searchsorted(flip_sign(res_nodes), flip_sign(ref_keys))
    in_residual = res_nodes[pos.clamp(0, res_nodes.shape[0] - 1)] == ref_keys
    cand = torch.cat([rv, rv]) & (ref_slots >= 0) & ~in_residual
    m = ref_keys.shape[0]
    lane = torch.arange(m, dtype=torch.int32, device=ref_keys.device)
    # first occurrence per slot: an endpoint shared by several refs (or
    # by both sides of one) still counts once.  Dropped lanes go to a
    # trash slot past the end (the reference's out-of-range index)
    first = torch.full((ncap + 1,), m, dtype=torch.int32, device=ref_keys.device)
    first.scatter_reduce_(0, torch.where(cand, ref_slots, ncap).to(torch.int64), lane, "amin")
    nmask = cand & (first[ref_slots.clamp(0, ncap - 1).to(torch.int64)] == lane)
    _masked_add(store.node_count, ref_slots, nmask, torch.ones_like(ref_slots))
    n_ref_nodes = nmask.sum(dtype=torch.int32)

    d = s["delta"]
    zb = torch.zeros_like(rv)
    batch_edges = s["batch_edges"] + n_refs
    stats = dict(s)
    stats.update(
        batch_nodes=s["batch_nodes"] + n_ref_nodes,
        batch_edges=batch_edges,
        instructions=s["new_nodes"] + batch_edges,
        dict_refs=n_refs,
        dict_hit_rate=n_refs.to(torch.float32) / batch_edges.to(torch.float32).clamp(min=1.0),
        delta=CommitDelta(
            node_ids=torch.cat([d.node_ids, ref_keys]),
            node_placed=torch.cat([d.node_placed, nmask]),
            node_new=torch.cat([d.node_new, torch.zeros_like(nmask)]),
            src=torch.cat([d.src, cc.ref_src]),
            dst=torch.cat([d.dst, cc.ref_dst]),
            etype=torch.cat([d.etype, cc.ref_etype]),
            count=torch.cat([d.count, cc.ref_count]),
            edge_placed=torch.cat([d.edge_placed, rv]),
            edge_new=torch.cat([d.edge_new, zb]),
            src_deg=torch.cat([d.src_deg, zb]),
            dst_deg=torch.cat([d.dst_deg, zb]),
        ),
    )
    return store, stats


# ---------------------------------------------------------------------------
# Distributed ingest: shard by key ownership over the `data` dimension
# ---------------------------------------------------------------------------

# stats reduced by max instead of sum across ranks (budgets and load
# factors are per-table properties, not additive counts)
_STATS_MAX_KEYS = ("probe_rounds", "node_load", "edge_load")
# stats that index a rank's own tables, dropped before the reduction
_SHARD_LOCAL = ("delta", "nslot", "eslot")
_LOW32 = 0xFFFFFFFF


def owner(src: torch.Tensor, n_ranks: int) -> torch.Tensor:
    """The rank that owns each edge: its source key, as the unsigned
    integer it holds, mod `n_ranks` (int32).  The key is not hashed,
    as in the reference's code (its docstring says "hash % D")."""
    if src.dtype == torch.int64:
        # u = 2 * (u >> 1) + (u & 1), and u >> 1 fits a signed int64
        own = ((lsr(src, 1) % n_ranks) * 2 + (src & 1)) % n_ranks
    else:
        own = (src.to(torch.int64) & _LOW32) % n_ranks
    return own.to(torch.int32)


def route(src: torch.Tensor, dst: torch.Tensor, etype: torch.Tensor, valid: torch.Tensor,
          n_ranks: int) -> torch.Tensor:
    """One rank's raw edges (n_local lanes) as its send buffer for the
    exchange: (n_ranks, 4, n_local // n_ranks) of the keys' dtype, row r
    for rank r, holding src, dst, etype and a keep flag (1 or 0).

    Lanes are sorted by owner (a stable sort, as `jnp.argsort`), and
    slot i goes to rank i // per, per = n_local // n_ranks: a lane whose
    owner is not its slot's rank is dropped without a count, as in the
    reference's capacity-partitioned exchange."""
    n = src.shape[0]
    if n % n_ranks:
        raise ValueError(f"a rank's {n} raw edges do not split into {n_ranks} equal "
                         f"slots (n_local % D != 0)")
    per = n // n_ranks
    own = owner(src, n_ranks)
    order = torch.argsort(own, stable=True)
    slot_owner = torch.arange(n, device=src.device) // per
    keep = valid[order] & (own[order] == slot_owner)
    kd = src.dtype
    lanes = torch.stack([src[order], dst[order], etype[order].to(kd), keep.to(kd)])
    return lanes.reshape(4, n_ranks, per).transpose(0, 1).contiguous()


def commit(store: GraphStore, received: torch.Tensor) -> Tuple[GraphStore, dict]:
    """Commit what a rank received from the exchange ((D, 4, per): row r
    from rank r) to its shard `store`, whose counters are the global ones.

    The shard's tables are updated in place; its counters are not (the
    caller adds the reduced new-node and new-edge counts).  The commit
    sees the global counters divided by D, so the probe budget and the
    loads follow the shard's own fill.  Returns (store, this rank's
    stats) without the shard-local `delta`, `nslot` and `eslot`."""
    n_ranks = received.shape[0]
    src, dst, etype, keep = received.transpose(0, 1).reshape(4, -1)
    et = build_edge_table(src, dst, etype.to(torch.int32), keep != 0)
    local = dataclasses.replace(store, n_nodes=store.n_nodes // n_ranks,
                                n_edges=store.n_edges // n_ranks)
    _, stats = ingest_step(local, et)
    for k in _SHARD_LOCAL:
        stats.pop(k)
    return store, stats


def _pack_stats(stats: dict, key: torch.Tensor):
    """A rank's stats as two tensors for the reduction: the summed counts
    at the reference's dtype of a sum (`core.counters.sum_dtype`), and
    the maxima in float32 (the probe budget, at most 128, is exact)."""
    names = [k for k in stats if k not in _STATS_MAX_KEYS]
    sums = torch.stack([stats[k].to(sum_dtype(key)) for k in names])
    maxes = torch.stack([stats[k].to(torch.float32) for k in _STATS_MAX_KEYS])
    return names, sums, maxes


def _unpack_stats(order, names, sums: torch.Tensor, maxes: torch.Tensor) -> dict:
    out = dict(zip(names, sums.unbind()))
    out.update(zip(_STATS_MAX_KEYS, maxes.unbind()))
    out["probe_rounds"] = out["probe_rounds"].to(torch.int32)
    return {k: out[k] for k in order}


def _add_new(store: GraphStore, stats: dict) -> None:
    """The global counters after a commit: old + the summed new counts,
    in place (int32, marked as the reference's int64 at 64-bit keys)."""
    store.n_nodes += stats["new_nodes"].to(store.n_nodes.dtype)
    store.n_edges += stats["new_edges"].to(store.n_edges.dtype)
    widen(store, store.node_keys, ("n_nodes", "n_edges"))  # core.counters


def make_distributed_ingest(mesh):
    """The ingest over the mesh's `data` dimension (D ranks): each rank
    owns the edges whose source key mod D is its rank, and holds its
    slice of the table rows; one `all_to_all_single` routes every edge to
    its owner, then the local commit (dedup and the two fused-upsert
    sweeps of `ingest_step`) runs unchanged.

    Returns `ingest(store, src, dst, etype, valid) -> (store, stats)`,
    which every rank of the mesh calls with its shard (its slice of each
    table, and the global `n_nodes`/`n_edges`) and its own n_local raw
    edges.  The shard is updated in place; the stats are reduced over
    the ranks (max for the probe budget and the loads, sum for the rest)
    and are the same on every rank.  The summed `store_nodes` and
    `store_edges` lag the global counters by their remainder mod D, and a
    node that several ranks hold counts once a rank, as in the reference.
    The `model` (and `pod`) dimension replicates the ingest."""
    import torch.distributed as dist

    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    n_ranks = mesh.size(mesh.mesh_dim_names.index("data"))
    group = mesh.get_group("data")

    def ingest(store, src, dst, etype, valid):
        send = route(src, dst, etype, valid, n_ranks)
        received = torch.empty_like(send)
        dist.all_to_all_single(received, send, group=group)
        store, local = commit(store, received)
        names, sums, maxes = _pack_stats(local, store.node_keys)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=group)
        stats = _unpack_stats(list(local), names, sums, maxes)
        _add_new(store, stats)
        return store, stats

    return ingest


def ingest_ranks(shards, src, dst, etype, valid):
    """`make_distributed_ingest`'s D ranks in one process, with no
    process group: `shards` are the D ranks' stores, and rank r's raw
    edges are the r-th of D equal slices of `src`, `dst`, `etype` and
    `valid`.  The exchange is a transpose of the routed buffers, the
    reduction a sum and a max over the ranks.  Updates every shard in
    place; returns (shards, stats)."""
    n_ranks = len(shards)
    n = src.shape[0]
    if n % n_ranks:
        raise ValueError(f"{n} raw edges do not split into {n_ranks} ranks")
    m = n // n_ranks
    sends = [route(src[r * m:(r + 1) * m], dst[r * m:(r + 1) * m],
                   etype[r * m:(r + 1) * m], valid[r * m:(r + 1) * m], n_ranks)
             for r in range(n_ranks)]
    local = [commit(shard, torch.stack([s[r] for s in sends]))[1]
             for r, shard in enumerate(shards)]
    packed = [_pack_stats(s, shards[0].node_keys) for s in local]
    sums = torch.stack([p[1] for p in packed])
    stats = _unpack_stats(list(local[0]), packed[0][0], sums.sum(0, dtype=sums.dtype),
                          torch.stack([p[2] for p in packed]).amax(0))
    for shard in shards:
        _add_new(shard, stats)
    return shards, stats
