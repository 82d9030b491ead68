"""Dictionary-compression pipeline stages (GraphZip rewrite path).
Counterpart of `repro.compress.stage`.

`DictionaryStage.rewrite` turns one dedup'd `EdgeTable` into a
`CompressedCommit`: the batch's dictionary hits become `(pattern_id,
bindings)` references (the binding is the cached (edge, src, dst)
store-slot triple) and the misses a smaller residual `EdgeTable` that
takes the normal two-sweep commit.  Mining (`kernels.pattern_mine`)
marks which residual edges belong to frequent patterns; after the store
confirms their slots, `observe_commit` admits them to the dictionary so
the next occurrence is a reference.

The raw and compressed paths give identical stores: an edge's first
appearance is always a miss, so the residual sweep inserts it as the
raw path would, and present keys never claim empty slots.

`CompressedCommit` duck-types the `EdgeTable` surface the rest of the
system reads (the controller's table metadata, the sketch's fields).

Keys follow the edge table's width (int64: uint64 bits, int32: uint32);
the stage makes its dictionary at that width, and makes it anew when an
edge table of the other width arrives, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.compress.dictionary import (
    PatternDictionary,
    dict_admit,
    dict_lookup,
    init_dictionary,
)
from repro_torch.core.compression import dedup_with_counts, flip_sign, mix_keys
from repro_torch.core.edge_table import EdgeTable
from repro_torch.device import resolve
from repro_torch.kernels.pattern_mine import pattern_mine
from repro_torch.telemetry.spans import NULL_REGISTRY

REF_MIN_CAP = 8  # smallest reference-array capacity


@dataclasses.dataclass
class CompressedCommit:
    """One batch rewritten as residual EdgeTable + pattern references.

    Reference arrays are (R,) at a power-of-two capacity;
    `ref_eslot`/`ref_sslot`/`ref_dslot` are the dictionary's cached store
    slots (the bindings), `ref_pattern` the dictionary entry index (the
    pattern id).  The scalar metadata keeps the FULL batch's unique
    node/edge counts, so controller signals match the raw path."""

    residual: EdgeTable
    res_admit: torch.Tensor    # (rcap,) bool: mined pattern members to admit
    res_psig: torch.Tensor     # (rcap,) their pattern signatures (key width)
    ref_src: torch.Tensor      # (R,) key bits
    ref_dst: torch.Tensor      # (R,) key bits
    ref_etype: torch.Tensor    # (R,) int32
    ref_count: torch.Tensor    # (R,) int32 batch multiplicity
    ref_eslot: torch.Tensor    # (R,) int32 store edge slot (binding)
    ref_sslot: torch.Tensor    # (R,) int32 store src-node slot
    ref_dslot: torch.Tensor    # (R,) int32 store dst-node slot
    ref_pattern: torch.Tensor  # (R,) int32 dictionary entry (pattern id)
    ref_valid: torch.Tensor    # (R,) bool
    n_refs: torch.Tensor       # 0-d int32
    n_raw: torch.Tensor        # 0-d int32 full-batch raw instructions
    n_nodes_full: torch.Tensor  # 0-d int32 full-batch unique nodes
    n_edges_full: torch.Tensor  # 0-d int32 full-batch unique edges

    # ---- EdgeTable duck-type surface (the sketch update reads these) ----
    @property
    def src(self):
        return torch.cat([self.residual.src, self.ref_src])

    @property
    def dst(self):
        return torch.cat([self.residual.dst, self.ref_dst])

    @property
    def etype(self):
        return torch.cat([self.residual.etype, self.ref_etype])

    @property
    def count(self):
        return torch.cat([self.residual.count, self.ref_count])

    @property
    def edge_valid(self):
        return torch.cat([self.residual.edge_valid, self.ref_valid])

    @property
    def node_ids(self):
        zero = torch.zeros_like(self.ref_src)
        return torch.cat([self.residual.node_ids,
                          torch.where(self.ref_valid, self.ref_src, zero),
                          torch.where(self.ref_valid, self.ref_dst, zero)])

    @property
    def node_valid(self):
        return torch.cat([self.residual.node_valid, self.ref_valid, self.ref_valid])

    # ---- table-level metadata (the controller reads these) ----
    def density(self) -> torch.Tensor:
        v = self.n_nodes_full.to(torch.float32).clamp(min=2.0)
        return 2.0 * self.n_edges_full.to(torch.float32) / (v * (v - 1.0))

    def size(self) -> torch.Tensor:
        return self.n_edges_full + self.n_nodes_full

    def compression_ratio(self) -> torch.Tensor:
        """Fig. 13 accounting with references: a reference costs ONE
        instruction (against 1 edge + up to 2 node instructions raw)."""
        eff = (self.residual.n_nodes + self.residual.n_edges + self.n_refs).to(torch.float32)
        raw = (3 * self.n_raw).to(torch.float32).clamp(min=1.0)
        return eff / raw


def _empty_refs(device, key_dtype: torch.dtype, cap: int = REF_MIN_CAP) -> dict:
    def full(v, dtype):
        return torch.full((cap,), v, dtype=dtype, device=device)

    return dict(
        ref_src=full(0, key_dtype), ref_dst=full(0, key_dtype),
        ref_etype=full(0, torch.int32), ref_count=full(0, torch.int32),
        ref_eslot=full(-1, torch.int32), ref_sslot=full(-1, torch.int32),
        ref_dslot=full(-1, torch.int32), ref_pattern=full(-1, torch.int32),
        ref_valid=full(False, torch.bool),
        n_refs=torch.zeros((), dtype=torch.int32, device=device),
    )


def _stable_front(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the first k lanes when the True lanes are moved to
    the front in order (the reference's stable `argsort(~mask)[:k]`)."""
    return torch.sort((~mask).to(torch.int8), stable=True).indices[:k]


def _split(et: EdgeTable, hit, admit, psig, eslot, sslot, dslot, entry,
           rcap: int, refcap: int) -> CompressedCommit:
    """Compact dictionary hits into reference arrays and misses into a
    residual EdgeTable (power-of-two capacities)."""
    keep = et.edge_valid & ~hit
    sidx = _stable_front(keep, rcap)
    rvalid = keep[sidx]

    def zed(a):
        return torch.where(rvalid, a[sidx], torch.zeros_like(a[sidx]))

    rsrc, rdst, rety, rcnt = zed(et.src), zed(et.dst), zed(et.etype), zed(et.count)
    ncomp = dedup_with_counts(torch.cat([rsrc, rdst]), torch.cat([rvalid, rvalid]))
    sorted_ids = flip_sign(ncomp.keys)

    def nidx(k):
        pos = torch.searchsorted(sorted_ids, flip_sign(k))
        return pos.clamp(0, 2 * rcap - 1).to(torch.int32)

    residual = EdgeTable(
        src=rsrc, dst=rdst, etype=rety, count=rcnt, edge_valid=rvalid,
        node_ids=ncomp.keys, node_valid=ncomp.valid,
        src_node_idx=nidx(rsrc), dst_node_idx=nidx(rdst),
        n_edges=rvalid.sum(dtype=torch.int32),
        n_nodes=ncomp.n_unique,
        n_raw=rcnt.sum(dtype=torch.int32),
    )
    ridx = _stable_front(hit, refcap)
    refv = hit[ridx]

    def gk(a):
        return torch.where(refv, a[ridx], torch.zeros_like(a[ridx]))

    def gi(a):
        return torch.where(refv, a[ridx], torch.full_like(a[ridx], -1))

    return CompressedCommit(
        residual=residual,
        res_admit=admit[sidx] & rvalid,
        res_psig=zed(psig),
        ref_src=gk(et.src), ref_dst=gk(et.dst),
        ref_etype=gk(et.etype), ref_count=gk(et.count),
        ref_eslot=gi(eslot), ref_sslot=gi(sslot), ref_dslot=gi(dslot),
        ref_pattern=gi(entry),
        ref_valid=refv,
        n_refs=refv.sum(dtype=torch.int32),
        n_raw=et.n_raw,
        n_nodes_full=et.n_nodes,
        n_edges_full=et.n_edges,
    )


def _pow2(n: int, lo: int) -> int:
    return max(lo, 1 << int(np.ceil(np.log2(max(n, 1)))))


class DictionaryStage:
    """Stage-protocol owner of the pattern dictionary, on `device`
    (default the card).

    As a record stage it is a pass-through observer (the work happens
    at transform time through `rewrite`); `PipelineBuilder
    .with_compression()` wires it in and registers `observe_commit` on
    the sink's ingestor, so admissions see confirmed store slots."""

    name = "dictionary"

    def __init__(self, capacity: int = 4096, star_min: int = 4,
                 hot_min: int = 2, ttl: int = 64,
                 device: Union[str, torch.device, None] = None):
        self.capacity = int(capacity)
        self.star_min = int(star_min)
        self.hot_min = int(hot_min)
        self.ttl = int(ttl)
        self.device = resolve(device)
        self.dct: Optional[PatternDictionary] = None
        self.ticks_seen = 0
        self.rewrites = 0
        self.refs_total = 0
        self.telemetry = NULL_REGISTRY

    # ---- Stage protocol ----
    def __call__(self, records: List[dict], ctx=None) -> List[dict]:
        self.ticks_seen += 1
        return records

    # ---- checkpoint surface (the dictionary's tensors excluded) ----
    def state(self) -> dict:
        return {"ticks_seen": self.ticks_seen, "rewrites": self.rewrites,
                "refs_total": self.refs_total}

    def restore_state(self, s: dict) -> None:
        self.ticks_seen = int(s["ticks_seen"])
        self.rewrites = int(s["rewrites"])
        self.refs_total = int(s["refs_total"])

    # ---- rewrite path ----
    def rewrite(self, et: EdgeTable) -> CompressedCommit:
        """Mine + dictionary lookup + split one dedup'd batch."""
        tel = self.telemetry
        kd = et.src.dtype
        if self.dct is None or self.dct.sig.dtype != kd:
            self.dct = init_dictionary(self.capacity, self.device, key_dtype=kd)
        with tel.span("rewrite.mine"):
            _, _, flags, psig = pattern_mine(
                et.src, et.dst, et.etype, et.count, et.edge_valid,
                self.star_min, self.hot_min)
        with tel.span("rewrite.lookup"):
            keys = mix_keys(et.src, et.dst, et.etype)
            self.dct, hit, eslot, sslot, dslot, entry = dict_lookup(
                self.dct, keys, et.edge_valid)
            n_ref, n_valid = torch.stack([hit.sum(), et.edge_valid.sum()]).tolist()
        admit = (flags != 0) & et.edge_valid & ~hit
        self.rewrites += 1
        self.refs_total += n_ref
        if n_ref == 0:
            # nothing referenced: the batch IS the residual
            return CompressedCommit(
                residual=et, res_admit=admit,
                res_psig=torch.where(et.edge_valid, psig, torch.zeros_like(psig)),
                n_raw=et.n_raw, n_nodes_full=et.n_nodes,
                n_edges_full=et.n_edges, **_empty_refs(et.src.device, kd))
        cap = et.src.shape[0]
        rcap = min(_pow2(max(n_valid - n_ref, 1), 64), cap)
        refcap = min(_pow2(n_ref, REF_MIN_CAP), cap)
        with tel.span("rewrite.split"):
            return _split(et, hit, admit, psig, eslot, sslot, dslot, entry, rcap, refcap)

    # ---- commit feedback (ingestor.commit_hooks) ----
    def observe_commit(self, committed, stats) -> None:
        """Admit the just-committed batch's mined pattern members using
        the slots the commit confirmed (`nslot`/`eslot` commit stats)."""
        if self.dct is None or stats is None:
            return
        res = getattr(committed, "residual", None)
        admit_mask = getattr(committed, "res_admit", None)
        if res is None or admit_mask is None:
            return
        eslot = stats.get("eslot")
        nslot = stats.get("nslot")
        if eslot is None or nslot is None:
            return
        with self.telemetry.span("dict.admit"):
            sslot = nslot[res.src_node_idx]
            dslot = nslot[res.dst_node_idx]
            admit = admit_mask & (eslot >= 0) & (sslot >= 0) & (dslot >= 0)
            keys = mix_keys(res.src, res.dst, res.etype)
            self.dct = dict_admit(self.dct, keys, admit, eslot, sslot, dslot,
                                  committed.res_psig, ttl=self.ttl)

    # ---- observability ----
    def stats(self) -> dict:
        if self.dct is None:
            return {"entries": 0, "load": 0.0, "hit_rate": 0.0,
                    "evictions": 0, "rewrites": self.rewrites,
                    "refs_total": self.refs_total}
        return {
            "entries": int(self.dct.n_entries),
            "load": self.dct.load(),
            "hit_rate": self.dct.hit_rate(),
            "evictions": int(self.dct.evictions),
            "rewrites": self.rewrites,
            "refs_total": self.refs_total,
        }


class CompressingTransform:
    """Transform-protocol wrapper: inner encode, then dictionary
    rewrite.  The instruction count refs actually cost (one per
    reference) replaces the plain compressed count, which is how
    compressibility reaches the consumer model and the controller."""

    def __init__(self, inner, stage: DictionaryStage):
        self.inner = inner
        self.stage = stage
        self.name = f"{inner.name}+dict"

    # one registry drives both halves
    @property
    def telemetry(self):
        return self.stage.telemetry

    @telemetry.setter
    def telemetry(self, reg):
        self.stage.telemetry = reg
        if hasattr(self.inner, "telemetry"):
            self.inner.telemetry = reg

    def encode(self, records: List[dict]) -> Tuple[CompressedCommit, int, int]:
        et, _, raw_instr = self.inner.encode(records)
        cc = self.stage.rewrite(et)
        res = cc.residual
        n_instr = int((res.n_nodes + res.n_edges + cc.n_refs).item())
        return cc, n_instr, raw_instr
