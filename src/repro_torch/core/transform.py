"""Model transformation (§II-A, Fig. 5/6, Algorithm 1 CREATEEDGE).

The port's copy of the reference's host-side transformation
(`repro.core.transform`): a declarative `MappingSpec` (the paper's XML
map file) and the generic extraction over dict-shaped records.  It
stays numpy on the host; the device work starts at
`core.edge_table.from_raw_batch`.

Nodes are identified by a 64-bit splitmix hash of (type_tag, key), so
the uint64 ids here are bit-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorised splitmix64 finaliser (uint64 -> uint64)."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK
        z = x
        z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK
        z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK
        z = z ^ (z >> np.uint64(31))
    return z


def hash_str(type_tag: int, s: str) -> int:
    """Stable node id for (node_type, key)."""
    h = np.uint64(1469598103934665603)  # FNV offset
    with np.errstate(over="ignore"):
        for b in s.encode("utf-8"):
            h = ((h ^ np.uint64(b)) * np.uint64(1099511628211)) & _MASK
        h ^= np.uint64(type_tag) << np.uint64(56)
    v = int(splitmix64(np.asarray([h]))[0])
    return v or 1  # 0 is the empty-slot sentinel


@dataclasses.dataclass(frozen=True)
class NodeDef:
    type_name: str
    type_tag: int
    key: Callable[[dict], Optional[str]]  # extraction binding (getName()...)


@dataclasses.dataclass(frozen=True)
class EdgeDef:
    name: str
    etype: int
    # return list of (src_key, dst_key) string pairs for one record
    extract: Callable[[dict], List[Tuple[str, str]]]
    src_type: int = 0
    dst_type: int = 0


@dataclasses.dataclass(frozen=True)
class MappingSpec:
    input_model: str  # "json"
    output_model: str  # "property-graph"
    nodes: Tuple[NodeDef, ...]
    edges: Tuple[EdgeDef, ...]
    max_edges_per_record: int = 24


# node type tags
T_USER, T_TWEET, T_HASHTAG = 1, 2, 3
# edge types (Fig. 6)
E_OWNER, E_MENTIONED, E_HT_USED_IN, E_MENTIONED_WITH_HT = 1, 2, 3, 4


def tweet_mapping() -> MappingSpec:
    """The paper's Twitter mapping (Fig. 6): user/tweet/hashtag nodes,
    owner / mentioned / hashtag-used-in / mentioned-with-ht edges."""

    def owner(r):
        return [(r["user"], r["id"])]

    def mentioned(r):
        return [(r["id"], m) for m in r.get("mentions", ())]

    def ht_used(r):
        return [(h, r["id"]) for h in r.get("hashtags", ())]

    def ht_mention(r):
        return [
            (h, m)
            for h in r.get("hashtags", ())
            for m in r.get("mentions", ())
        ]

    return MappingSpec(
        input_model="json",
        output_model="property-graph",
        nodes=(
            NodeDef("user", T_USER, lambda r: r["user"]),
            NodeDef("tweet", T_TWEET, lambda r: r["id"]),
            NodeDef("hashtag", T_HASHTAG, lambda r: None),
        ),
        edges=(
            EdgeDef("owner", E_OWNER, owner, T_USER, T_TWEET),
            EdgeDef("mentioned", E_MENTIONED, mentioned, T_TWEET, T_USER),
            EdgeDef("hashtag-used-in", E_HT_USED_IN, ht_used, T_HASHTAG, T_TWEET),
            EdgeDef("mentioned-with-ht", E_MENTIONED_WITH_HT, ht_mention, T_HASHTAG, T_USER),
        ),
    )


@dataclasses.dataclass
class RawEdgeBatch:
    """Host edge batch (pre-compression)."""

    src: np.ndarray  # (n,) uint64 node ids
    dst: np.ndarray  # (n,) uint64
    etype: np.ndarray  # (n,) int32
    src_type: np.ndarray  # (n,) int32
    dst_type: np.ndarray  # (n,) int32
    n_records: int

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def create_edges(records: Sequence[dict], mapping: MappingSpec) -> RawEdgeBatch:
    """CREATEEDGE over a mini-batch of records.  Linear in #edges."""
    srcs: List[int] = []
    dsts: List[int] = []
    ets: List[int] = []
    sts: List[int] = []
    dts: List[int] = []
    for r in records:
        for ed in mapping.edges:
            pairs = ed.extract(r)
            if len(pairs) > mapping.max_edges_per_record:
                pairs = pairs[: mapping.max_edges_per_record]
            for sk, dk in pairs:
                srcs.append(hash_str(ed.src_type, str(sk)))
                dsts.append(hash_str(ed.dst_type, str(dk)))
                ets.append(ed.etype)
                sts.append(ed.src_type)
                dts.append(ed.dst_type)
    return RawEdgeBatch(
        src=np.asarray(srcs, np.uint64),
        dst=np.asarray(dsts, np.uint64),
        etype=np.asarray(ets, np.int32),
        src_type=np.asarray(sts, np.int32),
        dst_type=np.asarray(dts, np.int32),
        n_records=len(records),
    )
