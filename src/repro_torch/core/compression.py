"""Graph compression (§I, §III-B "Graph Compression", Algorithm 1).

Duplicate edges collapse into a `count` property and duplicate nodes
are emitted once per batch.  Dedup is sort-based, as in the reference
(`repro.core.compression`): mix (src, dst, etype) into one key, sort,
mark run heads, segment-sum the counts.

Keys are 64-bit.  torch has no full uint64 arithmetic, so a key is a
`torch.int64` tensor holding the uint64 bit pattern:
  * multiply and add wrap exactly like uint64;
  * `>>` on int64 is arithmetic, so every logical shift is masked;
  * unsigned order is signed order on sign-flipped values
    (`flip_sign`), which is how sorts, searches and compares run here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

SIGN_BIT = -(1 << 63)  # int64 with only bit 63 set
SENTINEL = -1  # all-ones uint64: marks invalid, sorts last unsigned
_M32 = 0xFFFFFFFF

# Bijective packing layout for keys: [1b tag=0][1b pack=1][27b src]
# [27b dst][8b etype].  Ids that fit get an exact, collision-free key;
# anything wider falls back to the splitmix hash with bit 63 set, so
# the packed and mixed domains never alias.
PACK_SRC_BITS = 27
PACK_DST_BITS = 27
PACK_ETYPE_BITS = 8


def as_int64(c: int) -> int:
    """A uint64 constant as the int64 with the same bit pattern."""
    return c - (1 << 64) if c >= (1 << 63) else c


def flip_sign(k: torch.Tensor) -> torch.Tensor:
    """int64 values whose signed order is the unsigned order of `k`."""
    return k ^ SIGN_BIT


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the uint64 bit pattern in int64 `x`."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def hash_round(k32: torch.Tensor, r: int) -> torch.Tensor:
    """Round `r` of the uint32 splitmix-style hash that the sketch's
    `node_hash` and the Bloom filter share, on int64 tensors holding
    uint32 values: the reference's uint32 arithmetic, masked to 32 bits
    after every add and multiply (a product of two 32-bit values may wrap
    past 2^63, but its low 32 bits stay right)."""
    c1 = (0x9E3779B9 + 0x7F4A7C15 * r) & _M32
    x = (((k32 + c1) & _M32) * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def key_tensor(keys, device) -> torch.Tensor:
    """Keys as an int64 tensor of uint64 bits on `device`: a tensor is
    moved there, anything else (numpy, a list of ints) goes through a
    uint64 numpy array."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64)
    a = np.ascontiguousarray(np.asarray(keys).astype(np.uint64).view(np.int64))
    return torch.from_numpy(a).to(device)


_C1 = as_int64(0x9E3779B97F4A7C15)
_C2 = as_int64(0xBF58476D1CE4E5B9)


def mix_keys(src: torch.Tensor, dst: torch.Tensor, etype: torch.Tensor) -> torch.Tensor:
    """Combine (src, dst, etype) into one dedup key.

    Exact bijective packing when src/dst < 2^27 (unsigned) and
    0 <= etype < 2^8, splitmix hash with bit 63 set otherwise; the
    all-ones sentinel and the 0 empty marker are remapped away."""
    et = etype.to(torch.int64)
    x = src * _C1 + dst
    x = (x ^ lsr(x, 30)) * _C2
    x = x ^ lsr(x, 27)
    x = x + et
    # unsigned `< 2^27`: ids with bit 63 set are negative as int64
    fits = ((src >= 0) & (src < (1 << PACK_SRC_BITS))
            & (dst >= 0) & (dst < (1 << PACK_DST_BITS))
            & (et >= 0) & (et < (1 << PACK_ETYPE_BITS)))
    zero = torch.zeros_like(x)
    packed = ((1 << 62)
              | (torch.where(fits, src, zero) << (PACK_DST_BITS + PACK_ETYPE_BITS))
              | (torch.where(fits, dst, zero) << PACK_ETYPE_BITS)
              | torch.where(fits, et, zero))
    x = torch.where(fits, packed, x | SIGN_BIT)
    x = torch.where(x == SENTINEL, torch.full_like(x, SENTINEL - 1), x)
    return torch.where(x == 0, torch.full_like(x, 2), x)


@dataclasses.dataclass
class CompressedBatch:
    """Fixed-capacity dedup result (valid-masked)."""

    keys: torch.Tensor  # (n,) int64 sorted unique keys (invalid = sentinel)
    counts: torch.Tensor  # (n,) int32 multiplicity of each unique key
    index: torch.Tensor  # (n,) int64 original position of each key's first hit
    valid: torch.Tensor  # (n,) bool
    n_unique: torch.Tensor  # scalar int32
    n_input: torch.Tensor  # scalar int32 (valid inputs)


def dedup_with_counts(keys: torch.Tensor, valid: torch.Tensor) -> CompressedBatch:
    """Sort-based dedup with fixed shapes, in unsigned key order.

    The sort is stable, so `index` is the first original occurrence of
    each key, as with the reference's stable `argsort`."""
    n = keys.shape[0]
    dev = keys.device
    masked = torch.where(valid, keys, torch.full_like(keys, SENTINEL))
    order = torch.sort(flip_sign(masked), stable=True).indices
    sk = masked[order]
    is_valid = sk != SENTINEL
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      sk[1:] != sk[:-1]]) & is_valid
    run = torch.cumsum(head.to(torch.int32), 0) - 1
    n_unique = head.sum(dtype=torch.int32)
    run_c = run.clamp(0, n - 1).to(torch.int64)
    counts = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, run_c, is_valid.to(torch.int32))
    pos = torch.arange(n, device=dev)
    # sorted position of each run's head (non-heads carry n; min -> head)
    first_pos = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, run_c, torch.where(head, pos, torch.full_like(pos, n)), "amin")
    fp = first_pos.clamp(0, n - 1)
    live = pos < n_unique
    return CompressedBatch(
        keys=torch.where(live, sk[fp], torch.full_like(sk, SENTINEL)),
        counts=torch.where(live, counts, torch.zeros_like(counts)),
        index=torch.where(live, order[fp], torch.zeros_like(fp)),
        valid=live,
        n_unique=n_unique,
        n_input=valid.sum(dtype=torch.int32),
    )


def unique_nodes(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor) -> CompressedBatch:
    return dedup_with_counts(torch.cat([src, dst]), torch.cat([valid, valid]))


def compress_edges(src, dst, etype, valid) -> Tuple[CompressedBatch, torch.Tensor]:
    """Algorithm-1 edge compression: returns (dedup result, density).

    Density d = 2|E| / (|V| (|V|-1)) over the batch (paper §III-A)."""
    comp = dedup_with_counts(mix_keys(src, dst, etype), valid)
    nodes = unique_nodes(src, dst, valid)
    v = nodes.n_unique.to(torch.float32).clamp(min=2.0)
    density = 2.0 * comp.n_unique.to(torch.float32) / (v * (v - 1.0))
    return comp, density


def compression_ratio(n_unique_nodes, n_unique_edges, n_raw_edges) -> torch.Tensor:
    """Paper Fig. 13 metric: effective insert instructions over raw
    (2 node instructions + 1 edge instruction per raw edge)."""
    eff = (n_unique_nodes + n_unique_edges).to(torch.float32)
    raw = (3 * n_raw_edges).to(torch.float32).clamp(min=1.0)
    return eff / raw
