"""Graph compression (§I, §III-B "Graph Compression", Algorithm 1).

Duplicate edges collapse into a `count` property and duplicate nodes
are emitted once per batch.  Dedup is sort-based, as in the reference
(`repro.core.compression`): mix (src, dst, etype) into one key, sort,
mark run heads, segment-sum the counts.

Keys are 64-bit or 32-bit, as the reference's are uint64 under x64 and
uint32 without it.  torch has no full unsigned arithmetic, so a key is a
`torch.int64` tensor holding the uint64 bit pattern, or a `torch.int32`
tensor holding the uint32 one:
  * multiply and add wrap exactly like the unsigned type;
  * `>>` is arithmetic, so every logical shift is masked (`lsr`);
  * unsigned order is signed order on sign-flipped values
    (`flip_sign`), which is how sorts, searches and compares run here.
The width is chosen where a store, sketch or edge table is made (a
`key_dtype=`, default `torch.int64`); everything downstream follows the
dtype of the key tensors it is given.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

SIGN_BIT = -(1 << 63)  # int64 with only bit 63 set
SIGN_BIT32 = -(1 << 31)  # int32 with only bit 31 set
SENTINEL = -1  # all-ones at either width: marks invalid, sorts last unsigned
KEY_DTYPES = (torch.int64, torch.int32)
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


def as_int32(c: int) -> int:
    """A uint32 constant as the int32 with the same bit pattern."""
    return c - (1 << 32) if c >= (1 << 31) else c


def check_key_dtype(dtype: torch.dtype) -> torch.dtype:
    """`dtype` if it is a key width (int64: uint64 bits, int32: uint32
    bits); raises otherwise."""
    if dtype not in KEY_DTYPES:
        raise TypeError(f"keys are torch.int64 (uint64 bits) or torch.int32 "
                        f"(uint32 bits), not {dtype}")
    return dtype


def key_bits(dtype: torch.dtype) -> int:
    """64 or 32: the width of keys of `dtype`."""
    return 64 if check_key_dtype(dtype) == torch.int64 else 32


def sign_bit(dtype: torch.dtype) -> int:
    """The key dtype's value with only its top bit set."""
    return SIGN_BIT if key_bits(dtype) == 64 else SIGN_BIT32


def flip_sign(k: torch.Tensor) -> torch.Tensor:
    """Values whose signed order is the unsigned order of keys `k`
    (int64 or int32, same dtype out)."""
    return k ^ sign_bit(k.dtype)


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the unsigned bit pattern in int64 or int32
    `x` (0 < s < its width)."""
    return (x >> s) & ((1 << (key_bits(x.dtype) - s)) - 1)


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


_UNSIGNED = {np.dtype(np.int64): np.dtype(np.uint64), np.dtype(np.int32): np.dtype(np.uint32)}
_SIGNED = {u: s for s, u in _UNSIGNED.items()}


def unsigned_view(a: np.ndarray) -> np.ndarray:
    """int64 or int32 key bits as the uint64 or uint32 numpy array of
    the same bits (the reference's keys)."""
    return a.view(_UNSIGNED[a.dtype])


def signed_view(a: np.ndarray) -> np.ndarray:
    """A uint64 or uint32 numpy array as the int64 or int32 array of the
    same bits (the port's keys); any other dtype as it is."""
    return a.view(_SIGNED[a.dtype]) if a.dtype in _SIGNED else a


def numpy_unsigned(dtype: torch.dtype) -> np.dtype:
    """The reference's numpy key type for the port's key dtype: uint64
    for torch.int64, uint32 for torch.int32."""
    return np.dtype(np.uint64) if key_bits(dtype) == 64 else np.dtype(np.uint32)


def key_tensor(keys, device, dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Keys as a `dtype` tensor of unsigned bits (int64: uint64, int32:
    uint32) on `device`: a tensor is moved there, anything else (numpy, a
    list of ints) goes through an unsigned numpy array of that width,
    which keeps the low bits of wider values as the reference's
    `jnp.asarray(keys, kd)` does."""
    unsigned = numpy_unsigned(dtype)
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=dtype)
    a = signed_view(np.ascontiguousarray(np.asarray(keys).astype(unsigned)))
    return torch.from_numpy(a).to(device)


_C1 = as_int64(0x9E3779B97F4A7C15)
_C2 = as_int64(0xBF58476D1CE4E5B9)
_C1_32 = as_int32(0x9E3779B9)
_C2_32 = as_int32(0x85EBCA6B)


def mix_keys(src: torch.Tensor, dst: torch.Tensor, etype: torch.Tensor) -> torch.Tensor:
    """Combine (src, dst, etype) into one dedup key of src's width.

    64-bit: exact bijective packing when src/dst < 2^27 (unsigned) and
    0 <= etype < 2^8, splitmix hash with bit 63 set otherwise.  32-bit:
    the 32-bit splitmix-style hash alone.  Either way the all-ones
    sentinel and the 0 empty marker are remapped away."""
    wide = key_bits(src.dtype) == 64
    et = etype.to(src.dtype)
    c1, c2 = (_C1, _C2) if wide else (_C1_32, _C2_32)
    x = src * c1 + dst
    x = (x ^ lsr(x, 30)) * c2
    x = x ^ lsr(x, 27)
    x = x + et
    if not wide:
        x = torch.where(x == SENTINEL, torch.full_like(x, SENTINEL - 1), x)
        return torch.where(x == 0, torch.full_like(x, 2), x)
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

    keys: torch.Tensor  # (n,) sorted unique keys at the input's width (invalid = sentinel)
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
