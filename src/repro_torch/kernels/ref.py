"""Plain oracles for the kernels' tests (counterpart of
`repro.kernels.ref`).

These are written apart from the plain versions beside the kernels, so
a test can hold both against an independent statement of the function.
Nothing on a pipeline's path calls them.  The plain versions of the
other kernels live beside their wrappers (`upsert.fused_upsert_ref`,
`sketch.sketch_scatter_ref`, `sampler.traffic_ids_ref`,
`pattern_mine.pattern_mine_ref`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.edge_dedup import run_heads


def sort_dedup_ref(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sorted, order, head) by a stable sort: the same sorted keys and
    heads as `sort_dedup`, but tied keys in input order."""
    sk, order = torch.sort(keys, stable=True)
    return sk, order.to(torch.int32), run_heads(sk)


def _hash_round_np(keys: np.ndarray, r: int) -> np.ndarray:
    c1 = np.uint32((0x9E3779B9 + 0x7F4A7C15 * r) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        x = (keys + c1) * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        return x ^ (x >> np.uint32(16))


def _coords_np(keys: torch.Tensor, bitmap: torch.Tensor, hashes: int):
    k = keys.cpu().numpy().astype(np.uint32)
    flat = bitmap.cpu().numpy().reshape(-1).view(np.uint32)
    for r in range(hashes):
        h = _hash_round_np(k, r)
        yield flat, (h >> np.uint32(5)) % np.uint32(flat.size), h % np.uint32(32)


def bloom_build_ref(keys: torch.Tensor, bitmap: torch.Tensor, hashes: int = 4) -> torch.Tensor:
    """The filter with `keys` inserted, one key and bit at a time in
    numpy uint32 arithmetic."""
    out = bitmap.cpu().numpy().copy()
    flat = out.reshape(-1).view(np.uint32)
    for _, w, b in _coords_np(keys, bitmap, hashes):
        for wi, bi in zip(w.tolist(), b.tolist()):
            flat[wi] |= np.uint32(1 << bi)
    return torch.from_numpy(out).to(bitmap.device)


def bloom_probe_ref(keys: torch.Tensor, bitmap: torch.Tensor, hashes: int = 4) -> torch.Tensor:
    """int32 1 where all of a key's bits are set, in numpy uint32
    arithmetic."""
    hit = np.ones(keys.shape[0], np.int32)
    for flat, w, b in _coords_np(keys, bitmap, hashes):
        hit &= ((flat[w] >> b) & np.uint32(1)).astype(np.int32)
    return torch.from_numpy(hit).to(keys.device)
