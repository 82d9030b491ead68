"""Plain oracles for the kernels' tests (counterpart of
`repro.kernels.ref`).

These are written apart from the plain versions beside the kernels, so
a test can hold both against an independent statement of the function.
Nothing on a pipeline's path calls them.  The plain versions of the
other kernels live beside their wrappers (`upsert.fused_upsert_ref`,
`sketch.sketch_scatter_ref`, `sampler.traffic_ids_ref`,
`pattern_mine.pattern_mine_ref`, `flash_attention.sdpa_chunked_plain`,
`ssd_scan.ssd_chunked_plain`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """(BH,S,d) attention with the whole score matrix materialised: float32
    scores, masked to -1e30, softmax, output in q's dtype."""
    BH, S, d = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    w = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BH,S,p), dt (BH,S), A (BH,), B/C (BH,S,N) -> (y in x's dtype,
    final state (BH,N,p) float32), by the sequential recurrence (the
    definition):  h[t] = exp(dt[t] A) h[t-1] + dt[t] B[t] x[t]^T,
    y[t] = C[t]^T h[t]."""
    BH, S, p = x.shape
    f32 = torch.float32
    xf, dtf, Bf, Cf = (t.to(f32) for t in (x, dt, B, C))
    a = A.to(f32)
    h = torch.zeros((BH, B.shape[-1], p), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        h = (torch.exp(dtf[:, t] * a)[:, None, None] * h
             + dtf[:, t, None, None] * Bf[:, t, :, None] * xf[:, t, None, :])
        ys.append(torch.einsum("bn,bnp->bp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h
