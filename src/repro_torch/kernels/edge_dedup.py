"""Bitonic sort with run-head marking (Algorithm 1's INSERTEDGE dedup as
a sorting network).

Counterpart of `repro.kernels.edge_dedup`.  `sort_dedup(keys)` sorts a
power-of-two vector of uint32 keys by the reference kernel's bitonic
network and returns (sorted, order, head): the sorted keys, the input
position of each, and 1 where a run of equal keys starts.

The network fixes where equal keys go, so `order` is deterministic but
is not the stable order: a stable sort (`torch.sort(stable=True)`, or
`kernels.ref.sort_dedup_ref`) puts tied keys elsewhere.  Only running
the same network, compare for compare, gives all three outputs bit for
bit as the reference's kernel does.

Keys are `torch.int64` tensors holding the uint32 value (0 to
2^32 - 1), so their natural order is the unsigned order; `sorted` has
the same type, `order` and `head` are int32.

`sort_dedup` is the wrapper: on a CUDA tensor it launches the
hand-written kernel `csrc/sort_dedup.cu`, on a CPU tensor it runs the
plain version `sort_dedup_plain`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

MAX_LANES = 1 << 30  # positions and `order` must fit an int32
SMEM_LANES = 1 << 14  # one CTA sorts this many keys in shared memory (csrc kTile)

Dedup = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _stage(x: torch.Tensor, idx: torch.Tensor, k: int, j: int):
    """One compare-exchange stage (the reference's `_bitonic_stage`):
    lane i and its partner i + j, for every i whose bit j is 0; the pair
    ascends iff (i & k) == 0, and swaps iff ascending ? a > b : a < b."""
    n = x.shape[0]
    rows = n // (2 * j)
    xr, ir = x.view(rows, 2, j), idx.view(rows, 2, j)
    a, b, ia, ib = xr[:, 0], xr[:, 1], ir[:, 0], ir[:, 1]
    # bit k of i = row * 2j + col lies in the row part, since col < j < k
    row_start = torch.arange(rows, device=x.device).unsqueeze(1) * (2 * j)
    asc = (row_start & k) == 0
    swap = torch.where(asc, a > b, a < b)
    x = torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)], dim=1).reshape(n)
    idx = torch.stack([torch.where(swap, ib, ia), torch.where(swap, ia, ib)], dim=1).reshape(n)
    return x, idx


def run_heads(sorted_keys: torch.Tensor) -> torch.Tensor:
    """int32 1 where a run of equal keys starts (head[0] = 1)."""
    head = torch.ones_like(sorted_keys, dtype=torch.int32)
    head[1:] = (sorted_keys[1:] != sorted_keys[:-1]).to(torch.int32)
    return head


def sort_dedup_plain(keys: torch.Tensor) -> Dedup:
    """Plain PyTorch version: the reference kernel's network, stage by
    stage on reshaped tensors."""
    n = keys.shape[0]
    x = keys
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            x, idx = _stage(x, idx, k, j)
            j //= 2
        k *= 2
    return x, idx, run_heads(x)


def _check(keys: torch.Tensor) -> None:
    n = keys.shape[0] if keys.dim() == 1 else -1
    if n < 1 or n & (n - 1) or n > MAX_LANES:
        raise ValueError(f"keys must be (n,) with n a power of two up to {MAX_LANES}, "
                         f"got {tuple(keys.shape)}")
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64 holding uint32 values, got {keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2


def _launch(keys: torch.Tensor) -> Dedup:
    fn = build.library("sort_dedup").sort_dedup_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    n, dev = keys.shape[0], keys.device
    sorted_keys = torch.empty_like(keys)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    head = torch.empty(n, dtype=torch.int32, device=dev)
    # above one CTA's tile the network runs over (uint32 key, int32
    # position) pairs in this scratch between launches
    scratch = torch.empty(2 * n, dtype=torch.int32, device=dev) if n > SMEM_LANES else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(keys.data_ptr(), sorted_keys.data_ptr(), order.data_ptr(), head.data_ptr(), n,
             None if scratch is None else scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sort_dedup launch failed: cudaError {err}")
    build.launches["sort_dedup"] += 1
    return sorted_keys, order, head


def sort_dedup(keys: torch.Tensor) -> Dedup:
    """(sorted, order, head) of `keys`, (n,) int64 holding values in
    [0, 2^32), n a power of two.  CUDA tensors launch the kernel, CPU
    tensors run `sort_dedup_plain`.  The range is the caller's to keep
    (checking it would wait on the device): the kernel reads the low 32
    bits of each key."""
    _check(keys)
    if keys.device.type == "cuda":
        return _launch(keys)
    if keys.device.type == "cpu":
        return sort_dedup_plain(keys)
    raise ValueError(f"sort_dedup runs on cuda or cpu, not {keys.device}")
