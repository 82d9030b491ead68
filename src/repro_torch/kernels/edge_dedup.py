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

The kernel runs the network at four levels, by the distance j of a
stage: in one thread's registers (j < REG_LANES), across a warp by
shuffles (j < WARP_LANES), in one CTA's shared memory (j < CTA_LANES)
and in a thread-block cluster's distributed shared memory
(j < CLUSTER_LANES, where all of the call's clusters fit on the card at
once, one CTA to an SM); longer stages run in device memory.  `_plan(n, clusters)`
decides, on the host, which stages each launch fuses at which level.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

MAX_LANES = 1 << 30  # positions and `order` must fit an int32
# The kernel's levels (csrc constants in brackets): a thread holds
# REG_LANES consecutive lanes in registers [kE], a warp WARP_LANES, a CTA
# CTA_LANES in shared memory [kTile], a cluster of CLUSTER_CTAS CTAs
# [kMaxCluster] CLUSTER_LANES.
REG_LANES = 16
WARP_LANES = 32 * REG_LANES
CTA_LANES = 1 << 12
CLUSTER_CTAS = 16
CLUSTER_LANES = CLUSTER_CTAS * CTA_LANES
GROUP_STAGES = REG_LANES.bit_length() - 1  # stages one thread's lanes close under
REG, SMEM, CLUSTER, GLOBAL = range(4)  # the level a step runs at

Dedup = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# (level, k, j, m): the stages (k, j), (k, j/2), ..., m of them
Step = Tuple[int, int, int, int]


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


def _floors(n: int, clusters: int) -> Dict[int, int]:
    """The least stage distance j of each level for n keys on a card that
    runs `clusters` clusters of CLUSTER_CTAS CTAs at once, one CTA to an
    SM.  Where the call's clusters do not all fit so, CTAs share SMs or
    wait for a second wave, and the cluster's stages run in device memory
    instead."""
    if -(-n // CLUSTER_LANES) <= clusters:
        return {GLOBAL: CLUSTER_LANES, CLUSTER: CTA_LANES, SMEM: WARP_LANES, REG: 1}
    return {GLOBAL: CTA_LANES, SMEM: WARP_LANES, REG: 1}


def _level(j: int, floors: Dict[int, int]) -> int:
    """The level of a stage of distance j: the smallest unit that holds
    both lanes of each of its pairs."""
    return next(level for level in (GLOBAL, CLUSTER, SMEM, REG)
                if level in floors and j >= floors[level])


@functools.lru_cache(maxsize=None)
def _plan(n: int, clusters: int) -> Tuple[Tuple[Step, ...], ...]:
    """The kernel's launches for n keys on a card that runs `clusters`
    clusters at once, each launch a tuple of steps in network order.  A
    step fuses the stages of one k that share a level, at most
    GROUP_STAGES of them above REG; a GLOBAL step is a launch of its own
    (the stages it joins span CTAs or clusters), and the steps between
    two of them form one cluster launch.  There is always a last cluster
    launch, which writes the outputs."""
    floors = _floors(n, clusters)
    launches, launch = [], []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            level = _level(j, floors)
            m = j.bit_length() - floors[level].bit_length() + 1
            if level != REG:
                m = min(m, GROUP_STAGES)
            if level == GLOBAL:
                if launch:
                    launches.append(tuple(launch))
                    launch = []
                launches.append(((level, k, j, m),))
            else:
                launch.append((level, k, j, m))
            j >>= m
        k *= 2
    if launch or not launches:
        launches.append(tuple(launch))
    return tuple(launches)


def _step_lanes(step: Step, n: int) -> torch.Tensor:
    """(sets, size) lanes that one step's threads gather, one set a
    thread, as the kernel maps them: a REG step's set is a warp's
    WARP_LANES consecutive lanes (REG_LANES to a thread), a group's the
    REG_LANES lanes b + u * 2^lo, u < REG_LANES, whose bits lo .. log2(j)
    vary, with b the thread's index with GROUP_STAGES zero bits put in
    at bit lo."""
    level, _, j, _ = step
    if level == REG:
        return torch.arange(n).view(-1, min(n, WARP_LANES))
    lo = j.bit_length() - GROUP_STAGES
    g = torch.arange(n // REG_LANES)
    b = (g & ((1 << lo) - 1)) | ((g >> lo) << (lo + GROUP_STAGES))
    return b[:, None] + (torch.arange(REG_LANES) << lo)[None, :]


@functools.lru_cache(maxsize=None)
def _encoded_plan(n: int, clusters: int):
    """`_plan(n, clusters)` as the C launcher reads it: per launch its step
    count, then each step packed as level | log2 k << 4 | log2 j << 10 |
    m << 16."""
    words = []
    for launch in _plan(n, clusters):
        words.append(len(launch))
        words += [level | (k.bit_length() - 1) << 4 | (j.bit_length() - 1) << 10 | m << 16
                  for level, k, j, m in launch]
    return (ctypes.c_int * len(words))(*words), len(words)


_clusters: Dict[int, int] = {}


def resident_clusters(device: torch.device) -> int:
    """How many clusters of CLUSTER_CTAS CTAs of the kernel `device` runs
    at once with one CTA on each SM (the CUDA occupancy query; 7 on an
    H100 SXM, where two CTAs to an SM allow 14)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _clusters:
        fn = build.library("sort_dedup").sort_dedup_resident_clusters
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = fn(ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"sort_dedup occupancy query failed: cudaError {err}")
        _clusters[index] = out.value
    return _clusters[index]


def launch_plan(n: int, device: torch.device) -> Tuple[Tuple[Step, ...], ...]:
    """The launches `sort_dedup` makes for n keys on `device`."""
    return _plan(n, resident_clusters(device))


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
             + [ctypes.c_void_p])


def _launch(keys: torch.Tensor) -> Dedup:
    fn = build.library("sort_dedup").sort_dedup_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    n, dev = keys.shape[0], keys.device
    sorted_keys = torch.empty_like(keys)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    head = torch.empty(n, dtype=torch.int32, device=dev)
    # between launches the network runs over packed (key << 32 | position)
    # words in this scratch
    clusters = resident_clusters(dev)
    plan, plan_len = _encoded_plan(n, clusters)
    several = len(_plan(n, clusters)) > 1
    scratch = torch.empty(n, dtype=torch.int64, device=dev) if several else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(keys.data_ptr(), sorted_keys.data_ptr(), order.data_ptr(), head.data_ptr(), n,
             None if scratch is None else scratch.data_ptr(), plan, plan_len, stream)
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
