"""Per-batch frequent-substructure mining for GraphZip compression.

Counterpart of `repro.kernels.pattern_mine`.  Mining is recast as three
sorted-vector problems over the dedup'd batch:

  star bursts    fan_out[e] = |{f : (src, etype) equal}|  (hub fan-out)
                 fan_in[e]  = |{f : (dst, etype) equal}|  (hub fan-in)
  cascade chains dst[e] appears as a source elsewhere in the batch
  hot edges      within-batch multiplicity >= hot_min

Each admitted edge carries a pattern signature (the hub or relay id
mixed with a pattern tag).  Keys are int64 tensors holding uint64 bits
or int32 tensors holding uint32 bits; the signature has the keys' width.
The plain version `pattern_mine_ref` sorts and searches as the
reference does, on sign-flipped keys, whose signed order is the
unsigned order; invalid lanes hold the all-ones sentinel, which sorts
last.

`pattern_mine` is the wrapper: on CUDA tensors it launches the
hand-written kernels of `csrc/pattern_mine.cu`, which count the three
vectors' keys in hash tables in (distributed) shared memory instead of
sorting them, by the plan `cluster_plan` gives, through the 64-bit entry
or the 32-bit one by the keys' dtype; on CPU tensors it runs
`pattern_mine_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.compression import SENTINEL, flip_sign, mix_keys
from repro_torch.kernels import build

# pattern-signature tags (the "pattern class" half of a dictionary key)
TAG_STAR_OUT = 0xA1
TAG_STAR_IN = 0xA2
TAG_CHAIN = 0xA3
TAG_HOT = 0xA4

# admit-flag bits returned per edge
FLAG_STAR_OUT = 1
FLAG_STAR_IN = 2
FLAG_CHAIN = 4
FLAG_HOT = 8

MAX_LANES = 1 << 16  # the largest batch the reference's kernel takes
# The kernel's hash tables (csrc kMinLanes, kSlotsPerCta, kMaxCluster,
# kThreads): 2 max(n, 64) slots of 12 bytes for each vector, at most
# 16,384 (192 KB of shared memory) in a CTA of a cluster of at most 8.
# A cluster pays from 2,048 lanes: below, a single CTA's launch is 2 to 4
# us quicker than any cluster's; from there, 8 CTAs beat 1, 2 and 4 at
# every size (tools/k5_plan.py on an H100).
MIN_TABLE_LANES = 64
SLOTS_PER_CTA = 1 << 14
MAX_CLUSTER = 8
CLUSTER_LANES = 1 << 11
# the kernel's instance for each key dtype: its C entry, and its name in
# `build.launches`
ENTRIES = {torch.int64: "pattern_mine", torch.int32: "pattern_mine32"}

Mined = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _bisect(sorted_keys: torch.Tensor, q: torch.Tensor, right: bool) -> torch.Tensor:
    """The reference's vectorised binary search, step for step: n's
    bit length rounds of (lo, hi) halving over flipped (signed-order)
    keys, the probe index clipped to [0, n).  A query above every key
    ends at n + 1, as in the reference."""
    n = sorted_keys.shape[0]
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full(q.shape, n, dtype=torch.int32, device=q.device)
    for _ in range(max(n.bit_length(), 1)):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = sorted_keys[mid.clamp(0, n - 1).to(torch.int64)]
        go = (v <= q) if right else (v < q)
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    return lo


def _tag(ids: torch.Tensor, etype: torch.Tensor, tag: int) -> torch.Tensor:
    """Pattern signature: hub/relay id x etype x pattern-class tag, at
    the ids' width."""
    return mix_keys(ids, etype.to(ids.dtype), torch.full_like(etype, tag))


def pattern_mine_ref(src: torch.Tensor, dst: torch.Tensor, etype: torch.Tensor,
                     count: torch.Tensor, valid: torch.Tensor, star_min: int,
                     hot_min: int) -> Mined:
    """Plain PyTorch version of the reference's `mine_body`, with
    `torch.sort` on flipped keys for the sort.  Returns (fan_out,
    fan_in, flags, psig): int32 fan counts (0 on invalid lanes), the
    int32 FLAG_* mask, and the pattern signature at the keys' width (0
    where flags is 0)."""
    sentinel = torch.full_like(src, SENTINEL)
    gs = _tag(src, etype, TAG_STAR_OUT)  # (src, etype) group key
    gd = _tag(dst, etype, TAG_STAR_IN)  # (dst, etype) group key
    fgs, fgd, fdst = flip_sign(gs), flip_sign(gd), flip_sign(dst)
    sorted_gs = torch.sort(flip_sign(torch.where(valid, gs, sentinel))).values
    sorted_gd = torch.sort(flip_sign(torch.where(valid, gd, sentinel))).values
    sorted_src = torch.sort(flip_sign(torch.where(valid, src, sentinel))).values

    zero = torch.zeros_like(count)
    fan_out = torch.where(valid, _bisect(sorted_gs, fgs, True) - _bisect(sorted_gs, fgs, False),
                          zero)
    fan_in = torch.where(valid, _bisect(sorted_gd, fgd, True) - _bisect(sorted_gd, fgd, False),
                         zero)

    # cascade chain: this edge's head is some other edge's tail
    pos = _bisect(sorted_src, fdst, False)
    member = sorted_src[pos.clamp(0, src.shape[0] - 1).to(torch.int64)] == fdst
    chain = valid & member & (dst != src)

    staro = valid & (fan_out >= star_min)
    stari = valid & (fan_in >= star_min)
    hot = valid & (count >= hot_min)
    flags = (staro.to(torch.int32) * FLAG_STAR_OUT + stari.to(torch.int32) * FLAG_STAR_IN
             + chain.to(torch.int32) * FLAG_CHAIN + hot.to(torch.int32) * FLAG_HOT)

    # strongest pattern wins the signature: hub fan-out > fan-in >
    # chain relay > hot edge (the edge's own key)
    psig = _tag(src, etype, TAG_HOT)
    psig = torch.where(chain, _tag(dst, etype, TAG_CHAIN), psig)
    psig = torch.where(stari, gd, psig)
    psig = torch.where(staro, gs, psig)
    return fan_out, fan_in, flags, torch.where(flags != 0, psig, torch.zeros_like(psig))


def _check(src, dst, etype, count, valid):
    n = src.shape[0] if src.dim() == 1 else -1
    if n < 1 or n & (n - 1) or n > MAX_LANES:
        raise ValueError(f"batch size must be a power of two in [1, {MAX_LANES}], "
                         f"got {tuple(src.shape)}")
    tensors = (src, dst, etype, count, valid)
    if any(t.shape != (n,) for t in tensors):
        raise ValueError("src, dst, etype, count and valid must be (n,)")
    if (src.dtype not in ENTRIES or dst.dtype != src.dtype
            or (etype.dtype, count.dtype, valid.dtype) != (torch.int32, torch.int32, torch.bool)):
        raise TypeError("src/dst must be both int64 (uint64 bits) or both int32 (uint32 "
                        "bits), etype/count int32, valid bool")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every operand of pattern_mine must be contiguous")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")


def cluster_plan(n: int) -> int:
    """CTAs of each vector's cluster for a batch of n lanes: one below
    CLUSTER_LANES, else MAX_CLUSTER.  Each vector's table of 2 max(n, 64)
    slots (load at most 0.5) is spread over them; 65,536 lanes need all
    8 CTAs' SLOTS_PER_CTA.  The count kernel runs three such clusters."""
    return 1 if n < CLUSTER_LANES else MAX_CLUSTER


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6


def launch(src, dst, etype, count, valid, star_min, hot_min, ctas) -> Mined:
    """The kernels on CUDA tensors that `_check` passed, with `ctas` CTAs
    in each vector's cluster (a power of two up to MAX_CLUSTER that
    divides n and leaves a CTA at most SLOTS_PER_CTA slots), through the
    instance of the keys' width (`ENTRIES`).  `pattern_mine` passes
    `cluster_plan(n)`; tools/k5_plan.py times every plan the kernel
    takes."""
    name = ENTRIES[src.dtype]
    fn = getattr(build.library("pattern_mine"), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    n, dev = src.shape[0], src.device
    counts = torch.empty((3, n), dtype=torch.int32, device=dev)
    psig = torch.empty(n, dtype=src.dtype, device=dev)
    member = torch.empty(n, dtype=torch.uint8, device=dev)  # dst is some valid tail
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(src.data_ptr(), dst.data_ptr(), etype.data_ptr(), count.data_ptr(),
             valid.data_ptr(), n, int(star_min), int(hot_min), int(ctas), counts[0].data_ptr(),
             counts[1].data_ptr(), counts[2].data_ptr(), psig.data_ptr(), member.data_ptr(),
             stream)
    if err != 0:
        raise RuntimeError(f"pattern_mine launch failed: cudaError {err}")
    build.launches[name] += 1
    return counts[0], counts[1], counts[2], psig


def pattern_mine(src: torch.Tensor, dst: torch.Tensor, etype: torch.Tensor,
                 count: torch.Tensor, valid: torch.Tensor, star_min: int,
                 hot_min: int) -> Mined:
    """Mine one dedup'd batch: (fan_out, fan_in, flags, psig).

    src/dst (n,) key bits, both int64 or both int32; etype/count (n,) int32; valid (n,)
    bool; n a power of two up to 65,536; star_min/hot_min int
    thresholds.  CUDA tensors launch the kernel, CPU tensors run
    `pattern_mine_ref`."""
    _check(src, dst, etype, count, valid)
    if src.device.type == "cuda":
        return launch(src, dst, etype, count, valid, star_min, hot_min,
                      cluster_plan(src.shape[0]))
    if src.device.type == "cpu":
        return pattern_mine_ref(src, dst, etype, count, valid, star_min, hot_min)
    raise ValueError(f"pattern_mine runs on cuda or cpu, not {src.device}")
