"""Blocked Bloom filter: build and probe (the pre-commit diversity
signal rho of §III-A, the share of a bucket's node keys the filter has
not seen).

Counterpart of `repro.kernels.bloom`.  The filter is a (W, LANES)
bitmap of uint32 words, held as a `torch.int32` tensor with the same
bits; W * LANES words need not be a power of two.  Each key sets or
tests HASHES bits, one per round of the uint32 hash the sketch's
`node_hash` uses (`core.compression.hash_round`): word (h >> 5) % words,
bit h % 32.  Since words = W * LANES, that word is row (h >> 15) % W,
column (h >> 5) % LANES (`row_split`), which lets a CTA own whole rows.

Keys are `torch.int64` tensors holding uint32 values.

`bloom_probe`, `bloom_build` and `bloom_probe_build` (both in one
launch, for `ops.bloom_diversity`) are the wrappers: on CUDA tensors
they launch the hand-written kernels of `csrc/bloom.cu` under the
host's `launch_plan`, on CPU tensors they run the plain versions.
`launch` runs an entry under any plan its kernel takes.  A build
returns a new bitmap and leaves its input as it was, as the reference's
functional op does.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple, Union

import torch

from repro_torch.core.compression import hash_round as _hash_round
from repro_torch.device import resolve
from repro_torch.kernels import build

HASHES = 4
LANES = 1024
MAX_KEYS = 1 << 30  # keys a call: every index the kernels form stays an int

# The launch plan, from tools/k6_plan.py and tools/ab.py on an H100 (2 to
# 64 rows, 64 to 16,384 keys; PERF.md §6): the probe a key a thread on
# CTAs of PROBE_THREADS (the parent kernel's), of PROBE_NARROW_THREADS
# from PROBE_NARROW_KEYS up to PROBE_WIDE_KEYS keys; the build on the
# striped route up to STRIPED_KEYS keys (every CTA walks every key), a
# row a CTA, on CTAs of half the keys' threads (STRIPED_MIN_THREADS to
# MAX_THREADS); past STRIPED_KEYS the grid route on CTAs of GRID_THREADS.
# The fused entry (`bloom_diversity`, batches of 16,384 keys on the
# kernel-ops path) takes the grid route only.
PROBE_THREADS = 256
PROBE_NARROW_THREADS = 64
PROBE_NARROW_KEYS = 1_024
PROBE_WIDE_KEYS = 16_384
STRIPED_KEYS = 2_048
STRIPED_MIN_THREADS = 256
GRID_THREADS = 128
# What the kernels take (csrc/bloom.cu), and the sweep's grid of it
MAX_STRIPE = 32  # rows of shared memory a CTA (128 KB)
MAX_THREADS = 1_024
MAX_PROBE_THREADS = 256
SWEEP_STRIPES = (1, 2, 4, 8, 16)
SWEEP_THREADS = (128, 256, 512, 1_024)
SWEEP_PROBE_THREADS = (32, 64, 128, 256)
ROUTES = {"striped": 0, "grid": 1}  # the build's routes, as csrc/bloom.cu numbers them


class Plan(NamedTuple):
    route: str  # build: "striped" or "grid" (a cooperative launch; the fused entry's only route)
    stripe: int  # build, striped route: rows a CTA owns in shared memory (0 on the grid route)
    threads: int  # build: threads a CTA, a multiple of 32 up to MAX_THREADS
    probe_ctas: int  # probe: CTAs, a key a thread
    probe_threads: int  # probe: threads a CTA, a multiple of 32 up to MAX_PROBE_THREADS


def _warps(n: int) -> int:
    """n rounded up to a whole warp."""
    return -(-n // 32) * 32


def _probe_grid(n: int, threads: int) -> Tuple[int, int]:
    """(CTAs, threads) of the probe, a key a thread."""
    return -(-n // threads), threads


def launch_plan(rows: int, n: int, fused: bool = False) -> Plan:
    """The plan the wrappers launch for n keys into a filter of `rows`
    rows, for the fused entry where `fused` (see the constants above)."""
    narrow = PROBE_NARROW_KEYS <= n < PROBE_WIDE_KEYS
    probe = _probe_grid(n, PROBE_NARROW_THREADS if narrow else PROBE_THREADS)
    if n <= STRIPED_KEYS and not fused:
        threads = min(MAX_THREADS, max(STRIPED_MIN_THREADS, _warps(-(-n // 2))))
        return Plan("striped", 1, threads, *probe)
    return Plan("grid", 0, GRID_THREADS, *probe)


def build_plans(rows: int, n: int, fused: bool = False) -> List[Plan]:
    """Every build plan of the sweep (tools/k6_plan.py, chip_smoke.py)
    for the build, or the fused entry where `fused`: the striped route at
    SWEEP_STRIPES rows a CTA (not the fused entry's) and the grid route,
    each on CTAs of SWEEP_THREADS, with `launch_plan`'s probe; and
    `launch_plan`'s own."""
    own = launch_plan(rows, n, fused)
    routes = ([] if fused else [("striped", s) for s in SWEEP_STRIPES]) + [("grid", 0)]
    plans = [own._replace(route=r, stripe=s, threads=t) for r, s in routes for t in SWEEP_THREADS]
    return plans + [p for p in [own] if p not in plans]


def probe_plans(rows: int, n: int) -> List[Plan]:
    """Every probe plan of the sweep: CTAs of SWEEP_PROBE_THREADS, with
    `launch_plan`'s build; and its own."""
    own = launch_plan(rows, n)
    plans = [own._replace(**dict(zip(("probe_ctas", "probe_threads"), _probe_grid(n, t))))
             for t in SWEEP_PROBE_THREADS]
    return plans + [p for p in [own] if p not in plans]


def build_ctas(plan: Plan, rows: int, n: int) -> int:
    """CTAs the build launches under `plan`: the striped route's rows a
    stripe rounded up; the grid route's a key or a uint4 of the copy a
    thread, whichever needs more (on the card at most as many as are
    resident at once)."""
    if plan.route == "striped":
        return -(-rows // plan.stripe)
    return -(-max(n, rows * LANES // 4) // plan.threads)


def row_split(h: torch.Tensor, rows: int) -> torch.Tensor:
    """Word (h >> 5) % (rows * LANES) of hashes h (uint32 in int64), as
    the kernels form it: row (h >> 15) % rows, column (h >> 5) % LANES."""
    return ((h >> 15) % rows) * LANES + ((h >> 5) & (LANES - 1))


def _bit_coords(keys: torch.Tensor, r: int, words: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(word, bit) that round `r` gives each key, as int64."""
    h = _hash_round(keys, r)
    return (h >> 5) % words, h % 32


def bloom_probe_plain(keys: torch.Tensor, bitmap: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: int32 1 where all HASHES bits are set."""
    flat = bitmap.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    hit = torch.ones(keys.shape, dtype=torch.int64, device=keys.device)
    for r in range(HASHES):
        w, b = _bit_coords(keys, r, flat.shape[0])
        hit &= (flat[w] >> b) & 1
    return hit.to(torch.int32)


def bloom_build_plain(keys: torch.Tensor, bitmap: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a copy of `bitmap` with every key's bits
    set.  torch has no scatter-OR, so each bit position is one pass (the
    reference's 32 scatter-max passes): the words that take bit b get it
    ORed in, and a word listed twice is written the same value twice."""
    flat = bitmap.reshape(-1).clone()
    coords = [_bit_coords(keys, r, flat.shape[0]) for r in range(HASHES)]
    w = torch.cat([c[0] for c in coords])
    b = torch.cat([c[1] for c in coords])
    for bit in range(32):
        sel = w[b == bit]
        flat[sel] |= (1 << bit) - (1 << 32) if bit == 31 else 1 << bit  # int32 bits
    return flat.reshape(bitmap.shape)


def init_bitmap(rows: int = 64, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """An empty (rows, LANES) filter on `device` (default the card)."""
    return torch.zeros((rows, LANES), dtype=torch.int32, device=resolve(device))


def _check(keys: torch.Tensor, bitmap: torch.Tensor) -> None:
    if keys.dim() != 1:
        raise ValueError(f"keys must be (n,), got {tuple(keys.shape)}")
    if bitmap.dim() != 2 or bitmap.shape[1] != LANES or bitmap.shape[0] < 1:
        raise ValueError(f"bitmap must be (W, {LANES}), got {tuple(bitmap.shape)}")
    if keys.dtype != torch.int64 or bitmap.dtype != torch.int32:
        raise TypeError("keys must be int64 holding uint32 values and bitmap int32 "
                        f"holding uint32 words, got {keys.dtype} and {bitmap.dtype}")
    if not (keys.is_contiguous() and bitmap.is_contiguous()):
        raise ValueError("keys and bitmap must be contiguous")
    if keys.device != bitmap.device:
        raise ValueError(f"keys and bitmap must be on one device, got {keys.device} "
                         f"and {bitmap.device}")
    if bitmap.numel() >= 1 << 31:
        raise ValueError("the bitmap must hold fewer than 2^31 words")
    if keys.shape[0] > MAX_KEYS:
        raise ValueError(f"at most {MAX_KEYS} keys a call, got {keys.shape[0]}")


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {"bloom_probe": [_P, _P, _P, _I, _I, _I, _I, _P],
             "bloom_build": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
             "bloom_diversity": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]}


def launch(entry: str, keys: torch.Tensor, bitmap: torch.Tensor, plan: Plan):
    """Entry `entry` of the kernel on n > 0 CUDA keys and a bitmap that
    `_check` passed, under `plan`: "bloom_probe" returns the (n,) int32
    hits, "bloom_build" the new bitmap, "bloom_diversity" both, the hits
    as float32 0.0 / 1.0 (against the bitmap before the build; the grid
    route only).  The wrappers pass `launch_plan`'s plan;
    tools/k6_plan.py and chip_smoke.py run every plan the kernels take."""
    fn = getattr(build.library("bloom"), f"{entry}_launch")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES[entry], ctypes.c_int
    n, rows, dev = keys.shape[0], bitmap.shape[0], keys.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    build_plan = (ROUTES[plan.route], plan.stripe, plan.threads)
    if entry == "bloom_probe":
        out = torch.empty(keys.shape, dtype=torch.int32, device=dev)
        err = fn(keys.data_ptr(), bitmap.data_ptr(), out.data_ptr(), n, rows, plan.probe_ctas,
                 plan.probe_threads, stream)
    elif entry == "bloom_build":
        out = torch.empty_like(bitmap)
        err = fn(keys.data_ptr(), bitmap.data_ptr(), out.data_ptr(), n, rows, *build_plan,
                 stream)
    elif entry == "bloom_diversity":
        hits = torch.empty(keys.shape, dtype=torch.float32, device=dev)
        new = torch.empty_like(bitmap)
        err = fn(keys.data_ptr(), bitmap.data_ptr(), new.data_ptr(), hits.data_ptr(), n, rows,
                 *build_plan, stream)
        out = (hits, new)
    else:
        raise ValueError(f"no Bloom entry {entry!r}")
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err} under {plan}")
    build.launches[entry] += 1
    return out


def bloom_probe(keys: torch.Tensor, bitmap: torch.Tensor) -> torch.Tensor:
    """(n,) int32 hit mask of `keys` (n,) int64 against `bitmap`
    (W, LANES) int32.  CUDA tensors launch the kernel, CPU tensors run
    `bloom_probe_plain`."""
    _check(keys, bitmap)
    if keys.device.type == "cuda":
        if not keys.shape[0]:
            return torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
        return launch("bloom_probe", keys, bitmap, launch_plan(bitmap.shape[0], keys.shape[0]))
    if keys.device.type == "cpu":
        return bloom_probe_plain(keys, bitmap)
    raise ValueError(f"bloom_probe runs on cuda or cpu, not {keys.device}")


def bloom_build(keys: torch.Tensor, bitmap: torch.Tensor) -> torch.Tensor:
    """A new (W, LANES) int32 bitmap: `bitmap` with `keys` (n,) int64
    inserted; `bitmap` is left unchanged.  CUDA tensors launch the
    kernel, CPU tensors run `bloom_build_plain`."""
    _check(keys, bitmap)
    if keys.device.type == "cuda":
        if not keys.shape[0]:
            return bitmap.clone()
        return launch("bloom_build", keys, bitmap, launch_plan(bitmap.shape[0], keys.shape[0]))
    if keys.device.type == "cpu":
        return bloom_build_plain(keys, bitmap)
    raise ValueError(f"bloom_build runs on cuda or cpu, not {keys.device}")


def bloom_probe_build(keys: torch.Tensor,
                      bitmap: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hits, new bitmap): the (n,) float32 1.0 / 0.0 hit mask of `keys`
    against `bitmap`, and `bitmap` with `keys` inserted; `bitmap` is left
    unchanged.  CUDA tensors launch the kernel's fused entry once, CPU
    tensors run `bloom_probe_plain` (cast to float32), then
    `bloom_build_plain`."""
    _check(keys, bitmap)
    if keys.device.type == "cuda":
        if not keys.shape[0]:
            return torch.empty(keys.shape, dtype=torch.float32, device=keys.device), bitmap.clone()
        return launch("bloom_diversity", keys, bitmap,
                      launch_plan(bitmap.shape[0], keys.shape[0], fused=True))
    if keys.device.type == "cpu":
        return bloom_probe_plain(keys, bitmap).to(torch.float32), bloom_build_plain(keys, bitmap)
    raise ValueError(f"bloom_probe_build runs on cuda or cpu, not {keys.device}")
