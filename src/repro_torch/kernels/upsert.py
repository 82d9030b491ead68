"""Fused lookup-or-insert for the open-addressing store tables
(Algorithm 3 GRAPHPUSH commit hot path).

Counterpart of `repro.kernels.upsert`.  One probe sweep per table: at
each round a lane hits its key (slot found, not new), claims an empty
slot (unsigned scatter-max race; the winner checks back: slot found,
new), or probes on.  Keys are int64 tensors holding uint64 bits or
int32 tensors holding uint32 bits (the table's and the keys' dtype
alike); 0 marks an empty slot.

`fused_upsert` is the wrapper: on a CUDA tensor it launches the
hand-written kernel `csrc/fused_upsert.cu` (a live-lane worklist in
shared memory, two barriers a round) as one CTA or one cluster of CTAs,
by the plan `cluster_plan` gives, through its 64-bit entry or its 32-bit
one by the keys' dtype; on a CPU tensor it runs the plain version
`fused_upsert_ref`.  Both update the table IN PLACE and return
it; the reference returns a fresh copy of the table (up to 16 MB per
sweep at the default store size) instead.
"""
from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from repro_torch.core.compression import as_int64, flip_sign, key_bits, sign_bit
from repro_torch.kernels import build

_PROBE_MUL = as_int64(0x9E3779B97F4A7C15)
_PROBE_MUL32 = 0x9E3779B9
_LOW32 = 0xFFFFFFFF
_MAX_CAP = 1 << 30  # slot ids must fit an int32
# The kernel's limits (csrc kMaxCtaLanes, kMaxCluster, kHandOver): a CTA
# takes at most 16,384 lanes (16 a thread of 1,024; 12 bytes of shared
# memory a lane), a cluster at most 16 CTAs, and a cluster hands its live
# lanes to its first CTA once at most HAND_OVER_LANES are left.
MAX_CTA_LANES = 1 << 14
MAX_CLUSTER = 16
MAX_LANES = MAX_CLUSTER * MAX_CTA_LANES
HAND_OVER_LANES = 1 << 11
# A cluster pays from 4,096 lanes: below, one CTA's launch and barriers
# beat every cluster's; from there 8 CTAs spread round 0's reads and
# claims and beat 1, 2 and 4 (tools/k1_plan.py on an H100).
CLUSTER_LANES = 1 << 12
PLAN_CTAS = 8


def probe_hash(keys: torch.Tensor, cap: int, i: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear-probing slot for `keys` at probe round `i`: the low 32
    bits of h ^ (h >> 16) with h = key * golden at the keys' width
    (0x9E3779B97F4A7C15 for 64-bit keys, 0x9E3779B9 for 32-bit), plus i
    in uint32 with wraparound, then % cap.  Returns int64 slots."""
    if key_bits(keys.dtype) == 64:
        h = keys * _PROBE_MUL
        # the low 32 bits of an arithmetic and a logical shift by 16 agree
        base = (h ^ (h >> 16)) & _LOW32
    else:
        # uint32 arithmetic in int64, masked after the multiply
        h = ((keys.to(torch.int64) & _LOW32) * _PROBE_MUL32) & _LOW32
        base = h ^ (h >> 16)
    return ((base + i) & _LOW32) % cap


def _check(table, keys, valid, n_probes):
    if table.dim() != 1 or keys.dim() != 1 or valid.shape != keys.shape:
        raise ValueError("table and keys must be 1-D and valid shaped like keys")
    if (table.dtype not in (torch.int64, torch.int32) or keys.dtype != table.dtype
            or valid.dtype != torch.bool):
        raise TypeError("table and keys must be both int64 (uint64 bits) or both int32 "
                        "(uint32 bits), valid bool")
    if not (0 < table.shape[0] <= _MAX_CAP):
        raise ValueError(f"table capacity must be in (0, {_MAX_CAP}]")
    if not (table.is_contiguous() and keys.is_contiguous() and valid.is_contiguous()):
        raise ValueError("table, keys and valid must be contiguous")
    devices = {table.device, keys.device, valid.device}
    if isinstance(n_probes, torch.Tensor):
        devices.add(n_probes.device)
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")


def fused_upsert_ref(table: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
                     n_probes: Union[int, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sweep, round for round the
    reference's `upsert_sweep`.  Updates `table` in place; returns
    (table, slot int32 (-1 = dropped), is_new bool)."""
    cap, n = table.shape[0], keys.shape[0]
    dev = keys.device
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    is_new = torch.zeros(n, dtype=torch.bool, device=dev)
    done = ~valid
    for i in range(int(n_probes)):
        if bool(done.all()):  # later rounds change nothing
            break
        cand = probe_hash(keys, cap, i)
        cur = table[cand]
        live = valid & ~done
        hit = (cur == keys) & live
        empty = (cur == 0) & live
        claim = empty.nonzero().squeeze(1)
        if claim.numel():
            # every claimant of a slot read it empty (0, the unsigned
            # minimum), so the scatter-max leaves the largest claimant;
            # unsigned max is signed max on sign-flipped keys
            slots, inv = torch.unique(cand[claim], return_inverse=True)
            best = torch.full(slots.shape, sign_bit(keys.dtype), dtype=keys.dtype, device=dev)
            best.scatter_reduce_(0, inv, flip_sign(keys[claim]), "amax")
            table[slots] = flip_sign(best)
        won = empty & (table[cand] == keys)
        placed = hit | won
        slot = torch.where(placed, cand.to(torch.int32), slot)
        is_new |= won
        done |= placed
    return table, slot, is_new


def cluster_plan(n: int) -> int:
    """CTAs of the sweep's cluster for a batch of n lanes: one below
    CLUSTER_LANES, else PLAN_CTAS, or the fewest powers of two above that
    leave a CTA at most MAX_CTA_LANES lanes."""
    if n > MAX_LANES:
        raise ValueError(f"fused_upsert's kernel takes at most {MAX_LANES} lanes, got {n}")
    if n < CLUSTER_LANES:
        return 1
    ctas = PLAN_CTAS
    while -(-n // ctas) > MAX_CTA_LANES:
        ctas *= 2
    return ctas


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


# the kernel's instance for each key dtype: its C entry, and its name in
# `build.launches`
ENTRIES = {torch.int64: "fused_upsert", torch.int32: "fused_upsert32"}


def launch(table, keys, valid, n_probes, ctas):
    """The kernel on CUDA tensors that `_check` passed, as one cluster
    of `ctas` CTAs (1 to MAX_CLUSTER, each with at most MAX_CTA_LANES
    lanes), through the instance of the keys' width (`ENTRIES`).
    `fused_upsert` passes `cluster_plan(n)`; tools/k1_plan.py times
    every plan the kernel takes."""
    name = ENTRIES[keys.dtype]
    fn = getattr(build.library("fused_upsert"), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    n = keys.shape[0]
    if not isinstance(n_probes, torch.Tensor):
        n_probes = torch.tensor(int(n_probes), device=table.device)
    probes = n_probes.reshape(1).to(torch.int32).contiguous()
    slot = torch.empty(n, dtype=torch.int32, device=table.device)
    is_new = torch.empty(n, dtype=torch.bool, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), table.shape[0], keys.data_ptr(), valid.data_ptr(), n,
             probes.data_ptr(), int(ctas), slot.data_ptr(), is_new.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_upsert launch failed: cudaError {err}")
    build.launches[name] += 1
    return table, slot, is_new


def fused_upsert(table: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
                 n_probes: Union[int, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused upsert of UNIQUE keys into `table`, updated in place.

    table (cap,) and keys (n,) both int64 (uint64 bits) or both int32
    (uint32 bits), 0 = empty; valid (n,) bool;
    n_probes the probe budget (an int, or an int32 scalar tensor on the
    table's device, read by the kernel so the host never waits for it).
    Returns (table, slot int32 (-1 = dropped), is_new bool).  A CUDA
    table launches the kernel (at most MAX_LANES lanes), a CPU table
    runs `fused_upsert_ref`."""
    _check(table, keys, valid, n_probes)
    if table.device.type == "cuda":
        return launch(table, keys, valid, n_probes, cluster_plan(keys.shape[0]))
    if table.device.type == "cpu":
        return fused_upsert_ref(table, keys, valid, n_probes)
    raise ValueError(f"fused_upsert runs on cuda or cpu, not {table.device}")
