"""Blocked Bloom filter: build and probe (the pre-commit diversity
signal rho of §III-A, the share of a bucket's node keys the filter has
not seen).

Counterpart of `repro.kernels.bloom`.  The filter is a (W, LANES)
bitmap of uint32 words, held as a `torch.int32` tensor with the same
bits; W * LANES words need not be a power of two.  Each key sets or
tests HASHES bits, one per round of the uint32 hash the sketch's
`node_hash` uses (`core.compression.hash_round`): word (h >> 5) % words,
bit h % 32.

Keys are `torch.int64` tensors holding uint32 values.

`bloom_probe` and `bloom_build` are the wrappers: on CUDA tensors they
launch the hand-written kernels of `csrc/bloom.cu`, on CPU tensors they
run the plain versions.  `bloom_build` returns a new bitmap and leaves
its input as it was, as the reference's functional op does.
"""
from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from repro_torch.core.compression import hash_round as _hash_round
from repro_torch.device import resolve
from repro_torch.kernels import build

HASHES = 4
LANES = 1024


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


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _launch(name: str, keys: torch.Tensor, bitmap: torch.Tensor, out: torch.Tensor) -> None:
    fn = getattr(build.library("bloom"), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = fn(keys.data_ptr(), bitmap.data_ptr(), out.data_ptr(), keys.shape[0],
             bitmap.numel(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    build.launches[name] += 1


def bloom_probe(keys: torch.Tensor, bitmap: torch.Tensor) -> torch.Tensor:
    """(n,) int32 hit mask of `keys` (n,) int64 against `bitmap`
    (W, LANES) int32.  CUDA tensors launch the kernel, CPU tensors run
    `bloom_probe_plain`."""
    _check(keys, bitmap)
    if keys.device.type == "cuda":
        hit = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
        if keys.shape[0]:
            _launch("bloom_probe", keys, bitmap, hit)
        return hit
    if keys.device.type == "cpu":
        return bloom_probe_plain(keys, bitmap)
    raise ValueError(f"bloom_probe runs on cuda or cpu, not {keys.device}")


def bloom_build(keys: torch.Tensor, bitmap: torch.Tensor) -> torch.Tensor:
    """A new (W, LANES) int32 bitmap: `bitmap` with `keys` (n,) int64
    inserted; `bitmap` is left unchanged.  CUDA tensors launch the
    kernel, which copies the bitmap and sets the bits in the copy; CPU
    tensors run `bloom_build_plain`."""
    _check(keys, bitmap)
    if keys.device.type == "cuda":
        if not keys.shape[0]:
            return bitmap.clone()
        out = torch.empty_like(bitmap)
        _launch("bloom_build", keys, bitmap, out)
        return out
    if keys.device.type == "cpu":
        return bloom_build_plain(keys, bitmap)
    raise ValueError(f"bloom_build runs on cuda or cpu, not {keys.device}")
