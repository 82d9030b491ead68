"""Blocked (flash) attention forward, causal and sliding-window, with
grouped-query heads (the long-prompt prefill's attention).

Counterpart of `repro.kernels.flash_attention` (K7).  `attention` takes
the model's layout, q (B, S, n, h) and k/v (B, S, m, h) with query head
j reading kv head j // (n // m), as `models.layers._sdpa_chunked` does:
  * on CUDA tensors it launches the hand-written kernel
    `csrc/flash_attention.cu`, which reads q, k and v in place through
    their strides (no permute, no copy of k/v per query head) and writes
    a new contiguous (B, S, n, h) output.  bfloat16 runs on the tensor
    cores (wgmma, K and V loaded by TMA), which needs q, k and v 16-byte
    aligned with strides of whole 16-byte rows; float32 runs on the FMA
    units.  The choice is the dtype's, never a fallback;
  * on CPU tensors it runs the plain version `sdpa_chunked_plain`, the
    reference's online-softmax recurrence over KV chunks.
Scores are float32 from q and k, masked scores are set to -1e30, and the
output, divided by its softmax sum, is in q's dtype (float32 or
bfloat16).  In bfloat16 the kernel multiplies v by the softmax weights
as two bfloat16 parts, hi and the rounding of p - hi, which keeps about
16 bits of each weight (one part, as FlashAttention uses, misses the
card's check near 0); the sum stays float32.  `ops.flash_attention`
keeps the reference's (BH, S, d) signature over the same wrapper.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)  # head widths the kernel is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG = -1e30  # the reference's masked score


def _mask(Sq: int, k0: int, width: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = k0 + torch.arange(width, device=device)[None, :]
    msk = torch.ones((Sq, width), dtype=torch.bool, device=device)
    if causal:
        msk &= qpos >= kpos
    if window is not None:
        msk &= qpos - kpos < window
    return msk


def sdpa_chunked_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       window: Optional[int], chunk: int) -> torch.Tensor:
    """Plain PyTorch version: online-softmax attention scanning KV in
    chunks, the reference's `_sdpa_chunked` step for step.  q (B,S,n,h),
    k/v (B,S,m,h) -> (B,S,n,h) in q's dtype."""
    B, Sq, n, h = q.shape
    m = k.shape[2]
    g = n // m
    Sk = k.shape[1]
    qh = q.reshape(B, Sq, m, g, h).float()
    scale = 1.0 / math.sqrt(h)
    acc = torch.zeros((B, m, g, Sq, h), dtype=torch.float32, device=q.device)
    mx = torch.full((B, m, g, Sq), -math.inf, dtype=torch.float32, device=q.device)
    den = torch.zeros((B, m, g, Sq), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, chunk):
        kb = k[:, k0:k0 + chunk].float()
        vb = v[:, k0:k0 + chunk].float()
        s = torch.einsum("bqmgh,bkmh->bmgqk", qh, kb) * scale
        s = torch.where(_mask(Sq, k0, chunk, causal, window, q.device), s, NEG)
        new_mx = torch.maximum(mx, s.amax(dim=-1))
        alpha = torch.exp(mx - new_mx)
        p = torch.exp(s - new_mx[..., None])
        den = den * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bmgqk,bkmh->bmgqh", p, vb)
        mx = new_mx
    out = acc / den[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, n, h).to(q.dtype)


def _check(q, k, v, window, chunk):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be (B, S, n, h) and k, v (B, S, m, h)")
    B, S, n, h = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != h:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}: "
                         "self-attention over one sequence length")
    if k.shape[2] == 0 or n % k.shape[2]:
        raise ValueError(f"{n} query heads do not group over {k.shape[2]} kv heads")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of {list(DTYPES)}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must be on one device")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    if window is not None and window < 1:
        raise ValueError("window must be at least 1")


def _check_tma(q, k, v):
    """The bf16 kernel loads q, k and v by TMA: each base 16-byte aligned,
    each stride of a dimension longer than 1 a multiple of 16 bytes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(t.stride(i) * t.element_size() % 16
                                    for i in range(3) if t.shape[i] > 1):
            raise ValueError(f"{name} must be 16-byte aligned with strides of whole 16-byte "
                             f"rows for the bf16 kernel's TMA loads (strides {t.stride()})")


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _launch(q, k, v, causal, window):
    B, S, n, h = q.shape
    m = k.shape[2]
    if h not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head widths {HEAD_DIMS}, not {h}")
    if not all(t.stride(3) == 1 for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous along the head width")
    if q.dtype == torch.bfloat16:
        _check_tma(q, k, v)
    o = torch.empty((B, S, n, h), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    fn = build.library("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    strides = [t.stride(i) for t in (q, k, v, o) for i in (0, 2, 1)]  # batch, head, position
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, n, m, S, h, *strides,
             int(causal), -1 if window is None else int(window), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    build.launches["flash_attention"] += 1
    return o


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
              window: Optional[int] = None, chunk: int = 512) -> torch.Tensor:
    """Grouped-query attention forward: q (B,S,n,h), k/v (B,S,m,h) with
    n a multiple of m -> (B,S,n,h) in q's dtype.  `chunk` is the plain
    version's KV block (S must be a multiple of it, as the reference
    asserts); the kernel tiles on its own.  CUDA tensors launch the
    kernel, CPU tensors run `sdpa_chunked_plain`."""
    _check(q, k, v, window, chunk)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    if q.device.type == "cpu":
        return sdpa_chunked_plain(q, k, v, causal, window, chunk)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: Optional[int] = None, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """(BH, S, d) attention, the reference kernel's signature: each of the
    BH rows attends to its own k/v (MQA/GQA callers broadcast KV
    beforehand, or call `attention`).  S must be a multiple of
    min(block_q, S) and min(block_k, S), as the reference asserts."""
    if q.dim() != 3:
        raise ValueError("q, k and v must be (BH, S, d)")
    S = q.shape[1]
    bq, bk = min(block_q, S), min(block_k, S)
    if bq <= 0 or S % bq or S % bk:
        raise ValueError(f"sequence length {S} is not a multiple of the blocks ({bq}, {bk})")
    return attention(q[:, :, None], k[:, :, None], v[:, :, None], causal, window, bk)[:, :, 0]
