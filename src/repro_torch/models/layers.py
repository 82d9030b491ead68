"""Transformer building blocks (counterpart of `repro.models.layers`):
norms, RoPE, grouped-query attention (materialised, chunked online
softmax, sliding window, one-token decode), SwiGLU and GeLU MLPs.

Plain functions on tensors.  `p` is the module that holds a block's
parameters under the reference's names (`p.wq`, `p.scale`, ...).  The
chunked attention is kernel K7: on a CUDA tensor `_sdpa_chunked`
launches `kernels/csrc/flash_attention.cu`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as _flash

NEG = -1e30  # the reference's masked score

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * weight.float()).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def apply_norm(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    if cfg.use_layernorm:
        return layer_norm(x, p.scale, p.bias, cfg.norm_eps)
    return rms_norm(x, p.scale, cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (float(theta) ** exps)  # a Python base: no host-to-device copy


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Rotates
    in float32 and casts back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) @ w (D, ...) -> (B, S, ...)."""
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _project_qkv(x: torch.Tensor, p, cfg: ModelConfig):
    """x: (B,S,D) -> q (B,S,n,h), k,v (B,S,m,h)."""
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def _sdpa_full(q, k, v, causal: bool, window: Optional[int], q_offset: int = 0):
    """Materialised-scores attention for short sequences (plain torch, as
    in the reference, where it is outside any Pallas kernel).
    q: (B,Sq,n,h), k/v: (B,Sk,m,h) with n = m*g."""
    B, Sq, n, h = q.shape
    Sk, m = k.shape[1], k.shape[2]
    g = n // m
    qh = q.reshape(B, Sq, m, g, h)
    scale = 1.0 / math.sqrt(h)
    scores = torch.einsum("bqmgh,bkmh->bmgqk", qh, k).float() * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    w = torch.softmax(torch.where(mask, scores, NEG), dim=-1).to(q.dtype)
    out = torch.einsum("bmgqk,bkmh->bqmgh", w, v)
    return out.reshape(B, Sq, n, h)


def _sdpa_chunked(q, k, v, causal: bool, window: Optional[int], chunk: int):
    """Online-softmax attention over KV chunks, (B,S,n,h) q and (B,S,m,h)
    k/v.  Kernel K7: a CUDA tensor launches the flash-attention kernel
    (grouped heads read in place), a CPU tensor runs its plain version,
    the reference's recurrence."""
    return _flash.attention(q, k, v, causal, window, chunk)


def attention(x: torch.Tensor, p, cfg: ModelConfig, positions=None, causal: bool = True,
              return_kv: bool = False):
    """Full-sequence attention (prefill)."""
    B, S, D = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    if cfg.use_rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    # the reference's dispatch: chunked online softmax only where the S^2
    # score tensor is the memory problem
    if S > max(cfg.attn_full_max, 2 * cfg.attn_chunk) and S % cfg.attn_chunk == 0:
        out = _sdpa_chunked(q, k, v, causal, cfg.sliding_window, cfg.attn_chunk)
    else:
        out = _sdpa_full(q, k, v, causal, cfg.sliding_window)
    y = _proj(out.reshape(B, S, -1), p.wo.reshape(-1, D))
    if return_kv:
        return y, (k, v)
    return y


def decode_attention(xt: torch.Tensor, p, cfg: ModelConfig, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int):
    """One-token attention against a KV cache.

    xt: (B,1,D); cache_k/v: (B,W,m,h); pos: the position being written.
    Returns (y (B,1,D), cache_k, cache_v).  The caches are updated IN
    PLACE (the reference returns new arrays, donated by its jit).  W is
    the full context for dense archs or the sliding window for SWA archs,
    whose writes wrap: slot = pos % W."""
    B = xt.shape[0]
    q, k, v = _project_qkv(xt, p, cfg)
    if cfg.use_rope:
        posb = torch.full((B, 1), pos, dtype=torch.int32, device=xt.device)
        q = apply_rope(q, posb, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_theta)
    W = cache_k.shape[1]
    slot = pos % W if cfg.sliding_window is not None else min(pos, W - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    m = cache_k.shape[2]
    n, h = q.shape[2], q.shape[3]
    g = n // m
    qh = q.reshape(B, m, g, h).float()
    scale = 1.0 / math.sqrt(h)
    s = torch.einsum("bmgh,bwmh->bmgw", qh, cache_k.float()) * scale  # (B,m,g,W)
    wpos = torch.arange(W, device=xt.device)
    if cfg.sliding_window is not None and pos >= W:
        valid = torch.ones(W, dtype=torch.bool, device=xt.device)  # warm rolling buffer
    else:
        valid = wpos <= slot
    w = torch.softmax(torch.where(valid, s, NEG), dim=-1)
    out = torch.einsum("bmgw,bwmh->bmgh", w, cache_v.float())
    out = out.reshape(B, 1, n * h).to(xt.dtype)
    y = _proj(out, p.wo.reshape(-1, xt.shape[-1]))
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "silu":
        h = F.silu(_proj(x, p.wi)) * _proj(x, p.wg)
    else:
        h = _proj(x, p.wi)
        if getattr(p, "bi", None) is not None:
            h = h + p.bi.to(x.dtype)
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    y = _proj(h, p.wo)
    if getattr(p, "bo", None) is not None:
        y = y + p.bo.to(x.dtype)
    return y
