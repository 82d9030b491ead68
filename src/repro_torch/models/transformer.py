"""Decoder-only dense LM (counterpart of `repro.models.transformer`):
its modules, forward, prefill and one-token decode step.

Each module holds its parameters under the reference's names and
shapes (the reference's `*_specs` trees), drawn by a `ParamInit`; the
layer stack is an `nn.ModuleList` walked by a Python loop where the
reference scans stacked layers.  The decode cache keeps the
reference's layout, one (L, B, W, m, h) tensor each for k and v.
MoE layers come with a later slice (`models.model` raises for them).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import ParamInit, torch_dtype

Cache = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# Modules (the reference's param specs)
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, d: int, mk: ParamInit):
        super().__init__()
        self.scale = mk((d,), "ones")
        self.bias = mk((d,), "zeros") if cfg.use_layernorm else None


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, mk: ParamInit):
        super().__init__()
        D, n, m, h = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        self.wq = mk((D, n, h))
        self.wk = mk((D, m, h))
        self.wv = mk((D, m, h))
        self.wo = mk((n, h, D))
        if cfg.qkv_bias:
            self.bq = mk((n, h), "zeros")
            self.bk = mk((m, h), "zeros")
            self.bv = mk((m, h), "zeros")
        if cfg.qk_norm:
            self.q_norm = mk((h,), "ones")
            self.k_norm = mk((h,), "ones")


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, d_ff: int, mk: ParamInit):
        super().__init__()
        D = cfg.d_model
        self.wi = mk((D, d_ff))
        if cfg.act == "silu":
            self.wg = mk((D, d_ff))
            self.wo = mk((d_ff, D))
        else:
            self.bi = mk((d_ff,), "zeros")
            self.wo = mk((d_ff, D))
            self.bo = mk((D,), "zeros")


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, mk: ParamInit):
        super().__init__()
        self.attn_norm = Norm(cfg, cfg.d_model, mk)
        self.attn = Attention(cfg, mk)
        self.mlp_norm = Norm(cfg, cfg.d_model, mk)
        self.mlp = MLP(cfg, cfg.d_ff, mk)


class TransformerLM(nn.Module):
    """Embedding, `num_layers` decoder layers, final norm, and an untied
    head unless the config ties it to the embedding."""

    def __init__(self, cfg: ModelConfig, mk: ParamInit):
        super().__init__()
        V, D = cfg.padded_vocab, cfg.d_model
        self.embed = mk((V, D), "small_normal")
        self.final_norm = Norm(cfg, D, mk)
        self.layers = nn.ModuleList(DecoderLayer(cfg, mk) for _ in range(cfg.num_layers))
        self.head = None if cfg.tie_embeddings else mk((D, V))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def layer_body(x: torch.Tensor, lp: DecoderLayer, cfg: ModelConfig, positions=None):
    """One decoder layer."""
    h = L.apply_norm(x, lp.attn_norm, cfg)
    x = x + L.attention(h, lp.attn, cfg, positions=positions)
    h = L.apply_norm(x, lp.mlp_norm, cfg)
    return x + L.mlp(h, lp.mlp, cfg)


def embed_tokens(model: nn.Module, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[tokens.long()].to(torch_dtype(cfg.dtype))


def unembed(model: nn.Module, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ model.embed.to(h.dtype).t()  # (.., D) x (D, V)
    return h @ model.head.to(h.dtype)


def lm_forward(model: TransformerLM, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens: (B, S) int -> (logits (B,S,V), aux), aux 0 (no MoE router
    loss in a dense model)."""
    h = embed_tokens(model, cfg, tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for lp in model.layers:
        h = layer_body(h, lp, cfg, positions=positions)
    h = L.apply_norm(h, model.final_norm, cfg)
    return unembed(model, cfg, h), torch.zeros((), dtype=torch.float32, device=h.device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, context: int) -> Dict[str, Tuple[tuple, str]]:
    """Name -> (shape, dtype name) of the decode cache.  context = the
    full KV length, or the sliding window for SWA archs."""
    W = context if cfg.sliding_window is None else min(context, cfg.sliding_window)
    kv = ((cfg.num_layers, batch, W, cfg.num_kv_heads, cfg.resolved_head_dim), cfg.dtype)
    return {"k": kv, "v": kv}


def _pack_swa_cache(k: torch.Tensor, pos_end: int, W: int) -> torch.Tensor:
    """The last W entries of a (B,S,m,h) K/V in rolling-buffer slot order,
    so decode continues with slot = pos % W."""
    S = k.shape[1]
    slots = torch.arange(S - W, S, device=k.device) % W
    buf = torch.zeros((k.shape[0], W) + tuple(k.shape[2:]), dtype=k.dtype, device=k.device)
    buf[:, slots] = k[:, S - W:]
    return buf


def lm_prefill(model: TransformerLM, cfg: ModelConfig, tokens: torch.Tensor):
    """Process the whole prompt; return (last-token logits (B,V), cache)."""
    h = embed_tokens(model, cfg, tokens)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device)[None, :]
    W = S if cfg.sliding_window is None or cfg.sliding_window >= S else cfg.sliding_window
    shape, dt = cache_specs(cfg, B, W)["k"]
    cache = {name: torch.empty(shape, dtype=torch_dtype(dt), device=h.device)
             for name in ("k", "v")}
    for i, lp in enumerate(model.layers):
        hn = L.apply_norm(h, lp.attn_norm, cfg)
        a, (k, v) = L.attention(hn, lp.attn, cfg, positions=positions, return_kv=True)
        h = h + a
        hn = L.apply_norm(h, lp.mlp_norm, cfg)
        h = h + L.mlp(hn, lp.mlp, cfg)
        if W < S:
            k, v = _pack_swa_cache(k, S, W), _pack_swa_cache(v, S, W)
        cache["k"][i] = k
        cache["v"][i] = v
    h = L.apply_norm(h[:, -1:], model.final_norm, cfg)
    return unembed(model, cfg, h)[:, 0], cache


def layer_decode(x, lp: DecoderLayer, cfg: ModelConfig, ck, cv, pos: int):
    h = L.apply_norm(x, lp.attn_norm, cfg)
    a, ck, cv = L.decode_attention(h, lp.attn, cfg, ck, cv, pos)
    x = x + a
    h = L.apply_norm(x, lp.mlp_norm, cfg)
    return x + L.mlp(h, lp.mlp, cfg), ck, cv


def lm_decode_step(model: TransformerLM, cfg: ModelConfig, cache: Cache, tokens: torch.Tensor,
                   pos: int):
    """tokens: (B,) int, pos: the position being written.  Returns
    (logits (B,V), cache), the cache updated in place."""
    h = embed_tokens(model, cfg, tokens[:, None])
    for i, lp in enumerate(model.layers):
        h, _, _ = layer_decode(h, lp, cfg, cache["k"][i], cache["v"][i], pos)
    h = L.apply_norm(h, model.final_norm, cfg)
    return unembed(model, cfg, h)[:, 0], cache
