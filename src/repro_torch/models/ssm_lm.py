"""Pure-SSM (Mamba2) language model (counterpart of
`repro.models.ssm_lm`): its modules, forward, decode-cache shapes and
one-token decode step."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import Mamba2Mixer, mamba2_block
from repro_torch.models.params import ParamInit
from repro_torch.models.transformer import Norm, embed_tokens, unembed


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, mk: ParamInit):
        super().__init__()
        self.norm = Norm(cfg, cfg.d_model, mk)
        self.mamba = Mamba2Mixer(cfg, mk)


class SSMLM(nn.Module):
    """Embedding, `num_layers` Mamba2 layers, final norm, and an untied
    head unless the config ties it to the embedding."""

    def __init__(self, cfg: ModelConfig, mk: ParamInit):
        super().__init__()
        V, D = cfg.padded_vocab, cfg.d_model
        self.embed = mk((V, D), "small_normal")
        self.final_norm = Norm(cfg, D, mk)
        self.layers = nn.ModuleList(MambaLayer(cfg, mk) for _ in range(cfg.num_layers))
        self.head = None if cfg.tie_embeddings else mk((D, V))


def mamba_layer_body(x: torch.Tensor, lp: MambaLayer, cfg: ModelConfig) -> torch.Tensor:
    h = L.apply_norm(x, lp.norm, cfg)
    y, _ = mamba2_block(h, lp.mamba, cfg)
    return x + y


def ssm_lm_forward(model: SSMLM, cfg: ModelConfig, tokens: torch.Tensor):
    h = embed_tokens(model, cfg, tokens)
    for lp in model.layers:
        h = mamba_layer_body(h, lp, cfg)
    h = L.apply_norm(h, model.final_norm, cfg)
    return unembed(model, cfg, h), torch.zeros((), dtype=torch.float32, device=h.device)


# ---------------------------------------------------------------------------
# Decode: O(1) recurrent state per layer
# ---------------------------------------------------------------------------


def ssm_cache_specs(cfg: ModelConfig, batch: int, context: int) -> Dict[str, Tuple[tuple, str]]:
    """Name -> (shape, dtype name); the state's size does not depend on
    the context (the point of an SSM)."""
    del context
    nh, N, p = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    conv_ch = cfg.ssm_d_inner + 2 * N
    return {
        "state": ((cfg.num_layers, batch, nh, N, p), "float32"),
        "conv": ((cfg.num_layers, batch, cfg.ssm_conv - 1, conv_ch), cfg.dtype),
    }


def ssm_lm_decode_step(model: SSMLM, cfg: ModelConfig, cache, tokens: torch.Tensor, pos: int):
    """tokens (B,) -> (logits (B,V), cache), the cache's layers written
    in place (SSM decode is position-free: `pos` is unused)."""
    del pos
    h = embed_tokens(model, cfg, tokens[:, None])
    for i, lp in enumerate(model.layers):
        hn = L.apply_norm(h, lp.norm, cfg)
        y, (st, cv) = mamba2_block(hn, lp.mamba, cfg, state=cache["state"][i],
                                   conv_cache=cache["conv"][i], decode=True)
        cache["state"][i] = st
        cache["conv"][i] = cv
        h = h + y
    h = L.apply_norm(h, model.final_norm, cfg)
    return unembed(model, cfg, h)[:, 0], cache
