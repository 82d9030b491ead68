"""Model facade (counterpart of `repro.models.model`): family dispatch
for initialisation, forward, prefill, decode-cache shapes and the
one-token decode step.

The port serves the `dense` and `ssm` families; every other family
raises, naming the later slice that brings it.  `loss_fn` comes with
training.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm_lm, transformer
from repro_torch.models.mamba2 import mamba2_block
from repro_torch.models.params import ParamInit, torch_dtype

SERVED_FAMILIES = ("dense", "ssm")


def _require_served(cfg: ModelConfig) -> None:
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family is not ported yet; it comes with a "
            f"later slice of the port (ROADMAP Slice G); served: {SERVED_FAMILIES}")


def init_params(cfg: ModelConfig, device: Union[str, torch.device], seed: int = 0,
                dtype: Optional[Union[str, torch.dtype]] = None) -> nn.Module:
    """The model of `cfg` with random parameters drawn from `seed` on
    `device`, in `dtype` (default cfg.dtype), as the reference's
    `init_params(param_specs(cfg), key, dtype_override=...)` makes them:
    the same shapes and init kinds, not the same bits."""
    _require_served(cfg)
    mk = ParamInit(torch.device(device), torch_dtype(dtype or cfg.dtype), seed)
    if cfg.family == "ssm":
        return ssm_lm.SSMLM(cfg, mk)
    return transformer.TransformerLM(cfg, mk)


def forward(model: nn.Module, cfg: ModelConfig, batch: Dict):
    """(logits (B,S,V), aux) over batch["tokens"] (B,S)."""
    _require_served(cfg)
    if cfg.family == "ssm":
        return ssm_lm.ssm_lm_forward(model, cfg, batch["tokens"])
    return transformer.lm_forward(model, cfg, batch["tokens"])


def prefill(model: nn.Module, cfg: ModelConfig, batch: Dict):
    """(last-token logits (B,V), decode cache) over batch["tokens"]."""
    _require_served(cfg)
    if cfg.family == "ssm":
        return _ssm_prefill(model, cfg, batch["tokens"])
    return transformer.lm_prefill(model, cfg, batch["tokens"])


def _ssm_prefill(model: ssm_lm.SSMLM, cfg: ModelConfig, tokens: torch.Tensor):
    h = transformer.embed_tokens(model, cfg, tokens)
    states, convs = [], []
    for lp in model.layers:
        hn = L.apply_norm(h, lp.norm, cfg)
        y, (st, cv) = mamba2_block(hn, lp.mamba, cfg)
        h = h + y
        states.append(st)
        convs.append(cv.to(torch_dtype(cfg.dtype)))
    h = L.apply_norm(h[:, -1:], model.final_norm, cfg)
    logits = transformer.unembed(model, cfg, h)[:, 0]
    return logits, {"state": torch.stack(states), "conv": torch.stack(convs)}


def cache_specs(cfg: ModelConfig, batch: int, context: int):
    """Name -> (shape, dtype name) of the decode cache."""
    _require_served(cfg)
    if cfg.family == "ssm":
        return ssm_lm.ssm_cache_specs(cfg, batch, context)
    return transformer.cache_specs(cfg, batch, context)


def decode_step(model: nn.Module, cfg: ModelConfig, cache, tokens: torch.Tensor, pos: int):
    """(logits (B,V), cache) for one new token per sequence at `pos`;
    the cache is updated in place."""
    _require_served(cfg)
    if cfg.family == "ssm":
        return ssm_lm.ssm_lm_decode_step(model, cfg, cache, tokens, pos)
    return transformer.lm_decode_step(model, cfg, cache, tokens, pos)
