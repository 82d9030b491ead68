"""Decode-cache lifecycle for serving (counterpart of
`repro.serving.kvcache`).

Cache shapes live with each model family (`models.model.cache_specs`);
this module allocates a cache to a horizon, grows a prefill cache into
the serving buffer, and sizes it.  SWA archs keep a rolling window
(slot = pos % window, as `models.layers.decode_attention` and
`transformer._pack_swa_cache` do).
"""
from __future__ import annotations

from typing import Dict, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.params import torch_dtype


def alloc_cache(cfg: ModelConfig, batch: int, horizon: int,
                device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """A zero-filled decode cache for `horizon` total positions."""
    return {name: torch.zeros(shape, dtype=torch_dtype(dt), device=device)
            for name, (shape, dt) in M.cache_specs(cfg, batch, horizon).items()}


def pad_cache_to(cache: Dict[str, torch.Tensor], total_len: int) -> Dict[str, torch.Tensor]:
    """Grow prefill caches (length = prompt) to the serving horizon.  K/V
    tensors are (L, B, S, m, h) and are zero-padded along S; SSM states
    are length-free and pass through untouched."""
    out = {}
    for name, x in cache.items():
        if name in ("k", "v") and x.dim() == 5 and total_len > x.shape[2]:
            x = F.pad(x, (0, 0, 0, 0, 0, total_len - x.shape[2]))
        out[name] = x
    return out


def cache_bytes(cfg: ModelConfig, batch: int, horizon: int) -> int:
    """Serving-capacity planning: bytes of the decode cache."""
    total = 0
    for shape, dt in M.cache_specs(cfg, batch, horizon).values():
        n = 1
        for s in shape:
            n *= s
        total += n * torch.empty((), dtype=torch_dtype(dt)).element_size()
    return total
