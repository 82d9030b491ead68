"""Serving step (counterpart of `repro.train.trainstep.make_serve_step`).

The train step, its microbatching and the optimizer come with training,
in a later slice of the port."""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_serve_step(cfg: ModelConfig, keep: Optional[List[torch.Tensor]] = None):
    """One decode step: the greedy next token of every sequence.  Where
    `keep` is given, each step appends its logits (B, V) to it."""

    @torch.no_grad()
    def serve_step(model, cache, tokens, pos: int):
        logits, new_cache = M.decode_step(model, cfg, cache, tokens, pos)
        if keep is not None:
            keep.append(logits)
        return logits.argmax(dim=-1).to(tokens.dtype), new_cache

    return serve_step
