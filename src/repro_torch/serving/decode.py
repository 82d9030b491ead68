"""Batched serving loop (counterpart of `repro.serving.decode`).

`generate` runs prefill, then lock-step greedy decode across the batch
through `make_serve_step`; `BatchServer` owns a model and keeps the
loop's statistics, and `launch.serve` times the same loop.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serving.kvcache import pad_cache_to
from repro_torch.train.trainstep import make_serve_step


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (the host clock's end point)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(cfg: ModelConfig, model, tokens: torch.Tensor, max_new: int,
             stop_token: Optional[int] = None, keep: Optional[List[torch.Tensor]] = None
             ) -> Tuple[np.ndarray, float, float]:
    """Prefill `tokens` (B, S) on the model's device, grow the cache to
    S + max_new positions, then decode greedily until `max_new` tokens or
    every sequence's `stop_token`.  Returns ((B, n) int32 ids, n <= max_new,
    prefill seconds, decode seconds), the device synchronised before each
    clock read.  Where `keep` is given, the prefill's logits and each
    decode step's, (B, V) each on the device, are appended to it."""
    device = next(model.parameters()).device
    tokens = tokens.to(device)
    prompt_len = tokens.shape[1]
    t0 = time.perf_counter()
    logits, cache = M.prefill(model, cfg, {"tokens": tokens})
    cache = pad_cache_to(cache, prompt_len + max_new)
    sync(device)
    t_prefill = time.perf_counter() - t0

    if keep is not None:
        keep.append(logits)
    step = make_serve_step(cfg, keep)
    next_tok = logits.argmax(dim=-1).to(torch.int32)
    out = [next_tok.cpu().numpy()]
    t0 = time.perf_counter()
    for i in range(max_new - 1):
        next_tok, cache = step(model, cache, next_tok, prompt_len + i)
        out.append(next_tok.cpu().numpy())
        if stop_token is not None and bool((out[-1] == stop_token).all()):
            break
    sync(device)
    return np.stack(out, axis=1), t_prefill, time.perf_counter() - t0


class BatchServer:
    def __init__(self, cfg: ModelConfig, model, horizon: int = 256):
        self.cfg = cfg
        self.model = model
        self.horizon = horizon
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "tokens": 0}

    def generate(self, batch: dict, max_new: int = 32,
                 stop_token: Optional[int] = None) -> np.ndarray:
        """Prefill the prompt batch, then decode `max_new` tokens: (B, n)
        int32 ids, n <= max_new."""
        gen, t_prefill, t_decode = generate(self.cfg, self.model, batch["tokens"], max_new,
                                            stop_token)
        self.stats["prefill_s"] += t_prefill
        self.stats["decode_s"] += t_decode
        self.stats["tokens"] += int(gen.size)
        return gen

    @property
    def tokens_per_s(self) -> float:
        return self.stats["tokens"] / max(self.stats["decode_s"], 1e-9)
