"""Batched serving entry point: prefill a batch of prompts, then decode greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --smoke \\
      --batch 4 --prompt-len 32 --gen 16 --device cpu
  python -m repro_torch.launch.serve --arch mamba2-780m --batch 4 --prompt-len 4096

Counterpart of `repro.launch.serve`, with the same flags and printout,
plus `--device {cuda,cpu}` (default the card).  The weights are random,
drawn from seed 0 at the config's published widths (or the smoke
widths with `--smoke`), in the config's dtype; nothing is downloaded.
`main()` returns the generated ids, (batch, gen) int32; `run()` returns
them with the timings and every step's logits; `serve()` times the loop
over a given model and prompt batch.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve
from repro_torch.models import model as M
from repro_torch.serving.decode import generate


@dataclasses.dataclass
class ServeRun:
    """What `serve` did: the generated ids (B, gen) int32, the prefill
    and decode wall times (the device synchronised before each clock
    read), decode tokens per second, and the logits of the prefill and
    of each decode step, (B, V) each, on the device."""

    cfg: ModelConfig
    gen: np.ndarray
    prefill_ms: float
    decode_ms: float
    tok_per_s: float
    logits: List[torch.Tensor]


def serve(cfg: ModelConfig, model, tokens: torch.Tensor, gen: int) -> ServeRun:
    """Prefill `tokens` (B, S) on the model's device, then decode gen - 1
    greedy steps through `serving.decode.generate`, keeping each step's
    logits."""
    seen: List[torch.Tensor] = []
    ids, t_prefill, t_decode = generate(cfg, model, tokens, gen, keep=seen)
    tps = tokens.shape[0] * (gen - 1) / max(t_decode, 1e-9)
    return ServeRun(cfg, ids, t_prefill * 1e3, t_decode * 1e3, tps, seen)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def deployment(args: argparse.Namespace):
    """(cfg, the model with seed-0 weights on the device, the prompt
    tokens (batch, prompt_len) int32) that the flags name."""
    device = resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    tok = HashTokenizer(cfg.vocab_size)
    prompts = [f"user{i} says politics election vote #topic{i%3}" for i in range(args.batch)]
    tokens = torch.from_numpy(tok.encode_batch(prompts, args.prompt_len))
    return cfg, M.init_params(cfg, device, seed=0), tokens


def run(argv: Optional[List[str]] = None) -> ServeRun:
    args = parse_args(argv)
    cfg, model, tokens = deployment(args)

    out = serve(cfg, model, tokens, args.gen)
    print(f"prefill {args.prompt_len} toks x {args.batch} seqs: {out.prefill_ms:.1f} ms")
    print(f"decode  {args.gen-1} steps: {out.decode_ms:.1f} ms  ({out.tok_per_s:.1f} tok/s)")
    print("generated ids[0][:8]:", out.gen[0][:8].tolist())
    return out


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    return run(argv).gen


if __name__ == "__main__":
    main()
