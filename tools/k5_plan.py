#!/usr/bin/env python3
"""The pattern miner (K5) under every cluster plan its kernel takes, on one card.

    python3 tools/k5_plan.py            # from the repository root

For each batch size of LANES, on `chip_smoke._mine_batch`'s random and
patterned batches (seed 2, star_min 4, hot_min 2), launches
`pattern_mine.launch` with C = 1, 2, 4 and 8 CTAs in each vector's
cluster, wherever the kernel takes C (the table fits the cluster and a
CTA has at most 8 lanes a thread), holds each result to
`pattern_mine_ref` bit for bit, and prints one JSON line a (size, kind,
C): the call's CUDA-event time (`chip_smoke._time_ms`, median of 20)
in two passes, C rising then falling, and whether `cluster_plan` picks
that C.  The card's name and power limit come first.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import pattern_mine as PM  # noqa: E402

LANES = (256, 512, 1_024, 2_048, 4_096, 8_192, 16_384, 65_536)
KINDS = ("random", "patterned")
REPS = 20


def plans(n):
    """Every C the kernel takes at n lanes."""
    slots = 2 * max(n, PM.MIN_TABLE_LANES)
    return [c for c in (1, 2, 4, 8)
            if n % c == 0 and slots // c <= PM.SLOTS_PER_CTA and n // c <= 8 * 1_024]


def main():
    if not torch.cuda.is_available():
        sys.exit("k5_plan: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for n in LANES:
        for kind in KINDS:
            args = tuple(t.to(dev) for t in chip_smoke._mine_batch(
                torch, np.random.default_rng(2), n, kind)) + (4, 2)
            want = PM.pattern_mine_ref(*args)
            ms = {}
            for order in (plans(n), plans(n)[::-1]):
                for c in order:
                    got = PM.launch(*args, c)
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(f"pattern_mine != plain at n={n} {kind} C={c}")
                    ms.setdefault(c, []).append(chip_smoke._time_ms(
                        torch, lambda *a, c=c: PM.launch(*a, c), (), args, REPS))
            for c, times in ms.items():
                print("k5 plan", json.dumps({"lanes": n, "kind": kind, "ctas": c, "ms": times,
                                             "own_plan": c == PM.cluster_plan(n)}), flush=True)


if __name__ == "__main__":
    main()
