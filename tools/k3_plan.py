#!/usr/bin/env python3
"""The sketch scatter (K3) under every launch plan its kernel takes, on one card.

    python3 tools/k3_plan.py            # from the repository root
    python3 tools/k3_plan.py --widths 1024 2048 4096 --lanes 2048 4096 8192 \
        --out chiprun_out/k3_plan_wide.jsonl

For each lane count of LANES (smallest first), width of WIDTHS (D = 4)
and key mix of `chip_smoke.SKETCH_KEYS` (uniform, Zipf a = 1.3, one hub
source), on `chip_smoke.sketch_batch`'s operands (seed 3), runs the
fused entry (`sketch.launch(..., fused=True, plan)`, the one the paths
launch) under every grid of GRID_LANES lanes a CTA and GRID_THREADS
threads, in each mode (direct or private degree rows), holds each
result and the coordinates entry's to the plain versions bit for bit,
and times the call (`chip_smoke._time_ms`:
CUDA events with a device sleep ahead of the start event, median of
REPS) in two passes, plans in order and then reversed.  An empty launch
(`torch.cuda._sleep(0)`) is timed the same way, as the floor.

`--lanes` and `--widths` replace LANES and WIDTHS.  Every (size,
width, keys, plan) goes as a JSON line to `--out` (default
chiprun_out/k3_plan.jsonl); standard output gets the card's name and
power limit, the floor, and for each (size, width, keys) the plan
`launch_plan` picks with its time, the fastest plan, and the fastest
plan of each mode.
"""
import argparse
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
from repro_torch.kernels import sketch as SK  # noqa: E402

LANES = (64, 256, 512, 1_024, 2_048, 4_096, 8_192)
WIDTHS = (256, 512)
DEPTH = 4
GRID_LANES = (32, 64, 128, 256, 512, 1_024, 2_048, 4_096, 8_192)
GRID_THREADS = (128, 256, 512, 1_024)
REPS = 10
OUT = ROOT / "chiprun_out" / "k3_plan.jsonl"


def grids(n):
    """Every (ctas, threads) of GRID_LANES x GRID_THREADS at n lanes, a
    CTA's threads cut to its lanes rounded up to a warp."""
    out = set()
    for lanes in GRID_LANES:
        if lanes > max(n, GRID_LANES[0]) * 2:
            continue
        ctas = -(-n // lanes)
        chunk = SK.cta_lanes(n, ctas)
        for threads in GRID_THREADS:
            out.add((ctas, min(threads, -(-chunk // 32) * 32)))
    return sorted(out)


def plans(n, D, W):
    privs = (False, True) if SK.rows_fit(D, W) else (False,)
    return [SK.Plan(c, t, p) for c, t in grids(n) for p in privs]


def mode_name(plan):
    return "private" if plan.private else "direct"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, nargs="+", default=LANES)
    ap.add_argument("--widths", type=int, nargs="+", default=WIDTHS)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k3_plan: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    floor = chip_smoke._time_ms(torch, lambda: torch.cuda._sleep(0), (), (), 4 * REPS)
    print("k3 floor", json.dumps({"empty_launch_ms": floor}), flush=True)
    args.out.parent.mkdir(exist_ok=True)
    with args.out.open("w") as out:
        for n in args.lanes:
            for W in args.widths:
                for dist in chip_smoke.SKETCH_KEYS:
                    base, src, dst, cnt = chip_smoke.sketch_batch(
                        torch, dev, np.random.default_rng(3), DEPTH, W, n, dist)
                    r, c = SK.node_hash(src, DEPTH, W), SK.node_hash(dst, DEPTH, W)
                    want = SK.sketch_absorb_ref(*(b.clone() for b in base), src, dst, cnt)
                    own = SK.launch_plan(n, DEPTH, W)
                    todo = plans(n, DEPTH, W)
                    todo += [own] if own not in todo else []
                    for plan in todo:
                        for fused, (a, b) in ((False, (r, c)), (True, (src, dst))):
                            got = SK.launch(*(x.clone() for x in base), a, b, cnt, fused, plan)
                            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                                raise AssertionError(f"K3 != plain at n={n} W={W} {dist} "
                                                     f"fused={fused} {plan}")
                    ms = {p: [] for p in todo}
                    for order in (todo, todo[::-1]):
                        for plan in order:
                            ms[plan].append(chip_smoke._time_ms(
                                torch, lambda *x, p=plan: SK.launch(*x, True, p), base,
                                (src, dst, cnt), REPS))
                    for plan, times in ms.items():
                        out.write(json.dumps({"lanes": n, "width": W, "keys": dist,
                                              "plan": plan._asdict(), "ms": times,
                                              "own_plan": plan == own}) + "\n")
                    best = {m: min((p for p in todo if mode_name(p) == m),
                                   key=lambda p: min(ms[p]))
                            for m in sorted({mode_name(p) for p in todo})}
                    fastest = min(todo, key=lambda p: min(ms[p]))
                    print("k3 plan", json.dumps({
                        "lanes": n, "width": W, "keys": dist,
                        "own": [own.ctas, own.threads, mode_name(own), ms[own]],
                        "fastest": [fastest.ctas, fastest.threads, mode_name(fastest),
                                    ms[fastest]],
                        "by_mode": {m: [p.ctas, p.threads, min(ms[p])] for m, p in best.items()},
                    }), flush=True)


if __name__ == "__main__":
    main()
