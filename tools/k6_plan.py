#!/usr/bin/env python3
"""The Bloom kernels (K6a probe, K6b build and their fused entry) under every plan, on one card.

    python3 tools/k6_plan.py            # from the repository root

Builds `csrc/bloom.cu` as `kernels/build.py` does and prints each
kernel's registers and spills.  At `chip_smoke.py` phase 15's shapes (2,
16 and 64 rows, each at 64, 1,024 and 16,384 uniform keys, into a filter
already in use), at EXTRA's and at the diversity step's (64 rows, 16,384
Zipf keys into the filter of 60 earlier steps), holds the build, the fused entry and
the probe to the plain versions bit for bit under every plan of
`bloom.build_plans` (the build's, and the fused entry's on the grid
route) and `bloom.probe_plans` (the sweep and `launch_plan`'s), then
times each (`chip_smoke._time_ms`: CUDA events
with a device sleep ahead of the start event, median of REPS) in two
passes, plans in order and then reversed.  An empty launch
(`torch.cuda._sleep(0)`) is timed the same way, as the floor.

Every (shape, entry, plan) goes as a JSON line to `--out` (default
chiprun_out/k6_plan.jsonl).  Standard output gets the card's name and
power limit, the floor, and for each shape and entry the planned plan's
times and the fastest plan's.
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
from repro_torch.kernels import bloom as BL  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

REPS = 20
OUT = ROOT / "chiprun_out" / "k6_plan.jsonl"
STEP_WARMUP = 60  # diversity steps before the timed one
# where the plan changes route (2,048 to 8,192 keys)
EXTRA = ((64, 2_048), (64, 4_096), (64, 8_192))


def shapes(dev):
    """[(label, keys, start, queries)] at phase 15's shapes and the
    diversity step's, from its generators."""
    rng = np.random.default_rng(4)
    out = []
    for rows in chip_smoke.BLOOM_ROWS:
        for n in chip_smoke.BLOOM_LANES:
            start = chip_smoke._bloom_filter(torch, dev, rng, rows)
            keys = torch.from_numpy(rng.integers(0, 2**32, size=n)).to(dev)
            queries = torch.cat([keys[: n // 2],
                                 torch.from_numpy(rng.integers(0, 2**32, size=n // 2)).to(dev)])
            out.append((f"{rows}x{n}", keys, start, queries))
    for rows, n in EXTRA:
        start = chip_smoke._bloom_filter(torch, dev, rng, rows)
        keys = torch.from_numpy(rng.integers(0, 2**32, size=n)).to(dev)
        out.append((f"{rows}x{n}", keys, start, keys))
    pool = rng.integers(0, 2**32, size=1 << 18)
    n = chip_smoke.BLOOM_LANES[-1]
    bm = BL.init_bitmap(chip_smoke.DIVERSITY_ROWS, device=dev)
    for _ in range(STEP_WARMUP):
        bm = BL.bloom_build_plain(torch.from_numpy(chip_smoke._bloom_zipf(rng, pool, n)).to(dev),
                                  bm)
    keys = torch.from_numpy(chip_smoke._bloom_zipf(rng, pool, n)).to(dev)
    out.append((f"step {chip_smoke.DIVERSITY_ROWS}x{n} zipf", keys, bm, keys))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k6_plan: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    path, job = build._start("bloom")
    for line in build._finish("bloom", path, job).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"k6 build: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    floor = chip_smoke._time_ms(torch, lambda: torch.cuda._sleep(0), (), (), 4 * REPS)
    print("k6 floor", json.dumps({"empty_launch_ms": floor}), flush=True)

    args.out.parent.mkdir(exist_ok=True)
    with args.out.open("w") as out:
        for label, keys, start, queries in shapes(dev):
            rows, n = start.shape[0], keys.shape[0]
            chip_smoke.bloom_hold(torch, label, keys, start, queries)
            built = BL.bloom_build_plain(keys, start)
            own = {"bloom_probe": BL.launch_plan(rows, n), "bloom_build": BL.launch_plan(rows, n),
                   "bloom_diversity": BL.launch_plan(rows, n, fused=True)}
            todo = ([("bloom_build", p) for p in BL.build_plans(rows, n)]
                    + [("bloom_diversity", p) for p in BL.build_plans(rows, n, fused=True)]
                    + [("bloom_probe", p) for p in BL.probe_plans(rows, n)])
            ms = {job: [] for job in todo}
            for order in (todo, todo[::-1]):
                for entry, plan in order:
                    call = ((queries, built) if entry == "bloom_probe" else (keys, start))
                    ms[(entry, plan)].append(chip_smoke._time_ms(
                        torch, lambda *a, e=entry, p=plan: BL.launch(e, *a, p), (), call, REPS))
            for (entry, plan), times in ms.items():
                out.write(json.dumps({"shape": label, "rows": rows, "lanes": n, "entry": entry,
                                      "plan": plan._asdict(), "ms": times,
                                      "own_plan": plan == own[entry]}) + "\n")
            for entry in ("bloom_probe", "bloom_build", "bloom_diversity"):
                mine = {p: t for (e, p), t in ms.items() if e == entry}
                fastest = min(mine, key=lambda p: max(mine[p]))
                row = {"shape": label, "entry": entry, "own": [list(own[entry]), mine[own[entry]]],
                       "fastest": [list(fastest), mine[fastest]]}
                print("k6 plan", json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
