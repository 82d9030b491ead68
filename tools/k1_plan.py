#!/usr/bin/env python3
"""The fused upsert (K1) under every cluster width its kernel takes, on one card.

    python3 tools/k1_plan.py            # from the repository root

For the node table (cap 2^20, 128 to 16,384 lanes), the edge table (cap
2^21, 64 to 8,192 lanes) and the GraphZip dictionary (cap 4,096, 64 to
8,192 lanes, budget 16), at loads 0 and 0.5 (budget 32 in the store),
and at loads 0.7 and 0.85 with budget 128 at the store's widest sweeps,
on `chip_smoke.upsert_batch`'s batches (seed 3: 30% of the lanes present,
10% invalid), launches `upsert.launch` with C = 1, 2, 4, 8 and 16 CTAs
wherever a CTA gets at least a warp's lanes and at most MAX_CTA_LANES,
holds each result to `fused_upsert_ref` bit for bit (table, slot,
is_new), and prints one JSON line a (table, lanes, load, budget, C): the
call's CUDA-event time (`chip_smoke._time_ms`, median of 20) in two
passes, C rising then falling, the most rounds a lane took, and whether
`cluster_plan` picks that C.  The card's name and power limit come first.

First it builds `tools/l2_chase.cu` and prints the round trip of one
thread's dependent loads through a random cycle over tables of the node
and edge tables' sizes (8 and 16 MB, each just copied, as phase 1's
timed copies are) and over 4 KB, for K1's load, `__ldcg`'s and a plain
one: clock64 cycles a load and, from CUDA events around the walk, ns a
load.  A round of K1 waits for at least one such round trip, so
`max_rounds` of them is the floor of a round-synchronous sweep.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, upsert  # noqa: E402

REPS = 20
# (table, cap, lane counts, loads, budget)
SWEEPS = (
    ("node", 1 << 20, tuple(1 << k for k in range(7, 15)), (0.0, 0.5), 32),
    ("edge", 1 << 21, tuple(1 << k for k in range(6, 14)), (0.0, 0.5), 32),
    ("dict", 4_096, (64, 512, 2_048, 8_192), (0.0, 0.5), 16),
    ("node", 1 << 20, (16_384,), (0.7, 0.85), 128),
    ("edge", 1 << 21, (8_192,), (0.7, 0.85), 128),
)
CHASE_SLOTS = (1 << 9, 1 << 20, 1 << 21)  # 4 KB, and the node and edge tables
CHASE_HOPS = 4_096
CHASE_LOADS = ("ld.relaxed.gpu (K1)", "ld.global.cg (__ldcg)", "ld.global")


def l2_round_trip(dev):
    """Prints the round trip of dependent loads at CHASE_SLOTS slots."""
    lib_path = build.BUILD_DIR / "libl2_chase.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(ROOT / "tools" / "l2_chase.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).chase_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cpu").manual_seed(6)
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for slots in CHASE_SLOTS:
        order = torch.randperm(slots, generator=gen)
        cycle = torch.empty(slots, dtype=torch.int64)
        cycle[order] = order.roll(-1)  # one cycle through every slot
        base = cycle.to(dev)
        for flavour, name in enumerate(CHASE_LOADS):
            cycles, ns = [], []
            for _ in range(5):
                table = base.clone()  # just written, as a timed K1 table is
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                if fn(table.data_ptr(), CHASE_HOPS, flavour, out.data_ptr(), stream) != 0:
                    raise RuntimeError("l2_chase launch failed")
                end.record()
                torch.cuda.synchronize()
                cycles.append(int(out[0]) / CHASE_HOPS)
                ns.append(start.elapsed_time(end) * 1e6 / CHASE_HOPS)
            print("l2 chase", json.dumps({"bytes": 8 * slots, "load": name, "hops": CHASE_HOPS,
                                          "cycles_per_load": sorted(cycles)[2],
                                          "ns_per_load": sorted(ns)[2]}), flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("k1_plan: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    l2_round_trip(dev)
    rng = np.random.default_rng(3)
    for name, cap, sizes, loads, probes in SWEEPS:
        for load, table, fill_keys, m in cs.upsert_tables(torch, dev, rng, cap, max(sizes),
                                                          loads):
            budget = torch.tensor(probes, dtype=torch.int32, device=dev)
            for n in sizes:
                keys, valid = cs.upsert_batch(torch, dev, rng, fill_keys, m, n)
                want = upsert.fused_upsert_ref(table.clone(), keys, valid, budget)
                rounds = cs._least_bytes(torch, upsert.probe_hash, keys, valid, want[1],
                                         want[2], cap, probes)[2]
                widths = cs.upsert_widths(n)
                ms = {}
                for order in (widths, widths[::-1]):
                    for c in order:
                        got = upsert.launch(table.clone(), keys, valid, budget, c)
                        if not all(torch.equal(g, w) for g, w in zip(got, want)):
                            raise AssertionError(f"fused_upsert != plain: {name} n={n} "
                                                 f"load={load} C={c}")
                        ms.setdefault(c, []).append(cs._time_ms(
                            torch, lambda *a, c=c: upsert.launch(*a, c), table,
                            (keys, valid, budget), REPS))
                for c, times in ms.items():
                    print("k1 plan", json.dumps({
                        "table": name, "cap": cap, "lanes": n, "load": load, "probes": probes,
                        "ctas": c, "ms": times, "max_rounds": rounds,
                        "own_plan": c == upsert.cluster_plan(n)}), flush=True)


if __name__ == "__main__":
    main()
