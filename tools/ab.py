#!/usr/bin/env python3
"""One measurement from two trees of this repository, in turns, on one card.

    python3 tools/ab.py PARENT_ROOT CHANGE_ROOT sharded
    python3 tools/ab.py PARENT_ROOT CHANGE_ROOT sketch
    python3 tools/ab.py PARENT_ROOT CHANGE_ROOT traffic
    python3 tools/ab.py PARENT_ROOT CHANGE_ROOT bloom
    python3 tools/ab.py PARENT_ROOT CHANGE_ROOT profiled

Runs the named measurement of each tree in a fresh process, in the order
parent, change, change, parent, so that both trees run on one card in
one call, and prints each run's output with its tree's label, after the
card's name and power limit.

  * sharded: the tree's own `chip_smoke.sharded_path` (phase 16:
    `launch.ingest --shards 4 --dict-compress`, 120 ticks) and
    `chip_smoke.sharded_breakdown` (phase 17: ticks 40 to 79 with spans
    on and under torch.profiler).
  * sketch: CHANGE_ROOT's `chip_smoke.py` driving each tree's
    `src/repro_torch`: the device kernels of one `sketch_update` call
    (`chip_smoke._device_kernels`, first, while the process is fresh) at
    `chip_smoke.SKETCH_UPDATE_LANES`; K3 on hash coordinates
    (`kernels.sketch.sketch_scatter`) and a sketch update's whole hash
    and scatter (`ops.sketch_absorb` where the tree has it, else
    `node_hash` twice and `sketch_scatter`), timed by
    `chip_smoke._time_ms` at `chip_smoke.SKETCH_LANES` lanes, D = 4,
    W = 512, uniform and Zipf keys; then the query path's and the
    sharded workload path's profiled windows
    (`chip_smoke.query_breakdown`, phase 7, and
    `chip_smoke.sharded_workload_breakdown`, phase 26).
  * traffic: CHANGE_ROOT's `chip_smoke.py` driving each tree's
    `src/repro_torch`: an empty launch and K4 through the public
    `kernels.sampler.traffic_ids` at phase 9's timed shapes (every
    registry scenario at burst levels 0 and 1, `chip_smoke.TRAFFIC_LANES`
    records, seed 0, ctr0 0; `chip_smoke._time_ms`, median of
    TRAFFIC_REPS); then the workload path's and the sharded workload
    path's profiled windows (`chip_smoke.workload_breakdown`, phase 11,
    and `chip_smoke.sharded_workload_breakdown`, phase 26), which print
    K4's device ms and launches by block size, device busy ms and the
    idle share.  A tree whose sampler has no `launch` (before the launch
    plan) has its launches routed through one, so that they are counted
    the same way.
  * bloom: CHANGE_ROOT's `chip_smoke.py` driving each tree's
    `src/repro_torch`: the device kernels of one `ops.bloom_diversity`
    step (`chip_smoke._device_kernels`, first, while the process is
    fresh), an empty launch, K6a and K6b through the public
    `ops.bloom_probe` and `ops.bloom_build` at phase 15's shapes (its
    generators and seed) and a diversity step (64 rows, 16,384 Zipf keys
    into the filter of 60 earlier steps), each timed by
    `chip_smoke._time_ms`, median of BLOOM_REPS.
  * profiled: each tree's own `chip_smoke.py`, after `build.build_all()`:
    its profiled phases (3, 7, 11 and 17, under torch.profiler) and
    phase 27 (the workload path with telemetry and the monitor), and
    phase 29 (`launch.lineage`) where the tree has it, each printing its
    seconds as `chip_smoke.py` does.

Each snippet gets CHANGE_ROOT and the tree's root as its arguments.
"""
import subprocess
import sys

TRAFFIC_REPS = 50
BLOOM_REPS = 50

SNIPPETS = {
    "sharded": ("import sys, torch; sys.path.insert(0, sys.argv[2]); import chip_smoke as cs; "
                "cs.sharded_path(torch); cs.sharded_breakdown(torch)"),
    "sketch": """
import json, sys, torch
from pathlib import Path
import numpy as np
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
sys.path.insert(0, sys.argv[2] + "/src")
import repro_torch
print("package", repro_torch.__file__)
assert Path(repro_torch.__file__).resolve().parents[1] == Path(sys.argv[2], "src").resolve()
from repro_torch.kernels import ops
from repro_torch.kernels.sketch import sketch_scatter
from repro_torch.query import sketch as QS

print("sketch_update device kernels a call", json.dumps({
    n: cs._device_kernels(torch, QS.sketch_update, cs._sketch_update_args(torch, n))
    for n in cs.SKETCH_UPDATE_LANES}), flush=True)
D, W, dev = 4, 512, torch.device("cuda")
absorb = getattr(ops, "sketch_absorb", None)

def update(ew, od, idg, src, dst, cnt):
    if absorb is not None:
        return absorb(ew, od, idg, src, dst, cnt)
    return sketch_scatter(ew, od, idg, QS.node_hash(src, D, W), QS.node_hash(dst, D, W), cnt)

for n in cs.SKETCH_LANES:
    for dist in ("uniform", "zipf"):
        base, src, dst, cnt = cs.sketch_batch(torch, dev, np.random.default_rng(1), D, W, n, dist)
        r, c = QS.node_hash(src, D, W), QS.node_hash(dst, D, W)
        print("k3 times", json.dumps({
            "lanes": n, "keys": dist,
            "sketch_scatter_ms": cs._time_ms(torch, sketch_scatter, base, (r, c, cnt),
                                             cs.KERNEL_REPS),
            "update_scatter_ms": cs._time_ms(torch, update, base, (src, dst, cnt),
                                             cs.KERNEL_REPS)}), flush=True)
cs.query_breakdown(torch)
cs.sharded_workload_breakdown(torch)
""",
    "traffic": """
import json, sys, torch
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
sys.path.insert(0, sys.argv[2] + "/src")
import repro_torch
print("package", repro_torch.__file__)
assert Path(repro_torch.__file__).resolve().parents[1] == Path(sys.argv[2], "src").resolve()
from repro_torch.kernels import sampler as S
from repro_torch.workloads.scenarios import list_scenarios

if not hasattr(S, "launch"):
    real = S._launch
    S.launch = lambda seed, ctr0, n, ip, fp, plan=None: real(seed, ctr0, n, ip, fp)
    S._launch = lambda *a: S.launch(*a)
REPS = %d
dev = torch.device("cuda")
print("k4 floor", json.dumps({"empty_launch_ms": cs._time_ms(
    torch, lambda: torch.cuda._sleep(0), (), (), REPS)}), flush=True)
for scn in list_scenarios():
    ip = torch.from_numpy(scn.iparams()).to(dev)
    for burst in (0.0, 1.0):
        fp = torch.from_numpy(scn.fparams(burst)).to(dev)
        for n in cs.TRAFFIC_LANES:
            print("k4 times", json.dumps({
                "scenario": scn.name, "burst": burst, "lanes": n,
                "ms": cs._time_ms(torch, S.traffic_ids, (), (0, 0, n, ip, fp), REPS)}),
                flush=True)
cs.workload_breakdown(torch)
cs.sharded_workload_breakdown(torch)
""" % TRAFFIC_REPS,
    "bloom": """
import json, sys, torch
from pathlib import Path
import numpy as np
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
sys.path.insert(0, sys.argv[2] + "/src")
import repro_torch
print("package", repro_torch.__file__)
assert Path(repro_torch.__file__).resolve().parents[1] == Path(sys.argv[2], "src").resolve()
from repro_torch.kernels import ops
from repro_torch.kernels.bloom import bloom_build_plain, init_bitmap

REPS = %d
dev = torch.device("cuda")
rng = np.random.default_rng(4)
pool = rng.integers(0, 2**32, size=1 << 18)
n = cs.BLOOM_LANES[-1]
bm = init_bitmap(cs.DIVERSITY_ROWS, device=dev)
for _ in range(60):
    bm = bloom_build_plain(torch.from_numpy(cs._bloom_zipf(rng, pool, n)).to(dev), bm)
batch = torch.from_numpy(cs._bloom_zipf(rng, pool, n)).to(dev)
print("k6 step device kernels", json.dumps({"device_kernels": cs._device_kernels(
    torch, ops.bloom_diversity, (batch, bm))}), flush=True)
print("k6 floor", json.dumps({"empty_launch_ms": cs._time_ms(
    torch, lambda: torch.cuda._sleep(0), (), (), REPS)}), flush=True)
rng = np.random.default_rng(4)
for rows in cs.BLOOM_ROWS:
    for m in cs.BLOOM_LANES:
        start = cs._bloom_filter(torch, dev, rng, rows)
        keys = torch.from_numpy(rng.integers(0, 2**32, size=m)).to(dev)
        queries = torch.cat([keys[: m // 2],
                             torch.from_numpy(rng.integers(0, 2**32, size=m // 2)).to(dev)])
        built = ops.bloom_build(keys, start)
        print("k6 times", json.dumps({
            "rows": rows, "lanes": m,
            "probe_ms": cs._time_ms(torch, ops.bloom_probe, (), (queries, built), REPS),
            "build_ms": cs._time_ms(torch, ops.bloom_build, (), (keys, start), REPS)}),
            flush=True)
print("k6 step", json.dumps({"rows": cs.DIVERSITY_ROWS, "lanes": n, "step_ms": cs._time_ms(
    torch, ops.bloom_diversity, (), (batch, bm), REPS)}), flush=True)
""" % BLOOM_REPS,
    "profiled": """
import subprocess, sys, time, torch
sys.path.insert(0, sys.argv[2])
import chip_smoke as cs
from repro_torch.kernels import build

build.build_all()
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip()
phases = [(3, cs.tick_breakdown, (torch,)), (7, cs.query_breakdown, (torch,)),
          (11, cs.workload_breakdown, (torch,)), (17, cs.sharded_breakdown, (torch,)),
          (27, cs.monitored_workload, (torch, smi))]
if hasattr(cs, "lineage_path"):
    phases.append((29, cs.lineage_path, (torch, smi)))
for number, fn, args in phases:
    t = time.perf_counter()
    fn(*args)
    print(f"phase {number} ({fn.__name__}): {time.perf_counter() - t:.3f} s", flush=True)
""",
}


def main():
    if len(sys.argv) != 4 or sys.argv[3] not in SNIPPETS:
        sys.exit(__doc__)
    parent, change, what = sys.argv[1:]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for label, root in (("parent", parent), ("change", change), ("change", change),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", SNIPPETS[what], change, root],
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            print(label, line, flush=True)
        if proc.returncode:
            sys.exit(f"{label} run failed:\n{proc.stderr[-4000:]}")


if __name__ == "__main__":
    main()
