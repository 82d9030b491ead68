#!/usr/bin/env python3
"""The traffic-id sampler (K4) under every launch plan its kernel takes, on one card.

    python3 tools/k4_plan.py            # from the repository root

Builds `csrc/traffic_ids.cu` as `kernels/build.py` does and prints each
kernel's registers and the branches in its machine code (`cuobjdump
-sass`): the library `powf` branches on special values.  For each block
size of LANES (the workload source's 2,048 records and 65,536), each
registry scenario at burst levels 0 and 1 (seed 0, ctr0 0), runs the
kernel under every plan of `chip_smoke.traffic_plans` (CTAs of 32 to 256
threads, 1 to 4 records a thread, and `launch_plan`'s), holds each
result to the plain version bit for bit, and times the call
(`chip_smoke._time_ms`: CUDA events with a device sleep ahead of the
start event, median of REPS) in two passes, plans in order and then
reversed.  An empty launch (`torch.cuda._sleep(0)`) is timed the same
way, as the floor.

Every (size, scenario, burst, plan) goes as a JSON line to `--out`
(default chiprun_out/k4_plan.jsonl).  Standard output gets the card's
name and power limit, the floor, for each (size, scenario, burst) the
planned plan's time and the fastest plan, and for each (size, plan) its
worst and mean time over the scenarios and burst levels, fastest first.
"""
import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import sampler as SA  # noqa: E402
from repro_torch.workloads.scenarios import list_scenarios  # noqa: E402

LANES = (2_048, 65_536)
REPS = 20
OUT = ROOT / "chiprun_out" / "k4_plan.jsonl"


def _kernel_name(mangled):
    """`traffic_ids_kernel<R>` from a template kernel's mangled name."""
    m = re.search(r"\d+([a-z_]+_kernel)ILi(\d+)E", mangled)
    return f"{m[1]}<{m[2]}>" if m else mangled


def build_kernel():
    """Builds the kernel (unless current) and prints its registers and
    the branches in each instance's machine code."""
    path, job = build._start("traffic_ids")
    for line in build._finish("traffic_ids", path, job).splitlines():
        if "registers" in line or "spill" in line:
            print(f"k4 build: {line.strip()}", flush=True)
    sass = subprocess.run([str(Path(build._nvcc()).parent / "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True).stdout
    print("k4 build: SASS branches " + json.dumps(
        {_kernel_name(f.split()[0]): f.count(" BRA ") for f in sass.split("Function : ")[1:]}),
        flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, nargs="+", default=LANES)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k4_plan: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build_kernel()
    dev = torch.device("cuda")
    floor = chip_smoke._time_ms(torch, lambda: torch.cuda._sleep(0), (), (), 4 * REPS)
    print("k4 floor", json.dumps({"empty_launch_ms": floor}), flush=True)

    summary = {}
    args.out.parent.mkdir(exist_ok=True)
    with args.out.open("w") as out:
        for n in args.lanes:
            own = SA.launch_plan(n)
            todo = chip_smoke.traffic_plans(n)
            for scn in list_scenarios():
                ip = torch.from_numpy(scn.iparams()).to(dev)
                for burst in (0.0, 1.0):
                    call_args = (0, 0, n, ip, torch.from_numpy(scn.fparams(burst)).to(dev))
                    want = SA.traffic_ids_ref(*call_args)
                    for plan in todo:
                        got = SA.launch(*call_args, plan)
                        if not all(torch.equal(g, w) for g, w in zip(got, want)):
                            raise AssertionError(f"K4 != plain at n={n} {scn.name} "
                                                 f"burst={burst} {plan}")
                    ms = {plan: [] for plan in todo}
                    for order in (todo, todo[::-1]):
                        for plan in order:
                            ms[plan].append(chip_smoke._time_ms(
                                torch, lambda *a, p=plan: SA.launch(*a, p), (), call_args, REPS))
                    for plan, times in ms.items():
                        summary.setdefault((n, plan), []).append(min(times))
                        out.write(json.dumps({"lanes": n, "scenario": scn.name, "burst": burst,
                                              "plan": plan._asdict(), "ms": times,
                                              "own_plan": plan == own}) + "\n")
                    fastest = min(todo, key=lambda plan: min(ms[plan]))
                    print("k4 plan", json.dumps({
                        "lanes": n, "scenario": scn.name, "burst": burst,
                        "own": [list(own), ms[own]],
                        "fastest": [list(fastest), ms[fastest]]}), flush=True)
    for n in args.lanes:
        rows = sorted(((max(t), statistics.mean(t), plan)
                       for (m, plan), t in summary.items() if m == n),
                      key=lambda r: r[0])
        for worst, mean, plan in rows:
            print("k4 summary", json.dumps({"lanes": n, "plan": list(plan),
                                            "worst_ms": worst, "mean_ms": mean,
                                            "own_plan": plan == SA.launch_plan(n)}), flush=True)


if __name__ == "__main__":
    main()
