#!/usr/bin/env python3
"""Sharded GraphZip ingest from two trees of this repository, in turns.

    python3 tools/ab_sharded.py PARENT_ROOT CHANGE_ROOT   # one card

Runs `chip_smoke.sharded_path` (phase 16: `launch.ingest --shards 4
--dict-compress`, 120 ticks) and then `chip_smoke.sharded_breakdown`
(phase 17: ticks 40 to 79 with spans on and under torch.profiler) of
each tree, each run in a fresh process that builds only the kernels it
launches, in the order parent, change, change, parent, so that both
trees run on one card in one call.  Prints each run's output with its
tree's label, after the card's name and power limit.
"""
import subprocess
import sys

CODE = ("import sys, torch; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs; "
        "cs.sharded_path(torch); cs.sharded_breakdown(torch)")


def main():
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    parent, change = sys.argv[1:]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for label, root in (("parent", parent), ("change", change), ("change", change),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", CODE, root], capture_output=True,
                              text=True)
        for line in proc.stdout.splitlines():
            print(label, line, flush=True)
        if proc.returncode:
            sys.exit(f"{label} run failed:\n{proc.stderr[-4000:]}")


if __name__ == "__main__":
    main()
