"""Chaos harness: kill/resume bit-exactness and no-batch-lost checks.

  PYTHONPATH=src python -m repro_torch.launch.chaos --dryrun --device cpu
  PYTHONPATH=src python -m repro_torch.launch.chaos --scenario flash_crowd \
      --ticks 120 --crash-at 60 --fail-from 30 --fail-for 15

Counterpart of `repro.launch.chaos`, with the same flags, runs, verdict
and printout, plus `--device {cuda,cpu}` (default the card).  Three runs
of the same (scenario, seed), all executing the SAME fault schedule
(`repro_torch.resilience.FaultPlan`):

  1. reference   — uninterrupted, crash removed (`plan.without_crash()`)
  2. chaos       — checkpoints every N ticks, killed at `--crash-at`
                   (`PipelineKilled` raised mid-run)
  3. resume      — restores the latest checkpoint, runs the remaining
                   ticks with the crash-free plan

and then verifies the resilience contract:

  * BIT-EXACT: resumed store and CSR snapshot digests equal the
    reference run's (everything downstream of (scenario, seed) is
    counter-deterministic, and the checkpoint captured all of it);
  * NO BATCH LOST: `archived_total == retries_replayed +
    archive_remaining`: every failed or diverted batch is either
    replayed into the store or still accounted for in the archive;
  * NO HOT LOOP: commit failures during the outage stay logarithmic
    in the outage length (the capped-exponential backoff gate held),
    far under the one-failure-per-tick a gateless retry would burn.

`--dryrun` shrinks everything to CI size (48 ticks, a crash at 24, a
checkpoint every 8, an outage over 10:18, a 2^12-node, 2^14-edge store)
and exits nonzero on any violated invariant.  Keys are 64-bit, as in
the reference's CLI.
"""
import argparse
import json
import math
import os
import shutil
import tempfile
from typing import Tuple

from repro_torch.resilience import FaultPlan, PipelineKilled, RetryPolicy
from repro_torch.workloads import run_scenario


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="flash_crowd")
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-at", type=int, default=60,
                    help="kill the pipeline after this tick")
    ap.add_argument("--checkpoint-every", type=int, default=16)
    ap.add_argument("--fail-from", type=float, default=30.0,
                    help="simulated time the store outage starts")
    ap.add_argument("--fail-for", type=float, default=15.0,
                    help="outage duration in simulated seconds")
    ap.add_argument("--node-cap", type=int, default=None)
    ap.add_argument("--edge-cap", type=int, default=None)
    ap.add_argument("--dir", default=None,
                    help="working directory (checkpoints + spill); "
                         "a temp dir is created and removed by default")
    ap.add_argument("--json", default=None, help="write the verdict here")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny end-to-end run (CI smoke)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def run(argv=None) -> Tuple[int, dict]:
    """Run the CLI on `argv`; returns (exit code, verdict).  The verdict
    is None when the kill never fired."""
    args = _parser().parse_args(argv)
    if args.dryrun:
        args.ticks = min(args.ticks, 48)
        args.crash_at = min(args.crash_at, args.ticks // 2)
        args.checkpoint_every = min(args.checkpoint_every, 8)
        args.fail_from = min(args.fail_from, 10.0)
        args.fail_for = min(args.fail_for, 8.0)
        args.node_cap = args.node_cap or 1 << 12
        args.edge_cap = args.edge_cap or 1 << 14

    plan = FaultPlan(
        fail_times=((args.fail_from, args.fail_from + args.fail_for),),
        crash_at_tick=args.crash_at,
    )
    policy = RetryPolicy()

    work = args.dir or tempfile.mkdtemp(prefix="repro_torch_chaos_")
    ckpt_dir = os.path.join(work, "ckpt")
    common = dict(ticks=args.ticks, seed=args.seed,
                  node_cap=args.node_cap, edge_cap=args.edge_cap,
                  retry=policy, checkpoint_every=args.checkpoint_every,
                  device=args.device)

    print(f"[1/3] reference: {args.scenario} x{args.ticks} ticks, outage "
          f"t=[{args.fail_from}, {args.fail_from + args.fail_for})")
    ref = run_scenario(args.scenario, fault_plan=plan.without_crash(),
                       spill_dir=os.path.join(work, "spill_ref"), **common)

    print(f"[2/3] chaos: same run, checkpoint every "
          f"{args.checkpoint_every}, kill at tick {args.crash_at}")
    killed_at = None
    try:
        run_scenario(args.scenario, fault_plan=plan,
                     checkpoint_dir=ckpt_dir,
                     spill_dir=os.path.join(work, "spill_chaos"), **common)
    except PipelineKilled as pk:
        killed_at = pk.tick
    if killed_at is None:
        print("FAIL: crash_at_tick never fired")
        return 1, None

    print(f"[3/3] resume: killed at tick {killed_at}, restoring latest "
          f"checkpoint from {ckpt_dir}")
    res = run_scenario(args.scenario, fault_plan=plan.without_crash(),
                       checkpoint_dir=ckpt_dir, resume=True,
                       spill_dir=os.path.join(work, "spill_chaos"), **common)

    # ---- verdict --------------------------------------------------------
    checks = {}
    checks["bit_exact_store"] = res.store_digest == ref.store_digest
    checks["bit_exact_snapshot"] = res.snapshot_digest == ref.snapshot_digest
    checks["records_equal"] = res.total_records == ref.total_records
    checks["no_batch_lost"] = (
        res.archived_total == res.retries_replayed + res.archive_remaining)
    # backoff held: failures stay logarithmic in the outage length.  A
    # gateless retry fails ~once per tick (~fail_for failures plus the
    # pool drain); the capped-exponential gate allows degrade_after
    # probes, then one per gate opening: O(log2(W/base)).
    allowed = (3  # default degrade_after
               + 2 * (math.log2(max(args.fail_for, 1.0)
                                / policy.base_s) + 2))
    checks["backoff_not_hot"] = 0 < res.commit_failures <= allowed
    checks["resumed_mid_run"] = 0 < res.resumed_from_tick <= killed_at

    verdict = {
        "killed_at": killed_at,
        "resumed_from": res.resumed_from_tick,
        "ref": {"records": ref.total_records,
                "store_digest": ref.store_digest,
                "snapshot_digest": ref.snapshot_digest,
                "commit_failures": ref.commit_failures,
                "replayed": ref.retries_replayed},
        "resumed": {"records": res.total_records,
                    "store_digest": res.store_digest,
                    "snapshot_digest": res.snapshot_digest,
                    "commit_failures": res.commit_failures,
                    "replayed": res.retries_replayed,
                    "archived_total": res.archived_total,
                    "archive_remaining": res.archive_remaining,
                    "pool_overflows": res.pool_overflows,
                    "degraded_events": res.degraded_events,
                    "checkpoints_saved": res.checkpoints_saved},
        "max_failures_allowed": allowed,
        "checks": checks,
        "ok": all(checks.values()),
    }

    for name, ok in checks.items():
        print(f"  {'PASS' if ok else 'FAIL'}  {name}")
    print(f"store: {res.store_digest[:16]}... vs {ref.store_digest[:16]}... "
          f"| replayed={res.retries_replayed} "
          f"archive_remaining={res.archive_remaining} "
          f"failures={res.commit_failures} (allowed {allowed:.1f})")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(verdict, f, indent=2)
        print(f"(wrote verdict to {args.json})")
    if args.dir is None:
        shutil.rmtree(work, ignore_errors=True)

    print(f"chaos {'ok' if verdict['ok'] else 'FAILED'}")
    return (0 if verdict["ok"] else 1), verdict


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    raise SystemExit(main())
