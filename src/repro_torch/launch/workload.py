"""Workload-harness entry point: score the controller under a scenario.

  PYTHONPATH=src python -m repro_torch.launch.workload --list
  PYTHONPATH=src python -m repro_torch.launch.workload --scenario flash_crowd --dict-compress
  PYTHONPATH=src python -m repro_torch.launch.workload --scenario flash_crowd --shards 4 \
      --sketch-control
  PYTHONPATH=src python -m repro_torch.launch.workload --dryrun --device cpu   # smoke, on the host
  PYTHONPATH=src python -m repro_torch.launch.workload --trace-out trace.json

Counterpart of `repro.launch.workload`, with the same flags and
printout, plus `--device {cuda,cpu}` (default the card).  Drives the
pipeline through a registry scenario with the closed-loop harness
(`repro_torch.workloads.run_scenario`) and prints the report:
sustained throughput, spill/drop counts, the Algorithm-2 buffer-mode
transition timeline, table-pressure throttles and, with
`--dict-compress`, the GraphZip dictionary's references and hit rate.
`--shards N` partitions the stream by user over N controllers
(`ShardedPipeline`), and the timeline then names each transition's
shard.  `--dryrun` is the smoke run: a small-capacity short run that
exits non-zero if the harness produces no records or the report does
not serialise.  `--trace-out` turns on span telemetry and the
controller audit trail and writes a Perfetto-loadable Chrome trace of
the run (`launch.telemetry` prints the full summary view).
"""
import argparse
import json
from typing import Tuple

from repro_torch.workloads import WorkloadReport, list_scenarios, run_scenario


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="flash_crowd")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--ticks", type=int, default=None,
                    help="override the scenario's suggested run length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--speed", type=float, default=0.5,
                    help="simulated consumer speed (0.5 = paper's half-"
                         "capacity engine)")
    ap.add_argument("--rate-scale", type=float, default=1.0,
                    help="scale the scenario's base rate")
    ap.add_argument("--sketch-control", action="store_true",
                    help="sketch-guided control: feed live heavy-hitter "
                         "signals into the Algorithm-2 controller")
    ap.add_argument("--dict-compress", action="store_true",
                    help="GraphZip dictionary compression: rewrite "
                         "recurring mined patterns into references and "
                         "commit through the pattern-aware path")
    ap.add_argument("--dict-capacity", type=int, default=4096,
                    help="pattern-dictionary capacity (entries)")
    ap.add_argument("--node-cap", type=int, default=None)
    ap.add_argument("--edge-cap", type=int, default=None)
    ap.add_argument("--max-transitions", type=int, default=12,
                    help="timeline rows to print")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto-loadable Chrome trace of the "
                         "run here (enables span telemetry + the "
                         "controller audit trail; see launch.telemetry "
                         "for the full summary view)")
    ap.add_argument("--json", default=None, help="write the report dict here")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny end-to-end run (CI smoke)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def run(argv=None, on_event=None) -> Tuple[int, WorkloadReport]:
    """Run the CLI on `argv`; returns (exit code, report), the report
    None for `--list`.  `on_event` is passed to `run_scenario`."""
    args = _parser().parse_args(argv)
    if args.list:
        for s in list_scenarios():
            print(f"{s.name:18s} {s.description}")
        return 0, None

    if args.dryrun:
        args.ticks = min(args.ticks or 60, 60)
        args.node_cap = args.node_cap or 1 << 12
        args.edge_cap = args.edge_cap or 1 << 14

    rep = run_scenario(
        args.scenario,
        ticks=args.ticks,
        seed=args.seed,
        shards=args.shards,
        speed=args.speed,
        rate_scale=args.rate_scale,
        sketch_guided=args.sketch_control,
        dict_compress=args.dict_compress,
        dict_capacity=args.dict_capacity,
        node_cap=args.node_cap,
        edge_cap=args.edge_cap,
        trace=args.trace_out,
        on_event=on_event,
        device=args.device,
    )

    print(rep.summary())
    if rep.transitions:
        shown = rep.transitions[: args.max_transitions]
        print(f"buffer-mode timeline (first {len(shown)} of "
              f"{rep.n_transitions} transitions):")
        for tr in shown:
            shard = f" shard={tr['shard']}" if rep.shards > 1 else ""
            print(f"  t={tr['t']:7.1f}{shard}  {tr['from']} -> {tr['to']}")
    else:
        print("buffer-mode timeline: no transitions (controller stayed in "
              "one mode)")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep.to_dict(), f, indent=2)
        print(f"(wrote report to {args.json})")

    if args.trace_out:
        print(f"(wrote Chrome trace to {args.trace_out} — load in "
              f"ui.perfetto.dev or chrome://tracing)")

    if args.dryrun:
        ok = rep.total_records > 0 and bool(json.dumps(rep.to_dict()))
        print(f"dryrun {'ok' if ok else 'FAILED'}")
        return (0 if ok else 1), rep
    return 0, rep


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    raise SystemExit(main())
