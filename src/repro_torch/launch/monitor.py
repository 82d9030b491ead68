"""Health-monitor entry point: run a scenario under the online judge.

  PYTHONPATH=src python -m repro_torch.launch.monitor --scenario flash_crowd
  PYTHONPATH=src python -m repro_torch.launch.monitor --scenario spam_storm \
      --shards 4 --live --prom-out metrics.prom --report-out monitor.json
  PYTHONPATH=src python -m repro_torch.launch.monitor --dryrun --device cpu

Counterpart of `repro.launch.monitor`'s `run` command, with the same
flags and printout, plus `--device {cuda,cpu}` (default the card).
Drives a registry scenario with telemetry and the
`repro_torch.monitor.HealthMonitor` attached and prints the monitor
verdict: detector onsets with ticks, per-SLO budget/burn accounting,
and the controller decision-quality score.  `--live` repaints a
terminal dashboard every `--refresh` ticks while the run is in flight;
`--prom-out` writes Prometheus text exposition and `--report-out` the
JSON verdict.  `--dryrun` is the smoke run: a small flash_crowd run
that exits non-zero unless the burst produced at least one health
event and the SLO summary is populated.

The reference's `regression` command (its perf gate over a trajectory
file) exits non-zero here: the port's gate and its trajectory file
come with ROADMAP §1 item 2.5.
"""
import argparse
import json
import sys
from typing import Optional, Tuple

from repro_torch.monitor import (
    HealthMonitor,
    render_dashboard,
    text_report,
    write_prometheus,
)
from repro_torch.telemetry import TelemetryRegistry
from repro_torch.workloads import WorkloadReport, run_scenario

REGRESSION_MISSING = ("perf gate: not in the port yet; the port's regression "
                      "gate over its own trajectory file comes with ROADMAP "
                      "§1 item 2.5")


def _run(args) -> Tuple[int, WorkloadReport, HealthMonitor]:
    if args.dryrun:
        args.ticks = min(args.ticks or 60, 60)
        args.node_cap = args.node_cap or 1 << 12
        args.edge_cap = args.edge_cap or 1 << 14

    def _frame(mon, tick, values):
        if not args.live or tick % args.refresh:
            return
        out = render_dashboard(mon)
        if sys.stdout.isatty():
            sys.stdout.write("\x1b[2J\x1b[H" + out + "\n")
        else:
            sys.stdout.write(out + "\n\n")
        sys.stdout.flush()

    reg = TelemetryRegistry()
    mon = HealthMonitor(on_tick=_frame)
    rep = run_scenario(
        args.scenario,
        ticks=args.ticks,
        seed=args.seed,
        shards=args.shards,
        speed=args.speed,
        sketch_guided=args.sketch_control,
        dict_compress=args.dict_compress,
        node_cap=args.node_cap,
        edge_cap=args.edge_cap,
        telemetry=reg,
        monitor=mon,
        device=args.device,
    )

    print(rep.summary())
    print()
    print(text_report(mon))

    if args.report_out:
        payload = {"scenario": args.scenario, "seed": args.seed,
                   "shards": args.shards, **mon.report()}
        with open(args.report_out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"(wrote monitor report to {args.report_out})")
    if args.prom_out:
        write_prometheus(args.prom_out, monitor=mon, registry=reg)
        print(f"(wrote Prometheus exposition to {args.prom_out})")

    if args.dryrun:
        mrep = mon.report()
        checks = {
            "records": rep.total_records > 0,
            "burst health event": any(
                e["series"] == "rate" and e["phase"] == "onset"
                for e in mrep["health_events"]),
            "slo summary populated": len(mrep["slo"]) > 0
            and all("budget_consumed" in s for s in mrep["slo"].values()),
            "quality scored": mrep["quality"].get("decisions", 0) > 0,
            "report serialises": bool(json.dumps(mrep)),
        }
        failed = [name for name, ok in checks.items() if not ok]
        print(f"dryrun {'ok' if not failed else 'FAILED'}"
              + (f": missing {', '.join(failed)}" if failed else ""))
        return (0 if not failed else 1), rep, mon
    return 0, rep, mon


def _parser():
    ap = argparse.ArgumentParser(
        description="online health monitoring (the perf-regression gate "
                    "is not in the port yet)")
    ap.add_argument("command", nargs="?", default="run",
                    choices=("run", "regression"),
                    help="run a monitored scenario (default); regression "
                         "is not in the port yet")
    ap.add_argument("--scenario", default="flash_crowd")
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--speed", type=float, default=0.5)
    ap.add_argument("--sketch-control", action="store_true")
    ap.add_argument("--dict-compress", action="store_true")
    ap.add_argument("--node-cap", type=int, default=None)
    ap.add_argument("--edge-cap", type=int, default=None)
    ap.add_argument("--live", action="store_true",
                    help="repaint the terminal dashboard during the run")
    ap.add_argument("--refresh", type=int, default=10,
                    help="dashboard repaint period in ticks (with --live)")
    ap.add_argument("--report-out", default=None,
                    help="write the JSON monitor verdict here")
    ap.add_argument("--prom-out", default=None,
                    help="write Prometheus text exposition here")
    ap.add_argument("--dryrun", action="store_true",
                    help="small flash_crowd run + verdict checks (smoke)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def run(argv=None) -> Tuple[int, Optional[WorkloadReport], Optional[HealthMonitor]]:
    """Run the CLI on `argv`; returns (exit code, report, monitor), the
    last two None for `regression`."""
    ap = _parser()
    args, rest = ap.parse_known_args(argv)
    if args.command == "regression":  # whatever the gate's own flags
        print(REGRESSION_MISSING, file=sys.stderr)
        return 2, None, None
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    return _run(args)


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    raise SystemExit(main())
