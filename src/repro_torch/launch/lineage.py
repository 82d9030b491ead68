"""Lineage entry point: run a scenario with event-time watermarks and
per-batch provenance on, and print the freshness view of the run.

  PYTHONPATH=src python -m repro_torch.launch.lineage --scenario flash_crowd
  PYTHONPATH=src python -m repro_torch.launch.lineage --scenario flash_crowd \
      --outage 20:30 --jsonl-out lineage.jsonl --trace-out trace.json
  PYTHONPATH=src python -m repro_torch.launch.lineage --dryrun --device cpu

Counterpart of `repro.launch.lineage`, with the same flags and
printout, plus `--device {cuda,cpu}` (default the card).  Where
`launch.telemetry` prints what the pipeline spent its time on and
`launch.monitor` whether it stayed healthy, this prints how stale the
data a query would see actually was: the per-path freshness table
(direct vs buffered vs spilled vs archived-retry commit routes), the
watermark trajectory, the record-conservation verdict, and the
`freshness` SLO budget/burn status.  `--outage t0:t1` injects a store
outage (every commit in the window fails, batches detour through the
archive and replay under the default `RetryPolicy`) so the archive
path's lag contribution is visible on demand.

`--trace-out` writes the Chrome trace WITH lineage flow events: loaded
in ui.perfetto.dev the sampled batches render as arrows following each
batch from the buffer through its detours to the queryable store.
`--jsonl-out` writes the sampled per-batch hop logs, `--prom-out` the
Prometheus exposition with the lineage gauges.

`--dryrun` is the smoke run: a short run with a store outage at 20:26
that re-parses the emitted trace and exits non-zero unless every
traversed path has at least one complete flow chain and the final
queryable watermark is non-null.  Keys are 64-bit, as in the
reference's CLI.
"""
import argparse
import os
import tempfile
from typing import Tuple

from repro_torch.lineage import (
    LineageTracker,
    freshness_table,
    validate_flow_events,
    watermark_timeline,
)
from repro_torch.monitor import HealthMonitor, write_prometheus
from repro_torch.resilience import FaultPlan
from repro_torch.workloads import WorkloadReport, run_scenario


def _parse_outage(spec):
    t0, _, t1 = spec.partition(":")
    try:
        lo, hi = float(t0), float(t1)
    except ValueError:
        raise SystemExit(f"--outage wants t0:t1 (got {spec!r})")
    if hi <= lo:
        raise SystemExit(f"--outage window is empty: {spec!r}")
    return lo, hi


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="flash_crowd")
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--speed", type=float, default=0.5)
    ap.add_argument("--node-cap", type=int, default=None)
    ap.add_argument("--edge-cap", type=int, default=None)
    ap.add_argument("--sample-rate", type=float, default=0.25,
                    help="deterministic hash-sample rate for exported "
                         "per-batch hop logs")
    ap.add_argument("--outage", default=None, metavar="T0:T1",
                    help="inject a store outage over this simulated-"
                         "time window (commits fail, archive absorbs)")
    ap.add_argument("--timeline-rows", type=int, default=20)
    ap.add_argument("--trace-out", default=None,
                    help="write the Chrome trace incl. lineage flow "
                         "events here (Perfetto-loadable)")
    ap.add_argument("--jsonl-out", default=None,
                    help="write the sampled per-batch hop logs here")
    ap.add_argument("--prom-out", default=None,
                    help="write the Prometheus exposition (incl. the "
                         "lineage gauges) here")
    ap.add_argument("--dryrun", action="store_true",
                    help="small end-to-end run + flow-event/watermark "
                         "validation (smoke)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def run(argv=None) -> Tuple[int, WorkloadReport, LineageTracker, HealthMonitor]:
    """Run the CLI on `argv`; returns (exit code, report, tracker,
    monitor)."""
    args = _parser().parse_args(argv)
    if args.dryrun:
        args.ticks = min(args.ticks or 60, 60)
        args.node_cap = args.node_cap or 1 << 12
        args.edge_cap = args.edge_cap or 1 << 14
        if args.trace_out is None:
            # the validation needs a trace on disk even if the caller
            # did not ask to keep one
            args.trace_out = os.path.join(
                tempfile.mkdtemp(prefix="repro_torch_lineage_"), "trace.json")
        if args.outage is None:
            # exercise the archive path so the smoke covers a detour
            args.outage = "20:26"

    fault_plan = None
    if args.outage:
        lo, hi = _parse_outage(args.outage)
        fault_plan = FaultPlan(fail_times=((lo, hi),))

    trk = LineageTracker(sample_rate=args.sample_rate)
    mon = HealthMonitor()
    rep = run_scenario(
        args.scenario,
        ticks=args.ticks,
        seed=args.seed,
        shards=args.shards,
        speed=args.speed,
        node_cap=args.node_cap,
        edge_cap=args.edge_cap,
        lineage=trk,
        monitor=mon,
        trace=args.trace_out,
        lineage_jsonl=args.jsonl_out,
        fault_plan=fault_plan,
        device=args.device,
    )

    print(rep.summary())
    print()
    print(freshness_table(trk))
    print()
    print(watermark_timeline(trk, max_rows=args.timeline_rows))
    print()
    verdict = "BALANCED" if not rep.conservation_warning \
        else rep.conservation_warning
    print(f"conservation: in={rep.records_in} "
          f"committed={rep.records_committed} "
          f"dropped={rep.records_dropped} "
          f"in_flight={rep.records_in_flight} -> {verdict}")
    slo = rep.slo_summary.get("freshness")
    if slo:
        alerts = [a for a in slo["alerts"] if a["phase"] == "onset"]
        print(f"freshness SLO: {slo['objective']} — "
              f"{slo['breaches']}/{slo['ticks']} breaching ticks "
              f"(budget consumed {slo['budget_consumed']:.2f}x), "
              f"{len(alerts)} burn alerts"
              + (f", first onset tick {slo['first_alert_tick']}"
                 if alerts else ""))
    if args.prom_out:
        write_prometheus(args.prom_out, monitor=mon, lineage=trk)
        print(f"(wrote Prometheus exposition to {args.prom_out})")
    if args.trace_out:
        print(f"(wrote Chrome trace with flow events to {args.trace_out})")
    if args.jsonl_out:
        print(f"(wrote lineage JSONL to {args.jsonl_out})")

    if args.dryrun:
        ok = rep.total_records > 0 and not rep.conservation_warning
        msg = "records flowed, conservation holds" if ok else \
            (rep.conservation_warning or "no records flowed")
        if ok and rep.watermark_final.get("queryable") is None:
            ok, msg = False, "final queryable watermark is null"
        if ok:
            ok, msg = validate_flow_events(
                args.trace_out,
                require_paths=sorted(rep.path_mix))
        print(f"dryrun {'ok' if ok else 'FAILED'}: {msg}")
        return (0 if ok else 1), rep, trk, mon
    return 0, rep, trk, mon


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    raise SystemExit(main())
