"""Telemetry entry point: run a scenario with span telemetry on and
print the observability view of the run.

  PYTHONPATH=src python -m repro_torch.launch.telemetry --scenario flash_crowd
  PYTHONPATH=src python -m repro_torch.launch.telemetry --scenario spam_storm \
      --shards 4 --trace-out trace.json --jsonl-out spans.jsonl
  PYTHONPATH=src python -m repro_torch.launch.telemetry --dryrun --device cpu --trace-out t.json

Counterpart of `repro.launch.telemetry`, with the same flags and
printout, plus `--device {cuda,cpu}` (default the card).  Prints what
the pipeline spent its time on: the per-stage latency table
(p50/p95/p99 from the fixed log-bucket histograms), counters, and the
controller-decision audit timeline with the full PerfMon input vector
per decision.  `--trace-out` writes a Chrome `trace_event` file
loadable in ui.perfetto.dev with one timeline track per shard;
`--jsonl-out` the flat JSONL sink; `--tsv` a machine-readable per-stage
summary on stdout.

Spans time host code: around asynchronous CUDA work (`transform.dedup`,
`sketch.update`, `rewrite.*`) they time the enqueue, and `commit.wait`
is where a commit waits for the card.

`--dryrun` is the smoke run: a small short run that re-parses the
emitted Chrome trace and exits non-zero unless it is valid and carries
at least one span for every core instrumented stage.
"""
import argparse
import sys
from typing import Tuple

from repro_torch.telemetry import (
    TelemetryRegistry,
    summary_tsv,
    text_summary,
    validate_chrome_trace,
)
from repro_torch.workloads import WorkloadReport, run_scenario

# Core stages the dryrun insists on seeing in the trace: one per
# instrumented layer (loop, filter, controller, transform, commit).
DRYRUN_REQUIRED_STAGES = (
    "tick", "filter", "decide", "transform.dedup", "commit.upsert",
)


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="flash_crowd")
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--speed", type=float, default=0.5)
    ap.add_argument("--sketch-control", action="store_true")
    ap.add_argument("--dict-compress", action="store_true")
    ap.add_argument("--node-cap", type=int, default=None)
    ap.add_argument("--edge-cap", type=int, default=None)
    ap.add_argument("--max-decisions", type=int, default=20,
                    help="audit-timeline rows to print")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace_event file here "
                         "(Perfetto-loadable)")
    ap.add_argument("--jsonl-out", default=None,
                    help="write the flat JSONL span/audit sink here")
    ap.add_argument("--tsv", action="store_true",
                    help="print the machine-readable per-stage TSV "
                         "instead of the text summary")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny end-to-end run + trace validation "
                         "(smoke)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def run(argv=None) -> Tuple[int, WorkloadReport, TelemetryRegistry]:
    """Run the CLI on `argv`; returns (exit code, report, registry)."""
    args = _parser().parse_args(argv)
    if args.dryrun:
        args.ticks = min(args.ticks or 60, 60)
        args.node_cap = args.node_cap or 1 << 12
        args.edge_cap = args.edge_cap or 1 << 14

    reg = TelemetryRegistry()
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
        trace=args.trace_out,
        trace_jsonl=args.jsonl_out,
        device=args.device,
    )

    print(rep.summary())
    print()
    if args.tsv:
        print(summary_tsv(reg))
    else:
        print(text_summary(reg, max_decisions=args.max_decisions))
    if reg.events_dropped:
        # also on stderr so the truncation survives `--tsv | cut`-style
        # post-processing of stdout
        print(f"WARNING: {reg.events_dropped} span events dropped past "
              f"max_events={reg.max_events}; trace/JSONL span lists are "
              f"truncated (histograms and counters stay exact)",
              file=sys.stderr)
    if args.trace_out:
        print(f"(wrote Chrome trace to {args.trace_out} — load in "
              f"ui.perfetto.dev or chrome://tracing)")
    if args.jsonl_out:
        print(f"(wrote JSONL sink to {args.jsonl_out})")

    if args.dryrun:
        ok = rep.total_records > 0 and len(reg.audit) > 0
        msg = "records+audit present" if ok else \
            "no records or empty audit trail"
        if ok and args.trace_out:
            ok, msg = validate_chrome_trace(
                args.trace_out, require_stages=DRYRUN_REQUIRED_STAGES)
        print(f"dryrun {'ok' if ok else 'FAILED'}: {msg}")
        return (0 if ok else 1), rep, reg
    return 0, rep, reg


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    raise SystemExit(main())
