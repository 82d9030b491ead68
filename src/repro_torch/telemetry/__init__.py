"""`repro_torch.telemetry` — spans, histograms, audit trail, exporters.
Counterpart of `repro.telemetry`.

Span timers over fixed log-bucket histograms (`spans`), the controller
audit trail recording every Algorithm-2 decision with its PerfMon input
vector and its realized outcome (`audit`), and exporters: Chrome
``trace_event`` (Perfetto), JSONL, text/TSV summary (`export`).

    from repro_torch.telemetry import TelemetryRegistry, write_chrome_trace
    reg = TelemetryRegistry()
    pipe = (PipelineBuilder(cfg).with_source(src)
            .with_telemetry(reg).build())
    pipe.run(max_ticks=300)
    print(reg.summary()["commit.upsert"])   # p50/p95/p99 etc.
    write_chrome_trace(reg, "trace.json")   # open in Perfetto

or in one shot through the harness and the CLIs::

    run_scenario("flash_crowd", trace="trace.json")
    python -m repro_torch.launch.telemetry --scenario flash_crowd \
        --trace-out trace.json

Spans time host code.  Around asynchronous CUDA work (`transform.dedup`,
`sketch.update`, `rewrite.*`) a span times the enqueue, not the device;
`commit.wait` is where the commit waits for the card.
"""
from repro_torch.telemetry.audit import INPUT_KEYS, AuditRecord, AuditTrail
from repro_torch.telemetry.export import (
    chrome_trace,
    summary_tsv,
    text_summary,
    validate_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.telemetry.spans import (
    NBUCKETS,
    NULL_REGISTRY,
    NULL_SPAN,
    Histogram,
    Span,
    TelemetryRegistry,
    bucket_index,
    bucket_lower_ns,
    bucket_upper_ns,
)

__all__ = [
    "AuditRecord",
    "AuditTrail",
    "Histogram",
    "INPUT_KEYS",
    "NBUCKETS",
    "NULL_REGISTRY",
    "NULL_SPAN",
    "Span",
    "TelemetryRegistry",
    "bucket_index",
    "bucket_lower_ns",
    "bucket_upper_ns",
    "chrome_trace",
    "summary_tsv",
    "text_summary",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
]
