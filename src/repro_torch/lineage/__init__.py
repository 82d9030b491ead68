"""repro_torch.lineage — per-batch provenance, event-time watermarks,
and freshness SLIs for the ingest->query path.  Counterpart of
`repro.lineage`.

Layer three of the observability stack: the telemetry spans time the *stages*,
the monitor series watch the *aggregates*, this package follows the *data* —
every batch carries a monotone id + event-time envelope from the
source through buffer/spill/pool/archive to the queryable snapshot,
and the watermark pair (committed vs queryable) turns that into the
user-facing question: how stale is the graph a query sees, and which
hop made it so?

Entry points: ``PipelineBuilder.with_lineage()``,
``run_scenario(lineage=True)``, ``python -m repro_torch.launch.lineage``.
"""
from repro_torch.lineage.tracker import (
    PATHS,
    BatchTag,
    LineageTracker,
)
from repro_torch.lineage.export import (
    flow_events,
    freshness_table,
    prometheus_lines,
    sample_tags,
    validate_flow_events,
    watermark_timeline,
    write_lineage_jsonl,
)

__all__ = [
    "PATHS",
    "BatchTag",
    "LineageTracker",
    "flow_events",
    "freshness_table",
    "prometheus_lines",
    "sample_tags",
    "validate_flow_events",
    "watermark_timeline",
    "write_lineage_jsonl",
]
