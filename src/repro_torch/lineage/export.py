"""Lineage exporters: hash-sampled hop logs as JSONL + Chrome-trace
flow events, the per-path freshness table, and the watermark timeline.
Counterpart of `repro.lineage.export`, with the same output but the
exporter's name in the JSONL meta line.

Sampling is a deterministic hash over the monotone ``batch_id``
(Knuth multiplicative), so the same run always exports the same tags
— plus the earliest few tags of *every* traversed path are always
included, so a short CI smoke still gets >=1 flow per path.

Flow events use the Chrome ``trace_event`` flow phases (``"s"`` start,
``"t"`` step, ``"f"`` end sharing one ``id``): loaded next to the
telemetry span trace they render as Perfetto arrows following one batch
from the buffer through pool/archive detours to the queryable store.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.lineage.tracker import BatchTag, LineageTracker, PATHS

_KNUTH = 0x9E3779B1


def _sampled(batch_id: int, rate: float) -> bool:
    return ((batch_id * _KNUTH) & 0xFFFFFFFF) < int(rate * (1 << 32))


def sample_tags(tracker: LineageTracker,
                rate: Optional[float] = None) -> List[BatchTag]:
    """Deterministic hash sample of the completed tags, guaranteeing
    at least `tracker.min_sampled_per_path` earliest tags per path."""
    rate = tracker.sample_rate if rate is None else float(rate)
    floor = tracker.min_sampled_per_path
    taken: Dict[str, int] = {}
    out: List[BatchTag] = []
    for tag in tracker.completed:
        p = tag.path
        if _sampled(tag.batch_id, rate) or taken.get(p, 0) < floor:
            out.append(tag)
            taken[p] = taken.get(p, 0) + 1
    return out


# ---------------------------------------------------------------------------
# Chrome-trace flow events
# ---------------------------------------------------------------------------

def _tid(shard: Optional[int]) -> int:
    # mirror repro_torch.telemetry.export: track 0 = main, shard s = s+1
    return 0 if shard is None else int(shard) + 1


def flow_events(tracker: LineageTracker, t0_ns: int,
                rate: Optional[float] = None) -> List[Dict]:
    """Sampled batch hop logs as trace_event *flow* events, placed on
    the span timeline via each hop's host timestamp (`t0_ns` is the
    telemetry registry's run origin, ``reg.t0_ns``)."""
    events: List[Dict] = []
    for tag in sample_tags(tracker, rate=rate):
        hops = tag.hops
        if len(hops) < 2:
            continue  # an arrow needs two ends
        last = len(hops) - 1
        for j, (hop, t, wall_ns) in enumerate(hops):
            ph = "s" if j == 0 else ("f" if j == last else "t")
            ev = {
                "name": f"batch:{tag.path}", "cat": "lineage", "ph": ph,
                "id": tag.batch_id, "pid": 0, "tid": _tid(tag.shard),
                "ts": (wall_ns - t0_ns) / 1e3,
                "args": {"hop": hop, "t": t, "batch_id": tag.batch_id,
                         "n_records": tag.n_records, "path": tag.path},
            }
            if ph == "f":
                ev["bp"] = "e"  # bind the arrow end to the enclosing slice
            events.append(ev)
    return events


def validate_flow_events(trace, require_paths: Sequence[str] = ()
                         ) -> Tuple[bool, str]:
    """(ok, message): the trace carries well-formed lineage flow
    events and every path in `require_paths` has >=1 complete
    (start..finish) flow chain."""
    if isinstance(trace, str):
        try:
            if trace.lstrip().startswith("{"):
                trace = json.loads(trace)
            else:
                with open(trace) as f:
                    trace = json.load(f)
        except (OSError, ValueError) as e:
            return False, f"trace does not parse: {e!r}"
    if not isinstance(trace, dict) or not isinstance(
            trace.get("traceEvents"), list):
        return False, "missing traceEvents list"
    flows = [e for e in trace["traceEvents"]
             if isinstance(e, dict) and e.get("cat") == "lineage"
             and e.get("ph") in ("s", "t", "f")]
    if not flows:
        return False, "no lineage flow events"
    for e in flows:
        if not all(k in e for k in ("name", "id", "ts", "pid", "tid")):
            return False, f"malformed flow event: {e}"
    chains: Dict[Tuple[str, int], set] = {}
    for e in flows:
        path = str(e["name"]).split(":", 1)[-1]
        chains.setdefault((path, e["id"]), set()).add(e["ph"])
    complete = {p for (p, _), phs in chains.items()
                if "s" in phs and "f" in phs}
    missing = [p for p in require_paths if p not in complete]
    if missing:
        return False, f"paths with no complete flow chain: {missing}"
    return True, (f"{len(flows)} flow events over "
                  f"{len(chains)} batches, paths={sorted(complete)}")


# ---------------------------------------------------------------------------
# JSONL
# ---------------------------------------------------------------------------

def write_lineage_jsonl(tracker: LineageTracker, path: str,
                        meta: Optional[Dict] = None,
                        rate: Optional[float] = None) -> str:
    """One meta line (watermarks, conservation, sampling), then one
    line per sampled tag, then the per-path freshness histograms."""
    tags = sample_tags(tracker, rate=rate)
    with open(path, "w") as f:
        f.write(json.dumps({
            "type": "meta", "exporter": "repro_torch.lineage",
            "batches_opened": tracker.batches_opened,
            "batches_committed": tracker.batches_committed,
            "batches_dropped": tracker.batches_dropped,
            "replays": tracker.replays,
            "sampled": len(tags),
            "sample_rate": tracker.sample_rate,
            "tags_evicted": tracker.completed_dropped,
            "watermarks": tracker.watermarks(),
            "conservation": tracker.conservation(),
            **(meta or {}),
        }) + "\n")
        for tag in tags:
            f.write(json.dumps({"type": "batch", **tag.to_dict()}) + "\n")
        for pth, row in tracker.freshness().items():
            f.write(json.dumps({"type": "freshness", "path": pth,
                                **row}) + "\n")
        for row in tracker.timeline:
            f.write(json.dumps({"type": "watermark", **row}) + "\n")
    return path


# ---------------------------------------------------------------------------
# human-readable views (launch.lineage)
# ---------------------------------------------------------------------------

def freshness_table(tracker: LineageTracker) -> str:
    """Per-path freshness: batch counts + ingest/queryable lag stats."""
    fresh = tracker.freshness()
    out = ["== per-path freshness (stream-time lag, ms) =="]
    if not fresh:
        out.append("(no batches committed — was lineage enabled?)")
        return "\n".join(out)
    out.append(f"{'path':<10}{'batches':>8}{'share':>8}"
               f"{'ingest_p50':>12}{'ingest_p99':>12}"
               f"{'query_p50':>12}{'query_p99':>12}{'query_max':>12}")
    total = sum(r["batches"] for r in fresh.values()) or 1
    for pth in PATHS:
        if pth not in fresh:
            continue
        r = fresh[pth]
        ing, qry = r["ingest"], r["queryable"]
        out.append(
            f"{pth:<10}{r['batches']:>8}{r['batches'] / total:>8.1%}"
            f"{ing['p50_ms']:>12.1f}{ing['p99_ms']:>12.1f}"
            f"{qry['p50_ms']:>12.1f}{qry['p99_ms']:>12.1f}"
            f"{qry['max_ms']:>12.1f}")
    lag = tracker.lag_percentiles_ms()
    out.append(f"{'all':<10}{total:>8}{'':>8}"
               f"{'':>12}{lag['ingest_lag_ms_p99']:>12.1f}"
               f"{'':>12}{lag['queryable_lag_ms_p99']:>12.1f}{'':>12}")
    return "\n".join(out)


def watermark_timeline(tracker: LineageTracker, max_rows: int = 20) -> str:
    """The watermark trajectory (evenly subsampled to `max_rows`)."""
    rows = list(tracker.timeline)
    out = [f"== watermark timeline ({len(rows)} ticks) =="]
    if not rows:
        out.append("(no watermark observations)")
        return "\n".join(out)
    out.append(f"{'t':>8}{'committed':>11}{'queryable':>11}"
               f"{'ingest_lag':>12}{'query_lag':>12}{'pending':>9}")
    step = max(1, len(rows) // max_rows)
    shown = rows[::step]
    if shown[-1] is not rows[-1]:
        shown.append(rows[-1])
    for r in shown:
        out.append(f"{r['t']:>8.1f}{r['committed']:>11.1f}"
                   f"{r['queryable']:>11.1f}"
                   f"{r['ingest_lag_ms']:>11.0f}ms"
                   f"{r['queryable_lag_ms']:>11.0f}ms"
                   f"{r['pending_queryable']:>9}")
    return "\n".join(out)


def prometheus_lines(tracker: LineageTracker) -> List[str]:
    """Lineage gauges for the Prometheus exposition (appended by
    `repro_torch.monitor.export.prometheus_text` when given a tracker)."""
    wm = tracker.watermarks()
    lines = [
        "# HELP repro_lineage_watermark Event-time watermarks "
        "(stream seconds).",
        "# TYPE repro_lineage_watermark gauge",
    ]
    for k in ("committed", "queryable", "max_event_t"):
        v = wm.get(k)
        if v is not None:
            lines.append(f'repro_lineage_watermark{{kind="{k}"}} {v}')
    lines += [
        "# HELP repro_lineage_batches_total Committed batches per path.",
        "# TYPE repro_lineage_batches_total counter",
    ]
    for pth in PATHS:
        n = tracker.path_counts.get(pth, 0)
        lines.append(f'repro_lineage_batches_total{{path="{pth}"}} {n}')
    lines += [
        "# HELP repro_lineage_lag_ms Freshness lag percentiles "
        "(stream-time ms).",
        "# TYPE repro_lineage_lag_ms gauge",
    ]
    for pth, row in tracker.freshness().items():
        for kind in ("ingest", "queryable"):
            for q in ("p50_ms", "p99_ms"):
                lines.append(
                    f'repro_lineage_lag_ms{{path="{pth}",kind="{kind}",'
                    f'quantile="{q[:-3]}"}} {row[kind][q]}')
    cons = tracker.conservation()
    lines += [
        "# HELP repro_lineage_records_total Record conservation counters.",
        "# TYPE repro_lineage_records_total counter",
    ]
    for k in ("records_in", "records_committed", "records_dropped"):
        lines.append(f'repro_lineage_records_total{{state="{k[8:]}"}} '
                     f'{cons[k]}')
    return lines
