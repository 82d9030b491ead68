"""Telemetry exporters: Chrome trace, JSONL, text/TSV summaries.
Counterpart of `repro.telemetry.export`, in the same formats; only
`otherData.exporter` and the JSONL meta line name this package.

  * `chrome_trace` / `write_chrome_trace` — the Chrome ``trace_event``
    JSON format (open in Perfetto / ``chrome://tracing``): every span
    becomes a complete ``"ph": "X"`` event on its shard's track, and
    every controller audit decision an instant ``"ph": "i"`` event
    carrying the full PerfMon input vector in ``args``.
  * `write_jsonl` — a flat machine-readable trace sink: one JSON line
    per span event, audit record, per-stage histogram, and counter.
  * `text_summary` / `summary_tsv` — the one-shot human view
    (``python -m repro_torch.launch.telemetry``): per-stage p50/p95/p99
    table plus the decision timeline.
  * `validate_chrome_trace` — the CI-smoke check: the emitted JSON
    parses and contains >=1 span per required stage.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.telemetry.spans import TelemetryRegistry


def _tid(shard: Optional[int]) -> int:
    # track 0 is the unsharded/main timeline; shard s gets track s+1
    return 0 if shard is None else int(shard) + 1


def chrome_trace(reg: TelemetryRegistry, meta: Optional[Dict] = None,
                 extra_events: Optional[List[Dict]] = None) -> Dict:
    """The registry as a Chrome `trace_event` object (Perfetto-loadable).
    `extra_events` are appended verbatim — e.g. lineage flow
    events (``ph: s/t/f`` arrows) linking the spans a batch traversed."""
    root = reg._root
    t0 = root.t0_ns
    events: List[Dict] = []
    tracks = {_tid(s) for (_, s, _, _) in root.events}
    tracks |= {_tid(r.shard) for r in root.audit}
    for tid in sorted(tracks):
        events.append({
            "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
            "args": {"name": "main" if tid == 0 else f"shard{tid - 1}"},
        })
    for (name, shard, s0, s1) in root.events:
        events.append({
            "name": name, "cat": "span", "ph": "X", "pid": 0,
            "tid": _tid(shard),
            "ts": (s0 - t0) / 1e3,       # microseconds since run start
            "dur": max((s1 - s0) / 1e3, 0.001),
        })
    for rec in root.audit:
        events.append({
            "name": f"decision:{rec.action}"
                    + (f":{rec.reason}" if rec.reason else ""),
            "cat": "controller", "ph": "i", "s": "t", "pid": 0,
            "tid": _tid(rec.shard),
            "ts": (rec.ts_ns - t0) / 1e3,
            "args": {
                "beta": rec.beta, "beta_e_pred": rec.beta_e_pred,
                "mu_pred": rec.mu_pred, "slope": rec.slope,
                "mu_real": rec.mu_real, "beta_e_real": rec.beta_e_real,
                **{k: v for k, v in rec.inputs.items()},
            },
        })
    if extra_events:
        events.extend(extra_events)
    out = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "exporter": "repro_torch.telemetry",
            "events_dropped": root.events_dropped,
            **(meta or {}),
        },
    }
    return out


def write_chrome_trace(reg: TelemetryRegistry, path: str,
                       meta: Optional[Dict] = None,
                       extra_events: Optional[List[Dict]] = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(reg, meta, extra_events=extra_events), f)
    return path


def validate_chrome_trace(trace, require_stages: Sequence[str] = ()
                          ) -> Tuple[bool, str]:
    """(ok, message): `trace` is a dict, a path, or a JSON string.
    Checks the trace_event shape and that every `require_stages` name
    appears in >=1 complete ("X") span event."""
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
    spans = [e for e in trace["traceEvents"]
             if isinstance(e, dict) and e.get("ph") == "X"]
    if not spans:
        return False, "no complete span events"
    for e in spans:
        if not all(k in e for k in ("name", "ts", "dur", "pid", "tid")):
            return False, f"malformed span event: {e}"
    seen = {e["name"] for e in spans}
    missing = [s for s in require_stages if s not in seen]
    if missing:
        return False, f"stages with no span events: {missing}"
    return True, f"{len(spans)} spans over {len(seen)} stages"


def write_jsonl(reg: TelemetryRegistry, path: str) -> str:
    """Flat JSONL trace sink: spans, audit records, histograms, counters."""
    root = reg._root
    t0 = root.t0_ns
    with open(path, "w") as f:
        # meta first so consumers can judge completeness before reading
        # the rest: a nonzero events_dropped means the span *list* is
        # truncated (histograms and counters below stay exact)
        f.write(json.dumps({
            "type": "meta", "exporter": "repro_torch.telemetry",
            "events_dropped": root.events_dropped,
            "max_events": root.max_events,
            "spans": len(root.events), "audit_records": len(root.audit),
        }) + "\n")
        for (name, shard, s0, s1) in root.events:
            f.write(json.dumps({
                "type": "span", "name": name, "shard": shard,
                "t_us": (s0 - t0) / 1e3, "dur_us": (s1 - s0) / 1e3,
            }) + "\n")
        for rec in root.audit:
            d = rec.to_dict()
            # explicit resolution marker: records the run never resolved
            # (e.g. the loop stopped mid-tick) export with realized=null
            # rather than erroring or being skipped
            d["realized"] = None if rec.mu_real is None else \
                {"mu": rec.mu_real, "beta_e": rec.beta_e_real}
            f.write(json.dumps({"type": "audit", **d}) + "\n")
        for (name, shard), h in sorted(root._hists.items(),
                                       key=lambda kv: (kv[0][0],
                                                       kv[0][1] is not None,
                                                       kv[0][1] or 0)):
            f.write(json.dumps({"type": "histogram", "name": name,
                                "shard": shard, **h.stats()}) + "\n")
        for name, n in sorted(root.counters.items()):
            f.write(json.dumps({"type": "counter", "name": name,
                                "count": n}) + "\n")
    return path


# ---------------------------------------------------------------------------
# human-readable summaries
# ---------------------------------------------------------------------------

_COLS = ("count", "mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms",
         "total_s")


def summary_tsv(reg: TelemetryRegistry) -> str:
    """Per-stage latency table (aggregated across shards) as TSV.
    A `#`-prefixed warning line trails the table when span events were
    dropped past max_events (the table itself stays exact)."""
    root = reg._root
    lines = ["stage\t" + "\t".join(_COLS)]
    for name, st in sorted(root.summary().items()):
        lines.append(name + "\t" + "\t".join(str(st[c]) for c in _COLS))
    if root.events_dropped:
        lines.append(f"# WARNING: {root.events_dropped} span events "
                     f"dropped past max_events={root.max_events} "
                     f"(histograms above stay exact)")
    return "\n".join(lines)


def text_summary(reg: TelemetryRegistry, max_decisions: int = 20) -> str:
    """Per-stage p50/p95/p99 table + counters + the decision timeline."""
    root = reg._root
    out = ["== per-stage latency (all shards) =="]
    summ = root.summary()
    if summ:
        w = max(len(n) for n in summ) + 2
        out.append(f"{'stage':<{w}}{'count':>8}{'mean_ms':>10}{'p50_ms':>10}"
                   f"{'p95_ms':>10}{'p99_ms':>10}{'total_s':>10}")
        for name in sorted(summ, key=lambda n: -summ[n]["total_s"]):
            st = summ[name]
            out.append(f"{name:<{w}}{st['count']:>8}{st['mean_ms']:>10.3f}"
                       f"{st['p50_ms']:>10.3f}{st['p95_ms']:>10.3f}"
                       f"{st['p99_ms']:>10.3f}{st['total_s']:>10.3f}")
    else:
        out.append("(no spans recorded — was telemetry enabled?)")
    if root.events_dropped:
        out.append(f"(!) {root.events_dropped} span events dropped past "
                   f"max_events={root.max_events} (histograms stay exact)")
    if root.counters:
        out.append("\n== event counters ==")
        out.append("  " + "  ".join(f"{k}={v}"
                                    for k, v in sorted(root.counters.items())))
    out.append(f"\n== controller decisions ({len(root.audit)} recorded) ==")
    interesting = [r for r in root.audit
                   if r.action in ("throttle", "drain+push") or r.reason]
    shown = (interesting or root.audit)[:max_decisions]
    for r in shown:
        rsn = f" reason={r.reason}" if r.reason else ""
        mu_r = "-" if r.mu_real is None else f"{r.mu_real:.3f}"
        # .get: records from hand-built or partially-restored trails may
        # not carry the full PerfMon input vector
        out.append(
            f"  t={r.t:8.1f} shard={r.shard} {r.action:<10}{rsn:<17}"
            f"beta={r.beta:<6} mu_pred={r.mu_pred:.3f} mu_real={mu_r} "
            f"rate={r.inputs.get('rate', 0.0):.1f} "
            f"rho={r.inputs.get('rho', 0.0):.3f} "
            f"pressure={r.inputs.get('pressure', 0.0):.3f} "
            f"spill={r.inputs.get('spill_depth', 0)}")
    if len(root.audit) > len(shown):
        out.append(f"  ... {len(root.audit) - len(shown)} more "
                   f"(JSONL/Chrome trace has all)")
    return "\n".join(out)
