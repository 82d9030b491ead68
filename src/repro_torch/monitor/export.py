"""Monitor exposition: Prometheus text format + terminal dashboard.
Counterpart of `repro.monitor.export`, with the same metric names.

  * `prometheus_text(monitor=..., registry=...)` — the standard
    Prometheus exposition format (text/plain; version 0.0.4): event
    counters, per-stage latency histograms (the fixed log-bucket
    state maps 1:1 onto cumulative `_bucket{le=...}` lines), monitor
    series gauges, SLO budget/burn gauges, health-event counters and
    the controller score, and with `lineage=` the lineage gauges
    (watermarks, batches per path, freshness lags, record
    conservation).  Scrapeable by pointing any Prometheus
    file/textfile collector at the `--prom-out` file.
  * `render_dashboard(monitor, registry=...)` — the live terminal
    view the CLI repaints while a scenario runs: rolling per-stage
    latency table, latest per-tick series, SLO status with budget
    bars, and the active-alert list.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.lineage.export import prometheus_lines
from repro_torch.telemetry.spans import NBUCKETS, TelemetryRegistry, bucket_upper_ns


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt(v: float) -> str:
    # Prometheus wants plain decimals; ns->s conversions stay exact
    # enough at 9 digits
    return f"{float(v):.9g}"


def prometheus_text(monitor=None,
                    registry: Optional[TelemetryRegistry] = None,
                    lineage=None) -> str:
    """Render the run's state in Prometheus exposition format; with
    `lineage` (a `repro_torch.lineage.LineageTracker`), its watermark,
    freshness and conservation gauges too."""
    lines: List[str] = []
    if registry is None and monitor is not None:
        registry = monitor._registry
    if registry is not None:
        root = registry._root
        lines.append("# HELP repro_events_total pipeline loop events by kind")
        lines.append("# TYPE repro_events_total counter")
        for name, n in sorted(root.counters.items()):
            lines.append(f'repro_events_total{{kind="{_esc(name)}"}} {n}')
        lines.append("# HELP repro_spans_dropped_total span events dropped "
                     "past max_events (histograms stay exact)")
        lines.append("# TYPE repro_spans_dropped_total counter")
        lines.append(f"repro_spans_dropped_total {root.events_dropped}")
        lines.append("# HELP repro_stage_latency_seconds per-stage span "
                     "latency (fixed log-bucket histogram, all shards)")
        lines.append("# TYPE repro_stage_latency_seconds histogram")
        for name in root.stage_names():
            h = root.aggregate(name)
            stage = _esc(name)
            acc = 0
            for i in range(NBUCKETS):
                if h.counts[i] == 0:
                    continue
                acc += h.counts[i]
                le = bucket_upper_ns(i) / 1e9
                lines.append(
                    f'repro_stage_latency_seconds_bucket{{stage="{stage}",'
                    f'le="{_fmt(le)}"}} {acc}')
            lines.append(
                f'repro_stage_latency_seconds_bucket{{stage="{stage}",'
                f'le="+Inf"}} {h.count}')
            lines.append(f'repro_stage_latency_seconds_sum{{stage="{stage}"}}'
                         f' {_fmt(h.sum_ns / 1e9)}')
            lines.append(f'repro_stage_latency_seconds_count'
                         f'{{stage="{stage}"}} {h.count}')

    if monitor is not None:
        lines.append("# HELP repro_monitor_series latest per-tick series "
                     "value observed by the health monitor")
        lines.append("# TYPE repro_monitor_series gauge")
        for name, v in sorted(monitor.last_values.items()):
            if v is not None:
                lines.append(
                    f'repro_monitor_series{{series="{_esc(name)}"}} '
                    f'{_fmt(v)}')
        lines.append("# HELP repro_health_events_total detector onset/clear "
                     "boundaries by series and phase")
        lines.append("# TYPE repro_health_events_total counter")
        by_key: Dict[tuple, int] = {}
        for e in monitor.events:
            by_key[(e.series, e.detector, e.phase)] = \
                by_key.get((e.series, e.detector, e.phase), 0) + 1
        for (series, det, phase), n in sorted(by_key.items()):
            lines.append(
                f'repro_health_events_total{{series="{_esc(series)}",'
                f'detector="{_esc(det)}",phase="{_esc(phase)}"}} {n}')
        if monitor.slo is not None:
            summ = monitor.slo.summary()
            lines.append("# HELP repro_slo_budget_consumed fraction of the "
                         "error budget burned (1.0 = budget exhausted)")
            lines.append("# TYPE repro_slo_budget_consumed gauge")
            for name, s in sorted(summ.items()):
                lines.append(f'repro_slo_budget_consumed{{slo="{_esc(name)}"}}'
                             f' {_fmt(s["budget_consumed"])}')
            lines.append("# HELP repro_slo_burn_rate_max peak burn rate "
                         "per window")
            lines.append("# TYPE repro_slo_burn_rate_max gauge")
            for name, s in sorted(summ.items()):
                for win in ("short", "long"):
                    lines.append(
                        f'repro_slo_burn_rate_max{{slo="{_esc(name)}",'
                        f'window="{win}"}} {_fmt(s[f"max_burn_{win}"])}')
            lines.append("# HELP repro_slo_breaches_total breaching ticks "
                         "per SLO")
            lines.append("# TYPE repro_slo_breaches_total counter")
            for name, s in sorted(summ.items()):
                lines.append(f'repro_slo_breaches_total{{slo="{_esc(name)}"}}'
                             f' {s["breaches"]}')
        lines.append("# HELP repro_controller_score per-run controller "
                     "decision-quality score in [0,1]")
        lines.append("# TYPE repro_controller_score gauge")
        lines.append(f"repro_controller_score {_fmt(monitor.controller_score)}")
    if lineage is not None:
        lines.extend(prometheus_lines(lineage))
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, monitor=None,
                     registry: Optional[TelemetryRegistry] = None,
                     lineage=None) -> str:
    text = prometheus_text(monitor=monitor, registry=registry, lineage=lineage)
    with open(path, "w") as f:
        f.write(text)
    return path


# ---------------------------------------------------------------------------
# terminal dashboard
# ---------------------------------------------------------------------------

def _bar(frac: float, width: int = 16) -> str:
    frac = max(0.0, min(1.0, frac))
    n = int(round(frac * width))
    return "#" * n + "-" * (width - n)


def render_dashboard(monitor, registry: Optional[TelemetryRegistry] = None,
                     top_stages: int = 8, max_alerts: int = 6) -> str:
    """One frame of the live health view (plain text, ~80 cols)."""
    if registry is None:
        registry = monitor._registry
    lv = monitor.last_values or {}
    out: List[str] = []

    def g(key, fmt="{:.1f}", none="   -"):
        v = lv.get(key)
        return none if v is None else fmt.format(v)

    out.append(f"== repro_torch.monitor | tick {monitor.tick:>4} "
               f"t={monitor.t:7.1f}s ==")
    out.append(f"rate={g('rate'):>7}/t pushed={g('pushed'):>7} "
               f"drops={g('drops', '{:.0f}')} mu={g('mu', '{:.3f}')} "
               f"spill={g('spill_depth', '{:.0f}')} "
               f"commit_ms={g('commit_ms', '{:.2f}')} "
               f"p99={g('commit_p99_ms', '{:.2f}')}")

    if registry is not None and registry._root._hists:
        out.append("")
        out.append(f"{'stage':<22}{'count':>8}{'p50_ms':>9}{'p95_ms':>9}"
                   f"{'p99_ms':>9}{'total_s':>9}")
        summ = registry.summary()
        for name in sorted(summ, key=lambda n: -summ[n]["total_s"]
                           )[:top_stages]:
            st = summ[name]
            out.append(f"{name:<22}{st['count']:>8}{st['p50_ms']:>9.3f}"
                       f"{st['p95_ms']:>9.3f}{st['p99_ms']:>9.3f}"
                       f"{st['total_s']:>9.3f}")

    if monitor.slo is not None:
        out.append("")
        out.append(f"{'SLO':<20}{'objective':<28}{'budget':>18}"
                   f"{'burn s/l':>12}")
        for name, s in sorted(monitor.slo.summary().items()):
            consumed = s["budget_consumed"]
            flag = " " if s["met"] else "!"
            out.append(
                f"{flag}{name:<19}{s['objective']:<28}"
                f"[{_bar(consumed)}]{min(consumed, 9.99):>5.2f}"
                f"{s['max_burn_short']:>6.1f}/{s['max_burn_long']:<5.1f}")

    alerts = monitor.active_alerts()
    out.append("")
    if alerts:
        out.append(f"ACTIVE ALERTS ({len(alerts)}): "
                   + ", ".join(alerts[:max_alerts])
                   + (" ..." if len(alerts) > max_alerts else ""))
    else:
        out.append("active alerts: none")
    recent = monitor.events[-max_alerts:]
    for e in recent:
        out.append(f"  {e}")
    return "\n".join(out)


def text_report(monitor) -> str:
    """Post-run text verdict (the CLI's non-dashboard summary)."""
    rep = monitor.report()
    out = [f"== monitor verdict: {rep['ticks']} ticks, "
           f"{rep['n_health_events']} health events, "
           f"{rep['slo_breaches']} SLO-breaching ticks, "
           f"{rep['slo_alerts']} burn alerts =="]
    if rep["onsets"]:
        out.append("first onsets: " + ", ".join(
            f"{s}@tick{t}" for s, t in sorted(rep["onsets"].items())))
    for e in monitor.events:
        out.append(f"  {e}")
    if rep["slo"]:
        out.append("SLOs:")
        for name, s in sorted(rep["slo"].items()):
            mark = "ok " if s["met"] else "MISS"
            out.append(
                f"  [{mark}] {name}: {s['objective']} — "
                f"{s['breaches']}/{s['ticks']} breaching ticks "
                f"(budget {s['budget']:.0%}, consumed "
                f"{s['budget_consumed']:.2f}x), peak burn "
                f"{s['max_burn_short']:.1f}/{s['max_burn_long']:.1f}")
    q = rep["quality"]
    if q:
        out.append(
            f"controller score: {rep['controller_score']:.4f} over "
            f"{q.get('decisions', 0)} decisions "
            f"(mu err mean {q.get('mu_err_mean', 0):.4f}, regret total "
            f"{q.get('regret_total', 0):+.4f}, overload "
            f"{q.get('overload_decisions', 0)}, overcautious "
            f"{q.get('overcautious_decisions', 0)})")
    for action, s in sorted(rep.get("quality_by_action", {}).items()):
        out.append(f"  {action:<11} n={s['n']:<5} "
                   f"score_mean={s['score_mean']:.4f} "
                   f"min={s['score_min']:.4f}")
    return "\n".join(out)
