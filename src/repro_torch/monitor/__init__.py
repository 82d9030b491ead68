"""`repro_torch.monitor` — online health monitoring over the
ingest->query path.  Counterpart of `repro.monitor`, without its
perf-regression gate (`regression`), which waits for the port's own
trajectory file (ROADMAP §1 item 2.5).

  * `detectors` — streaming EWMA z-score + Page–Hinkley change-point
    detection over per-tick series, emitting `HealthEvent`s with
    onset/clear semantics.
  * `slo` — declarative SLO specs with error budgets and multi-window
    burn-rate alerts, evaluated every tick.
  * `quality` — controller decision-quality scoring from the audit
    trail: predicted-vs-realized error, regret vs a do-nothing
    baseline, one controller score per run.
  * `monitor` — `HealthMonitor`, wired into a pipeline with
    `PipelineBuilder.with_monitor()` (or `run_scenario(...,
    monitor=True)`).
  * `export` — Prometheus text exposition + the live terminal
    dashboard.

    from repro_torch.monitor import HealthMonitor
    mon = HealthMonitor()
    pipe = (PipelineBuilder(cfg).with_source(src)
            .with_monitor(mon).build())
    pipe.run(max_ticks=300)
    print(mon.report()["controller_score"], mon.burst_onset_tick())

CLI: ``python -m repro_torch.launch.monitor --scenario flash_crowd``.
"""
from repro_torch.monitor.detectors import (
    DEFAULT_SERIES,
    DetectorBank,
    EwmaDetector,
    HealthEvent,
    PageHinkley,
    SeriesSpec,
)
from repro_torch.monitor.export import (
    prometheus_text,
    render_dashboard,
    text_report,
    write_prometheus,
)
from repro_torch.monitor.monitor import SERIES_KEYS, HealthMonitor
from repro_torch.monitor.quality import per_action_scores, score_record, score_trail
from repro_torch.monitor.slo import SLOSpec, SLOTracker, default_slos

__all__ = [
    "DEFAULT_SERIES",
    "DetectorBank",
    "EwmaDetector",
    "HealthEvent",
    "HealthMonitor",
    "PageHinkley",
    "SERIES_KEYS",
    "SLOSpec",
    "SLOTracker",
    "SeriesSpec",
    "default_slos",
    "per_action_scores",
    "prometheus_text",
    "render_dashboard",
    "score_record",
    "score_trail",
    "text_report",
    "write_prometheus",
]
