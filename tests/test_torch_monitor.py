"""Port parity: the health monitor (`repro_torch.monitor`) and
`launch.monitor`.

  * `EwmaDetector`, `PageHinkley` and `DetectorBank` fed the same
    synthetic series give the reference's events and statistics,
    exactly; so do `SLOTracker`'s burn rates and alerts, and
    `score_trail`/`per_action_scores` on the same audit trail.
  * A `HealthMonitor` bound to a hub and fed the same synthetic events
    gives the reference's report, Prometheus text, dashboard (apart
    from the package name in its header) and text verdict.
  * The flash_crowd dryrun run, monitored, is held against the
    reference's in tests/test_torch_telemetry.py, which makes the one
    reference run that both CLIs replay.
  * `shards=2` with telemetry, the monitor and lineage, under per-shard
    replay: audit records tagged 0 and 1 in the reference's counts and
    actions, the same non-wall-clock detector events, and the same
    lineage tracker state and report fields.
  * With a lineage tracker, `prometheus_text` appends the reference's
    lineage gauges.
"""
import dataclasses
import math

import numpy as np
import pytest

import repro.monitor as RM
import repro.telemetry as RT
import repro_torch.monitor as M
import repro_torch.telemetry as T
from repro.api import MetricsHub as RefHub
from repro_torch.api import MetricsHub
from repro_torch.launch import monitor as cli
from repro_torch.workloads import harness
from test_torch_workloads import CAPS, SCENARIO, SEED, TICKS, _reference_run, _replaying

WALL_SERIES = ("commit_ms", "commit_p99_ms")  # per-tick latencies, wall clock
WALL_SLOS = ("commit_p99",)


def _noise(i, amp=3.0):
    return amp * math.sin(1.7 * i) + 0.5 * amp * math.cos(3.1 * i)


def _series(n=160):
    """Values with a step, a decaying burst, a dip and quiet stretches,
    for every default series."""
    out = []
    for i in range(n):
        step = 400.0 if 40 <= i < 70 else 0.0
        decay = 900.0 * math.exp(-(i - 100) / 6.0) if i >= 100 else 0.0
        out.append({
            "rate": 100.0 + _noise(i) + step + decay,
            "commit_ms": 5.0 + 0.1 * _noise(i) + (40.0 if i in (20, 21, 120) else 0.0),
            "drops": 0.0 if i % 37 else 250.0,
            "spill_depth": float(max(0, (i - 60) // 10)) if i < 130 else 0.0,
            "mu": 0.3 + 0.01 * _noise(i) + (0.3 if 80 <= i < 95 else 0.0),
            "dict_hit": None if i < 10 else 0.5 - (0.3 if i > 140 else 0.0) + 0.01 * _noise(i),
            "queryable_lag_ms": None,
            "pushed": 0.0 if i % 3 == 0 else 100.0,
            "commit_p99_ms": 5.0 + (200.0 if 50 <= i < 75 else 0.0),
        })
    return out


@pytest.mark.parametrize("direction", [1, -1, 0])
def test_ewma_and_page_hinkley_match_reference(direction):
    seq = [row["rate"] for row in _series()]
    for kw_ewma, kw_ph in [({}, {}), (dict(alpha=0.3, z_on=3.0, k_on=2, k_off=1),
                                      dict(delta=0.2, lam=4.0, alpha=0.1, k_off=1))]:
        dets = [(pkg.EwmaDetector(direction=direction, **kw_ewma),
                 pkg.PageHinkley(direction=direction, **kw_ph)) for pkg in (M, RM)]
        for x in seq:
            (ge, gp), (we, wp) = dets
            assert (ge.update(x), gp.update(x)) == (we.update(x), wp.update(x))
            assert (ge.z, ge.mean, ge.var, ge.active) == (we.z, we.mean, we.var, we.active)
            assert (gp.z, gp.stat, gp.cum, gp.scale, gp.active) == \
                (wp.z, wp.stat, wp.cum, wp.scale, wp.active)
    with pytest.raises(ValueError):
        M.EwmaDetector(alpha=0.0)


def test_detector_bank_matches_reference():
    banks = [pkg.DetectorBank(pkg.DEFAULT_SERIES) for pkg in (M, RM)]
    assert [dataclasses.asdict(s) for s in M.DEFAULT_SERIES] == \
        [dataclasses.asdict(s) for s in RM.DEFAULT_SERIES]
    for i, row in enumerate(_series()):
        got, want = (b.observe(i, float(i), row) for b in banks)
        assert [e.to_dict() for e in got] == [e.to_dict() for e in want]
        assert [str(e) for e in got] == [str(e) for e in want]
    g, w = banks
    assert len(g.events) > 10 and {e.series for e in g.events} >= {"rate", "drops", "mu"}
    assert g.active_alerts() == w.active_alerts()
    for s in g.specs:
        assert g.first_onset_tick(s) == w.first_onset_tick(s)


def test_slo_tracker_burn_rates_match_reference():
    specs = {pkg: pkg.default_slos(cpu_max=0.5, theta2=0.25) for pkg in (M, RM)}
    specs = {pkg: s + [pkg.SLOSpec("tight", "rate", "<=", 300.0, budget=0.01,
                                   short_window=4, long_window=8, burn_alert=2.0)]
             for pkg, s in specs.items()}
    trackers = [pkg.SLOTracker(specs[pkg]) for pkg in (M, RM)]
    for i, row in enumerate(_series()):
        got, want = (t.observe(i, float(i), row) for t in trackers)
        assert got == want
    g, w = trackers
    assert g.summary() == w.summary()
    assert (g.total_breaches(), g.total_alerts(), g.active_alerts()) == \
        (w.total_breaches(), w.total_alerts(), w.active_alerts())
    assert g.total_alerts() > 0
    with pytest.raises(ValueError):
        M.SLOSpec("x", "rate", "<", 1.0).ok(0.0)


def _trail(pkg):
    rng = np.random.default_rng(3)
    out = []
    for i in range(200):
        action = ("push", "hold", "throttle", "drain+push")[int(rng.integers(4))]
        mu_real = None if i % 17 == 0 else float(rng.uniform(0, 1))
        out.append(pkg.AuditRecord(
            seq=i, t=float(i), ts_ns=i, shard=0, action=action,
            reason="load" if action == "throttle" else "", beta=100,
            beta_e_pred=50.0, mu_pred=float(rng.uniform(0, 1)), slope=0.0, inputs={},
            mu_real=mu_real, beta_e_real=None if mu_real is None else 40.0))
    return out


def test_score_trail_matches_reference():
    got, want = _trail(T), _trail(RT)
    for cpu_max in (0.55, 0.3):
        assert M.score_trail(got, cpu_max=cpu_max) == RM.score_trail(want, cpu_max=cpu_max)
        assert [r.quality for r in got] == [r.quality for r in want]
        assert M.per_action_scores(got) == RM.per_action_scores(want)
    assert M.score_record(got[0]) == RM.score_record(want[0])
    assert M.score_trail([]) == RM.score_trail([])


class _Ev:
    def __init__(self, kind, t, **payload):
        self.kind, self.t, self.payload = kind, t, payload


def _driven(pkg, hub_cls):
    """A monitor bound to a hub with a registry, fed 60 synthetic ticks
    (a burst at 30) and a commit span a tick from explicit clocks."""
    reg = pkg.TelemetryRegistry()
    hub = hub_cls(telemetry=reg)
    mon = (M if pkg is T else RM).HealthMonitor()
    mon.bind(hub)
    for i in range(60):
        kept = int(100.0 + _noise(i) + (400.0 if i >= 30 else 0.0))
        mon.on_event(_Ev("tick", float(i), kept=kept, raw=kept + 5))
        reg._finish("commit.upsert", None, 1_000 * i, 1_000 * i + 2_000_000 + 997 * i)
        mon.on_event(_Ev("commit", float(i), dropped=3 if i in (33, 34) else 0,
                         dict_hit_rate=0.25, refs=2))
        mon.on_event(_Ev("push", float(i), records=kept))
        mon.on_event(_Ev("sample", float(i), mu=0.4 + (0.5 if 35 <= i < 40 else 0.0),
                         spill_depth=1 if i > 45 else 0))
        reg.counters["tick"] += 1
        reg.audit.append(_trail(pkg)[i])
    mon.on_event(_Ev("report", 60.0))
    return mon, reg


def test_monitor_report_and_exposition_match_reference():
    (gm, greg), (wm, wreg) = _driven(T, MetricsHub), _driven(RT, RefHub)
    assert gm.report() == wm.report()
    assert gm.report()["burst_onset_tick"] == 30
    assert M.prometheus_text(monitor=gm) == RM.prometheus_text(monitor=wm)
    assert M.prometheus_text(registry=greg) == RM.prometheus_text(registry=wreg)
    assert M.text_report(gm) == RM.text_report(wm)
    assert M.render_dashboard(gm) == \
        RM.render_dashboard(wm).replace("== repro.monitor |", "== repro_torch.monitor |")
    gm.finish()
    assert gm.report() == wm.report()  # finish is idempotent


def test_lineage_gauges_and_regression_gate_are_not_ported_yet(tmp_path, capsys):
    """The lineage gauges are ported now: with a tracker driven the same
    way, the Prometheus text and file are the reference's.  The
    regression gate is still not ported (ROADMAP §1 item 2.5)."""
    from test_torch_lineage import PORT, REF, _random_marks

    (gm, _), (wm, _) = _driven(T, MetricsHub), _driven(RT, RefHub)
    gtrk, wtrk = (_random_marks(side, np.random.default_rng(4)) for side in (PORT, REF))
    got = M.prometheus_text(monitor=gm, lineage=gtrk)
    assert got == RM.prometheus_text(monitor=wm, lineage=wtrk)
    assert 'repro_lineage_watermark{kind="queryable"}' in got
    assert M.prometheus_text(lineage=gtrk) == RM.prometheus_text(lineage=wtrk)
    M.write_prometheus(str(tmp_path / "m.prom"), monitor=gm, lineage=gtrk)
    RM.write_prometheus(str(tmp_path / "r.prom"), monitor=wm, lineage=wtrk)
    assert (tmp_path / "m.prom").read_text() == (tmp_path / "r.prom").read_text() == got
    code, rep, mon = cli.run(["regression", "--baseline", "0"])
    assert code != 0 and rep is None
    assert "item 2.5" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the flash_crowd dryrun with two shards, both packages
# ---------------------------------------------------------------------------


def _steady_events(events):
    return [e for e in events if e["series"] not in WALL_SERIES]


def test_sharded_run_under_replay_matches_reference(tmp_path_factory, monkeypatch):
    """With lineage on both sides too: the same tracker state (each tag
    stamped with its shard), timeline and lineage report fields."""
    from repro.lineage import LineageTracker as RefTracker
    from repro_torch.lineage import LineageTracker
    from test_torch_lineage import tracker_view

    tmp = tmp_path_factory.mktemp("monitor_sharded")
    ref_reg, ref_trk = RT.TelemetryRegistry(), RefTracker()
    ref = _reference_run(tmp, False, shards=2, telemetry=ref_reg, monitor=True,
                         lineage=ref_trk)
    _replaying(monkeypatch, tmp, ref)
    reg, trk = T.TelemetryRegistry(), LineageTracker()
    rep = harness.run_scenario(SCENARIO, ticks=TICKS, seed=SEED, shards=2, device="cpu",
                               telemetry=reg, monitor=True, lineage=trk, **CAPS)
    assert tracker_view(trk) == tracker_view(ref_trk)
    assert list(trk.timeline) == list(ref_trk.timeline)
    assert {t.shard for t in trk.completed} == {0, 1}
    lineage_fields = ("lineage_enabled", "ingest_lag_ms_p50", "ingest_lag_ms_p99",
                      "queryable_lag_ms_p99", "path_mix", "watermark_final", "records_in",
                      "records_committed", "records_dropped", "records_in_flight",
                      "conservation_warning")
    want = ref["report"]
    assert {k: getattr(rep, k) for k in lineage_fields} == \
        {k: getattr(want, k) for k in lineage_fields}
    assert rep.lineage_enabled and rep.records_in > 0 and not rep.conservation_warning
    assert rep.slo_summary["freshness"] == want.slo_summary["freshness"]

    def by_shard(audit):
        return {s: [(r.action, r.reason, r.beta, r.inputs["dropped_inserts"],
                     r.inputs["spill_depth"]) for r in audit if r.shard == s] for s in (0, 1)}

    got, want = by_shard(reg.audit), by_shard(ref_reg.audit)
    assert {r.shard for r in reg.audit} == {0, 1}
    assert {s: len(v) for s, v in got.items()} == {0: TICKS, 1: TICKS}
    assert got == want
    assert _steady_events(rep.health_events) == _steady_events(ref["report"].health_events)
    assert rep.audit_decisions == ref["report"].audit_decisions == 2 * TICKS
    assert set(rep.stage_latency_ms) == set(ref["report"].stage_latency_ms)
