"""Port parity: span telemetry, the controller audit trail and the
exporters (`repro_torch.telemetry`), and `launch.telemetry`.

  * Spans: `bucket_index` and the bucket bounds, histogram percentiles
    and merges, child registries and the bounded event list agree with
    the reference's on the same durations; the disabled path allocates
    nothing (as tests/test_telemetry.py pins for the reference).
  * `AuditTrail.record`/`resolve` on the same PerfMon inputs give the
    reference's record, and recording reads no tensor.
  * The exporters (`chrome_trace`, `write_jsonl`, `summary_tsv`,
    `text_summary`, `validate_chrome_trace`) on two registries filled
    the same way give the reference's output, apart from the
    exporter's name.
  * One reference run of the CLIs' `--dryrun` deployment
    (`run_scenario("flash_crowd", ticks=60, seed=0, node_cap=2**12,
    edge_cap=2**14, telemetry=..., monitor=..., trace=...,
    trace_jsonl=...)`, x64) is replayed, records and decisions
    (tests/test_torch_workloads.py: ROADMAP F1 and F2), by the port's
    `run_scenario` with the same options, by `launch.telemetry --dryrun
    --device cpu` and by `launch.monitor --dryrun --device cpu`.
    Exact: the audit trail's action, reason, beta, inputs (dropped
    inserts, spill depth, ...) and realized outcome; the span names,
    span counts and decision events of the Chrome trace and the JSONL
    sink; the detector events on every series but the wall-clock ones
    (`commit_ms`; `commit_p99_ms` feeds only the `commit_p99` SLO);
    every SLO's summary but `commit_p99`'s; the Prometheus metric
    names.  The predictions within the F2 tolerances of
    tests/test_torch_controller.py.  Both CLIs' printouts with the
    wall-clock parts masked and the predictions and scores within one
    unit of their printed digits.  The telemetry CLI runs no monitor,
    so its report and files are held against the reference's without
    the monitor's fields and verdicts.
"""
import contextlib
import dataclasses
import io
import json
import re
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest

import repro.monitor as RM
import repro.telemetry as R
import repro_torch.monitor as M
import repro_torch.telemetry as T
import repro_torch.telemetry.spans as port_spans
from repro_torch.launch import monitor as monitor_cli
from repro_torch.launch import telemetry as cli
from repro_torch.workloads import harness
from test_torch_monitor import WALL_SERIES, WALL_SLOS, _steady_events
from test_torch_workloads import CAPS, SCENARIO, SEED, TICKS, _reference_run, _replaying

# F2 (tests/test_torch_controller.py): the port's float32 RLS sums in
# another order, so its predictions drift from the reference's
BETA_PRED_RTOL = 2.5e-3
MU_PRED_ATOL = 1.5e-2
SLOPE_ATOL = 1e-6  # cpu_slope over the same mu history, float32
# one unit of the printed digits (3 decimals) plus the F2 drift
PRINTED_ATOL = 1.5e-3
EXPORTER = '"exporter": "repro_torch.telemetry"'
# the report's fields that only a monitored run fills
MONITOR_FIELDS = ("monitor_enabled", "health_events", "burst_onset_tick", "slo_summary",
                  "slo_breaches", "slo_alerts", "controller_score", "decision_quality")


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_bucket_index_and_bounds_match_reference():
    rng = np.random.default_rng(0)
    values = [0, 1, 2, 3] + [int(v) for v in rng.integers(0, 2**62, 2_000)]
    values += [2**k + d for k in range(1, 100) for d in (-1, 0, 1)]
    assert [T.bucket_index(v) for v in values] == [R.bucket_index(v) for v in values]
    assert T.NBUCKETS == R.NBUCKETS
    for i in range(T.NBUCKETS):
        assert (T.bucket_lower_ns(i), T.bucket_upper_ns(i)) == \
            (R.bucket_lower_ns(i), R.bucket_upper_ns(i))


def test_histogram_percentiles_and_merge_match_reference():
    rng = np.random.default_rng(1)
    a = [int(v) for v in rng.lognormal(12, 3, 3_000)]
    b = [int(v) for v in rng.integers(0, 10**9, 500)] + [0, 1, 2**40]
    hists = []
    for pkg in (T, R):
        ha, hb = pkg.Histogram(), pkg.Histogram()
        for v in a:
            ha.record_ns(v)
        for v in b:
            hb.record_ns(v)
        delta = ha.since(pkg.Histogram())
        ha.merge(hb)
        hists.append((ha, hb, delta))
    for got, want in zip(*hists):
        assert got.counts == want.counts and got.count == want.count
        assert (got.sum_ns, got.max_ns) == (want.sum_ns, want.max_ns)
        assert got.stats() == want.stats()
        for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
            assert got.percentile_ns(q) == want.percentile_ns(q)


def _fill(pkg, reg):
    """Fill `reg` the same way in either package: spans on the main
    track and two shards (explicit clock values), counters, and two
    audit records, one resolved."""
    reg.t0_ns = 1_000_000
    spans = [("tick", None, 0, 5_000_123), ("filter", None, 10, 90_000),
             ("commit.upsert", 0, 100, 2_000_100), ("commit.upsert", 1, 200, 7_654_321),
             ("decide", 1, 300, 300), ("tick", None, 6_000_000, 9_999_999)]
    for name, shard, s0, s1 in spans:
        reg._finish(name, shard, reg.t0_ns + s0, reg.t0_ns + s1)
    reg.counters.update({"tick": 2, "commit": 1, "spill": 3})
    for seq, (shard, action, reason, mu_real) in enumerate(
            [(0, "push", "", 0.25), (1, "throttle", "pressure", None)]):
        reg.audit.append(pkg.AuditRecord(
            seq=seq, t=float(seq), ts_ns=reg.t0_ns + 1_234 * (seq + 1), shard=shard,
            action=action, reason=reason, beta=400 + seq, beta_e_pred=12.5,
            mu_pred=0.375, slope=-0.5,
            inputs={k: float(i) for i, k in enumerate(pkg.INPUT_KEYS)},
            mu_real=mu_real, beta_e_real=None if mu_real is None else 9.0))
    return reg


@pytest.fixture(scope="module")
def filled():
    return _fill(T, T.TelemetryRegistry()), _fill(R, R.TelemetryRegistry())


def test_child_registries_and_bounded_events_match_reference():
    got = []
    for pkg in (T, R):
        root = pkg.TelemetryRegistry(max_events=3)
        c0, c1 = root.child(0), root.child(1)
        for reg in (c0, c1, c1, root, c0):
            with reg.span("tick"):
                pass
        c0.count("push")
        c1.count("push", 2)
        got.append((root.shards(), root.stage_names(), root.aggregate("tick").count,
                    [root.hist("tick", s).count for s in (None, 0, 1)],
                    [(n, s) for n, s, _, _ in root.events], root.events_dropped,
                    c0.counters["push"], c1.counters["push"], root.counters["push"]))
        c0.enabled = False
        assert root.span("x") is pkg.NULL_SPAN and c1.span("x") is pkg.NULL_SPAN
    assert got[0] == got[1]
    assert got[0][:2] == ([0, 1], ["tick"]) and got[0][5] == 2


def test_disabled_path_zero_allocation_per_tick():
    reg = T.TelemetryRegistry(enabled=False)
    assert reg.span("a") is T.NULL_SPAN and T.NULL_REGISTRY.span("x") is T.NULL_SPAN
    for _ in range(16):  # warm any lazy interpreter state
        with reg.span("tick"):
            reg.count("x")
    filt = (tracemalloc.Filter(True, port_spans.__file__),)
    tracemalloc.start()
    before = tracemalloc.take_snapshot().filter_traces(filt)
    for _ in range(200):
        with reg.span("tick"):
            pass
        reg.observe("commit.total", 1e-6)
        reg.count("x")
    after = tracemalloc.take_snapshot().filter_traces(filt)
    tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "lineno") if d.size_diff > 0]
    assert grown == [], f"disabled path allocated: {grown}"
    assert reg.events == [] and reg.stage_names() == [] and reg.counters["x"] == 0


# ---------------------------------------------------------------------------
# the audit trail
# ---------------------------------------------------------------------------


def test_audit_record_and_resolve_match_reference():
    """One decision on the same PerfMon inputs (host floats only: the
    port's PerfMon holds no tensor the trail would read)."""
    perfmon = SimpleNamespace(
        velocity=lambda: (412.5, -3.25), rho_hist=[0.5, 0.75, 0.625],
        mu_hist=[0.0, 0.125, 0.4375], table_pressure=0.8125, sketch_rho=None,
        dict_hit=0.3)
    dec = SimpleNamespace(action="throttle", reason="pressure", beta=1234,
                          beta_e=56.5, mu_exp=0.625, slope=0.015625)
    got = []
    for pkg in (T, R):
        reg = pkg.TelemetryRegistry()
        trail = pkg.AuditTrail(reg.child(1), shard=1)
        trail.record(dec, perfmon, 7.0, spill_depth=3, dropped=17)
        trail.record(dec, perfmon, None, spill_depth=4, dropped=0)
        trail.resolve(0.5, 42.0)
        trail.resolve(0.9, 1.0)  # nothing open: ignored
        got.append([{k: v for k, v in r.to_dict().items() if k != "ts_ns"} for r in reg.audit])
    assert got[0] == got[1]
    assert got[0][1]["mu_real"] == 0.5 and got[0][0]["mu_real"] is None
    assert tuple(got[0][0]["inputs"]) == T.INPUT_KEYS == R.INPUT_KEYS


# ---------------------------------------------------------------------------
# the exporters, on registries filled the same way
# ---------------------------------------------------------------------------


def _ours(text):
    return text.replace('"exporter": "repro.telemetry"', EXPORTER)


def test_chrome_trace_matches_reference(filled, tmp_path):
    port, ref = filled
    meta = {"scenario": "flash_crowd", "seed": 0}
    got, want = T.chrome_trace(port, meta), R.chrome_trace(ref, meta)
    assert got["otherData"].pop("exporter") == "repro_torch.telemetry"
    assert want["otherData"].pop("exporter") == "repro.telemetry"
    assert got == want
    path = T.write_chrome_trace(port, str(tmp_path / "t.json"), meta)
    assert T.validate_chrome_trace(path, ("tick", "commit.upsert")) == \
        R.validate_chrome_trace(R.write_chrome_trace(ref, str(tmp_path / "r.json"), meta),
                                ("tick", "commit.upsert"))
    for bad in ({"traceEvents": []}, "{not json", {"x": 1}):
        assert T.validate_chrome_trace(bad)[0] is False
    assert T.validate_chrome_trace(path, ("nope",)) == R.validate_chrome_trace(
        str(tmp_path / "r.json"), ("nope",))


def test_jsonl_tsv_and_text_summary_match_reference(filled, tmp_path):
    port, ref = filled
    got = open(T.write_jsonl(port, str(tmp_path / "t.jsonl"))).read()
    want = open(R.write_jsonl(ref, str(tmp_path / "r.jsonl"))).read()
    assert EXPORTER in got and got == _ours(want)
    assert T.summary_tsv(port) == R.summary_tsv(ref)
    assert T.text_summary(port, max_decisions=1) == R.text_summary(ref, max_decisions=1)
    empty = (T.TelemetryRegistry(), R.TelemetryRegistry())
    assert T.text_summary(empty[0]) == R.text_summary(empty[1])
    assert T.summary_tsv(empty[0]) == R.summary_tsv(empty[1])


# ---------------------------------------------------------------------------
# the CLIs' dryrun, both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """The reference's run at the CLIs' dryrun deployment with telemetry,
    the monitor and both exporters on.  Then, replaying it on the CPU,
    the port's `run_scenario` with the same options, `launch.telemetry
    --dryrun` and `launch.monitor --dryrun`.  The monitor takes no
    decision, so this one reference run serves both CLIs: what the
    telemetry CLI prints and writes is held against it with the
    monitor's part left out."""
    tmp = tmp_path_factory.mktemp("telemetry")
    ref_reg, ref_mon = R.TelemetryRegistry(), RM.HealthMonitor()
    ref = _reference_run(tmp, False, telemetry=ref_reg, monitor=ref_mon,
                         trace=str(tmp / "ref.json"), trace_jsonl=str(tmp / "ref.jsonl"))
    run_reg = T.TelemetryRegistry()
    argv = ["--dryrun", "--device", "cpu", "--trace-out", str(tmp / "port.json"),
            "--jsonl-out", str(tmp / "port.jsonl")]
    out, mon_out = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        built = _replaying(mp, tmp, ref)
        run = harness.run_scenario(SCENARIO, ticks=TICKS, seed=SEED, device="cpu",
                                   telemetry=run_reg, monitor=True,
                                   trace=str(tmp / "run.json"),
                                   trace_jsonl=str(tmp / "run.jsonl"), **CAPS)
        run_mon = built["pipe"].monitor  # made by run_scenario(monitor=True)
        with contextlib.redirect_stdout(out):
            code, rep, reg = cli.run(argv)
        with contextlib.redirect_stdout(mon_out):
            mon_code, _, _ = monitor_cli.run(
                ["--dryrun", "--device", "cpu", "--report-out", str(tmp / "report.json"),
                 "--prom-out", str(tmp / "m.prom")])
    return dict(ref=ref, ref_reg=ref_reg, ref_mon=ref_mon, run=run, run_reg=run_reg,
                run_mon=run_mon, code=code, rep=rep, reg=reg, out=out.getvalue(),
                mon_code=mon_code, mon_out=mon_out.getvalue(), tmp=tmp, argv=argv)


def _unmonitored(report):
    """`report` as the reference's telemetry CLI, which runs no monitor,
    would have it."""
    return dataclasses.replace(report, **{f.name: _default(f) for f in dataclasses.fields(report)
                                          if f.name in MONITOR_FIELDS})


def _default(field):
    if field.default is not dataclasses.MISSING:
        return field.default
    return field.default_factory()


def test_dryrun_audit_trail_matches_reference(dryrun):
    got, want = dryrun["reg"].audit, dryrun["ref_reg"].audit
    assert len(got) == len(want) == dryrun["rep"].audit_decisions == 60
    assert {r.action for r in got} == {"push", "hold", "throttle"}
    for g, w in zip(got, want):
        assert (g.seq, g.t, g.shard, g.action, g.reason, g.beta) == \
            (w.seq, w.t, w.shard, w.action, w.reason, w.beta)
        assert g.inputs == w.inputs
        assert (g.mu_real, g.beta_e_real) == (w.mu_real, w.beta_e_real)
        assert g.beta_e_pred == pytest.approx(w.beta_e_pred, rel=BETA_PRED_RTOL, abs=1.0)
        assert g.mu_pred == pytest.approx(w.mu_pred, abs=MU_PRED_ATOL)
        assert g.slope == pytest.approx(w.slope, abs=SLOPE_ATOL)
    assert all(r.mu_real is not None for r in got)  # every tick resolves its decision


def _trace_digest(path):
    """What a trace must share with the reference's: per-name span
    counts on each track, the tracks, and the decision events in order
    with their args, the predictions aside (F2)."""
    with open(path) as f:
        trace = json.load(f)
    spans, tracks, decisions = {}, set(), []
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            spans[(e["name"], e["tid"])] = spans.get((e["name"], e["tid"]), 0) + 1
        elif e["ph"] == "M":
            tracks.add((e["tid"], e["args"]["name"]))
        elif e["ph"] == "i":
            args = {k: v for k, v in e["args"].items()
                    if k not in ("beta_e_pred", "mu_pred", "slope")}
            decisions.append((e["name"], e["tid"], args))
    other = {k: v for k, v in trace["otherData"].items() if k != "exporter"}
    return spans, tracks, decisions, other


def test_dryrun_chrome_trace_matches_reference(dryrun):
    tmp = dryrun["tmp"]
    ok, msg = T.validate_chrome_trace(str(tmp / "port.json"),
                                      cli.DRYRUN_REQUIRED_STAGES + ("commit.wait",))
    assert ok, msg
    got, want = _trace_digest(tmp / "port.json"), _trace_digest(tmp / "ref.json")
    assert got == want
    assert {n for n, _ in got[0]} == set(dryrun["ref_reg"].stage_names())
    assert got[3] == {"events_dropped": 0, "scenario": "flash_crowd", "seed": 0, "shards": 1}


def _jsonl_digest(path):
    """What a JSONL sink must share with the reference's: the predictions
    aside (F2), and the monitor's verdicts, which only a monitored run
    writes."""
    lines = [json.loads(x) for x in open(path)]
    kinds = [x["type"] for x in lines]
    spans = sorted((x["name"], x["shard"]) for x in lines if x["type"] == "span")
    hists = [(x["name"], x["shard"], x["count"]) for x in lines if x["type"] == "histogram"]
    counters = [x for x in lines if x["type"] == "counter"]
    audit = [{k: v for k, v in x.items() if k not in ("ts_ns", "beta_e_pred", "mu_pred",
                                                      "slope", "quality")}
             for x in lines if x["type"] == "audit"]
    meta = {k: v for k, v in lines[0].items() if k != "exporter"}
    return lines[0]["exporter"], kinds, spans, hists, counters, audit, meta


def test_dryrun_jsonl_sink_matches_reference(dryrun):
    tmp = dryrun["tmp"]
    got, want = _jsonl_digest(tmp / "port.jsonl"), _jsonl_digest(tmp / "ref.jsonl")
    assert (got[0], want[0]) == ("repro_torch.telemetry", "repro.telemetry")
    assert got[1:] == want[1:]
    assert {"meta", "span", "audit", "histogram", "counter"} == set(got[1])
    with open(tmp / "port.jsonl") as f:  # the telemetry CLI runs no monitor
        assert all(x.get("quality") is None for x in map(json.loads, f) if x["type"] == "audit")


def _split_printed(text, keys=("mu_pred",)):
    """`text` with wall-clock numbers masked, and the printed numbers
    after `keys` (predictions, F2) taken out to compare with a
    tolerance.  The per-stage rows keep their name and count, sorted by
    name (the CLI orders them by wall time)."""
    text = re.sub(r"[\d.]+/s wall", "<wall>/s wall", text)
    text = re.sub(r"(telemetry: \d+ stages, \d+ audited decisions \|).*", r"\1 <wall>", text)
    lines, stages, numbers = [], [], []
    in_table = False
    for line in text.splitlines():
        if line.startswith("== per-stage latency"):
            in_table = True
        elif in_table and not line.strip():
            in_table = False
            lines.extend(sorted(stages))
            stages = []
        elif in_table and not line.startswith("stage "):
            name, count = line.split()[:2]
            stages.append(f"{name} {count} <wall>")
            continue
        for key in keys:
            numbers += [float(x) for x in re.findall(rf"{key}=([-+\d.]+)", line)]
            line = re.sub(rf"{key}=[-+\d.]+", f"{key}=<f2>", line)
        lines.append(line)
    return "\n".join(lines), numbers


def test_dryrun_cli_prints_the_reference_output(dryrun):
    """`launch.telemetry --dryrun --device cpu` prints what the
    reference's CLI prints for its run: the report, the text summary,
    the files written and the trace check."""
    assert dryrun["code"] == 0
    ref, reg, tmp = dryrun["ref"], dryrun["ref_reg"], dryrun["tmp"]
    ok, msg = R.validate_chrome_trace(str(tmp / "ref.json"), cli.DRYRUN_REQUIRED_STAGES)
    assert ok
    want = "\n".join([
        _unmonitored(ref["report"]).summary(), "", R.text_summary(reg, max_decisions=20),
        f"(wrote Chrome trace to {tmp / 'port.json'} — load in ui.perfetto.dev or "
        f"chrome://tracing)",
        f"(wrote JSONL sink to {tmp / 'port.jsonl'})",
        f"dryrun ok: {msg}", ""])
    got_text, got_num = _split_printed(dryrun["out"])
    want_text, want_num = _split_printed(want)
    assert got_text == want_text
    assert len(got_num) == len(want_num) > 0
    np.testing.assert_allclose(got_num, want_num, rtol=0, atol=PRINTED_ATOL)


def test_report_carries_the_stage_breakdown(dryrun):
    rep, want = dryrun["rep"], _unmonitored(dryrun["ref"]["report"])
    assert dryrun["ref"]["report"].monitor_enabled and not rep.monitor_enabled
    assert rep.telemetry_enabled and want.telemetry_enabled
    assert set(rep.stage_latency_ms) == set(want.stage_latency_ms)
    for name, st in rep.stage_latency_ms.items():
        assert st["count"] == want.stage_latency_ms[name]["count"], name
        assert st["p95_ms"] >= st["p50_ms"] >= 0
    g = dataclasses.asdict(rep)
    w = dataclasses.asdict(want)
    for k in ("wall_s", "records_per_wall_s", "commit_ms_mean", "stage_latency_ms"):
        g.pop(k), w.pop(k)
    assert g == w


# ---------------------------------------------------------------------------
# the same run, monitored: run_scenario and launch.monitor
# ---------------------------------------------------------------------------


def test_audit_trail_matches_reference(dryrun):
    got, want = dryrun["run_reg"].audit, dryrun["ref_reg"].audit
    assert len(got) == len(want) == dryrun["run"].audit_decisions == TICKS
    for g, w in zip(got, want):
        assert (g.action, g.reason, g.beta, g.shard) == (w.action, w.reason, w.beta, w.shard)
        assert g.inputs == w.inputs  # dropped_inserts, spill_depth, pressure, ...
        assert (g.mu_real, g.beta_e_real) == (w.mu_real, w.beta_e_real)
        assert g.beta_e_pred == pytest.approx(w.beta_e_pred, rel=BETA_PRED_RTOL, abs=1.0)
        assert g.mu_pred == pytest.approx(w.mu_pred, abs=MU_PRED_ATOL)
        assert g.quality["resolved"] and g.quality["overload"] == w.quality["overload"]
        assert g.quality["overcautious"] == w.quality["overcautious"]
    assert sum(r.inputs["dropped_inserts"] > 0 for r in got) > 0
    assert max(r.inputs["spill_depth"] for r in got) > 0


def test_detector_events_and_slos_match_reference(dryrun):
    rep, want = dryrun["run"], dryrun["ref"]["report"]
    assert rep.monitor_enabled and want.monitor_enabled
    steady = _steady_events(rep.health_events)
    assert steady == _steady_events(want.health_events)
    assert {e["series"] for e in steady} >= {"rate", "drops", "mu", "spill_depth"}
    assert rep.burst_onset_tick == want.burst_onset_tick == 30
    assert set(rep.slo_summary) == set(want.slo_summary)
    for name, s in rep.slo_summary.items():
        if name not in WALL_SLOS:
            assert s == want.slo_summary[name], name
    breaches = {n: s["breaches"] for n, s in rep.slo_summary.items() if n not in WALL_SLOS}
    assert breaches["no_drops"] > 0 and sum(breaches.values()) > 0
    q, wq = rep.decision_quality, want.decision_quality
    for k in ("decisions", "resolved", "overload_decisions", "overcautious_decisions",
              "cpu_max"):
        assert q[k] == wq[k], k
    for k in ("controller_score", "mu_err_mean", "regret_mean"):
        assert q[k] == pytest.approx(wq[k], abs=PRINTED_ATOL), k
    assert rep.controller_score == pytest.approx(want.controller_score, abs=PRINTED_ATOL)


def _span_names(path):
    with open(path) as f:
        return {e["name"] for e in json.load(f)["traceEvents"] if e["ph"] == "X"}


def test_trace_span_names_match_reference(dryrun):
    tmp = dryrun["tmp"]
    assert _span_names(tmp / "run.json") == _span_names(tmp / "ref.json")
    assert {"commit.wait", "commit.upsert", "tick", "decide"} <= _span_names(tmp / "run.json")
    with open(tmp / "run.jsonl") as f:
        audit = [json.loads(x) for x in f if '"type": "audit"' in x]
    assert len(audit) == TICKS and all(a["quality"] is not None for a in audit)


def _metric_names(text):
    return {line.split("{")[0].split()[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def test_prometheus_metric_names_match_reference(dryrun):
    got = M.prometheus_text(monitor=dryrun["run_mon"], registry=dryrun["run_reg"])
    want = RM.prometheus_text(monitor=dryrun["ref_mon"], registry=dryrun["ref_reg"])
    assert _metric_names(got) == _metric_names(want)
    assert len(_metric_names(got)) >= 9
    counters = [line for line in got.splitlines() if line.startswith("repro_events_total")]
    assert counters == [line for line in want.splitlines()
                        if line.startswith("repro_events_total")]
    with open(dryrun["tmp"] / "m.prom") as f:
        assert _metric_names(f.read()) == _metric_names(want)


_PRINTED = (r"controller_score=", r"controller score: ", r"mu err mean ", r"regret total ",
            r"score_mean=", r"min=")


def _mask_monitor(text):
    """The monitor CLI's printout with the wall-clock parts masked: the
    wall rates, the stage latencies, the events of the wall-clock
    series, the `commit_p99` SLO, and the counts that include them; the
    printed scores (F2) taken out to compare with a tolerance."""
    text = re.sub(r"[\d.]+/s wall", "<wall>/s wall", text)
    text = re.sub(r"(telemetry: \d+ stages, \d+ audited decisions \|).*", r"\1 <wall>", text)
    text = re.sub(r"\d+ health events", "<n> health events", text)
    text = re.sub(r"\d+ (SLO-)?breaching ticks", r"<n> \1breaching ticks", text)
    text = re.sub(r"\d+ burn alerts", "<n> burn alerts", text)
    text = re.sub(r"SLOs \([^)]*\)", "SLOs (<missed>)", text)
    text = re.sub(r" ?commit_ms@tick\d+,?", "", text)
    lines, numbers = [], []
    for line in text.splitlines():
        if any(f" {s}/" in line for s in WALL_SERIES) or any(
                f"] {s}: " in line for s in WALL_SLOS):
            continue
        for key in _PRINTED:
            numbers += [float(x) for x in re.findall(rf"{key}([-+\d.]+)", line)]
            line = re.sub(rf"{key}[-+\d.]+", f"{key}<f2>", line)
        lines.append(line)
    return "\n".join(lines), numbers


def test_monitor_dryrun_cli_prints_the_reference_output(dryrun):
    """`launch.monitor --dryrun --device cpu` prints what the reference's
    CLI prints for its run: the report, the verdict, the files written
    and the dryrun checks."""
    assert dryrun["mon_code"] == 0
    tmp, ref = dryrun["tmp"], dryrun["ref"]
    want = "\n".join([ref["report"].summary(), "", RM.text_report(dryrun["ref_mon"]),
                      f"(wrote monitor report to {tmp / 'report.json'})",
                      f"(wrote Prometheus exposition to {tmp / 'm.prom'})", "dryrun ok", ""])
    got_text, got_num = _mask_monitor(dryrun["mon_out"])
    want_text, want_num = _mask_monitor(want)
    assert got_text == want_text
    assert len(got_num) == len(want_num) > 5
    np.testing.assert_allclose(got_num, want_num, rtol=0, atol=PRINTED_ATOL)
    with open(tmp / "report.json") as f:
        report = json.load(f)
    assert report["scenario"] == SCENARIO and report["burst_onset_tick"] == 30
    assert _steady_events(report["health_events"]) == \
        _steady_events(dryrun["ref"]["report"].health_events)
