"""Closed-loop controller evaluation harness.
Counterpart of `repro.workloads.harness`.

`run_scenario` drives a pipeline through a registry scenario and
condenses the run into a `WorkloadReport`: sustained throughput,
drop/spill/drain counts, the Algorithm-2 buffer-mode transition
timeline, the table-pressure throttles and, with `dict_compress`, the
GraphZip dictionary's references and hit rate.  The CLI
(`python -m repro_torch.launch.workload`) calls it.

The port runs one shard or several (`ShardedPipeline`), optionally
sketch-guided and with dictionary compression, with span telemetry and
the controller audit trail (`telemetry`, and the `trace` and
`trace_jsonl` exporters), the health monitor (`monitor`), batch lineage
and its watermarks (`lineage`, `lineage_jsonl`), injected commit faults
with backoff-governed retry (`fault_plan`, `retry`), and step-atomic
checkpoints with kill and resume (`checkpoint_dir`, `resume`, a plan's
`crash_at_tick`), at 64-bit or 32-bit keys (`key_dtype`).  It takes
every option of the reference's but `cfg`, which no caller passes, and
the report keeps every field of the reference's.  The reference's key
width follows JAX's x64 flag; the port's is the `key_dtype` argument.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.api import PipelineBuilder
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.device import resolve
from repro_torch.lineage import LineageTracker, flow_events, write_lineage_jsonl
from repro_torch.monitor import HealthMonitor, default_slos
from repro_torch.query.snapshot import build_snapshot
from repro_torch.resilience import PipelineCheckpointer, drive, pytree_digest
from repro_torch.telemetry import TelemetryRegistry, write_chrome_trace, write_jsonl
from repro_torch.workloads.scenarios import Scenario, get_scenario
from repro_torch.workloads.source import ScenarioSource


@dataclasses.dataclass
class WorkloadReport:
    """Structured result of one scenario run (JSON-safe via to_dict)."""

    scenario: str
    seed: int
    ticks: int
    shards: int
    sketch_guided: bool
    wall_s: float
    stream_s: float
    total_records: int
    records_per_stream_s: float  # sustained throughput in stream time
    records_per_wall_s: float    # what this host actually sustained
    total_instructions: int
    raw_instructions: int
    mean_compression: float
    spill_events: int
    drain_events: int
    dropped_inserts: int         # store-table inserts lost under pressure
    pressure_throttles: int      # one-shot table-pressure throttles fired
    action_counts: Dict[str, int]
    transitions: List[Dict]      # [{t, shard, from, to}] buffer-mode timeline
    mu_mean: float
    mu_p95: float
    mu_max: float
    delay_max_s: float
    store_nodes: int
    store_edges: int
    # dictionary-compression path (zeros when off)
    dict_compress: bool = False
    pattern_refs: int = 0        # total (pattern_id, bindings) references
    dict_hit_rate: float = 0.0   # dictionary hit rate over the whole run
    commit_ms_mean: float = 0.0  # mean successful-commit latency (ms)
    # resilience path (inert defaults when off)
    commit_failures: int = 0     # failed commit attempts (injected or real)
    retries_replayed: int = 0    # archived batches successfully re-committed
    archived_total: int = 0      # batches ever archived (no-batch-lost LHS)
    archive_remaining: int = 0   # batches still awaiting replay at run end
    pool_overflows: int = 0      # pool-cap diversions to the archive
    degraded_events: int = 0     # ticks served in degraded (store-down) mode
    checkpoints_saved: int = 0
    resumed_from_tick: int = -1  # -1 = fresh run (not resumed)
    store_digest: str = ""       # pytree sha256 of the final GraphStore
    snapshot_digest: str = ""    # pytree sha256 of build_snapshot(store)
    # telemetry (empty when the registry is off)
    telemetry_enabled: bool = False
    # per-stage latency breakdown, aggregated across shards:
    # {stage: {count, mean_ms, p50_ms, p95_ms, p99_ms, max_ms, total_s}}
    stage_latency_ms: Dict[str, Dict[str, float]] = \
        dataclasses.field(default_factory=dict)
    audit_decisions: int = 0     # controller audit-trail records
    # health monitoring (inert defaults when off)
    monitor_enabled: bool = False
    health_events: List[Dict] = dataclasses.field(default_factory=list)
    burst_onset_tick: int = -1   # first "rate" onset (-1 = none detected)
    slo_summary: Dict = dataclasses.field(default_factory=dict)
    slo_breaches: int = 0        # SLO-breaching ticks across all specs
    slo_alerts: int = 0          # multi-window burn-rate alert onsets
    controller_score: float = 1.0  # mean per-decision quality in [0,1]
    decision_quality: Dict = dataclasses.field(default_factory=dict)
    # lineage / freshness (inert defaults when off)
    lineage_enabled: bool = False
    ingest_lag_ms_p50: float = 0.0   # store staleness (stream-time ms)
    ingest_lag_ms_p99: float = 0.0
    queryable_lag_ms_p99: float = 0.0  # query-surface staleness
    path_mix: Dict[str, int] = dataclasses.field(default_factory=dict)
    # final watermarks: {committed, queryable, max_event_t, pending_*}
    watermark_final: Dict = dataclasses.field(default_factory=dict)
    records_in: int = 0          # records that entered the buffer
    records_committed: int = 0   # ... that landed in the store
    records_dropped: int = 0     # ... terminally lost (lineage-observed)
    records_in_flight: int = 0   # ... still buffered/spilled/archived
    conservation_warning: str = ""  # non-empty iff the invariant broke

    @property
    def n_transitions(self) -> int:
        return len(self.transitions)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["n_transitions"] = self.n_transitions
        return json.loads(json.dumps(d, default=float))  # force JSON-safe

    def summary(self) -> str:
        acts = " ".join(f"{k}={v}" for k, v in sorted(self.action_counts.items()))
        return (
            f"scenario={self.scenario} ticks={self.ticks} shards={self.shards}\n"
            f"records={self.total_records} "
            f"({self.records_per_stream_s:.1f}/s stream, "
            f"{self.records_per_wall_s:.1f}/s wall) "
            f"instructions={self.total_instructions} "
            f"(raw {self.raw_instructions}, cr {self.mean_compression:.3f})\n"
            f"mu: mean={self.mu_mean:.3f} p95={self.mu_p95:.3f} "
            f"max={self.mu_max:.3f} delay_max={self.delay_max_s:.1f}s\n"
            f"control: {acts} | transitions={self.n_transitions} "
            f"spills={self.spill_events} drains={self.drain_events} "
            f"pressure_throttles={self.pressure_throttles} "
            f"dropped_inserts={self.dropped_inserts}\n"
            f"store: {self.store_nodes} nodes, {self.store_edges} edges"
            + (f"\ndict: refs={self.pattern_refs} "
               f"hit_rate={self.dict_hit_rate:.3f} "
               f"commit_ms={self.commit_ms_mean:.2f}"
               if self.dict_compress else "")
            + (self._stage_summary() if self.telemetry_enabled else "")
            + (self._monitor_summary() if self.monitor_enabled else "")
            + (self._lineage_summary() if self.lineage_enabled else "")
        )

    def _lineage_summary(self) -> str:
        mix = " ".join(f"{k}={v}" for k, v in sorted(self.path_mix.items()))
        wq = self.watermark_final.get("queryable")
        warn = f" | WARNING: {self.conservation_warning}" \
            if self.conservation_warning else ""
        return (f"\nlineage: {self.records_in} in -> "
                f"{self.records_committed} committed, "
                f"{self.records_dropped} dropped, "
                f"{self.records_in_flight} in flight | "
                f"lag p50={self.ingest_lag_ms_p50:.0f}ms "
                f"query_p99={self.queryable_lag_ms_p99:.0f}ms | "
                f"paths: {mix or '-'} | Wq="
                + (f"{wq:.1f}" if wq is not None else "-") + warn)

    def _monitor_summary(self) -> str:
        onset = f"burst_onset_tick={self.burst_onset_tick}" \
            if self.burst_onset_tick >= 0 else "no burst onset"
        missed = [n for n, s in self.slo_summary.items()
                  if not s.get("met", True)]
        slos = f"{len(self.slo_summary)} SLOs" \
            + (f" ({len(missed)} missed: {', '.join(sorted(missed))})"
               if missed else " (all met)")
        return (f"\nmonitor: {len(self.health_events)} health events, "
                f"{onset} | {slos}, {self.slo_breaches} breaching ticks, "
                f"{self.slo_alerts} burn alerts | controller_score="
                f"{self.controller_score:.4f}")

    def _stage_summary(self, top: int = 6) -> str:
        if not self.stage_latency_ms:
            return "\ntelemetry: on (no spans recorded)"
        ranked = sorted(self.stage_latency_ms.items(),
                        key=lambda kv: -kv[1].get("total_s", 0.0))[:top]
        rows = "  ".join(
            f"{name}: p50={st['p50_ms']:.2f} p95={st['p95_ms']:.2f}ms"
            for name, st in ranked)
        return (f"\ntelemetry: {len(self.stage_latency_ms)} stages, "
                f"{self.audit_decisions} audited decisions | {rows}")


def _timeline(samples: Dict, actions: List[str], shard: int) -> List[Dict]:
    """Buffer-mode transitions from one pipeline trace."""
    ts = samples.get("t", np.asarray([]))
    out = []
    for i in range(1, len(actions)):
        if actions[i] != actions[i - 1]:
            out.append({"t": float(ts[i]) if i < len(ts) else float(i),
                        "shard": shard,
                        "from": actions[i - 1], "to": actions[i]})
    return out


class _Tally:
    """Commit-event counts the report reads: dropped inserts,
    dictionary references, and the hit rate summed over commits."""

    def __init__(self):
        self.dropped = self.refs = self.commits = 0
        self.hit_sum = 0.0

    def __call__(self, ev) -> None:
        if ev.kind == "commit":
            self.dropped += int(ev.payload.get("dropped", 0))
            self.refs += int(ev.payload.get("refs", 0))
            self.hit_sum += float(ev.payload.get("dict_hit_rate", 0.0))
            self.commits += 1


def scenario_builder(
    scn: Scenario,
    *,
    seed: int = 0,
    speed: float = 0.5,
    rate_scale: float = 1.0,
    sketch_guided: bool = False,
    dict_compress: bool = False,
    dict_capacity: int = 4096,
    node_cap: Optional[int] = None,
    edge_cap: Optional[int] = None,
    shards: int = 1,
    spill_dir: Optional[str] = None,
    key_dtype: torch.dtype = torch.int64,
    device: Union[str, torch.device, None] = None,
):
    """The pipeline `run_scenario` drives, not yet built: returns
    (builder, source, tally), the tally counting the commit events the
    report reads.  A caller may add to the builder (metrics, event
    handlers) before `build()`.  Without `spill_dir` each controller
    spills into a fresh temporary directory of its own.

    `key_dtype` is the width of every key of the pipeline, handed to
    `PipelineBuilder`: torch.int64 (uint64 bits, the reference's keys
    under x64) or torch.int32 (uint32 bits, its keys without x64)."""
    dev = resolve(device)
    cfg = IngestConfig(
        mean_rate=scn.base_rate,
        store_nodes=node_cap or IngestConfig.store_nodes,
        store_edges=edge_cap or IngestConfig.store_edges,
    )
    src = ScenarioSource(scn, seed=seed, rate_scale=rate_scale, device=dev)
    tally = _Tally()
    b = (PipelineBuilder(cfg, device=dev, key_dtype=key_dtype)
         .with_source(src)
         .simulated_consumer(speed=speed)
         .on_event(tally))
    if spill_dir is not None:
        b = b.spill_dir(spill_dir)
    if sketch_guided:
        b = b.sketch_guided()
    if dict_compress:
        b = b.with_compression(capacity=dict_capacity)
    if shards > 1:
        b = b.sharded(shards)
    return b, src, tally


def run_scenario(
    scenario: Union[Scenario, str],
    *,
    ticks: Optional[int] = None,
    seed: int = 0,
    shards: int = 1,
    speed: float = 0.5,
    rate_scale: float = 1.0,
    sketch_guided: bool = False,
    dict_compress: bool = False,
    dict_capacity: int = 4096,
    node_cap: Optional[int] = None,
    edge_cap: Optional[int] = None,
    spill_dir: Optional[str] = None,
    on_event=None,
    telemetry=None,
    monitor=None,
    lineage=None,
    trace: Optional[str] = None,
    trace_jsonl: Optional[str] = None,
    lineage_jsonl: Optional[str] = None,
    fault_plan=None,
    retry=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 16,
    checkpoint_keep: int = 3,
    resume: bool = False,
    key_dtype: torch.dtype = torch.int64,
    device: Union[str, torch.device, None] = None,
) -> WorkloadReport:
    """Drive a pipeline through `scenario` on `device` (default the
    card) and report (module docstring).

    `key_dtype` is the width of the pipeline's keys, chosen once here
    and handed on to every stage, shard and checkpoint: torch.int64
    (the default; uint64 bits, as the reference's `run_scenario` keys
    under x64) or torch.int32 (uint32 bits, as it keys without x64).
    Every option below works at either width; a resume refuses a
    checkpoint saved at the other.

    `speed` scales the simulated consumer (0.5 = the paper's half-
    capacity store engine, the setting that makes bursts bite);
    `node_cap`/`edge_cap` shrink the store; `shards` > 1 partitions the
    stream by user over that many controllers (`ShardedPipeline`);
    `dict_compress` turns on the GraphZip dictionary-compression path
    (`with_compression`); `spill_dir` is where the controller spills
    (default: a fresh temporary directory) and, as `<spill_dir>_archive`,
    where the retry archive overflows.

    `telemetry` turns on span telemetry + the controller audit trail
    (pass True, or a `repro_torch.telemetry.TelemetryRegistry` to keep
    for inspection); `trace` writes a Perfetto-loadable Chrome trace
    there after the run and `trace_jsonl` the flat JSONL sink; either
    implies telemetry.  The report then carries the per-stage
    p50/p95/p99 latency breakdown (`stage_latency_ms`).

    `monitor` turns on online health monitoring (pass True, or a
    configured `repro_torch.monitor.HealthMonitor` to keep for
    inspection) and implies telemetry.  The report then carries the
    detector `health_events` (with `burst_onset_tick`), the per-SLO
    budget/burn summary and the controller decision-quality score
    (`controller_score`); every audit record gains its `quality`
    verdict in place.

    `lineage` turns on event-time watermarks + per-batch provenance
    (pass True, or a `repro_torch.lineage.LineageTracker` to keep for
    inspection).  The report then carries the freshness SLIs
    (`ingest_lag_ms_p50/p99`, `queryable_lag_ms_p99`), the commit path
    mix, the final watermarks, and the record-conservation counters
    (with `conservation_warning` set iff the invariant ``records_in ==
    committed + dropped + in_flight`` broke).  With `trace` also set,
    the Chrome trace gains per-batch flow events; `lineage_jsonl`
    writes the sampled hop logs (implies lineage).

    Resilience (repro_torch.resilience): `fault_plan` injects commit
    faults (and, through `crash_at_tick`, raises `PipelineKilled`
    mid-run); it arms the default `RetryPolicy` unless `retry`
    overrides (pass a policy to customise, `False` to disable).
    `checkpoint_dir` turns on periodic step-atomic checkpoints every
    `checkpoint_every` ticks, keeping the last `checkpoint_keep`;
    `resume=True` restores the latest one (same scenario, seed and
    shards enforced) and runs only the remaining ticks, bit-exact
    against an uninterrupted run.  With any of these active the report
    carries the retry and archive accounting and the store and snapshot
    digests."""
    if shards < 1:
        raise ValueError("shards must be >= 1")
    scn = get_scenario(scenario) if isinstance(scenario, str) else scenario
    ticks = int(ticks if ticks is not None else scn.ticks)
    b, src, tally = scenario_builder(
        scn, seed=seed, speed=speed, rate_scale=rate_scale,
        sketch_guided=sketch_guided, dict_compress=dict_compress,
        dict_capacity=dict_capacity, node_cap=node_cap, edge_cap=edge_cap,
        shards=shards, spill_dir=spill_dir, key_dtype=key_dtype,
        device=device)
    reg = None
    if telemetry or trace or trace_jsonl or monitor:
        reg = telemetry if isinstance(telemetry, TelemetryRegistry) \
            else TelemetryRegistry()
        b = b.with_telemetry(reg)
    mon = None
    if monitor:
        mon = monitor if isinstance(monitor, HealthMonitor) \
            else HealthMonitor(slos=default_slos(
                cpu_max=b.cfg.cpu_max, theta2=b.cfg.theta2,
                checkpoint_every=checkpoint_every if checkpoint_dir is not None else 0))
        b = b.with_monitor(mon)
    trk = None
    if lineage or lineage_jsonl:
        trk = lineage if isinstance(lineage, LineageTracker) \
            else LineageTracker(dt=float(src.dt))
        b = b.with_lineage(trk)
    if fault_plan is not None:
        b = b.with_faults(fault_plan)
    if retry is not False and (retry is not None or fault_plan is not None):
        # a fault plan arms the default policy unless retry=False
        b = b.with_retry(retry if retry not in (None, True) else None,
                         archive_dir=f"{spill_dir}_archive" if spill_dir is not None else None)
    if on_event is not None:
        b = b.on_event(on_event)
    pipe = b.build()

    resilient = (fault_plan is not None or checkpoint_dir is not None
                 or (retry is not None and retry is not False))
    ckpt = None
    ckpt_extra = {"scenario": scn.name, "seed": seed, "shards": shards}
    if checkpoint_dir is not None:
        ckpt = PipelineCheckpointer(checkpoint_dir, keep=checkpoint_keep,
                                    every=checkpoint_every, telemetry=reg)
    start_tick = 0
    if resume:
        if ckpt is None:
            raise ValueError("resume=True needs checkpoint_dir")
        manifest = ckpt.restore(pipe, src, expect=ckpt_extra)
        start_tick = int(manifest["step"])

    if ckpt is not None or fault_plan is not None:
        stream = drive(src.ticks(), pipe, src, checkpointer=ckpt,
                       fault_plan=fault_plan, start_tick=start_tick,
                       extra=ckpt_extra)
        try:
            rep = pipe.run(stream, max_ticks=max(ticks - start_tick, 0))
        finally:
            if ckpt is not None:
                ckpt.wait()
    else:
        rep = pipe.run(max_ticks=ticks)

    if shards > 1:
        sub = rep.shards
        mu = np.concatenate([r.samples["mu"] for r in sub])
        delay = np.concatenate([r.samples["delay_s"] for r in sub])
        transitions = [tr for si, r in enumerate(sub)
                       for tr in _timeline(r.samples, r.actions, si)]
        transitions.sort(key=lambda tr: tr["t"])
        controllers = [s.controller for s in pipe.shards]
        actions = [a for r in sub for a in r.actions]
    else:
        mu, delay = rep.samples["mu"], rep.samples["delay_s"]
        transitions = _timeline(rep.samples, rep.actions, 0)
        controllers = [pipe.buffer_stage.controller]
        actions = list(rep.actions)
    mu = mu if len(mu) else np.asarray([0.0])
    delay = delay if len(delay) else np.asarray([0.0])
    counts: Dict[str, int] = {}
    for a in actions:
        counts[a] = counts.get(a, 0) + 1
    ingestor = pipe.sink.ingestor
    commit_ms = [1e3 * c.busy_s for c in ingestor.commits if c.ok]
    store_digest = snapshot_digest = ""
    if resilient:
        store_digest = pytree_digest(pipe.store)
        snapshot_digest = pytree_digest(build_snapshot(pipe.store))
    mon_report: Dict = {}
    if mon is not None:
        # finish BEFORE the exporters run, so that every audit record
        # already carries its quality verdict in the trace files
        mon.finish()
        mon_report = mon.report()
    lineage_lags: Dict[str, float] = {}
    cons: Dict = {}
    cons_warning = ""
    if trk is not None:
        # conservation: whatever still sits in the stage buffers and
        # spill files is accounted in flight, not lost
        stages = pipe.shards if shards > 1 else [pipe.buffer_stage]
        buffered = sum(len(st.buffer) + st.spilled_records for st in stages)
        cons = trk.conservation(buffered_records=buffered)
        if cons["imbalance"]:
            cons_warning = (f"record conservation broke: in="
                            f"{cons['records_in']} != committed="
                            f"{cons['records_committed']} + dropped="
                            f"{cons['records_dropped']} + in_flight="
                            f"{cons['records_in_flight']} "
                            f"(imbalance {cons['imbalance']:+d})")
        lineage_lags = trk.lag_percentiles_ms()
        if lineage_jsonl:
            write_lineage_jsonl(trk, lineage_jsonl, meta={
                "scenario": scn.name, "seed": seed, "shards": shards,
                "conservation_warning": cons_warning})
    stage_latency: Dict[str, Dict[str, float]] = {}
    if reg is not None:
        stage_latency = reg.summary()
        if trace:
            write_chrome_trace(reg, trace, meta={
                "scenario": scn.name, "seed": seed, "shards": shards},
                extra_events=flow_events(trk, reg.t0_ns) if trk is not None else None)
        if trace_jsonl:
            write_jsonl(reg, trace_jsonl)
    return WorkloadReport(
        scenario=scn.name,
        seed=seed,
        ticks=ticks,
        shards=shards,
        sketch_guided=sketch_guided,
        wall_s=float(rep.wall_s),
        stream_s=float(ticks * src.dt),
        total_records=int(rep.total_records),
        records_per_stream_s=rep.total_records / max(ticks * src.dt, 1e-9),
        records_per_wall_s=rep.total_records / max(rep.wall_s, 1e-9),
        total_instructions=int(rep.total_instructions),
        raw_instructions=int(rep.raw_instructions),
        mean_compression=float(rep.mean_compression),
        spill_events=int(rep.spill_events),
        drain_events=int(rep.drain_events),
        dropped_inserts=tally.dropped,
        pressure_throttles=sum(c.pressure_throttles for c in controllers),
        action_counts=counts,
        transitions=transitions,
        mu_mean=float(mu.mean()),
        mu_p95=float(np.percentile(mu, 95)),
        mu_max=float(mu.max()),
        delay_max_s=float(delay.max()),
        store_nodes=int(pipe.store.n_nodes),
        store_edges=int(pipe.store.n_edges),
        dict_compress=dict_compress,
        pattern_refs=tally.refs,
        dict_hit_rate=tally.hit_sum / max(tally.commits, 1),
        commit_ms_mean=float(np.mean(commit_ms)) if commit_ms else 0.0,
        commit_failures=sum(1 for c in ingestor.commits if not c.ok),
        retries_replayed=ingestor.replayed,
        archived_total=ingestor.archived_total,
        archive_remaining=ingestor.archive_depth,
        pool_overflows=ingestor.pool_overflows,
        degraded_events=int(pipe.metrics.counters["degraded"]),
        checkpoints_saved=ckpt.saves if ckpt is not None else 0,
        resumed_from_tick=start_tick if resume else -1,
        store_digest=store_digest,
        snapshot_digest=snapshot_digest,
        telemetry_enabled=reg is not None,
        stage_latency_ms=stage_latency,
        audit_decisions=len(reg.audit) if reg is not None else 0,
        monitor_enabled=mon is not None,
        health_events=mon_report.get("health_events", []),
        burst_onset_tick=mon_report.get("burst_onset_tick", -1),
        slo_summary=mon_report.get("slo", {}),
        slo_breaches=mon_report.get("slo_breaches", 0),
        slo_alerts=mon_report.get("slo_alerts", 0),
        controller_score=mon_report.get("controller_score", 1.0),
        decision_quality=mon_report.get("quality", {}),
        lineage_enabled=trk is not None,
        ingest_lag_ms_p50=lineage_lags.get("ingest_lag_ms_p50", 0.0),
        ingest_lag_ms_p99=lineage_lags.get("ingest_lag_ms_p99", 0.0),
        queryable_lag_ms_p99=lineage_lags.get("queryable_lag_ms_p99", 0.0),
        path_mix=dict(trk.path_counts) if trk is not None else {},
        watermark_final=trk.watermarks() if trk is not None else {},
        records_in=cons.get("records_in", 0),
        records_committed=cons.get("records_committed", 0),
        records_dropped=cons.get("records_dropped", 0),
        records_in_flight=cons.get("records_in_flight", 0),
        conservation_warning=cons_warning,
    )
