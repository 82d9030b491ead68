"""Port parity: checkpoint and resume (`repro_torch.resilience`'s
`PipelineCheckpointer`, `drive` and `pytree_digest`, `run_scenario`'s
`checkpoint_dir`, `checkpoint_every`, `checkpoint_keep`, `resume` and
`spill_dir`, the checkpoint-cadence SLO, and `launch.chaos`).

  * Unit cases on the port's own tiny pipelines, as tests/test_resilience.py
    has them for the reference: the save and restore round trip, after
    which both pipelines continue identically (raw, with the query sink
    and GraphZip, with a sketch stage, and two shards); a save that does
    not block, taken while the pipeline runs on, restores the state of its
    own tick; an `expect` mismatch, a torn checkpoint, keep-N GC, no
    checkpoint, a pipeline configured differently, and a host blob that
    names a jax class.
  * Counter dtypes: `pytree_digest` and the saved leaves of a store, a
    sketch, a dictionary and a snapshot, fresh and updated, equal the
    reference's at 64-bit keys (x64, where its counters promote to int64
    on their first update) and at 32-bit keys (no x64, all int32), and
    survive the trip back into the port.
  * One reference `run_scenario` at `launch.chaos --dryrun`'s deployment
    (flash_crowd, 48 ticks, seed 0, 2^12/2^14, a store outage over 10:18,
    the default `RetryPolicy`), uninterrupted, checkpointing every 8
    ticks and keeping 6, its records and decisions recorded.  Replaying
    it (ROADMAP F1 and F2), the port writes the same manifests and
    byte-identical `.npy` leaves at every step and the same report,
    digests included; it resumes the reference's step-16 checkpoint
    (the reference's `host.pkl` read through the class-mapping
    unpickler) onto the reference's final digests; and `launch.chaos
    --dryrun --device cpu` prints the reference CLI's output for it.
  * The port's own kill and resume, bit-exact, in flash_crowd and
    celebrity_cascade and with two shards, the outage's backoff, and the
    inert report of a run without faults (no reference run needed).
"""
import dataclasses
import filecmp
import io
import json
import math
import os
import pickle
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

import repro.monitor as RM
import repro.resilience as RR
import repro_torch.monitor as M
import repro_torch.resilience as R
from repro.api import MetricsHub as RefHub
from repro.compress import dictionary as RD
from repro.core.edge_table import from_raw_batch as ref_from_raw
from repro.core.transform import create_edges as ref_create_edges
from repro.core.transform import tweet_mapping as ref_tweet_mapping
from repro.graphstore import store as RS
from repro.query import sketch as RQ
from repro.query import snapshot as RSN
from repro_torch import convert
from repro_torch.api import MetricsHub, PipelineBuilder
from repro_torch.compress import dictionary as PD
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.core import compression as C
from repro_torch.core.edge_table import from_raw_batch
from repro_torch.core.transform import create_edges, tweet_mapping
from repro_torch.graphstore import store as PS
from repro_torch.launch import chaos
from repro_torch.query import sketch as PQ
from repro_torch.query import snapshot as PSN
from repro_torch.resilience import checkpoint as CK
from repro_torch.workloads import ScenarioSource, harness
from test_torch_monitor import _Ev
from test_torch_workloads import CAPS, SCENARIO, SEED, WALL_FIELDS, _reference_run, _replaying

# ---------------------------------------------------------------------------
# unit cases on the port's own pipelines
# ---------------------------------------------------------------------------

KINDS = ("raw", "query+dict", "sketch_stage", "sharded")
COMPONENTS = {"raw": {"store"}, "query+dict": {"store", "sink_sketch", "stage0_dict"},
              "sketch_stage": {"store", "stage0_sketch"}, "sharded": {"store"}}


def _tiny_pipe(tmp_path, tag, kind="raw"):
    src = ScenarioSource("steady_state", seed=5, device="cpu")
    b = (PipelineBuilder(IngestConfig(store_nodes=1 << 11, store_edges=1 << 12), device="cpu")
         .with_source(src)
         .simulated_consumer(speed=1.0)
         .spill_dir(str(tmp_path / f"spill_{tag}")))
    if kind == "query+dict":
        b = b.sketch_guided().with_compression(capacity=512)
    elif kind == "sketch_stage":
        b = b.with_sketch(width=128)
    elif kind == "sharded":
        b = b.sharded(2)
    return b.build(), src


def _digests(pipe):
    """Every array component's digest, and the served snapshot's."""
    out = {name: R.pytree_digest(obj) for name, obj in CK._array_components(pipe).items()}
    out["snapshot"] = R.pytree_digest(PSN.build_snapshot(pipe.store))
    if hasattr(pipe.sink, "snapshot"):
        out["served"] = R.pytree_digest(pipe.sink.snapshot())
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_save_restore_roundtrip(tmp_path, kind):
    """Restored, a freshly built pipeline holds the saved components and
    cursor, and both continue identically: no holder of the store, the
    sketch or the dictionary kept the old one."""
    pipe, src = _tiny_pipe(tmp_path, "save", kind)
    pipe.run(max_ticks=12)
    ck = R.PipelineCheckpointer(str(tmp_path / "ck"), every=4)
    ck.save(12, pipe, src, blocking=True, extra={"seed": 5})
    assert ck.list_steps() == [12]

    pipe2, src2 = _tiny_pipe(tmp_path, "load", kind)
    man = ck.restore(pipe2, src2, expect={"seed": 5})
    assert man["step"] == 12
    assert set(CK._array_components(pipe2)) == COMPONENTS[kind]
    assert _digests(pipe2) == _digests(pipe)
    assert src2.state() == src.state()
    assert pipe2.metrics.counters == pipe.metrics.counters
    pipe.run(max_ticks=6)
    pipe2.run(max_ticks=6)
    assert _digests(pipe2) == _digests(pipe)
    assert pipe2.metrics.counters == pipe.metrics.counters
    assert int(pipe.store.n_nodes) > 0


def test_nonblocking_save_holds_the_state_of_its_tick(tmp_path, monkeypatch):
    """On the host `.numpy()` shares the live tensors, which the store
    updates in place: the capture copies every leaf before `save`
    returns, so a write held back until the pipeline has run on still
    restores the state of the save's tick."""
    pipe, src = _tiny_pipe(tmp_path, "nb", "query+dict")
    pipe.run(max_ticks=8)
    want = _digests(pipe)
    gate, np_save = threading.Event(), np.save

    def held_save(*args, **kw):
        assert gate.wait(60)
        return np_save(*args, **kw)

    monkeypatch.setattr(np, "save", held_save)
    ck = R.PipelineCheckpointer(str(tmp_path / "ck"))
    ck.save(8, pipe, src)
    pipe.run(max_ticks=6)
    assert _digests(pipe) != want
    gate.set()
    ck.wait()
    pipe2, src2 = _tiny_pipe(tmp_path, "nb2", "query+dict")
    ck.restore(pipe2, src2)
    assert _digests(pipe2) == want


def test_checkpoint_expect_mismatch_is_hard_error(tmp_path):
    pipe, src = _tiny_pipe(tmp_path, "exp")
    pipe.run(max_ticks=4)
    ck = R.PipelineCheckpointer(str(tmp_path / "ck"))
    ck.save(4, pipe, src, blocking=True, extra={"seed": 5})
    pipe2, src2 = _tiny_pipe(tmp_path, "exp2")
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore(pipe2, src2, expect={"seed": 6})


def test_torn_checkpoint_ignored_and_gc_keeps_n(tmp_path):
    pipe, src = _tiny_pipe(tmp_path, "gc")
    pipe.run(max_ticks=4)
    ck = R.PipelineCheckpointer(str(tmp_path / "ck"), keep=2)
    for step in (4, 8, 12, 16):
        ck.save(step, pipe, src, blocking=True)
    assert ck.list_steps() == [12, 16]  # keep-N GC
    # a torn checkpoint (no _COMMITTED) is invisible to discovery
    os.remove(str(tmp_path / "ck" / "step_00000016" / "_COMMITTED"))
    assert ck.list_steps() == [12]
    assert ck.latest_step() == 12
    with pytest.raises(ValueError, match=">= 1"):
        R.PipelineCheckpointer(str(tmp_path / "ck"), every=0)


def test_restore_without_checkpoint_raises(tmp_path):
    pipe, src = _tiny_pipe(tmp_path, "none")
    ck = R.PipelineCheckpointer(str(tmp_path / "ck"))
    with pytest.raises(FileNotFoundError):
        ck.restore(pipe, src)


@pytest.mark.parametrize("saved,into,match", [("query+dict", "raw", "does not"),
                                              ("raw", "query+dict", "lacks leaf")])
def test_restore_into_a_pipeline_configured_differently_raises(tmp_path, saved, into, match):
    pipe, src = _tiny_pipe(tmp_path, "a", saved)
    pipe.run(max_ticks=4)
    ck = R.PipelineCheckpointer(str(tmp_path / "ck"))
    ck.save(4, pipe, src, blocking=True)
    pipe2, src2 = _tiny_pipe(tmp_path, "b", into)
    with pytest.raises(KeyError, match=match):
        ck.restore(pipe2, src2)


def test_host_blob_is_numpy_and_plain_python(tmp_path):
    """The host blob names no torch class (a card's checkpoint restores on
    the host), and the restore refuses a jax class with a clear error."""
    pipe, src = _tiny_pipe(tmp_path, "host", "query+dict")
    pipe.run(max_ticks=8)
    ck = R.PipelineCheckpointer(str(tmp_path / "ck"))
    ck.save(8, pipe, src, blocking=True)
    seen = set()

    class Recording(CK._HostUnpickler):
        def find_class(self, module, name):
            seen.add(module)
            return super().find_class(module, name)

    with open(tmp_path / "ck" / "step_00000008" / "host.pkl", "rb") as f:
        Recording(f).load()
    assert seen and not any(m.split(".")[0] == "torch" for m in seen), seen
    with pytest.raises(pickle.UnpicklingError, match="jax"):
        CK._HostUnpickler(io.BytesIO(b"cjax._src.array\nArrayImpl\n.")).load()


# ---------------------------------------------------------------------------
# counter dtypes: digests and leaves against the reference's
# ---------------------------------------------------------------------------


def _records(tag, n=24):
    return [{"id": f"{tag}{i}", "user": f"u{tag}{i % 7}", "hashtags": [f"h{i % 5}"],
             "mentions": [f"u{tag}{(i * 3) % 11}"]} for i in range(n)]


def _tables(bits, tag):
    """The same batch as the reference's EdgeTable (built under the x64
    mode of `bits`) and the port's."""
    kd = torch.int64 if bits == 64 else torch.int32
    return (ref_from_raw(ref_create_edges(_records(tag), ref_tweet_mapping()), 64),
            from_raw_batch(create_edges(_records(tag), tweet_mapping()), 64, device="cpu",
                           key_dtype=kd))


def _structures(bits, case):
    """(reference structure, port structure) in state `case`."""
    kd = torch.int64 if bits == 64 else torch.int32
    what, state = case.split("-")
    (ra, pa), (rb, pb) = _tables(bits, "a"), _tables(bits, "b")
    if what in ("store", "snapshot"):
        rs, ps = RS.init_store(256, 512), PS.init_store(256, 512, device="cpu", key_dtype=kd)
        for r_et, p_et in ((ra, pa), (rb, pb))[:0 if state == "fresh" else 2]:
            rs, r_stats = RS.ingest_step(rs, r_et)
            ps, p_stats = PS.ingest_step(ps, p_et)
        if what == "store":
            return rs, ps
        if state != "delta":
            return RSN.build_snapshot(rs), PSN.build_snapshot(ps)
        rs1 = RS.ingest_step(RS.init_store(256, 512), ra)[0]
        ps1 = PS.ingest_step(PS.init_store(256, 512, device="cpu", key_dtype=kd), pa)[0]
        rsnap = RSN.apply_delta(RSN.build_snapshot(rs1), RS.ingest_step(rs1, rb)[1]["delta"])[0]
        psnap = PSN.apply_delta(PSN.build_snapshot(ps1), PS.ingest_step(ps1, pb)[1]["delta"])[0]
        return rsnap, psnap
    if what == "sketch":
        rk = RQ.init_sketch(4, 128, 16)
        pk = PQ.init_sketch(4, 128, 16, device="cpu", key_dtype=kd)
        if state == "updated":
            rk, pk = RQ.sketch_update(rk, ra), PQ.sketch_update(pk, pa)
        return rk, pk
    rd, pd = RD.init_dictionary(64), PD.init_dictionary(64, "cpu", key_dtype=kd)
    if state == "fresh":
        return rd, pd
    rng = np.random.default_rng(bits)
    keys = rng.integers(1, 2 ** (bits - 1), size=16).astype(np.uint64 if bits == 64 else np.uint32)
    valid = np.arange(16) % 5 != 0
    pkeys = torch.from_numpy(C.signed_view(keys).copy())
    rd, *_ = RD.dict_lookup(rd, keys, valid)
    pd, *_ = PD.dict_lookup(pd, pkeys, torch.from_numpy(valid))
    if state == "admit":
        slots = rng.integers(0, 512, size=(3, 16)).astype(np.int32)
        rd = RD.dict_admit(rd, keys, valid, *slots, keys)
        pd = PD.dict_admit(pd, pkeys, torch.from_numpy(valid),
                           *(torch.from_numpy(s) for s in slots), pkeys)
    return rd, pd


CASES = ("store-fresh", "store-updated", "sketch-fresh", "sketch-updated", "dict-fresh",
         "dict-lookup", "dict-admit", "snapshot-fresh", "snapshot-updated", "snapshot-delta")


@pytest.mark.parametrize("bits", [64, 32])
@pytest.mark.parametrize("case", CASES)
def test_counter_dtypes_digests_and_leaves_match_reference(bits, case):
    """The reference's counters promote to int64 under x64 on their first
    update by a sum; the port's stay int32 and are written as the
    reference holds them.  Leaves and digests equal the reference's, and
    the reference's leaves read back into the port keep the digest."""
    with jax.enable_x64(bits == 64):
        ref, port = _structures(bits, case)
        want = [np.asarray(a) for a in jax.tree_util.tree_leaves(ref)]
        want_digest = RR.pytree_digest(ref)
    got = list(convert.reference_arrays(port, copy=True).values())
    assert [(a.dtype, a.shape) for a in got] == [(a.dtype, a.shape) for a in want]
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert R.pytree_digest(port) == want_digest
    wide = {a.dtype for a in want if a.ndim == 0}
    assert (np.dtype(np.int64) in wide) == (bits == 64 and not case.endswith("fresh")
                                           or case == "snapshot-fresh" and bits == 64)
    names = [f.name for f in dataclasses.fields(port)]
    back = convert.from_reference_arrays(type(port), dict(zip(names, want)), "cpu")
    assert all(getattr(back, n).dtype == getattr(port, n).dtype for n in names)
    assert R.pytree_digest(back) == want_digest


# ---------------------------------------------------------------------------
# the checkpoint-cadence SLO
# ---------------------------------------------------------------------------


def _cadence(pkg, hub_cls):
    """A monitor armed for a checkpoint every 4 ticks, fed 30 ticks with
    a checkpoint every 4 until tick 12 and none after."""
    hub = hub_cls(telemetry=pkg.TelemetryRegistry())
    mon = pkg.HealthMonitor().bind(hub, checkpoint_every=4)
    for i in range(30):
        mon.on_event(_Ev("tick", float(i), kept=10, raw=10))
        mon.on_event(_Ev("push", float(i), records=10))
        if i % 4 == 3 and i < 12:
            mon.on_event(_Ev("checkpoint", float(i + 1), step=i + 1))
    mon.on_event(_Ev("report", 30.0))
    return mon


def test_checkpoint_cadence_slo_matches_reference():
    import repro.telemetry as RT
    import repro_torch.telemetry as T

    assert [dataclasses.asdict(s) for s in M.default_slos(checkpoint_every=8)] == \
        [dataclasses.asdict(s) for s in RM.default_slos(checkpoint_every=8)]
    assert [s.name for s in M.default_slos()] == [s.name for s in RM.default_slos()]
    got, want = _cadence(type("P", (), {"TelemetryRegistry": T.TelemetryRegistry,
                                        "HealthMonitor": M.HealthMonitor}), MetricsHub), \
        _cadence(type("P", (), {"TelemetryRegistry": RT.TelemetryRegistry,
                                "HealthMonitor": RM.HealthMonitor}), RefHub)
    rows = [r["ticks_since_checkpoint"] for r in got.history]
    assert rows == [r["ticks_since_checkpoint"] for r in want.history]
    assert max(rows) > 8
    slo = got.report()["slo"]["checkpoint_cadence"]
    assert slo == want.report()["slo"]["checkpoint_cadence"] and slo["breaches"] > 0


def test_checkpointing_run_records_spans_and_the_cadence_slo(tmp_path):
    """A checkpointing, monitored run: the reference's span names and
    counter, and a cadence SLO that holds; its resume restores once."""
    from repro_torch.telemetry import TelemetryRegistry

    kw = dict(ticks=16, device="cpu", checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4,
              spill_dir=str(tmp_path / "sp"), **CAPS)
    reg = TelemetryRegistry()
    rep = harness.run_scenario(SCENARIO, telemetry=reg, monitor=True, **kw)
    assert rep.checkpoints_saved == 4 and reg.counters["checkpoint.saved"] == 4
    assert {"checkpoint.capture", "checkpoint.write"} <= set(rep.stage_latency_ms)
    # the series is fed from the first checkpoint (tick 4) on
    slo = rep.slo_summary["checkpoint_cadence"]
    assert slo["met"] and slo["breaches"] == 0 and slo["ticks"] == 13
    reg2 = TelemetryRegistry()
    res = harness.run_scenario(SCENARIO, telemetry=reg2, resume=True, **dict(kw, ticks=20))
    assert res.resumed_from_tick == 16 and res.checkpoints_saved == 1
    assert reg2.summary()["checkpoint.restore"]["count"] == 1


# ---------------------------------------------------------------------------
# launch.chaos --dryrun's deployment, both packages
# ---------------------------------------------------------------------------

CHAOS_TICKS, OUTAGE, EVERY, KEEP = 48, (10.0, 18.0), 8, 6


def _port_chaos_kw(tmp, name):
    return dict(ticks=CHAOS_TICKS, seed=SEED, device="cpu",
                fault_plan=R.FaultPlan(fail_times=(OUTAGE,)), retry=R.RetryPolicy(),
                checkpoint_dir=str(tmp / f"{name}_ck"), checkpoint_every=EVERY,
                checkpoint_keep=KEEP, spill_dir=str(tmp / f"{name}_spill"), **CAPS)


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """The reference's `run_scenario` at `launch.chaos --dryrun`'s
    deployment, uninterrupted, checkpointing every 8 ticks and keeping
    all 6; then the port's, replaying its records and decisions."""
    tmp = tmp_path_factory.mktemp("chaos")
    ref = _reference_run(tmp, False, ticks=CHAOS_TICKS,
                         fault_plan=RR.FaultPlan(fail_times=(OUTAGE,)), retry=RR.RetryPolicy(),
                         checkpoint_dir=str(tmp / "ref_ck"), checkpoint_every=EVERY,
                         checkpoint_keep=KEEP)
    with pytest.MonkeyPatch.context() as mp:
        _replaying(mp, tmp, ref)
        port = harness.run_scenario(SCENARIO, **_port_chaos_kw(tmp, "port"))
    return dict(ref=ref, port=port, tmp=tmp)


def _masked(rep, *more):
    d = rep.to_dict()
    for k in WALL_FIELDS + more:
        d.pop(k)
    return d


def test_port_writes_the_reference_checkpoints(dryrun):
    """Every step's manifest equal and every `.npy` leaf byte-identical."""
    tmp = dryrun["tmp"]
    steps = R.PipelineCheckpointer(str(tmp / "ref_ck")).list_steps()
    assert steps == [8, 16, 24, 32, 40, 48]
    assert R.PipelineCheckpointer(str(tmp / "port_ck")).list_steps() == steps
    for step in steps:
        got, want = (tmp / f"{side}_ck" / f"step_{step:08d}" for side in ("port", "ref"))
        with open(got / "manifest.json") as g, open(want / "manifest.json") as w:
            manifest = json.load(w)
            assert json.load(g) == manifest
        assert [leaf["key"] for leaf in manifest["leaves"]] == [f"store.{i}" for i in range(10)]
        for leaf in manifest["leaves"]:
            assert filecmp.cmp(got / leaf["file"], want / leaf["file"], shallow=False), leaf


def test_chaos_deployment_report_matches_reference(dryrun):
    """Every field but the wall-clock ones, the digests included."""
    rep, want = dryrun["port"], dryrun["ref"]["report"]
    assert _masked(rep) == _masked(want)
    assert rep.store_digest and rep.snapshot_digest and rep.checkpoints_saved == 6
    assert rep.commit_failures > 0 and rep.retries_replayed == rep.archived_total > 0


def test_port_resumes_the_reference_checkpoint(dryrun, tmp_path, monkeypatch):
    """The reference's step-16 checkpoint (leaves and host blob, its
    archive holding batches of the outage) restores into the port, which
    replays ticks 17 to 48 onto the reference's digests and report."""
    ref = dryrun["ref"]
    kw = _port_chaos_kw(tmp_path, "resume")
    shutil.copytree(dryrun["tmp"] / "ref_ck" / "step_00000016",
                    os.path.join(kw["checkpoint_dir"], "step_00000016"))
    with open(os.path.join(kw["checkpoint_dir"], "step_00000016", "host.pkl"), "rb") as f:
        ingestor = pickle.Unpickler(f).load()["pipe"]["sink"]["ingestor"]
    assert ingestor["archive"] and not ingestor["archive_spill"]
    _replaying(monkeypatch, tmp_path, ref)
    res = harness.run_scenario(SCENARIO, resume=True, **kw)
    assert res.resumed_from_tick == 16 and res.checkpoints_saved == 4
    assert (res.store_digest, res.snapshot_digest) == \
        (ref["report"].store_digest, ref["report"].snapshot_digest)
    extra = ("resumed_from_tick", "checkpoints_saved")
    assert _masked(res, *extra) == _masked(ref["report"], *extra)


def _chaos_printout(ref, work):
    """What the reference's `launch.chaos --dryrun` prints for a run whose
    three parts give `ref`'s numbers (importing its CLI would flip x64
    for the whole worker)."""
    allowed = 3 + 2 * (math.log2((OUTAGE[1] - OUTAGE[0]) / RR.RetryPolicy().base_s) + 2)
    checks = ["bit_exact_store", "bit_exact_snapshot", "records_equal", "no_batch_lost",
              "backoff_not_hot", "resumed_mid_run"]
    return "\n".join(
        [f"[1/3] reference: {SCENARIO} x{CHAOS_TICKS} ticks, outage t=[{OUTAGE[0]}, {OUTAGE[1]})",
         f"[2/3] chaos: same run, checkpoint every {EVERY}, kill at tick {CHAOS_TICKS // 2}",
         f"[3/3] resume: killed at tick {CHAOS_TICKS // 2}, restoring latest checkpoint from "
         f"{os.path.join(work, 'ckpt')}"]
        + [f"  PASS  {c}" for c in checks]
        + [f"store: {ref.store_digest[:16]}... vs {ref.store_digest[:16]}... | replayed="
           f"{ref.retries_replayed} archive_remaining={ref.archive_remaining} failures="
           f"{ref.commit_failures} (allowed {allowed:.1f})", "chaos ok", ""])


def test_chaos_cli_dryrun_matches_reference(dryrun, tmp_path, monkeypatch, capsys):
    """`launch.chaos --dryrun --device cpu` under the replay: its three runs
    land on the reference's digests, records, commit failures and
    replays, every check passes, and it prints what the reference's CLI
    prints for them."""
    ref = dryrun["ref"]["report"]
    _replaying(monkeypatch, tmp_path, dryrun["ref"])
    work = str(tmp_path / "work")
    code, verdict = chaos.run(["--dryrun", "--device", "cpu", "--dir", work])
    assert code == 0 and verdict["ok"] and all(verdict["checks"].values())
    assert (verdict["killed_at"], verdict["resumed_from"]) == (24, 24)
    for side in ("ref", "resumed"):
        got = verdict[side]
        assert (got["records"], got["store_digest"], got["snapshot_digest"],
                got["commit_failures"], got["replayed"]) == \
            (ref.total_records, ref.store_digest, ref.snapshot_digest, ref.commit_failures,
             ref.retries_replayed)
    assert capsys.readouterr().out == _chaos_printout(ref, work)


# ---------------------------------------------------------------------------
# the port's own kill and resume (tests/test_resilience.py's e2e cases)
# ---------------------------------------------------------------------------

_CHAOS_KW = dict(ticks=40, seed=3, node_cap=1 << 12, edge_cap=1 << 14,
                 retry=R.RetryPolicy(jitter=0.0), checkpoint_every=8, device="cpu")


def _kill_and_resume(tmp_path, scenario, plan, **kw):
    ref = harness.run_scenario(scenario, fault_plan=plan.without_crash(),
                               spill_dir=str(tmp_path / "ref"), **kw)
    with pytest.raises(R.PipelineKilled) as killed:
        harness.run_scenario(scenario, fault_plan=plan, checkpoint_dir=str(tmp_path / "ck"),
                             spill_dir=str(tmp_path / "chaos"), **kw)
    assert killed.value.tick == plan.crash_at_tick
    res = harness.run_scenario(scenario, fault_plan=plan.without_crash(),
                               checkpoint_dir=str(tmp_path / "ck"), resume=True,
                               spill_dir=str(tmp_path / "chaos"), **kw)
    return ref, res


@pytest.mark.parametrize("scenario", ["flash_crowd", "celebrity_cascade"])
def test_kill_resume_bit_exact(scenario, tmp_path):
    """Kill mid-scenario, resume from the latest checkpoint: store AND
    CSR snapshot digests match an uninterrupted run executing the same
    fault schedule."""
    ref, res = _kill_and_resume(tmp_path, scenario,
                                R.FaultPlan(fail_times=((10.0, 16.0),), crash_at_tick=20),
                                **_CHAOS_KW)
    assert ref.commit_failures > 0  # the outage actually bit
    assert res.resumed_from_tick == 16
    assert res.total_records == ref.total_records
    assert res.store_digest == ref.store_digest
    assert res.snapshot_digest == ref.snapshot_digest
    assert _masked(res, "resumed_from_tick", "checkpoints_saved") == \
        _masked(ref, "resumed_from_tick", "checkpoints_saved")
    # no batch lost across kill/resume: archive accounting balances
    assert res.archived_total == res.retries_replayed + res.archive_remaining


def test_sharded_kill_resume_bit_exact(tmp_path):
    """The contract holds across shards too: per-shard buffers,
    controllers and hub counters all ride in the checkpoint."""
    ref, res = _kill_and_resume(tmp_path, "flash_crowd",
                                R.FaultPlan(fail_times=((8.0, 12.0),), crash_at_tick=16),
                                **dict(_CHAOS_KW, shards=2, ticks=32))
    assert res.resumed_from_tick == 16 and res.shards == 2
    assert res.store_digest == ref.store_digest
    assert res.snapshot_digest == ref.snapshot_digest
    assert res.total_records == ref.total_records


def test_outage_backoff_does_not_hot_loop(tmp_path):
    """During a store outage the commit-failure count stays logarithmic
    in the outage length: the backoff gate holds."""
    outage = 14.0
    rep = harness.run_scenario("flash_crowd", fault_plan=R.FaultPlan(fail_times=((8.0, 8.0 + outage),)),
                               spill_dir=str(tmp_path / "sp"), **_CHAOS_KW)
    assert 0 < rep.commit_failures <= 3 + 2 * (math.log2(outage / 0.5) + 2)
    assert rep.retries_replayed > 0 and rep.archive_remaining == 0
    assert rep.archived_total == rep.retries_replayed
    assert rep.degraded_events > 0


def test_faults_off_keeps_report_inert(tmp_path):
    rep = harness.run_scenario("steady_state", ticks=10, node_cap=1 << 10, edge_cap=1 << 11,
                               spill_dir=str(tmp_path / "sp"), device="cpu")
    assert rep.commit_failures == 0 and rep.retries_replayed == 0
    assert rep.store_digest == "" and rep.snapshot_digest == ""
    assert rep.resumed_from_tick == -1 and rep.checkpoints_saved == 0
    assert "commit_failures" in rep.to_dict()  # JSON-safe
