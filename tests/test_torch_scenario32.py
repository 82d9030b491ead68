"""Port parity at 32-bit keys through the scenario harness
(`run_scenario(key_dtype=torch.int32)` and `scenario_builder`), and the
counters the port holds at the reference's dtype (ROADMAP F35).

  * The counters, with no reference run: a sketch at `n_updates`
    2^31 - 3 absorbs 5 edges, and a dictionary whose `hits`, `misses` and
    `evictions` sit near 2^31 takes a lookup and an admission that
    evicts.  Under x64 (64-bit keys) the reference's counters turn int64
    and pass 2^31; without it (32-bit keys) they stay int32 and wrap.
    The port's values and dtypes, `sketch_error_bound`, `hit_rate`, the
    saved leaves and `pytree_digest` equal the reference's at both
    widths, and the capped counters (the store's `n_nodes`, `n_edges`,
    the dictionary's `n_entries`) stay int32 and marked.
  * One reference `run_scenario` without x64, where it keys the graph
    with uint32: flash_crowd, 48 ticks, seed 0, 2^12/2^14, with
    `dict_compress`, `sketch_guided`, `lineage`, a store outage over
    10:18 and a checkpoint every 8 ticks, keeping 6.  Replaying its
    records and decisions (ROADMAP F1, F2), `run_scenario(key_dtype=
    torch.int32, device="cpu")` gives the same report (wall-clock fields
    masked), digests, manifests and `.npy` leaves at every step, and the
    same batches in its host blob; it resumes the reference's step-16
    checkpoint onto the reference's final digests.
  * The port's own 32-bit runs, with no reference run: every option of
    `run_scenario` at 32 bits (two shards, the sketch-guided GraphZip
    path, telemetry and both trace exporters, the monitor, lineage and
    its hop log, a fault plan) reaches the plain versions of K1, K3 and
    K5 with 32-bit keys only; a kill and resume is bit-exact with two
    shards; the 64-bit run of the same deployment holds another store;
    and a resume across widths raises.
"""
import dataclasses
import filecmp
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.resilience as RR
from repro.compress import dictionary as RD
from repro.core.edge_table import from_raw_batch as ref_from_raw
from repro.core.transform import RawEdgeBatch as RefRawEdgeBatch
from repro.graphstore import store as RS
from repro.query import sketch as RQ
from repro_torch import convert
import repro_torch.resilience as R
from repro_torch.compress import dictionary as PD
from repro_torch.core import compression as C
from repro_torch.core import counters
from repro_torch.core.edge_table import from_raw_batch
from repro_torch.core.transform import RawEdgeBatch
from repro_torch.graphstore import store as PS
from repro_torch.kernels import pattern_mine as PM
from repro_torch.kernels import sketch as PK
from repro_torch.kernels import upsert as PU
from repro_torch.query import sketch as PQ
from repro_torch.resilience import checkpoint as CK
from repro_torch.workloads import harness
from test_torch_checkpoint import _kill_and_resume
from test_torch_workloads import CAPS, SCENARIO, SEED, WALL_FIELDS, _reference_run, _replaying

NEAR = (1 << 31) - 3
KD = {64: torch.int64, 32: torch.int32}

# ---------------------------------------------------------------------------
# F35: the counters past 2^31, against the reference at both widths
# ---------------------------------------------------------------------------


def _leaves_and_digest(ref, port):
    """The reference's leaves and digest against the port's."""
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(ref)]
    got = list(convert.reference_arrays(port, copy=True).values())
    assert [(a.dtype, a.shape) for a in got] == [(a.dtype, a.shape) for a in want]
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert R.pytree_digest(port) == RR.pytree_digest(ref)
    names = [f.name for f in dataclasses.fields(port)]
    back = convert.from_reference_arrays(type(port), dict(zip(names, want)), "cpu")
    assert R.pytree_digest(back) == RR.pytree_digest(ref)
    return back


def _as_counter(value: int, bits: int) -> int:
    """`value` as the reference's counter holds it: int64 at 64-bit
    keys, int32 (wrapped) at 32-bit keys."""
    return value if bits == 64 else (value + (1 << 31)) % (1 << 32) - (1 << 31)


def _same_counter(got: torch.Tensor, want, bits: int):
    w = np.asarray(want)
    assert str(got.dtype) == f"torch.{w.dtype}", (got.dtype, w.dtype)
    assert int(got) == int(w)
    assert w.dtype == (np.int64 if bits == 64 else np.int32)


@pytest.mark.parametrize("bits", [64, 32])
def test_sketch_n_updates_past_2_31_matches_reference(bits):
    """5 edges onto 2^31 - 3: 2^31 + 2 as int64 at 64-bit keys, wrapped
    int32 at 32-bit keys, as the reference; the error bound follows."""
    rng = np.random.default_rng(bits)
    src, dst = (rng.integers(1, 2**64 - 1, 5, dtype=np.uint64) for _ in range(2))
    et, z = np.arange(5, dtype=np.int32) % 3, np.zeros(5, np.int32)
    with jax.enable_x64(bits == 64):
        rsk = RQ.init_sketch(depth=4, width=128, hh_slots=16)
        rsk = dataclasses.replace(rsk, n_updates=jnp.asarray(np.int32(NEAR)))
        rsk = RQ.sketch_update(rsk, ref_from_raw(RefRawEdgeBatch(src, dst, et, z, z, 5), 16))
        bound = float(RQ.sketch_error_bound(rsk))
    psk = PQ.init_sketch(depth=4, width=128, hh_slots=16, device="cpu", key_dtype=KD[bits])
    psk = dataclasses.replace(psk, n_updates=torch.tensor(NEAR, dtype=torch.int32))
    psk = PQ.sketch_update(psk, from_raw_batch(RawEdgeBatch(src, dst, et, z, z, 5), 16,
                                               device="cpu", key_dtype=KD[bits]))
    _same_counter(psk.n_updates, rsk.n_updates, bits)
    assert int(psk.n_updates) == _as_counter(NEAR + 5, bits)
    assert PQ.sketch_error_bound(psk) == bound
    assert (bound > 0) == (bits == 64)
    back = _leaves_and_digest(rsk, psk)
    assert back.n_updates.dtype == psk.n_updates.dtype  # read back at its dtype
    assert counters.int64_counters(psk) == frozenset()


def _dictionary_near_2_31(bits):
    """(reference, port) dictionaries of 64 slots holding 40 admitted
    signatures, past their high-water mark, every entry idle for 200
    ticks, `hits`, `misses` and `evictions` at 2^31 - 3 (int32, as a
    dictionary whose counters no sum has promoted); and the signatures."""
    rng = np.random.default_rng(bits)
    keys = np.unique(rng.integers(3, 2 ** (bits - 1), size=64)).astype(
        np.uint64 if bits == 64 else np.uint32)[:40]
    slots = rng.integers(0, 512, size=(3, 40)).astype(np.int32)
    with jax.enable_x64(bits == 64):
        rd = RD.dict_admit(RD.init_dictionary(64), keys, np.ones(40, bool), *slots, keys)
        arrays = {f.name: np.array(getattr(rd, f.name)) for f in dataclasses.fields(rd)}
    arrays.update(tick=np.int32(200), n_entries=np.int32(60), hits=np.int32(NEAR),
                  misses=np.int32(NEAR), evictions=np.int32(NEAR))
    with jax.enable_x64(bits == 64):
        rd = RD.PatternDictionary(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return rd, convert.dictionary_from_numpy(arrays, device="cpu"), keys


@pytest.mark.parametrize("bits", [64, 32])
def test_dictionary_counters_past_2_31_match_reference(bits):
    """A lookup (hits and misses) and an admission that evicts, onto
    counters at 2^31 - 3: int64 past 2^31 at 64-bit keys, wrapped int32
    at 32-bit keys; `hit_rate` follows; `n_entries` stays int32, marked
    int64 at 64-bit keys."""
    rd, pd, keys = _dictionary_near_2_31(bits)
    rng = np.random.default_rng(bits + 1)
    probe = np.concatenate([keys[:12], (keys[:12] ^ 0x5A5A).astype(keys.dtype)])
    valid = np.ones(len(probe), bool)
    new = (keys[:8] + 1).astype(keys.dtype)
    slots = rng.integers(0, 512, size=(3, 8)).astype(np.int32)
    pk, pnew = (torch.from_numpy(C.signed_view(k).copy()) for k in (probe, new))
    with jax.enable_x64(bits == 64):
        rd, *_ = RD.dict_lookup(rd, probe, valid)
        r_rate = rd.hit_rate()
        rd = RD.dict_admit(rd, new, np.ones(8, bool), *slots, new)
    pd, *_ = PD.dict_lookup(pd, pk, torch.from_numpy(valid))
    assert pd.hit_rate() == r_rate
    pd = PD.dict_admit(pd, pnew, torch.ones(8, dtype=torch.bool), *map(torch.from_numpy, slots), pnew)
    for name in ("hits", "misses", "evictions"):
        _same_counter(getattr(pd, name), getattr(rd, name), bits)
    assert int(pd.hits) == _as_counter(NEAR + 12, bits)
    assert int(pd.evictions) == _as_counter(NEAR + 28, bits)  # 28 idle entries evicted
    assert pd.hit_rate() == rd.hit_rate()
    assert pd.n_entries.dtype == torch.int32
    assert counters.int64_counters(pd) == (frozenset({"n_entries"}) if bits == 64
                                          else frozenset())
    _leaves_and_digest(rd, pd)


@pytest.mark.parametrize("bits", [64, 32])
def test_dictionary_lookup_after_admit_keeps_the_reference_leaves(bits):
    """Lookups with no admission after them, as at a rewrite inside a
    store outage: `n_entries`, int64 in the reference from the first
    admission under x64, stays marked through each lookup, so the
    leaves and digest a checkpoint writes still equal the reference's."""
    rng = np.random.default_rng(bits + 2)
    kt = np.uint64 if bits == 64 else np.uint32
    keys = np.unique(rng.integers(3, 2 ** (bits - 1), size=32)).astype(kt)[:24]
    probe = np.concatenate([keys[:10], (keys[:6] ^ 0x3C3C).astype(kt)])
    valid = np.ones(len(probe), bool)
    slots = rng.integers(0, 512, size=(3, 24)).astype(np.int32)
    pk, pp = (torch.from_numpy(C.signed_view(k).copy()) for k in (keys, probe))
    with jax.enable_x64(bits == 64):
        rd = RD.dict_admit(RD.init_dictionary(64), keys, np.ones(24, bool), *slots, keys)
        for _ in range(2):
            rd, *_ = RD.dict_lookup(rd, probe, valid)
    pd = PD.dict_admit(PD.init_dictionary(64, device="cpu", key_dtype=KD[bits]), pk,
                       torch.ones(24, dtype=torch.bool), *map(torch.from_numpy, slots), pk)
    for _ in range(2):
        pd, *_ = PD.dict_lookup(pd, pp, torch.from_numpy(valid))
    assert counters.int64_counters(pd) == (frozenset({"n_entries"}) if bits == 64
                                          else frozenset())
    for name in ("hits", "misses"):
        _same_counter(getattr(pd, name), getattr(rd, name), bits)
    assert int(pd.hits) == 20 and int(pd.misses) == 12
    back = _leaves_and_digest(rd, pd)
    assert counters.int64_counters(back) == counters.int64_counters(pd)


@pytest.mark.parametrize("bits", [64, 32])
def test_store_counters_stay_int32_and_marked(bits):
    """The store's counters are bounded by its caps and read by K1's
    probe budget: int32 at both widths, marked int64 at 64-bit keys."""
    rng = np.random.default_rng(bits)
    src, dst = (rng.integers(1, 2**64 - 1, 40, dtype=np.uint64) for _ in range(2))
    et, z = np.zeros(40, np.int32), np.zeros(40, np.int32)
    with jax.enable_x64(bits == 64):
        rs, _ = RS.ingest_step(RS.init_store(256, 512),
                               ref_from_raw(RefRawEdgeBatch(src, dst, et, z, z, 40), 64))
    ps, _ = PS.ingest_step(PS.init_store(256, 512, device="cpu", key_dtype=KD[bits]),
                           from_raw_batch(RawEdgeBatch(src, dst, et, z, z, 40), 64, device="cpu",
                                          key_dtype=KD[bits]))
    assert ps.n_nodes.dtype == ps.n_edges.dtype == torch.int32
    assert counters.int64_counters(ps) == (frozenset({"n_nodes", "n_edges"}) if bits == 64
                                          else frozenset())
    back = _leaves_and_digest(rs, ps)
    assert back.n_nodes.dtype == torch.int32
    assert counters.int64_counters(back) == counters.int64_counters(ps)


# ---------------------------------------------------------------------------
# the reference's run_scenario without x64, replayed at 32-bit keys
# ---------------------------------------------------------------------------

TICKS, OUTAGE, EVERY, KEEP = 48, (10.0, 18.0), 8, 6
OPTIONS = dict(dict_compress=True, sketch_guided=True, lineage=True)


def _port_kw(tmp, name):
    return dict(ticks=TICKS, seed=SEED, device="cpu", key_dtype=torch.int32,
                fault_plan=R.FaultPlan(fail_times=(OUTAGE,)), retry=R.RetryPolicy(),
                checkpoint_dir=str(tmp / f"{name}_ck"), checkpoint_every=EVERY,
                checkpoint_keep=KEEP, spill_dir=str(tmp / f"{name}_spill"), **CAPS, **OPTIONS)


@pytest.fixture(scope="module")
def run32(tmp_path_factory):
    """The reference's `run_scenario` without x64 (uint32 keys),
    uninterrupted, checkpointing every 8 ticks and keeping all 6; then
    the port's at `key_dtype=torch.int32`, replaying its records and
    decisions."""
    tmp = tmp_path_factory.mktemp("scenario32")
    ref = _reference_run(tmp, True, ticks=TICKS, x64=False, sketch_guided=True, lineage=True,
                         fault_plan=RR.FaultPlan(fail_times=(OUTAGE,)), retry=RR.RetryPolicy(),
                         checkpoint_dir=str(tmp / "ref_ck"), checkpoint_every=EVERY,
                         checkpoint_keep=KEEP)
    assert ref["store"]["node_keys"].dtype == np.uint32
    kw = _port_kw(tmp, "port")
    with pytest.MonkeyPatch.context() as mp:
        got = _replaying(mp, tmp, ref)
        port = harness.run_scenario(SCENARIO, **kw)
    return dict(ref=ref, port=port, pipe=got["pipe"], tmp=tmp)


# the commit-event tallies of a resumed run count from the resume on, in
# both packages (the reference's live in its `run_scenario`, outside the
# checkpoint)
TALLIES = ("pattern_refs", "dict_hit_rate", "dropped_inserts")


def _masked(rep, *more):
    d = rep.to_dict()
    for k in WALL_FIELDS + more:
        d.pop(k)
    return d


def test_scenario32_report_and_digests_match_reference(run32):
    """Every field but the wall-clock ones, the digests, the lineage
    accounting and the dictionary's hit rate included."""
    rep, want = run32["port"], run32["ref"]["report"]
    assert _masked(rep) == _masked(want)
    assert rep.store_digest and rep.store_digest == want.store_digest
    assert rep.snapshot_digest == want.snapshot_digest
    assert rep.commit_failures > 0 and rep.pattern_refs > 0 and rep.lineage_enabled
    assert rep.checkpoints_saved == 6
    pipe = run32["pipe"]
    assert pipe.store.node_keys.dtype == pipe.sink.sketch.hh_keys.dtype == torch.int32
    assert run32["ref"]["dict"].dct.sig.dtype == jnp.uint32


def test_scenario32_writes_the_reference_checkpoints(run32):
    """Every step's manifest equal (no field added for the width) and
    every `.npy` leaf byte-identical, the int32 counters included."""
    tmp = run32["tmp"]
    steps = R.PipelineCheckpointer(str(tmp / "ref_ck")).list_steps()
    assert steps == [8, 16, 24, 32, 40, 48]
    assert R.PipelineCheckpointer(str(tmp / "port_ck")).list_steps() == steps
    for step in steps:
        got, want = (tmp / f"{side}_ck" / f"step_{step:08d}" for side in ("port", "ref"))
        assert (got / "manifest.json").read_bytes() == (want / "manifest.json").read_bytes()
        manifest = json.loads((want / "manifest.json").read_text())
        assert {leaf["dtype"] for leaf in manifest["leaves"] if leaf["shape"] == []} == \
            {"int32"}
        assert "uint32" in {leaf["dtype"] for leaf in manifest["leaves"]}
        for leaf in manifest["leaves"]:
            assert filecmp.cmp(got / leaf["file"], want / leaf["file"], shallow=False), leaf


def _ingestor_state(path):
    """The ingestor's part of a `host.pkl` of either package (the query
    sink holds the ingestor's sink as `inner`)."""
    with open(path, "rb") as f:
        return CK._HostUnpickler(f).load()["pipe"]["sink"]["inner"]["ingestor"]


def _leaves(batch, prefix=""):
    """(name, numpy leaf) of a host batch, nested tables flattened."""
    out = []
    for f in dataclasses.fields(batch):
        x = getattr(batch, f.name)
        out += _leaves(x, f"{prefix}{f.name}.") if dataclasses.is_dataclass(x) \
            else [(prefix + f.name, np.asarray(x))]
    return out


def test_scenario32_host_blob_holds_the_reference_batches(run32):
    """The batches in the pool and the archive at every step: the same
    classes, leaves, dtypes (the reference's, read from its own file:
    int32 counters without x64) and bytes as the reference's `host.pkl`."""
    tmp, archived = run32["tmp"], 0
    for step in (8, 16, 24, 32, 40, 48):
        got, want = (_ingestor_state(tmp / f"{side}_ck" / f"step_{step:08d}" / "host.pkl")
                     for side in ("port", "ref"))
        for part in ("pool", "archive"):
            assert [type(b).__name__ for b in got[part]] == \
                [type(b).__name__ for b in want[part]]
            for g, w in zip(got[part], want[part]):
                gl, wl = _leaves(g), _leaves(w)
                assert [(n, a.dtype, a.shape) for n, a in gl] == \
                    [(n, a.dtype, a.shape) for n, a in wl]
                assert all(a.tobytes() == b.tobytes() for (_, a), (_, b) in zip(gl, wl))
                assert {a.dtype for _, a in wl if a.ndim == 0} <= {np.dtype(np.int32)}
            archived += len(want["archive"])
        assert got["archive_n"] == want["archive_n"]
    assert archived > 0


def test_scenario32_resumes_the_reference_checkpoint(run32, tmp_path, monkeypatch):
    """The reference's 32-bit step-16 checkpoint (its leaves and its
    `host.pkl`, the archive holding batches of the outage) restores into
    the port, which replays ticks 17 to 48 onto the reference's digests."""
    ref = run32["ref"]
    kw = _port_kw(tmp_path, "resume")
    shutil.copytree(run32["tmp"] / "ref_ck" / "step_00000016",
                    os.path.join(kw["checkpoint_dir"], "step_00000016"))
    assert _ingestor_state(os.path.join(kw["checkpoint_dir"], "step_00000016",
                                        "host.pkl"))["archive"]
    _replaying(monkeypatch, tmp_path, ref)
    res = harness.run_scenario(SCENARIO, resume=True, **kw)
    assert res.resumed_from_tick == 16 and res.checkpoints_saved == 4
    assert (res.store_digest, res.snapshot_digest) == \
        (ref["report"].store_digest, ref["report"].snapshot_digest)
    extra = ("resumed_from_tick", "checkpoints_saved") + TALLIES
    assert _masked(res, *extra) == _masked(ref["report"], *extra)
    assert 0 < res.pattern_refs < ref["report"].pattern_refs


# ---------------------------------------------------------------------------
# the port's own 32-bit runs
# ---------------------------------------------------------------------------


def test_every_option_reaches_the_kernels_at_32_bits(tmp_path, monkeypatch):
    """Two shards, the sketch-guided GraphZip path, telemetry with both
    trace exporters, the monitor, lineage with its hop log and a fault
    plan, at 32-bit keys: the plain versions of K1, K3 and K5 see 32-bit
    keys only (on the card K3's wrapper widens them), and every exporter
    writes."""
    seen = {}

    def spy(mod, name, key_arg):
        plain = getattr(mod, name)

        def wrapped(*args, **kw):
            seen.setdefault(name, set()).add(args[key_arg].dtype)
            return plain(*args, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    spy(PU, "fused_upsert_ref", 1)
    spy(PM, "pattern_mine_ref", 0)
    spy(PK, "sketch_absorb_ref", 3)
    trace, jsonl, hops = (str(tmp_path / n) for n in ("t.json", "t.jsonl", "hops.jsonl"))
    rep = harness.run_scenario(
        "flash_crowd", ticks=24, seed=1, shards=2, sketch_guided=True, dict_compress=True,
        telemetry=True, monitor=True, lineage=True, trace=trace, trace_jsonl=jsonl,
        lineage_jsonl=hops, fault_plan=R.FaultPlan(fail_times=((6.0, 10.0),)),
        spill_dir=str(tmp_path / "sp"), node_cap=1 << 11, edge_cap=1 << 13,
        key_dtype=torch.int32, device="cpu")
    assert seen == {"fused_upsert_ref": {torch.int32}, "pattern_mine_ref": {torch.int32},
                    "sketch_absorb_ref": {torch.int32}}
    assert rep.shards == 2 and rep.pattern_refs > 0 and rep.commit_failures > 0
    assert rep.audit_decisions > 0 and rep.slo_summary and rep.records_in > 0
    assert not rep.conservation_warning
    assert json.load(open(trace))["traceEvents"]
    assert all(os.path.getsize(p) > 0 for p in (jsonl, hops))


_KW32 = dict(ticks=32, seed=3, shards=2, node_cap=1 << 12, edge_cap=1 << 14,
             retry=R.RetryPolicy(jitter=0.0), checkpoint_every=8, device="cpu",
             dict_compress=True)


def test_sharded_kill_resume_bit_exact_at_32_bits(tmp_path):
    """A two-shard GraphZip run at 32-bit keys, killed at 16 and resumed
    from its checkpoint, lands on the uninterrupted run's digests; the
    64-bit run of the same deployment holds another store."""
    plan = R.FaultPlan(fail_times=((8.0, 12.0),), crash_at_tick=16)
    ref, res = _kill_and_resume(tmp_path, "flash_crowd", plan,
                                **dict(_KW32, key_dtype=torch.int32))
    assert res.resumed_from_tick == 16 and res.shards == 2 and ref.commit_failures > 0
    assert (res.store_digest, res.snapshot_digest) == (ref.store_digest, ref.snapshot_digest)
    extra = ("resumed_from_tick", "checkpoints_saved") + TALLIES
    assert _masked(res, *extra) == _masked(ref, *extra)
    assert 0 < res.pattern_refs < ref.pattern_refs
    wide = harness.run_scenario("flash_crowd", fault_plan=plan.without_crash(),
                                spill_dir=str(tmp_path / "wide"), **_KW32)
    assert wide.total_records == ref.total_records
    assert (wide.store_nodes, wide.store_edges, wide.dropped_inserts) != \
        (ref.store_nodes, ref.store_edges, ref.dropped_inserts)


@pytest.mark.parametrize("saved,into", [(32, 64), (64, 32)])
def test_resume_across_key_widths_raises(tmp_path, saved, into):
    """A checkpoint restores only into a pipeline of its own key width;
    the error names both widths and nothing of the pipeline changes."""
    kw = dict(ticks=8, seed=3, node_cap=1 << 10, edge_cap=1 << 12, checkpoint_every=4,
              checkpoint_dir=str(tmp_path / "ck"), spill_dir=str(tmp_path / "sp"),
              device="cpu", sketch_guided=True)
    harness.run_scenario("steady_state", key_dtype=KD[saved], **kw)
    with pytest.raises(ValueError, match=f"{saved}-bit keys .*{into}-bit keys"):
        harness.run_scenario("steady_state", key_dtype=KD[into], resume=True,
                             **dict(kw, ticks=12))
    manifest = json.loads((tmp_path / "ck" / "step_00000008" / "manifest.json").read_text())
    assert set(manifest) == {"step", "leaves", "extra", "host"}
