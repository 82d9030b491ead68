"""Port parity: GraphZip dictionary compression (`repro_torch.compress`
and `graphstore.store.commit_compressed`).

  * `dict_lookup` and `dict_admit` against `repro.compress` (x64) on the
    same numpy keys and payloads, bit for bit after every operation: a
    64-entry dictionary with ttl 2 fills past its 0.85 high-water mark,
    so the aging eviction clears entries and orphans some probe chains.
  * `DictionaryStage.rewrite` + `commit_compressed` + `observe_commit`
    against the reference's, batch by batch on the same raw batches
    replayed twice (so the second round references the first): every
    store array, every commit stat, the reference arrays of each
    `CompressedCommit` and the dictionary, bit for bit.
  * In the port, the raw path (`ingest_step`) and the compressed path
    give equal stores and snapshots on the same batches: the
    reference's own invariant.  A compressed batch that fails to commit
    spills to the archive on disk and commits unchanged on retry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import DictionaryStage as RefDictionaryStage
from repro.compress import dictionary as RD
from repro.core.edge_table import from_raw_batch as ref_from_raw
from repro.core.transform import RawEdgeBatch as RefRawEdgeBatch
from repro.graphstore import store as RS
from repro_torch import convert
from repro_torch.compress import DictionaryStage
from repro_torch.compress import dictionary as PD
from repro_torch.core.edge_table import from_raw_batch
from repro_torch.core.ingestor import GraphIngestor
from repro_torch.core.transform import RawEdgeBatch
from repro_torch.graphstore import store as PS
from repro_torch.query.snapshot import build_snapshot

CAP, NCAP, ECAP = 128, 1 << 11, 1 << 12
STAT_KEYS = ("new_nodes", "new_edges", "batch_nodes", "batch_edges", "instructions",
             "store_nodes", "store_edges", "dropped_inserts", "probe_rounds", "dict_refs")
REF_FIELDS = ("ref_src", "ref_dst", "ref_etype", "ref_count", "ref_eslot", "ref_sslot",
              "ref_dslot", "ref_pattern", "ref_valid", "res_admit", "res_psig")


def _keys(rng, n):
    """n distinct uint64 keys away from 0 and the all-ones sentinel."""
    return np.unique(rng.integers(3, 2**64 - 2, size=2 * n, dtype=np.uint64))[:n]


def _assert_dict_equal(got: PD.PatternDictionary, want, msg=""):
    g = convert.dictionary_to_numpy(got)
    for f in dataclasses.fields(RD.PatternDictionary):
        w = np.asarray(getattr(want, f.name))
        np.testing.assert_array_equal(g[f.name], w.astype(g[f.name].dtype),
                                      err_msg=f"{msg}{f.name}")


def test_dictionary_lookup_admit_and_eviction_match_reference():
    rng = np.random.default_rng(0)
    cap, n, ttl = 64, 16, 2
    universe = _keys(rng, 160)
    with jax.enable_x64(True):
        ref = RD.init_dictionary(cap)
    port = PD.init_dictionary(cap, device="cpu")
    evictions = 0
    for step in range(24):
        keys = universe[rng.choice(universe.size, n, replace=False)]
        valid = rng.random(n) < 0.9
        kt, vt = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(valid)
        with jax.enable_x64(True):
            ref, *want = RD.dict_lookup(ref, jnp.asarray(keys), jnp.asarray(valid))
        port, *got = PD.dict_lookup(port, kt, vt)
        for name, g, w in zip(("hit", "eslot", "sslot", "dslot", "entry"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{step} {name}")
        _assert_dict_equal(port, ref, f"lookup {step}: ")

        admit = valid & ~np.asarray(want[0]) & (rng.random(n) < 0.8)
        slots = [rng.integers(0, 1 << 12, n).astype(np.int32) for _ in range(3)]
        psig = _keys(rng, n)
        with jax.enable_x64(True):
            ref = RD.dict_admit(ref, jnp.asarray(keys), jnp.asarray(admit),
                                *(jnp.asarray(s) for s in slots), jnp.asarray(psig), ttl=ttl)
        port = PD.dict_admit(port, kt, torch.from_numpy(admit),
                             *(torch.from_numpy(s) for s in slots),
                             torch.from_numpy(psig.view(np.int64)), ttl=ttl)
        _assert_dict_equal(port, ref, f"admit {step}: ")
        evictions = int(port.evictions)
    assert evictions > 0 and port.hit_rate() > 0 and port.load() > 0.5


def _batches(seed, n_batches, n_ids):
    """Raw batches over a small id pool (half the ids packed, half wide),
    so stars, chains and repeats are common."""
    rng = np.random.default_rng(seed)
    ids = np.unique(rng.integers(1, 2**64 - 1, size=n_ids, dtype=np.uint64))
    ids[: len(ids) // 2] >>= np.uint64(40)
    out = []
    for _ in range(n_batches):
        n = int(rng.integers(CAP // 2, CAP))
        hub = rng.choice(ids, 1)
        src = np.where(rng.random(n) < 0.3, hub, rng.choice(ids, n)).astype(np.uint64)
        dst = rng.choice(ids, n)
        et = rng.integers(0, 3, size=n).astype(np.int32)
        z = np.zeros(n, np.int32)
        out.append((RefRawEdgeBatch(src, dst, et, z, z, n), RawEdgeBatch(src, dst, et, z, z, n)))
    return out + out  # replay: the second round hits the dictionary


def test_rewrite_and_commit_compressed_match_reference():
    with jax.enable_x64(True):
        ref_store = RS.init_store(NCAP, ECAP)
        ref_stage = RefDictionaryStage(capacity=512, star_min=3, hot_min=2)
    port_store = PS.init_store(NCAP, ECAP, device="cpu")
    port_stage = DictionaryStage(capacity=512, star_min=3, hot_min=2, device="cpu")
    refs = 0
    for i, (rraw, praw) in enumerate(_batches(1, 10, 300)):
        with jax.enable_x64(True):
            rcc = ref_stage.rewrite(ref_from_raw(rraw, CAP))
            ref_store, want = RS.commit_compressed(ref_store, rcc)
            ref_stage.observe_commit(rcc, want)
        pcc = port_stage.rewrite(from_raw_batch(praw, CAP, device="cpu"))
        port_store, got = PS.commit_compressed(port_store, pcc)
        port_stage.observe_commit(pcc, got)

        for name in REF_FIELDS:
            g, w = getattr(pcc, name).numpy(), np.asarray(getattr(rcc, name))
            np.testing.assert_array_equal(g.view(np.uint64) if w.dtype == np.uint64 else g, w,
                                          err_msg=f"batch {i}: {name}")
        for k in STAT_KEYS:
            assert int(got[k]) == int(want[k]), f"batch {i}: {k}"
        assert got["dict_hit_rate"].numpy().tobytes() == np.asarray(want["dict_hit_rate"]).tobytes()
        for k in ("nslot", "eslot"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        for f in dataclasses.fields(RS.CommitDelta):
            g, w = getattr(got["delta"], f.name).numpy(), np.asarray(getattr(want["delta"], f.name))
            np.testing.assert_array_equal(g.view(np.uint64) if w.dtype == np.uint64 else g, w,
                                          err_msg=f"batch {i}: delta.{f.name}")
        g = convert.store_to_numpy(port_store)
        for f in dataclasses.fields(RS.GraphStore):
            w = np.asarray(getattr(ref_store, f.name))
            np.testing.assert_array_equal(g[f.name], w.astype(g[f.name].dtype),
                                          err_msg=f"batch {i}: {f.name}")
        _assert_dict_equal(port_stage.dct, ref_stage.dct, f"batch {i}: ")
        refs += int(got["dict_refs"])
    assert refs > 0
    assert port_stage.stats() == ref_stage.stats()


def test_raw_and_compressed_commits_give_equal_stores():
    raw = PS.init_store(NCAP, ECAP, device="cpu")
    comp = PS.init_store(NCAP, ECAP, device="cpu")
    stage = DictionaryStage(capacity=512, star_min=3, hot_min=2, device="cpu")
    refs = 0
    for _, praw in _batches(2, 10, 300):
        et = from_raw_batch(praw, CAP, device="cpu")
        raw, _ = PS.ingest_step(raw, et)
        cc = stage.rewrite(et)
        comp, s = PS.commit_compressed(comp, cc)
        stage.observe_commit(cc, s)
        refs += int(s["dict_refs"])
    assert refs > 0
    for f in dataclasses.fields(PS.GraphStore):
        assert torch.equal(getattr(raw, f.name), getattr(comp, f.name)), f.name
    sr, sc = build_snapshot(raw), build_snapshot(comp)
    for f in dataclasses.fields(sr):
        assert torch.equal(getattr(sr, f.name), getattr(sc, f.name)), f.name


def test_dictionary_numpy_round_trip_and_default_device(monkeypatch):
    d = PD.init_dictionary(32, device="cpu")
    keys = torch.from_numpy(_keys(np.random.default_rng(3), 8).view(np.int64))
    s = torch.arange(8, dtype=torch.int32)
    d = PD.dict_admit(d, keys, torch.ones(8, dtype=torch.bool), s, s, s, keys)
    arrays = convert.dictionary_to_numpy(d)
    assert arrays["sig"].dtype == np.uint64 and int(arrays["n_entries"]) == 8
    back = convert.dictionary_from_numpy(arrays, device="cpu")
    for f in dataclasses.fields(PD.PatternDictionary):
        assert torch.equal(getattr(back, f.name), getattr(d, f.name)), f.name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.init_dictionary(32)


def test_a_compressed_batch_survives_the_archive_spill(tmp_path):
    """Failed compressed commits go to the archive, the second one past
    `max_archive` to disk in numpy form (keys as uint64), and on retry
    both commit as they would have directly."""
    stage = DictionaryStage(capacity=512, star_min=3, hot_min=2, device="cpu")
    store = PS.init_store(NCAP, ECAP, device="cpu")
    batches = _batches(4, 6, 300)
    for _, praw in batches[:-2]:
        cc = stage.rewrite(from_raw_batch(praw, CAP, device="cpu"))
        store, s = PS.commit_compressed(store, cc)
        stage.observe_commit(cc, s)
    last = [stage.rewrite(from_raw_batch(praw, CAP, device="cpu")) for _, praw in batches[-2:]]
    assert all(int(cc.n_refs) > 0 for cc in last)
    direct = PS.GraphStore(**{f.name: getattr(store, f.name).clone()
                              for f in dataclasses.fields(store)})
    for cc in last:
        direct, _ = PS.commit_compressed(direct, cc)

    down = [True]
    ing = GraphIngestor(store, fail_hook=lambda: down[0], max_archive=1,
                        archive_dir=str(tmp_path))
    for cc in last:
        assert not ing.push(cc, now=0.0)["committed"]
    assert ing.archive_depth == 2 and len(list(tmp_path.iterdir())) == 1
    down[0] = False
    assert ing.retry_archive(now=1.0) == 2
    assert [c.refs for c in ing.commits if c.ok] == [int(cc.n_refs) for cc in last]
    for f in dataclasses.fields(PS.GraphStore):
        assert torch.equal(getattr(ing.store, f.name), getattr(direct, f.name)), f.name
