"""Port parity: CSR snapshots (`query/snapshot.py`) and the exact query
engine (`query/engine.py`).

Sequences of commits go through the reference's `ingest_step` (x64) and
the port's (CPU) from the same numpy batches; the stores are equal after
every commit (tests/test_torch_store.py).  Then:

  * `build_snapshot` of the port equals the reference's, also over a
    reference store carried across with `convert.store_from_numpy`;
  * `apply_delta` of each commit's delta equals the reference's, and
    where it placed everything it equals a fresh `build_snapshot`; the
    node table saturates mid-run, so dangling edges force the rebuild
    fallback, and `SnapshotMaintainer` counts both paths alike;
  * every engine query equals the reference's, `top_k_degree` over tied
    degrees included.

All results are integer: every comparison is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.edge_table import from_raw_batch as ref_from_raw
from repro.core.transform import RawEdgeBatch as RefRawEdgeBatch
from repro.graphstore import store as RS
from repro.query import engine as RE
from repro.query import snapshot as RN
from repro_torch import convert
from repro_torch.core.compression import key_tensor
from repro_torch.core.edge_table import from_raw_batch
from repro_torch.core.transform import RawEdgeBatch
from repro_torch.graphstore import store as PS
from repro_torch.query import engine as PE
from repro_torch.query import snapshot as PN

NODE_CAP, EDGE_CAP, BATCH_CAP = 256, 1024, 128


def _commits(seed=0, n_batches=8, n_ids=330):
    """Commit the same raw batches to a reference and a port store;
    yields (ref store, ref stats, port store, port stats) per commit.
    330 ids against 256 node slots: the node table saturates mid-run."""
    rng = np.random.default_rng(seed)
    ids = np.unique(rng.integers(1, 2**64 - 1, size=n_ids, dtype=np.uint64))
    ids[: len(ids) // 4] >>= np.uint64(40)  # narrow ids: packed edge keys
    hot = ids[:12]  # a few hubs, so degrees repeat and tie
    with jax.enable_x64(True):
        ref = RS.init_store(NODE_CAP, EDGE_CAP)
    port = PS.init_store(NODE_CAP, EDGE_CAP, device="cpu")
    for i in range(n_batches):
        n = int(rng.integers(BATCH_CAP // 2, BATCH_CAP + 1))
        pool = ids[: 120 + 30 * i]  # new ids arrive batch by batch
        src = np.where(rng.random(n) < 0.3, rng.choice(hot, n), rng.choice(pool, n))
        dst = rng.choice(pool, n)
        et = rng.integers(0, 3, size=n).astype(np.int32)
        z = np.zeros(n, np.int32)
        with jax.enable_x64(True):
            ref, rstats = RS.ingest_step(ref, ref_from_raw(
                RefRawEdgeBatch(src, dst, et, z, z, n), BATCH_CAP))
        port, pstats = PS.ingest_step(port, from_raw_batch(
            RawEdgeBatch(src, dst, et, z, z, n), BATCH_CAP, device="cpu"))
        yield ref, rstats, port, pstats


def _assert_snap_equal(got, want, msg=""):
    g = convert.snapshot_to_numpy(got)
    for f in dataclasses.fields(RN.GraphSnapshot):
        w = np.asarray(getattr(want, f.name))
        np.testing.assert_array_equal(g[f.name], w.astype(g[f.name].dtype),
                                      err_msg=f"{msg}{f.name}")


def _ref_arrays(store):
    return {f.name: np.asarray(getattr(store, f.name))
            for f in dataclasses.fields(RS.GraphStore)}


def test_build_snapshot_matches_reference():
    saturated = False
    for i, (ref, _, port, pstats) in enumerate(_commits()):
        with jax.enable_x64(True):
            want = RN.build_snapshot(ref)
        _assert_snap_equal(PN.build_snapshot(port), want, f"commit {i}: ")
        saturated |= int(pstats["dropped_nodes"]) > 0
    assert saturated and int(want.n_edges) < int(ref.n_edges)  # dangling edges left out
    # a reference store carried across builds the same snapshot
    carried = convert.store_from_numpy(_ref_arrays(ref), device="cpu")
    _assert_snap_equal(PN.build_snapshot(carried), want)


def test_apply_delta_matches_reference_and_a_fresh_build():
    rsnap = psnap = None
    outcomes = []
    rmaint, pmaint = RN.SnapshotMaintainer(max_pending=2), PN.SnapshotMaintainer(max_pending=2)
    for i, (ref, rstats, port, pstats) in enumerate(_commits()):
        msg = f"commit {i}: "
        rmaint.absorb(None, rstats)
        pmaint.absorb(None, pstats)
        if rsnap is not None:
            with jax.enable_x64(True):
                rsnap, runplaced = RN.apply_delta(rsnap, rstats["delta"])
            psnap, punplaced = PN.apply_delta(psnap, pstats["delta"])
            _assert_snap_equal(psnap, rsnap, msg)
            assert int(punplaced) == int(runplaced), msg
            outcomes.append(int(punplaced))
            if int(punplaced) == 0:
                _assert_snap_equal(psnap, PN.build_snapshot(port), msg + "vs fresh build: ")
        with jax.enable_x64(True):
            rsnap = RN.build_snapshot(ref)  # the next merge starts from the exact view
        psnap = PN.build_snapshot(port)
        if i % 2 == 1:
            with jax.enable_x64(True):
                want = rmaint.snapshot(ref)
            _assert_snap_equal(pmaint.snapshot(port), want, msg + "maintainer: ")
    assert 0 in outcomes and max(outcomes) > 0  # both the merge and the fallback ran
    assert (pmaint.full_builds, pmaint.delta_applies) == \
        (rmaint.full_builds, rmaint.delta_applies)
    assert pmaint.full_builds >= 2 and pmaint.delta_applies >= 1


@pytest.fixture(scope="module")
def snapshots():
    *_, (ref, _, port, _) = _commits()
    with jax.enable_x64(True):
        rsnap = RN.build_snapshot(ref)
    return rsnap, PN.build_snapshot(port)


def test_degree_distribution_and_top_k_match_reference(snapshots):
    rsnap, psnap = snapshots
    with jax.enable_x64(True):
        want_hist = np.asarray(RE.degree_distribution(rsnap, num_bins=16))
        want_top = {k: [np.asarray(a) for a in RE.top_k_degree(rsnap, k)]
                    for k in (1, 10, 40)}
    np.testing.assert_array_equal(PE.degree_distribution(psnap, num_bins=16).numpy(), want_hist)
    for k, (wk, wd) in want_top.items():
        gk, gd = PE.top_k_degree(psnap, k)
        np.testing.assert_array_equal(gk.numpy().view(np.uint64), wk, err_msg=f"k={k}")
        np.testing.assert_array_equal(gd.numpy(), wd, err_msg=f"k={k}")
    _, wd = want_top[40]
    assert len(set(wd.tolist())) < len(wd)  # tied degrees inside the top 40


def test_top_k_degree_orders_ties_by_key_like_the_reference():
    """A star of 1 hub and 6 leaves: the leaves all have degree 1, and
    the top-k must list them in the reference's order."""
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 2**64 - 1, size=7, dtype=np.uint64)
    src, dst = np.repeat(ids[:1], 6), ids[1:]
    et, z = np.zeros(6, np.int32), np.zeros(6, np.int32)
    with jax.enable_x64(True):
        ref, _ = RS.ingest_step(RS.init_store(16, 16),
                                ref_from_raw(RefRawEdgeBatch(src, dst, et, z, z, 6), 8))
        wk, wd = (np.asarray(a) for a in RE.top_k_degree(RN.build_snapshot(ref), 5))
    port, _ = PS.ingest_step(PS.init_store(16, 16, device="cpu"),
                             from_raw_batch(RawEdgeBatch(src, dst, et, z, z, 6), 8, device="cpu"))
    gk, gd = PE.top_k_degree(PN.build_snapshot(port), 5)
    assert wd.tolist() == [6, 1, 1, 1, 1]
    np.testing.assert_array_equal(gk.numpy().view(np.uint64), wk)
    np.testing.assert_array_equal(gd.numpy(), wd)


@pytest.mark.parametrize("directed", [False, True])
def test_k_hop_matches_reference(snapshots, directed):
    rsnap, psnap = snapshots
    nk = np.asarray(rsnap.node_key)
    seeds = np.concatenate([nk[[0, 5, 17]], np.array([12345, 0], np.uint64)])
    for hops in (1, 2, 3):
        with jax.enable_x64(True):
            want = np.asarray(RE.k_hop(rsnap, jnp.asarray(seeds), hops=hops, directed=directed))
        got = PE.k_hop(psnap, key_tensor(seeds, "cpu"), hops=hops, directed=directed)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"hops={hops}")


def test_triangle_count_and_edge_lookup_match_reference(snapshots):
    rsnap, psnap = snapshots
    with jax.enable_x64(True):
        want_tri = RE.triangle_count(rsnap)
    assert PE.triangle_count(psnap) == want_tri > 0

    live = np.asarray(rsnap.edge_row) < rsnap.node_cap
    nk = np.asarray(rsnap.node_key)
    take = np.flatnonzero(live)[:48]
    s_keys = nk[np.asarray(rsnap.edge_row)[take]]
    d_keys = nk[np.asarray(rsnap.edge_col)[take]]
    # absent pairs: swapped endpoints, and a key the store never saw
    s_keys = np.concatenate([s_keys, d_keys[:8], np.array([777], np.uint64)])
    d_keys = np.concatenate([d_keys, s_keys[:8], d_keys[:1]])
    with jax.enable_x64(True):
        want = np.asarray(RE.edge_lookup(rsnap, jnp.asarray(s_keys), jnp.asarray(d_keys)))
    got = PE.edge_lookup(psnap, key_tensor(s_keys, "cpu"), key_tensor(d_keys, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:48] > 0).all() and want[-1] == 0
