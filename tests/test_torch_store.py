"""Port parity: the GRAPHPUSH commit (`ingest_step`) and the store state
carried between the packages.

Sequences of commits go through `repro.graphstore.store.ingest_step`
(x64) and `repro_torch.graphstore.store.ingest_step` (CPU, plain upsert)
from the same numpy batches.  After every commit each store array and
each stats entry, the `CommitDelta` and the slot arrays included, must
be equal bit for bit.  Small tables fill past 0.6 and 0.8 load, so the
adaptive probe budget escalates and inserts drop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.edge_table import from_raw_batch as ref_from_raw
from repro.core.transform import RawEdgeBatch as RefRawEdgeBatch
from repro.graphstore import store as RS
from repro_torch import convert
from repro_torch.core.edge_table import from_raw_batch
from repro_torch.core.transform import RawEdgeBatch
from repro_torch.graphstore import store as PS
from repro_torch.kernels import ops

FLOAT_STATS = ("node_load", "edge_load")
SCALAR_STATS = ("new_nodes", "new_edges", "batch_nodes", "batch_edges", "instructions",
                "store_nodes", "store_edges", "dropped_nodes", "dropped_edges",
                "dropped_inserts", "probe_rounds")


def _batches(seed, n_batches, batch, n_ids):
    """Raw edge batches over `n_ids` ids (half of them >= 2^63)."""
    rng = np.random.default_rng(seed)
    ids = np.unique(rng.integers(1, 2**64 - 1, size=n_ids, dtype=np.uint64))
    ids[: len(ids) // 4] >>= np.uint64(40)  # narrow ids: packed edge keys
    out = []
    for _ in range(n_batches):
        n = int(rng.integers(batch // 2, batch + batch // 2))
        src, dst = rng.choice(ids, n), rng.choice(ids, n)
        et = rng.integers(0, 3, size=n).astype(np.int32)
        z = np.zeros(n, np.int32)
        out.append((RefRawEdgeBatch(src, dst, et, z, z, n), RawEdgeBatch(src, dst, et, z, z, n)))
    return out


def _assert_stores_equal(got, want, msg=""):
    g = convert.store_to_numpy(got)
    for f in dataclasses.fields(RS.GraphStore):
        w = np.asarray(getattr(want, f.name))
        # under x64 the reference's counters widen to int64 after a commit
        np.testing.assert_array_equal(g[f.name], w.astype(g[f.name].dtype),
                                      err_msg=f"{msg}{f.name}", strict=True)


def _assert_stats_equal(got, want, msg=""):
    assert set(got) == set(want)
    for k in SCALAR_STATS:
        assert int(got[k]) == int(want[k]), f"{msg}{k}"
    for k in FLOAT_STATS:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), f"{msg}{k}"
    for k in ("nslot", "eslot"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"{msg}{k}")
    for f in dataclasses.fields(RS.CommitDelta):
        g = getattr(got["delta"], f.name).numpy()
        w = np.asarray(getattr(want["delta"], f.name))
        if w.dtype == np.uint64:
            g = g.view(np.uint64)
        np.testing.assert_array_equal(g, w, err_msg=f"{msg}delta.{f.name}")


def _run_both(batches, cap, ref_store, port_store):
    """Commit every batch to both stores, comparing after each commit."""
    dropped = 0
    budgets = set()
    for i, (rraw, praw) in enumerate(batches):
        with jax.enable_x64(True):
            ref_store, want = RS.ingest_step(ref_store, ref_from_raw(rraw, cap))
            port_store, got = PS.ingest_step(port_store, from_raw_batch(praw, cap, device="cpu"))
            _assert_stats_equal(got, want, f"commit {i}: ")
            _assert_stores_equal(port_store, ref_store, f"commit {i}: ")
        dropped += int(got["dropped_inserts"])
        budgets.add(int(got["probe_rounds"]))
    return ref_store, port_store, dropped, budgets


@pytest.mark.parametrize("ncap,ecap,cap,n_ids,seed", [
    (256, 512, 128, 400, 0),     # node table overflows: drops, budget x2 and x4
    (1024, 256, 128, 200, 1),    # edge table overflows first
    (4096, 8192, 512, 3000, 2),  # roomy tables, large batches
])
def test_ingest_step_sequence_bit_exact(ncap, ecap, cap, n_ids, seed):
    batches = _batches(seed, 12, cap, n_ids)
    with jax.enable_x64(True):
        ref_store = RS.init_store(ncap, ecap)
    port_store = PS.init_store(ncap, ecap, device="cpu")
    _, port_store, dropped, budgets = _run_both(batches, cap, ref_store, port_store)
    if seed < 2:  # the high-load cases really exercise table pressure
        assert dropped > 0 and max(budgets) == 4 * PS.MAX_PROBES


def test_ingest_step_continues_from_a_converted_reference_store():
    batches = _batches(5, 10, 128, 500)
    with jax.enable_x64(True):
        ref_store = RS.init_store(512, 1024)
        for rraw, _ in batches[:5]:
            ref_store, _ = RS.ingest_step(ref_store, ref_from_raw(rraw, 128))
        arrays = {f.name: np.asarray(getattr(ref_store, f.name))
                  for f in dataclasses.fields(RS.GraphStore)}
    port_store = convert.store_from_numpy(arrays, device="cpu")
    _assert_stores_equal(port_store, ref_store)
    assert port_store.node_keys.dtype == torch.int64 and port_store.n_nodes.dtype == torch.int32
    _run_both(batches[5:], 128, ref_store, port_store)


def test_store_numpy_round_trip():
    batches = _batches(6, 3, 64, 200)
    store = PS.init_store(256, 512, device="cpu")
    for _, praw in batches:
        store, _ = PS.ingest_step(store, from_raw_batch(praw, 64, device="cpu"))
    arrays = convert.store_to_numpy(store)
    assert arrays["node_keys"].dtype == np.uint64 and (arrays["node_keys"] >= 2**63).any()
    back = convert.store_from_numpy(arrays, device="cpu")
    for f in dataclasses.fields(PS.GraphStore):
        assert torch.equal(getattr(back, f.name), getattr(store, f.name)), f.name


@pytest.mark.parametrize("n_used", [0, 100, 614, 615, 818, 819, 1024])
def test_probe_budget_matches_reference(n_used):
    with jax.enable_x64(True):
        want = int(RS.probe_budget(jnp.int32(n_used), 1024))
    assert int(PS.probe_budget(torch.tensor(n_used, dtype=torch.int32), 1024)) == want


def test_ingest_step_runs_two_sweeps_per_commit(monkeypatch):
    """The port's counterpart of `count_probe_loops`: one node sweep and
    one edge sweep per commit, and nothing else probes."""
    calls = []
    plain = ops.fused_upsert

    def counting(table, keys, valid, n_probes):
        calls.append(table.shape[0])
        return plain(table, keys, valid, n_probes)

    monkeypatch.setattr(ops, "fused_upsert", counting)
    store = PS.init_store(256, 512, device="cpu")
    for _, praw in _batches(7, 3, 64, 200):
        store, _ = PS.ingest_step(store, from_raw_batch(praw, 64, device="cpu"))
    assert calls == [256, 512] * 3


def test_init_store_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.init_store(64, 64)
    assert PS.init_store(64, 64, device="cpu").device.type == "cpu"
