"""The port's GraphIngestor (Algorithm 3 GRAPHPUSH): pool admission,
archive and retry, bounded disk spill, backoff and checkpoint state.

The cases of `tests/test_ingestor_pool.py`, run on the port (CPU), plus
the port's archive-spill format (numpy leaves, uint64 keys, as the
reference writes them) and a pooled push sequence compared with the
reference's store.
"""
import dataclasses
import pickle

import jax
import numpy as np
import pytest

from repro.core.edge_table import from_raw_batch as ref_from_raw
from repro.core.ingestor import GraphIngestor as RefIngestor
from repro.core.ingestor import _to_host as ref_to_host
from repro.core.transform import create_edges as ref_create_edges
from repro.core.transform import tweet_mapping as ref_tweet_mapping
from repro.graphstore.store import init_store as ref_init_store
from repro_torch.convert import store_to_numpy
from repro_torch.core.edge_table import from_raw_batch
from repro_torch.core.ingestor import GraphIngestor
from repro_torch.core.transform import create_edges, tweet_mapping
from repro_torch.graphstore.store import init_store


def _recs(tag, n=5):
    return [{"id": f"{tag}{i}", "user": f"u{tag}{i}", "hashtags": ["x"], "mentions": []}
            for i in range(n)]


def _et(tag, n=5):
    return from_raw_batch(create_edges(_recs(tag, n), tweet_mapping()), 64, device="cpu")


def _ingestor(**kw):
    return GraphIngestor(init_store(512, 1024, device="cpu"), **kw)


class _Policy:
    """Doubling backoff: 1, 2, 4, ... seconds."""

    def delay(self, k):
        return float(2 ** k)


def test_pool_full_holds_batch_without_commit():
    ing = _ingestor(max_pool_size=2)
    ing.pool.append(_et("a"))
    ing.pool.append(_et("b"))
    assert ing.push(_et("c")) == {"committed": False, "pooled": 3}
    assert int(ing.store.n_nodes) == 0 and ing.commits == []


def test_pool_drains_fully_once_below_capacity():
    ing = _ingestor(max_pool_size=4)
    ing.pool.append(_et("a"))
    ing.pool.append(_et("b"))
    out = ing.push(_et("c"))
    assert out["committed"] and len(ing.pool) == 0 and len(ing.commits) == 3
    assert int(ing.store.n_nodes) == 3 * 5 * 2 + 1
    assert out["rho"] == pytest.approx(10 / 11) and out["dropped"] == 0


def test_pool_drain_stops_at_first_failure():
    fails = {"n": 0}

    def hook():
        fails["n"] += 1
        return fails["n"] == 2

    ing = _ingestor(max_pool_size=4, fail_hook=hook)
    ing.pool.append(_et("a"))
    ing.pool.append(_et("b"))
    out = ing.push(_et("c"))
    assert not out["committed"] and out["archived"] == 1
    assert len(ing.archive) == 1 and len(ing.pool) == 1
    assert [c.ok for c in ing.commits] == [True, False]


def test_retry_archive_after_injected_failures():
    fail = {"on": True}
    ing = _ingestor(fail_hook=lambda: fail["on"])
    for tag in "abc":
        assert not ing.push(_et(tag))["committed"]
    assert ing.retry_archive() == 0 and len(ing.archive) == 3
    fail["on"] = False
    assert ing.retry_archive() == 3 and len(ing.archive) == 0
    assert int(ing.store.n_nodes) == 3 * 5 * 2 + 1
    assert [c.ok for c in ing.commits] == [False] * 4 + [True] * 3


def test_archive_spills_to_disk_in_reference_format_and_replays_in_order(tmp_path):
    ing = _ingestor(fail_hook=lambda: True, max_archive=1, archive_dir=str(tmp_path))
    for tag in "abc":
        ing.push(_et(tag))
    assert len(ing.archive) == 1 and ing.archive_depth == 3
    spilled = sorted(tmp_path.glob("archive_*.pkl"))
    assert len(spilled) == 2
    with open(spilled[0], "rb") as f:
        host = pickle.load(f)
    with jax.enable_x64(True):
        want = ref_to_host(ref_from_raw(ref_create_edges(_recs("b"), ref_tweet_mapping()), 64))
    for f in dataclasses.fields(host):
        g, w = getattr(host, f.name), getattr(want, f.name)
        assert isinstance(g, np.ndarray)
        if g.ndim:  # x64 widens the reference's scalar counters to int64
            assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f.name)
    assert host.node_ids.dtype == np.uint64
    ing.fail_hook = None
    assert ing.retry_archive() == 3 and ing.archive_depth == 0
    assert ing.archived_total == ing.replayed == 3
    assert int(ing.store.n_nodes) == 3 * 5 * 2 + 1


def test_backoff_gate_and_degraded_mode():
    ing = _ingestor(fail_hook=lambda: True, retry_policy=_Policy(), degrade_after=2)
    assert ing.push(_et("a"), now=0.0)["retry_in_s"] == 1.0
    assert ing.push(_et("b"), now=0.5)["degraded"]
    assert ing.next_retry_t == 0.5 + 2.0
    attempts = ing.attempts
    out = ing.push(_et("c"), now=1.0)  # gate closed: archived without a probe
    assert out == {"committed": False, "archived": 3, "degraded": True}
    assert ing.attempts == attempts and ing.retry_archive(now=2.0) == 0
    ing.fail_hook = None
    assert ing.retry_archive(now=2.5) == 3 and not ing.degraded


def test_pool_cap_diverts_to_archive():
    ing = _ingestor(max_pool_size=1, pool_cap=2)
    ing.pool.extend([_et("a"), _et("b")])
    out = ing.push(_et("c"))
    assert out["pool_overflow"] == 1 and ing.archive_depth == 1


def test_state_round_trip_restores_pool_archive_and_counters(tmp_path):
    ing = _ingestor(fail_hook=lambda: True, max_archive=1, archive_dir=str(tmp_path / "a"))
    for tag in "ab":
        ing.push(_et(tag))
    ing.pool.append(_et("c"))
    s = pickle.loads(pickle.dumps(ing.state()))
    other = _ingestor(archive_dir=str(tmp_path / "b"))
    other.restore_state(s)
    assert (other.archive_depth, len(other.pool), other.attempts) == (2, 1, 2)
    assert other.retry_archive() == 2
    assert int(other.store.n_nodes) == 2 * 5 * 2 + 1


def test_pooled_pushes_match_reference_store():
    tags = ["a", "b", "c", "a", "d"]
    with jax.enable_x64(True):
        ref = RefIngestor(ref_init_store(512, 1024), max_pool_size=2)
        ref.pool.append(ref_from_raw(ref_create_edges(_recs("z", 40), ref_tweet_mapping()), 64))
        for t in tags:
            ref.push(ref_from_raw(ref_create_edges(_recs(t, 7), ref_tweet_mapping()), 64))
        want = {f.name: np.asarray(getattr(ref.store, f.name))
                for f in dataclasses.fields(ref.store)}
    ing = _ingestor(max_pool_size=2)
    ing.pool.append(_et("z", 40))
    for t in tags:
        ing.push(_et(t, 7))
    got = store_to_numpy(ing.store)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w.astype(got[name].dtype), err_msg=name)
    assert [c.instructions for c in ing.commits] == [c.instructions for c in ref.commits]
