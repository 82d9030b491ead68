"""Port parity: the GraphZip pattern miner (kernel K5's plain version).

The same numpy batches go through `repro.kernels.pattern_mine
.pattern_mine_ref` (uint64 keys, x64) and the port's `pattern_mine` on
CPU tensors (the plain version).  All four outputs (fan_out, fan_in,
flags, psig) must be equal bit for bit, at n = 64 and n = 8,192 (the
path's edge-table cap), for random batches with invalid lanes and for
batches built to hold star bursts, cascade chains and hot edges, with
ids on both branches of `mix_keys` (packed below 2^27, hashed above),
and for a batch with no invalid lane, where the reference's binary
search ends past the end for the largest key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pattern_mine as RM
from repro_torch.kernels import pattern_mine as PM

STAR_MIN, HOT_MIN = 4, 2


def _ids(rng, k, narrow):
    """k distinct nonzero uint64 ids: below 2^27 (packed keys) or wide."""
    hi = (1 << 27) if narrow else 2**64 - 1
    return np.unique(rng.integers(1, hi, size=2 * k, dtype=np.uint64))[:k]


def _random_batch(rng, n, narrow, valid_frac=0.8):
    pool = _ids(rng, max(n // 4, 4), narrow)
    src, dst = pool[rng.integers(0, pool.size, n)], pool[rng.integers(0, pool.size, n)]
    et = rng.integers(0, 3, n).astype(np.int32)
    count = rng.integers(1, 4, n).astype(np.int32)
    return src, dst, et, count, rng.random(n) < valid_frac


def _patterned_batch(rng, n, narrow):
    """Star bursts (a hub with 6 out- or in-edges of one etype), cascade
    chains (a -> b -> c -> d) and hot edges (count >= hot_min), placed at
    random lanes among random filler, with ~10% invalid lanes."""
    src, dst, et, count, valid = _random_batch(rng, n, narrow, valid_frac=0.9)
    ids = _ids(rng, n, narrow)
    lane = iter(rng.permutation(n))
    take = iter(ids)
    for _ in range(n // 64):
        hub, e = next(take), rng.integers(0, 3)
        out_star = rng.random() < 0.5
        for _ in range(6):
            i, other = next(lane), next(take)
            src[i], dst[i] = (hub, other) if out_star else (other, hub)
            et[i], valid[i] = e, True
        chain = [next(take) for _ in range(4)]
        for a, b in zip(chain, chain[1:]):
            i = next(lane)
            src[i], dst[i], et[i], valid[i] = a, b, 1, True
        i = next(lane)
        count[i], valid[i] = HOT_MIN + 3, True
    return src, dst, et, count, valid


def _compare(src, dst, et, count, valid):
    with jax.enable_x64(True):
        want = [np.asarray(w) for w in RM.pattern_mine_ref(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(et), jnp.asarray(count),
            jnp.asarray(valid), STAR_MIN, HOT_MIN)]
    got = PM.pattern_mine(torch.from_numpy(src.view(np.int64)),
                          torch.from_numpy(dst.view(np.int64)), torch.from_numpy(et),
                          torch.from_numpy(count), torch.from_numpy(valid), STAR_MIN, HOT_MIN)
    got = [g.numpy() for g in got]
    assert [g.dtype for g in got] == [np.int32, np.int32, np.int32, np.int64]
    for name, g, w in zip(("fan_out", "fan_in", "flags"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got[3].view(np.uint64), want[3], err_msg="psig")
    return got


@pytest.mark.parametrize("n", [64, 8192])
@pytest.mark.parametrize("narrow", [False, True])
def test_random_batches_match_reference(n, narrow):
    rng = np.random.default_rng(n + narrow)
    fan_out, fan_in, flags, psig = _compare(*_random_batch(rng, n, narrow))
    assert (flags != 0).any() and ((psig != 0) == (flags != 0)).all()


@pytest.mark.parametrize("n", [64, 8192])
@pytest.mark.parametrize("narrow", [False, True])
def test_patterned_batches_match_reference(n, narrow):
    rng = np.random.default_rng(100 + n + narrow)
    batch = _patterned_batch(rng, n, narrow)
    fan_out, fan_in, flags, psig = _compare(*batch)
    for bit in (PM.FLAG_STAR_OUT, PM.FLAG_STAR_IN, PM.FLAG_CHAIN, PM.FLAG_HOT):
        assert (flags & bit).any(), bit
    valid = batch[4]
    assert (fan_out[~valid] == 0).all() and (fan_in[~valid] == 0).all()
    assert (flags[~valid] == 0).all() and (psig[~valid] == 0).all()


def test_all_valid_batch_matches_reference_past_the_end():
    rng = np.random.default_rng(7)
    src, dst, et, count, _ = _random_batch(rng, 64, narrow=True)
    _compare(src, dst, et, count, np.ones(64, dtype=bool))


def test_wrapper_checks_its_inputs():
    z64, z32 = torch.zeros(48, dtype=torch.int64), torch.zeros(48, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        PM.pattern_mine(z64, z64, z32, z32, z32.bool(), STAR_MIN, HOT_MIN)
    big = torch.zeros(1 << 17, dtype=torch.int64)
    with pytest.raises(ValueError, match="power of two"):
        PM.pattern_mine(big, big, big.int(), big.int(), big.bool(), STAR_MIN, HOT_MIN)
    z64, z32 = z64[:32], z32[:32]
    with pytest.raises(TypeError, match="int64"):
        PM.pattern_mine(z64.int(), z64, z32, z32, z32.bool(), STAR_MIN, HOT_MIN)
