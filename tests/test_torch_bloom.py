"""Port parity: the Bloom filter kernels' plain versions
(`repro_torch.kernels.bloom`) and `ops.bloom_diversity`.

The same numpy keys go through the reference's ops (`repro.kernels.ops`,
Pallas in interpret mode on the CPU) and the port's ops on CPU tensors,
at the reference tests' shapes (tests/test_kernels.py, tests/test_bloom.py).
Bits are integers, so every comparison is exact (tolerance 0): built
bitmaps, probe masks, and rho with the bitmap on every step of a run of
batches.  Also: no false negatives, the input bitmap unchanged, the
port's oracles in `kernels/ref.py`, and the numpy converters.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bloom as RB
from repro.kernels import ops as ref_ops
from repro_torch import convert
from repro_torch.kernels import bloom, build, ops, ref
from repro_torch.query.sketch import node_hash


def _keys(rng, n, lo=1, hi=2**31):
    return rng.integers(lo, hi, size=n).astype(np.uint32)


def _kt(keys):
    return torch.from_numpy(keys.astype(np.int64))


@pytest.mark.parametrize("n,rows", [(64, 2), (256, 4), (1024, 16), (128, 4), (256, 16)])
def test_build_and_probe_match_reference(n, rows):
    rng = np.random.default_rng(n + rows)
    keys = _keys(rng, n)
    keys[:2] = [0, 2**32 - 1]
    queries = np.concatenate([keys[: n // 2], _keys(rng, n, hi=2**32)])
    launches = dict(build.launches)
    want_bm = np.asarray(ref_ops.bloom_build(jnp.asarray(keys), RB.init_bitmap(rows)))
    want_hit = np.asarray(ref_ops.bloom_probe(jnp.asarray(queries), jnp.asarray(want_bm)))
    empty = bloom.init_bitmap(rows, device="cpu")
    bm = ops.bloom_build(_kt(keys), empty)
    assert bm.dtype == torch.int32 and bm.shape == (rows, bloom.LANES)
    np.testing.assert_array_equal(convert.bloom_bitmap_to_numpy(bm), want_bm)
    hit = ops.bloom_probe(_kt(queries), bm)
    assert hit.dtype == torch.int32
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    assert int(empty.abs().sum()) == 0  # the input bitmap is unchanged
    assert dict(build.launches) == launches  # CPU tensors never launch the kernels


@pytest.mark.parametrize("rows", [4, 16])
def test_plain_versions_match_the_port_s_oracles(rows):
    rng = np.random.default_rng(rows)
    start = convert.bloom_bitmap_from_numpy(
        rng.integers(0, 2**32, size=(rows, bloom.LANES), dtype=np.uint32) & np.uint32(0x01010101),
        device="cpu")
    keys = _kt(_keys(rng, 300, lo=0, hi=2**32))
    built = ops.bloom_build(keys, start)
    assert torch.equal(built, ref.bloom_build_ref(keys, start))
    queries = torch.cat([keys[:100], _kt(_keys(rng, 200, lo=0, hi=2**32))])
    assert torch.equal(ops.bloom_probe(queries, built), ref.bloom_probe_ref(queries, built))


def test_no_false_negatives_and_input_unchanged():
    rng = np.random.default_rng(1)
    for trial in range(5):
        keys = _kt(_keys(rng, 256))
        bm0 = bloom.init_bitmap(8, device="cpu")
        bm0[0, :3] = torch.tensor([1, -1, 1 << 30], dtype=torch.int32)
        before = bm0.clone()
        bm = ops.bloom_build(keys, bm0)
        assert torch.equal(bm0, before)
        assert bool((ops.bloom_probe(keys, bm) == 1).all()), f"false negative in trial {trial}"
        assert bool(((bm & before) == before).all())  # bits are only ever added


def test_diversity_over_successive_batches_matches_reference():
    rng = np.random.default_rng(2)
    pool = _keys(rng, 20_000, hi=2**32)
    want_bm, got_bm = RB.init_bitmap(4), bloom.init_bitmap(4, device="cpu")
    for step in range(12):
        batch = pool[np.minimum(rng.zipf(1.3, size=256), pool.size) - 1]
        want_rho, want_bm = ref_ops.bloom_diversity(jnp.asarray(batch), want_bm)
        before = got_bm.clone()
        rho, new_bm = ops.bloom_diversity(_kt(batch), got_bm)
        assert rho.dtype == torch.float32 and rho.shape == ()
        assert float(rho) == float(want_rho), step
        assert torch.equal(got_bm, before)
        np.testing.assert_array_equal(convert.bloom_bitmap_to_numpy(new_bm),
                                      np.asarray(want_bm), err_msg=f"step {step}")
        got_bm = new_bm
    assert 0.0 < float(rho) < 1.0


def test_hash_round_is_the_sketch_s():
    """The Bloom rounds and node_hash share one helper: node_hash of a
    key below 2^32 is round d of the key, mod the width."""
    keys = _kt(_keys(np.random.default_rng(4), 512, lo=0, hi=2**32))
    got = node_hash(keys, bloom.HASHES, 1 << 27)
    for r in range(bloom.HASHES):
        h = bloom._hash_round(keys, r)
        want = np.asarray(RB._hash_round(jnp.asarray(keys.numpy().astype(np.uint32)), r))
        np.testing.assert_array_equal(h.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(got[r].numpy(), (h % (1 << 27)).numpy())


def test_converters_round_trip():
    bm = np.random.default_rng(5).integers(0, 2**32, size=(2, bloom.LANES), dtype=np.uint32)
    bm[0, :2] = [0, 2**32 - 1]
    t = convert.bloom_bitmap_from_numpy(bm, device="cpu")
    assert t.dtype == torch.int32 and t.shape == bm.shape
    back = convert.bloom_bitmap_to_numpy(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, bm)


def test_wrappers_check_their_operands(monkeypatch):
    keys, bm = torch.zeros(4, dtype=torch.int64), bloom.init_bitmap(2, device="cpu")
    with pytest.raises(ValueError):
        ops.bloom_probe(keys, torch.zeros((2, 512), dtype=torch.int32))
    with pytest.raises(TypeError):
        ops.bloom_build(keys.int(), bm)
    with pytest.raises(TypeError):
        ops.bloom_build(keys, bm.long())
    with pytest.raises(ValueError, match="cuda or cpu"):
        bloom.bloom_probe(keys.to("meta"), bm.to("meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bloom.init_bitmap(2)  # defaults to the card
