"""Port parity: 64-bit key mixing, sort-based dedup and the edge table.

`repro_torch.core.compression` and `repro_torch.core.edge_table`
against `repro.core.compression` and `repro.core.edge_table` under x64,
on inputs made with numpy.  The port keeps uint64 keys as int64 bit
patterns, so the cases lean on what that changes: ids at or above 2^63
(negative as int64), the packed and hashed branches of `mix_keys` and
the boundaries between them, the remap of the all-ones sentinel, and
unsigned order in the sort and the binary search.  Everything is
compared bit for bit, at capacities 64 to 8192.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as RC
from repro.core import edge_table as RE
from repro.core.transform import RawEdgeBatch as RefRawEdgeBatch
from repro_torch.core import compression as PC
from repro_torch.core import edge_table as PE
from repro_torch.core.transform import RawEdgeBatch

M64 = 2**64 - 1
SENTINEL = np.uint64(M64)
CAPS = [64, 512, 8192]


def _t(a):
    """numpy -> torch, uint64 as int64 bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy((a.view(np.int64) if a.dtype == np.uint64 else a).copy())


def _u64(t):
    return t.numpy().view(np.uint64)


def _ids(rng, n, pool):
    """n ids drawn from a pool of `pool` values: narrow ids that pack,
    ids just past 2^27, and full 64-bit ids (about half >= 2^63)."""
    values = np.concatenate([
        rng.integers(0, 1 << 27, size=pool, dtype=np.uint64),
        rng.integers(1 << 27, 1 << 28, size=pool // 4 + 1, dtype=np.uint64),
        rng.integers(0, M64, size=pool, dtype=np.uint64, endpoint=True),
        np.array([0, (1 << 27) - 1, 1 << 27, 1 << 63, (1 << 63) - 1, M64 - 1], np.uint64),
    ])
    return rng.choice(values, size=n)


def _unxorshift(y, s):
    x = y
    for _ in range(64 // s + 1):
        x = y ^ (x >> s)
    return x & M64


def _dst_hashing_to(target, src):
    """dst such that the hash branch of mix_keys(src, dst, 0) is `target`
    before bit 63 is set (the mix is a bijection of src * C1 + dst)."""
    c1, c2 = 0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9
    x = _unxorshift(target, 27)
    x = (x * pow(c2, -1, 2**64)) & M64
    x = _unxorshift(x, 30)
    return (x - src * c1) & M64


def _ref_mix(src, dst, et):
    with jax.enable_x64(True):
        return np.asarray(RC.mix_keys(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(et)))


def test_mix_keys_branches_and_boundaries():
    rng = np.random.default_rng(0)
    n = 4096
    src, dst = _ids(rng, n, 512), _ids(rng, n, 512)
    et = rng.choice(np.array([-(2**31), -1, 0, 1, 7, 254, 255, 256, 2**31 - 1], np.int32), n)
    want = _ref_mix(src, dst, et)
    got = _u64(PC.mix_keys(_t(src), _t(dst), _t(et)))
    np.testing.assert_array_equal(got, want)
    packed = (want >> np.uint64(62)) == 1
    hashed = (want >> np.uint64(63)) == 1
    assert packed.any() and hashed.any() and (packed | hashed).all()
    assert not ((want == 0) | (want == SENTINEL)).any()


def test_mix_keys_pack_boundaries_exact():
    src = np.array([0, (1 << 27) - 1, 1 << 27, 5, 5, 5, 1 << 63, 3], np.uint64)
    dst = np.array([0, (1 << 27) - 1, 5, 1 << 27, 5, 5, 5, M64 - 1], np.uint64)
    et = np.array([0, 255, 0, 0, 256, -1, 0, 0], np.int32)
    want = _ref_mix(src, dst, et)
    np.testing.assert_array_equal(_u64(PC.mix_keys(_t(src), _t(dst), _t(et))), want)
    fits = np.array([1, 1, 0, 0, 0, 0, 0, 0], bool)
    np.testing.assert_array_equal((want >> np.uint64(62)) == 1, fits)


@pytest.mark.parametrize("target", [M64, (1 << 63) - 1])
def test_mix_keys_sentinel_remap(target):
    """A hashed key equal to the all-ones sentinel is moved to
    sentinel - 1.  (A 64-bit key is never 0: a packed key has bit 62
    set and a hashed one bit 63, so the 0 remap cannot fire here.)"""
    src = np.array([1 << 40, 1 << 63, 12345], np.uint64)
    dst = np.array([_dst_hashing_to(target, int(s)) for s in src], np.uint64)
    et = np.zeros(3, np.int32)
    want = _ref_mix(src, dst, et)
    got = _u64(PC.mix_keys(_t(src), _t(dst), _t(et)))
    np.testing.assert_array_equal(got, want)
    assert (want[:2] == SENTINEL - np.uint64(1)).all()


def _dedup_case(rng, cap):
    keys = np.concatenate([
        rng.integers(1, M64, size=max(cap // 8, 2), dtype=np.uint64),
        np.array([1, 2, 1 << 63, (1 << 63) - 1, M64 - 1], np.uint64)])
    keys = rng.choice(keys, size=cap)
    valid = rng.random(cap) >= 0.2
    return keys, valid


def _assert_batches_equal(got, want):
    np.testing.assert_array_equal(_u64(got.keys), np.asarray(want.keys))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index).astype(np.int64))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.n_unique) == int(want.n_unique)
    assert int(got.n_input) == int(want.n_input)


@pytest.mark.parametrize("cap", CAPS)
def test_dedup_with_counts_bit_exact(cap):
    rng = np.random.default_rng(cap)
    keys, valid = _dedup_case(rng, cap)
    with jax.enable_x64(True):
        want = RC.dedup_with_counts(jnp.asarray(keys), jnp.asarray(valid))
        _assert_batches_equal(PC.dedup_with_counts(_t(keys), _t(valid)), want)
    # sentinel sorts last: the valid head is in unsigned order
    got = _u64(PC.dedup_with_counts(_t(keys), _t(valid)).keys)
    live = got[got != SENTINEL]
    assert (np.diff(live.astype(object)) > 0).all() if live.size > 1 else True


def test_dedup_all_invalid_and_all_equal():
    keys = np.full(64, (1 << 63) + 5, np.uint64)
    for valid in (np.zeros(64, bool), np.ones(64, bool)):
        with jax.enable_x64(True):
            want = RC.dedup_with_counts(jnp.asarray(keys), jnp.asarray(valid))
            _assert_batches_equal(PC.dedup_with_counts(_t(keys), _t(valid)), want)


@pytest.mark.parametrize("cap", CAPS)
def test_compress_edges_and_unique_nodes(cap):
    rng = np.random.default_rng(cap + 1)
    src, dst = _ids(rng, cap, cap // 4 + 2), _ids(rng, cap, cap // 4 + 2)
    et = rng.integers(0, 4, size=cap).astype(np.int32)
    valid = rng.random(cap) >= 0.1
    with jax.enable_x64(True):
        args = [jnp.asarray(a) for a in (src, dst, et, valid)]
        want, wden = RC.compress_edges(*args)
        wnodes = RC.unique_nodes(args[0], args[1], args[3])
        got, gden = PC.compress_edges(_t(src), _t(dst), _t(et), _t(valid))
        _assert_batches_equal(got, want)
        _assert_batches_equal(PC.unique_nodes(_t(src), _t(dst), _t(valid)), wnodes)
        assert gden.dtype == torch.float32
        assert gden.numpy().tobytes() == np.asarray(wden).tobytes()
        wcr = RC.compression_ratio(wnodes.n_unique, want.n_unique, want.n_input)
        gcr = PC.compression_ratio(torch.tensor(int(wnodes.n_unique), dtype=torch.int32),
                                   got.n_unique, got.n_input)
        assert gcr.numpy().tobytes() == np.asarray(wcr).tobytes()


def _raw_pair(rng, cap, n):
    src, dst = _ids(rng, n, n // 3 + 2), _ids(rng, n, n // 3 + 2)
    et = rng.integers(0, 4, size=n).astype(np.int32)
    z = np.zeros(n, np.int32)
    ref = RefRawEdgeBatch(src=src, dst=dst, etype=et, src_type=z, dst_type=z, n_records=n)
    port = RawEdgeBatch(src=src, dst=dst, etype=et, src_type=z, dst_type=z, n_records=n)
    return ref, port


def _assert_tables_equal(got, want):
    keyed = ("src", "dst", "node_ids")
    for f in ("src", "dst", "etype", "count", "edge_valid", "node_ids", "node_valid",
              "src_node_idx", "dst_node_idx", "n_edges", "n_nodes", "n_raw"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f in keyed:
            g = g.view(np.uint64)
        np.testing.assert_array_equal(g, w, err_msg=f)
        if g.ndim:
            assert g.dtype == w.dtype, f
    assert int(got.size()) == int(want.size())
    for m in ("density", "compression_ratio"):  # float32 in both
        assert getattr(got, m)().numpy().tobytes() == np.asarray(getattr(want, m)()).tobytes(), m


@pytest.mark.parametrize("cap,n", [(64, 40), (64, 200), (512, 512), (8192, 6000)])
def test_from_raw_batch_matches_reference(cap, n):
    """Includes a batch longer than the capacity (truncated) and padded ones."""
    rng = np.random.default_rng(cap * 7 + n)
    ref_raw, port_raw = _raw_pair(rng, cap, n)
    with jax.enable_x64(True):
        want = RE.from_raw_batch(ref_raw, cap)
        got = PE.from_raw_batch(port_raw, cap, device="cpu")
        _assert_tables_equal(got, want)
    # every valid endpoint's index points at its own id
    v = got.edge_valid
    assert torch.equal(got.node_ids[got.src_node_idx[v]], got.src[v])
    assert torch.equal(got.node_ids[got.dst_node_idx[v]], got.dst[v])


@pytest.mark.parametrize("cap", [64, 1024])
def test_build_edge_table_with_masked_lanes(cap):
    rng = np.random.default_rng(cap + 3)
    src, dst = _ids(rng, cap, cap // 2), _ids(rng, cap, cap // 2)
    et = rng.integers(0, 300, size=cap).astype(np.int32)  # some etypes do not pack
    valid = rng.random(cap) >= 0.3
    with jax.enable_x64(True):
        want = RE.build_edge_table(*[jnp.asarray(a) for a in (src, dst, et, valid)])
        got = PE.build_edge_table(_t(src), _t(dst), _t(et), _t(valid))
        _assert_tables_equal(got, want)
