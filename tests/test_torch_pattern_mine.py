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

The CUDA kernel counts in hash tables instead of sorting
(`csrc/pattern_mine.cu`).  `_emulate` runs its design in torch: the
same slot hash, linear probing across the C CTAs' slot ranges that
`cluster_plan` gives for each n, claims in lock-step rounds (one
schedule the atomics may take), the all-ones rule for T, the
past-the-end one for GS and GD, and the flags pass.  It is held bit for
bit to both packages' plain versions at 1 to 65,536 lanes and to the
reference's Pallas kernel in interpret mode up to 1,024, on random,
patterned, one-hub, extreme-id (0 and 2^64 - 1, with and without an
invalid lane), all-invalid and all-valid batches, and on one batch of
32-bit keys (int32 bits) against the Pallas kernel at uint32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pattern_mine as RM
from repro_torch.core.compression import as_int64, flip_sign, lsr, signed_view, unsigned_view
from repro_torch.kernels import pattern_mine as PM

STAR_MIN, HOT_MIN = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The kernel's emulation runs thousands of torch ops on tensors of
    up to 65,536 lanes.  On torch's intra-op threads such ops wait for
    every thread, and when the test run's workers share the cores they
    stall; one thread a worker keeps them at one core's speed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _jax_ref(src, dst, et, count, valid, fn=RM.pattern_mine_ref, **kw):
    # 64-bit keys under x64, 32-bit keys without it, as the reference runs each
    with jax.enable_x64(src.dtype == np.uint64):
        return [np.asarray(w) for w in fn(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(et), jnp.asarray(count),
            jnp.asarray(valid), STAR_MIN, HOT_MIN, **kw)]


def _compare(src, dst, et, count, valid):
    want = _jax_ref(src, dst, et, count, valid)
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


# ---------------------------------------------------------------- the kernel's design

EMPTY = -1  # the all-ones key: an empty slot, and the reference's sentinel
_F1, _F2 = as_int64(0xBF58476D1CE4E5B9), as_int64(0x94D049BB133111EB)
KINDS = ("random", "patterned", "hub", "extremes", "extremes_all_valid", "all_invalid",
         "all_valid")


def _slot_of(k):
    """csrc slot_of: the splitmix64 finalizer of the key, a 32-bit key
    zero-extended (masked by the caller)."""
    if k.dtype == torch.int32:
        k = k.to(torch.int64) & 0xFFFFFFFF
    k = (k ^ lsr(k, 30)) * _F1
    k = (k ^ lsr(k, 27)) * _F2
    return k ^ lsr(k, 31)


class _Table:
    """One vector's table: S slots, CTA r holding slots r*spc .. r*spc+spc-1
    as row r of (ctas, spc) arrays, probed linearly across the rows."""

    def __init__(self, n, key_dtype):
        self.ctas = PM.cluster_plan(n)
        self.spc = 2 * max(n, PM.MIN_TABLE_LANES) // self.ctas
        self.mask = self.ctas * self.spc - 1
        self.keys = torch.full((self.ctas, self.spc), EMPTY, dtype=key_dtype)
        self.counts = torch.zeros((self.ctas, self.spc), dtype=torch.int64)

    def _at(self, s):
        return s // self.spc, s % self.spc  # (CTA of the cluster, its slot)

    def insert(self, keys):
        """Insert keys (EMPTY never), each distinct key once with its number
        of lanes (a warp's leader adds its peers' number; the sum is the
        same).  In each round every pending key tries its slot; the first
        of those that find it empty claims it, the rest probe on."""
        uniq, num = torch.unique(keys[keys != EMPTY], return_counts=True)
        pos = _slot_of(uniq) & self.mask
        pending = torch.arange(uniq.numel())
        for _ in range(self.mask + 1):
            if pending.numel() == 0:
                break
            s = pos[pending]
            empty = self.keys[self._at(s)] == EMPTY
            first = torch.full((self.mask + 1,), uniq.numel(), dtype=torch.int64)
            first.scatter_reduce_(0, s[empty], pending[empty], "amin")
            won = empty & (first[s] == pending)
            self.keys[self._at(s[won])] = uniq[pending[won]]
            self.counts[self._at(s[won])] = num[pending[won]]
            pos[pending[~won]] = (s[~won] + 1) & self.mask
            pending = pending[~won]
        assert pending.numel() == 0, "the table overflowed"

    def find(self, q):
        """Slot of each query key, or -1: probe to the key or an empty slot."""
        pos, found = _slot_of(q) & self.mask, torch.full_like(q, -1)
        active = torch.ones_like(q, dtype=torch.bool)
        for _ in range(self.mask + 1):
            if not active.any():
                break
            cur = self.keys[self._at(pos)]
            hit, miss = active & (cur == q), active & (cur == EMPTY)
            found = torch.where(hit, pos, found)
            active &= ~(hit | miss)
            pos = (pos + 1) & self.mask
        return found


def _emulate(src, dst, et, count, valid, star_min=STAR_MIN, hot_min=HOT_MIN):
    """The CUDA design on numpy inputs: (fan_out, fan_in, flags, psig)."""
    src, dst = torch.from_numpy(signed_view(src)), torch.from_numpy(signed_view(dst))
    et, count, valid = torch.from_numpy(et), torch.from_numpy(count), torch.from_numpy(valid)
    n = src.shape[0]
    fans = []
    for ids, tag in ((src, PM.TAG_STAR_OUT), (dst, PM.TAG_STAR_IN)):
        key = torch.where(valid, PM._tag(ids, et, tag), torch.full_like(ids, EMPTY))
        table = _Table(n, key.dtype)
        table.insert(key)
        slot = table.find(key)
        fan = torch.where(valid, table.counts[table._at(slot.clamp(min=0))],
                          torch.zeros_like(slot))
        # past the end: no invalid lane, so the largest key is a real one
        if n >= 2 and bool(valid.all()):
            top = flip_sign(flip_sign(key).max())
            fan = fan + (key == top).long()
        fans.append(fan.to(torch.int32))
    tails = _Table(n, src.dtype)
    tails.insert(torch.where(valid, src, torch.full_like(src, EMPTY)))
    any_flag = bool((~valid).any() or (valid & (src == EMPTY)).any())
    member = torch.where(dst == EMPTY, torch.full_like(valid, any_flag), tails.find(dst) >= 0)
    # the flags pass
    fan_out, fan_in = fans
    chain = valid & member & (dst != src)
    staro, stari = valid & (fan_out >= star_min), valid & (fan_in >= star_min)
    hot = valid & (count >= hot_min)
    flags = (staro.int() * PM.FLAG_STAR_OUT + stari.int() * PM.FLAG_STAR_IN
             + chain.int() * PM.FLAG_CHAIN + hot.int() * PM.FLAG_HOT)
    psig = torch.where(hot, PM._tag(src, et, PM.TAG_HOT), torch.zeros_like(src))
    psig = torch.where(chain, PM._tag(dst, et, PM.TAG_CHAIN), psig)
    psig = torch.where(stari, PM._tag(dst, et, PM.TAG_STAR_IN), psig)
    psig = torch.where(staro, PM._tag(src, et, PM.TAG_STAR_OUT), psig)
    return [fan_out.numpy(), fan_in.numpy(), flags.numpy(), unsigned_view(psig.numpy())]


def _kind_batch(rng, n, kind):
    if kind == "keys32":  # uint32 ids: 0, 2^32 - 1 and a hub among them, one invalid lane
        ids = np.unique(rng.integers(1, 2**32 - 1, size=n, dtype=np.uint64)).astype(np.uint32)
        ids[:2] = [0, 2**32 - 1]
        src, dst = ids[rng.integers(0, ids.size, n)], ids[rng.integers(0, ids.size, n)]
        et = rng.integers(0, 3, n).astype(np.int32)
        src[: n // 8], et[: n // 8] = ids[2], 1
        dst[n // 8: n // 4] = src[n // 4: 3 * n // 8]
        count = rng.integers(1, 4, n).astype(np.int32)
        valid = np.ones(n, dtype=bool)
        valid[rng.integers(0, n)] = False
        return src, dst, et, count, valid
    if kind == "random":
        return _random_batch(rng, n, narrow=False)
    if kind == "patterned":
        return _patterned_batch(rng, n, narrow=True)
    src, dst, et, count, valid = _random_batch(rng, n, narrow=kind != "all_invalid")
    if kind == "hub":  # one (src, etype) owns every lane; some heads are the hub
        src[:] = src[0]
        et[:] = 1
        dst[rng.random(n) < 0.1] = src[0]
        valid[:] = True
    elif kind.startswith("extremes"):
        ids = np.array([0, 2**64 - 1, 1, 2**63, (1 << 27) - 1, 1 << 27], dtype=np.uint64)
        src, dst = ids[rng.integers(0, ids.size, n)], ids[rng.integers(0, ids.size, n)]
        valid[:] = True
        if kind == "extremes":
            valid[rng.integers(0, n)] = False
    elif kind == "all_invalid":
        valid[:] = False
    elif kind == "all_valid":
        valid[:] = True
    return src, dst, et, count, valid


def _assert_same(got, want, what):
    for name, g, w in zip(("fan_out", "fan_in", "flags", "psig"), got, want):
        np.testing.assert_array_equal(np.asarray(g).view(np.asarray(w).dtype), w,
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 2, 64, 1_024, 2_048, 4_096, 8_192, 16_384, 65_536])
def test_hash_design_matches_both_plain_versions(n, kind):
    batch = _kind_batch(np.random.default_rng(1_000 + n + KINDS.index(kind)), n, kind)
    got = _emulate(*batch)
    port = PM.pattern_mine_ref(*(torch.from_numpy(x.view(np.int64) if x.dtype == np.uint64
                                                  else x) for x in batch), STAR_MIN, HOT_MIN)
    _assert_same(got, [p.numpy() for p in port[:3]] + [port[3].numpy().view(np.uint64)],
                 "port's plain version")
    _assert_same(got, _jax_ref(*batch), "reference's plain version")


@pytest.mark.parametrize("n,kind", [
    (n, kind) for kind in ("random", "hub", "extremes", "extremes_all_valid")
    for n in (1, 2, 64, 1_024)] + [(64, "keys32")])
def test_hash_design_matches_pallas_kernel(n, kind):
    seed = 2_000 + n + (KINDS.index(kind) if kind in KINDS else len(KINDS))
    batch = _kind_batch(np.random.default_rng(seed), n, kind)
    _assert_same(_emulate(*batch), _jax_ref(*batch, fn=RM.pattern_mine, interpret=True),
                 "reference's Pallas kernel")


@pytest.mark.parametrize("log_n", range(17))
def test_cluster_plan_fits_the_card(log_n):
    n = 1 << log_n
    ctas = PM.cluster_plan(n)
    assert 1 <= ctas <= 8 and ctas & (ctas - 1) == 0  # a portable cluster; 3 of them
    assert n % ctas == 0 and n // ctas <= 8 * 1024  # at most 8 lanes a thread of 1,024
    slots = 2 * max(n, 64) // ctas  # the kernel's table of 2 max(n, 64) over its CTAs
    assert slots * ctas == 2 * max(n, 64)
    assert slots * (8 + 4) <= 192 * 1024  # 8-byte key and 4-byte count a slot
    assert n <= 0.5 * ctas * slots  # load at most 0.5: every probe ends


def test_hub_fan_is_past_the_end_where_no_lane_is_invalid():
    """The reference's upper bound ends at n + 1 for its largest key when
    no lane is invalid: a hub owning all 64 lanes gets fan_out 65."""
    src, dst, et, count, valid = _kind_batch(np.random.default_rng(5), 64, "hub")
    assert (_emulate(src, dst, et, count, valid)[0] == 65).all()
    assert (_jax_ref(src, dst, et, count, valid)[0] == 65).all()
    valid[3] = False
    assert (_emulate(src, dst, et, count, valid)[0][valid] == 63).all()
