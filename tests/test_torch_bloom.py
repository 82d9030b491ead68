"""Port parity: the Bloom filter kernels' plain versions
(`repro_torch.kernels.bloom`) and `ops.bloom_diversity`.

The same numpy keys go through the reference's ops (`repro.kernels.ops`,
Pallas in interpret mode on the CPU) and the port's ops on CPU tensors,
at the reference tests' shapes (tests/test_kernels.py, tests/test_bloom.py).
Bits are integers, so every comparison is exact (tolerance 0): built
bitmaps, probe masks, and rho with the bitmap on every step of a run of
batches.  Also: no false negatives, the input bitmap unchanged, the
port's oracles in `kernels/ref.py`, and the numpy converters.

The kernels themselves run only on the card (chip_smoke.py phase 15).
Here their schedule is emulated in numpy (`kernel_emulation`): the row
split of a word, the striped build's CTAs owning rows with a private
delta each (every plan of the sweep and `launch_plan`'s, at 1 to 64 rows
and 1 to 16,384 uniform, hub and Zipf keys), the grid route, the fused
entry on the grid route (rho through torch's mean), and `launch_plan`'s
coverage of every row and key at 1 to 4,097 rows.
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


# ---------------------------------------------------------------------------
# The kernels' schedule (csrc/bloom.cu), emulated on the CPU
# ---------------------------------------------------------------------------

GARBAGE = np.uint32(0xDEADBEEF)  # what `torch.empty` may hold where no CTA writes


def _hashes(keys):
    """(HASHES, n) uint32 hashes of int64 keys, as int64."""
    return np.stack([bloom._hash_round(keys, r).numpy() for r in range(bloom.HASHES)])


def _probe_words(h, flat):
    """1 where all rounds' bits of each key (columns of h) are set in `flat`."""
    words = bloom.row_split(torch.from_numpy(h), flat.size // bloom.LANES).numpy()
    return np.bitwise_and.reduce((flat[words] >> (h & 31).astype(np.uint32)) & 1, axis=0)


def kernel_emulation(keys, bitmap, plan, probe=False):
    """The build under `plan` as the kernel runs it, in numpy: (new bitmap
    as int32, float32 hits or None).

    Striped route: CTA b owns rows [b S, min((b + 1) S, rows)); it walks
    keys k T + t (k its loop iteration), ORs each round whose row passes
    the kernel's unsigned bound `row - b S < S` into its own delta, then
    writes in | delta over its rows.  Grid route: out = in, then every
    key's bits ORed in, and (the fused entry's only route) every key
    probed against `in`.  Rows no CTA writes keep GARBAGE."""
    rows, n = bitmap.shape[0], keys.shape[0]
    flat = bitmap.numpy().view(np.uint32).reshape(-1)
    h = _hashes(keys)
    row, col = (h >> 15) % rows, (h >> 5) & (bloom.LANES - 1)
    bit = np.left_shift(np.uint32(1), (h & 31).astype(np.uint32))
    if plan.route == "grid":
        out = flat.copy()
        np.bitwise_or.at(out, row * bloom.LANES + col, bit)
        hits = _probe_words(h, flat).astype(np.float32) if probe else None
        return torch.from_numpy(out.view(np.int32).reshape(bitmap.shape)), hits
    assert plan.route == "striped" and not probe, plan
    S, ctas = plan.stripe, bloom.build_ctas(plan, rows, n)
    # every CTA tests every round against its bound; a round can pass it
    # only in its row's CTA or a neighbour, so test those three
    delta = np.zeros((ctas, S * bloom.LANES), np.uint32)
    for d in (-1, 0, 1):
        cta = row // S + d
        local = row - cta * S
        m = (cta >= 0) & (cta < ctas) & (local >= 0) & (local < S)
        np.bitwise_or.at(delta, (cta[m], local[m] * bloom.LANES + col[m]), bit[m])
    out = np.full(rows * bloom.LANES, GARBAGE, np.uint32)
    for cta in range(ctas):
        lo = cta * S
        assert lo < rows, f"CTA {cta} holds no row under {plan}"
        words = slice(lo * bloom.LANES, min(lo + S, rows) * bloom.LANES)
        out[words] = flat[words] | delta[cta, : words.stop - words.start]
    return torch.from_numpy(out.view(np.int32).reshape(bitmap.shape)), None


def _zipf_keys(rng, n, pool=None):
    """n Zipf (a = 1.3) draws from `pool` (default a fresh one of 2^16 keys)."""
    pool = rng.integers(0, 2**32, size=1 << 16) if pool is None else pool
    return pool[np.minimum(rng.zipf(1.3, size=n), pool.size) - 1]


def _kind_keys(rng, n, kind):
    if kind == "edges":  # uniform, with keys 0 and 2^32 - 1
        keys = rng.integers(0, 2**32, size=n)
        keys[: min(n, 2)] = [0, 2**32 - 1][: min(n, 2)]
        return keys
    if kind == "hub":  # one key in every lane
        return np.full(n, 0x9E3779B9, np.int64)
    return _zipf_keys(rng, n)


def _filter(rng, rows):
    """A filter already in use: a few bits set in each word."""
    return torch.from_numpy((rng.integers(0, 2**32, size=(rows, bloom.LANES), dtype=np.uint32)
                             & np.uint32(0x00100001)).view(np.int32))


def test_row_split_is_the_word_modulo():
    """(h >> 5) % (rows * 1024) is row (h >> 15) % rows, column
    (h >> 5) & 1023, for every uint32 h: random and edge hashes at rows 1
    to 70 and 64-row multiples up to 2^15."""
    rng = np.random.default_rng(11)
    h = np.concatenate([rng.integers(0, 2**32, size=4_096),
                        [0, 1, 31, 32, 2**15 - 1, 2**15, 2**31, 2**32 - 2, 2**32 - 1]])
    ht = torch.from_numpy(h)
    for rows in list(range(1, 71)) + list(range(64, 2**15 + 1, 64)):
        want = (h >> 5) % (rows * bloom.LANES)
        np.testing.assert_array_equal(bloom.row_split(ht, rows).numpy(), want, err_msg=str(rows))


STRIPED_ROWS = (1, 2, 3, 16, 48, 64)
STRIPED_N = (1, 33, 1_024, 16_384)


@pytest.mark.parametrize("kind", ["edges", "hub", "zipf"])
@pytest.mark.parametrize("rows", STRIPED_ROWS)
def test_striped_build_emulation_matches_plain(rows, kind):
    """The build's schedule under every plan of the sweep and
    `launch_plan`'s equals `bloom_build_plain` bit for bit, with no
    GARBAGE left (every row written by its one owner)."""
    rng = np.random.default_rng(rows * 7 + len(kind))
    start = _filter(rng, rows)
    for n in STRIPED_N:
        keys = _kt(_kind_keys(rng, n, kind))
        want = bloom.bloom_build_plain(keys, start)
        for plan in bloom.build_plans(rows, n):
            got, _ = kernel_emulation(keys, start, plan)
            assert torch.equal(got, want), f"rows={rows} n={n} {kind} {plan}"


def test_striped_build_emulation_matches_the_reference():
    rng = np.random.default_rng(12)
    keys = _keys(rng, 256, lo=0, hi=2**32)
    want = np.asarray(ref_ops.bloom_build(jnp.asarray(keys), RB.init_bitmap(3)))
    empty = bloom.init_bitmap(3, device="cpu")
    own = bloom.launch_plan(3, 256)
    for plan in [own, own._replace(stripe=2, threads=128), own._replace(route="grid", stripe=0)]:
        got, _ = kernel_emulation(_kt(keys), empty, plan)
        np.testing.assert_array_equal(convert.bloom_bitmap_to_numpy(got), want, err_msg=str(plan))


def test_fused_diversity_emulation_matches_reference():
    """The fused entry's schedule (the grid route's build, each key
    probed against the filter before it) gives the plain route's rho and
    bitmap on every step of a run of Zipf batches, under every plan of the
    sweep and `launch_plan`'s, all on the grid route."""
    rng = np.random.default_rng(13)
    rows, n = 64, 4_096
    plans = bloom.build_plans(rows, n, fused=True)
    assert {p.route for p in plans} == {"grid"}, plans
    bms = [bloom.init_bitmap(rows, device="cpu") for _ in plans]
    want_bm = bloom.init_bitmap(rows, device="cpu")
    pool = rng.integers(0, 2**32, size=1 << 16)
    for step in range(4):
        keys = _kt(_zipf_keys(rng, n, pool))
        want_rho, new_want = ops.bloom_diversity(keys, want_bm)
        for p, plan in enumerate(plans):
            got_bm, hits = kernel_emulation(keys, bms[p], plan, probe=True)
            rho = 1.0 - torch.from_numpy(hits).mean()
            assert torch.equal(rho, want_rho), (step, plan)
            assert torch.equal(got_bm, new_want), (step, plan)
            bms[p] = got_bm
        want_bm = new_want
    assert 0.0 < float(want_rho) < 1.0


def _row_sizes():
    return sorted({r for k in range(13) for r in (2**k - 1, 2**k, 2**k + 1) if 1 <= r <= 2**12})


@pytest.mark.parametrize("n", [1, 33, 2_049, 16_384, 1 << 20])
def test_launch_plan_covers_every_row_once(n):
    """Under `launch_plan` (and every plan of the sweep), at rows 1 to
    2^12 at powers of two and their neighbours: each row is owned by
    exactly one CTA, no CTA is empty, the probe's CTAs hold every key
    once, and the grid is within the card's limits."""
    for rows in _row_sizes():
        own = bloom.launch_plan(rows, n)
        sweep = (bloom.build_plans(rows, n) + bloom.build_plans(rows, n, fused=True)
                 + bloom.probe_plans(rows, n)) if n == 33 else []
        for plan in [own, bloom.launch_plan(rows, n, fused=True)] + sweep:
            assert plan.threads % 32 == 0 and 32 <= plan.threads <= bloom.MAX_THREADS, plan
            ctas = bloom.build_ctas(plan, rows, n)
            assert 1 <= ctas <= 2**31 - 1, (rows, plan)
            if plan.route == "striped":
                S = plan.stripe
                assert 1 <= S <= bloom.MAX_STRIPE, plan
                first = np.arange(ctas) * S  # the kernel's blockIdx.x * stripe
                last = np.minimum(first + S, rows)
                assert (last > first).all(), f"a CTA holds no row: rows={rows} {plan}"
                owners = np.zeros(rows + 1, np.int64)
                np.add.at(owners, first, 1)
                np.add.at(owners, last, -1)
                assert (np.cumsum(owners)[:rows] == 1).all(), f"a row not owned once: {rows} {plan}"
            else:  # a key or a uint4 of the copy a thread
                assert plan.route == "grid" and plan.stripe == 0, plan
                work = max(n, rows * bloom.LANES // 4)
                assert (ctas - 1) * plan.threads < work, f"a CTA with nothing to do: {rows} {plan}"
            T = plan.probe_threads
            assert T % 32 == 0 and 32 <= T <= bloom.MAX_PROBE_THREADS, plan
            assert (plan.probe_ctas - 1) * T < n <= plan.probe_ctas * T, (n, plan)  # a key a thread
            assert plan.probe_ctas <= 2**31 - 1
