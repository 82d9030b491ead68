"""Port parity: the fused upsert sweep.

`repro_torch.kernels.upsert` against the reference's Pallas kernel
(`repro.kernels.upsert.fused_upsert`, interpret mode) and its jnp
oracle, on 64-bit keys made with numpy.  The keys straddle bit 63 and
crowd onto a few probe slots, so hits, claims, contended claims (an
unsigned scatter-max between keys with and without bit 63) and drops
all occur.  Every output is compared bit for bit.  One corner case of
the kernel's emulated schedule runs 32-bit keys (int32 bits) against the
reference's Pallas kernel at uint32.

The CUDA kernel itself cannot run here; `chip_smoke.py` holds it
against `fused_upsert_ref` on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import upsert as ref
from repro_torch.core.compression import flip_sign, signed_view, unsigned_view
from repro_torch.kernels import build
from repro_torch.kernels import upsert as port

CAP = 1024
LANES = 256


def _distinct_keys(rng, n, dtype=np.uint64):
    """n distinct keys of `dtype` (uint64 or uint32) in [1, 2^bits - 2],
    about half with the top bit set."""
    top = np.iinfo(dtype).max
    keys = np.unique(rng.integers(1, top, size=2 * n + 16, dtype=np.uint64)).astype(dtype)
    rng.shuffle(keys)
    return keys[:n]


def _tensor(a):
    """Unsigned keys as a torch tensor of the same bits (int64 or int32)."""
    return torch.from_numpy(signed_view(a).copy())


def _first_slot(keys, cap):
    return port.probe_hash(_tensor(keys), cap, 0).numpy()


def _ref_upsert(fn, table, keys, valid, probes, **kw):
    # 64-bit keys under x64, 32-bit keys without it, as the reference runs each
    with jax.enable_x64(table.dtype == np.uint64):
        tk, slot, new = fn(jnp.asarray(table), jnp.asarray(keys), jnp.asarray(valid),
                           jnp.int32(probes), **kw)
        return np.asarray(tk), np.asarray(slot), np.asarray(new)


def _port_upsert(fn, table, keys, valid, probes):
    tk, slot, new = fn(_tensor(table), _tensor(keys), torch.from_numpy(valid.copy()), probes)
    return unsigned_view(tk.numpy()), slot.numpy(), new.numpy()


def _case(seed, load, zero_key=False, dtype=np.uint64):
    """A table pre-filled to `load` and a batch of LANES unique keys:
    30% already present, the rest new, a quarter of those crowded onto
    eight first-probe slots, 10% of the lanes invalid."""
    rng = np.random.default_rng(seed)
    pool = _distinct_keys(rng, 64 * CAP, dtype)
    m = int(load * CAP)
    fill, rest = pool[:m], pool[m:]
    table = np.zeros(CAP, dtype)
    if m:
        table, fslot, _ = _ref_upsert(ref.fused_upsert_ref, table, fill,
                                      np.ones(m, bool), 1 << 12)
        assert (fslot >= 0).all()
    hot = np.flatnonzero(np.isin(_first_slot(rest, CAP), rng.choice(CAP, 8, replace=False)))
    n_present = int(0.3 * LANES) if m else 0
    n_hot = min(len(hot), LANES // 4)
    crowded = rest[hot[:n_hot]]
    fresh = np.setdiff1d(rest, crowded)[: LANES - n_present - n_hot]
    keys = np.concatenate([rng.choice(fill, n_present, replace=False) if m else fill[:0],
                           crowded, fresh])
    if zero_key:  # key 0 reads an empty slot as its own key
        keys[-1] = 0
    keys = keys[rng.permutation(LANES)]
    valid = rng.random(LANES) >= 0.1
    if zero_key:
        valid[keys == 0] = True
    return table, keys, valid


def test_probe_hash_matches_reference():
    rng = np.random.default_rng(1)
    keys = np.concatenate([_distinct_keys(rng, 4096),
                           np.array([0, 1, 2**63, 2**63 - 1, 2**64 - 1], np.uint64)])
    for cap in (1, 7, CAP, 1 << 20, 3 << 20):
        for i in (0, 1, 127, 2**31 - 1):
            with jax.enable_x64(True):
                want = np.asarray(ref.probe_hash(jnp.asarray(keys), cap,
                                                 jnp.full(keys.shape, i, jnp.int32)))
            got = port.probe_hash(torch.from_numpy(keys.view(np.int64)), cap, i).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"cap={cap} i={i}")


@pytest.mark.parametrize("probes", [32, 64, 128])
@pytest.mark.parametrize("load", [0.0, 0.5, 0.85])
def test_fused_upsert_ref_matches_pallas_and_oracle(load, probes):
    table, keys, valid = _case(int(load * 100) + probes, load)
    # both halves of the key space contend for the crowded slots
    first = _first_slot(keys[valid], CAP)
    hi = (keys[valid] >> np.uint64(63)).astype(bool)
    assert np.intersect1d(first[hi], first[~hi]).size > 0
    want = _ref_upsert(ref.fused_upsert, table, keys, valid, probes, interpret=True)
    oracle = _ref_upsert(ref.fused_upsert_ref, table, keys, valid, probes)
    got = _port_upsert(port.fused_upsert_ref, table, keys, valid, probes)
    for name, w, o, g in zip(("table", "slot", "is_new"), want, oracle, got):
        np.testing.assert_array_equal(o, w, err_msg=f"oracle {name}")
        np.testing.assert_array_equal(g, w, err_msg=f"port {name}")
    slot, new = got[1], got[2]
    assert new.any()  # claims
    if load > 0:
        assert (slot[valid & ~new] >= 0).any()  # hits
    if load == 0.85 and probes == 32:
        assert (slot[valid] < 0).any()  # drops under table pressure


def test_fused_upsert_zero_key_matches_pallas():
    table, keys, valid = _case(7, 0.5, zero_key=True)
    want = _ref_upsert(ref.fused_upsert, table, keys, valid, 64, interpret=True)
    got = _port_upsert(port.fused_upsert_ref, table, keys, valid, 64)
    for name, w, g in zip(("table", "slot", "is_new"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_wrapper_runs_plain_version_on_cpu_and_updates_in_place():
    table, keys, valid = _case(3, 0.5)
    before = build.launches["fused_upsert"]
    t = torch.from_numpy(table.view(np.int64).copy())
    out, slot, new = port.fused_upsert(t, torch.from_numpy(keys.view(np.int64)),
                                       torch.from_numpy(valid),
                                       torch.tensor(64, dtype=torch.int32))
    assert out is t  # in place
    want = _ref_upsert(ref.fused_upsert_ref, table, keys, valid, 64)
    np.testing.assert_array_equal(t.numpy().view(np.uint64), want[0])
    np.testing.assert_array_equal(slot.numpy(), want[1])
    np.testing.assert_array_equal(new.numpy(), want[2])
    assert slot.dtype == torch.int32 and new.dtype == torch.bool
    # the launch count moves only where the CUDA kernel launches
    assert build.launches["fused_upsert"] == before


@pytest.mark.parametrize("bad", ["int32_keys", "2d_table", "short_valid", "strided",
                                 "uint8_valid", "meta"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    table = torch.zeros(64, dtype=torch.int64)
    keys = torch.arange(1, 17, dtype=torch.int64)
    valid = torch.ones(16, dtype=torch.bool)
    if bad == "int32_keys":
        keys = keys.to(torch.int32)
    elif bad == "2d_table":
        table = table.reshape(8, 8)
    elif bad == "short_valid":
        valid = valid[:8]
    elif bad == "strided":
        keys = torch.arange(1, 33, dtype=torch.int64)[::2]
    elif bad == "uint8_valid":
        valid = valid.to(torch.uint8)
    else:
        table, keys, valid = table.to("meta"), keys.to("meta"), valid.to("meta")
    with pytest.raises((TypeError, ValueError)):
        port.fused_upsert(table, keys, valid, 32)


# ---- the kernel's schedule (csrc/fused_upsert.cu), emulated in torch ----
#
# `_emulate` runs the design of the CUDA kernel on the CPU: the lanes
# split over C CTAs as `cluster_plan`'s launch splits them; round 0 from
# each thread's own lanes; then per round barrier 1, the claims (phase
# B), barrier 2, and one phase (A) that checks round i's claims back and
# reads round i+1's slot, over each CTA's worklist of 16-bit codes (the
# index of the key the CTA holds, bit 15 for a pending claim), whose
# order the emulation shuffles; the hand-over of a cluster's worklists
# to its first CTA once at most `hand_over` lanes are live.  It counts
# the barriers and every write of a lane's outputs.

CLAIM, LANE = 0x8000, 0x7FFF


def _claim(table, slots, keys):
    """Unsigned atomicMax of `keys` into table[slots], at the keys' width."""
    if not slots.numel():
        return
    uniq, inv = torch.unique(slots, return_inverse=True)
    best = flip_sign(table[uniq]).scatter_reduce(0, inv, flip_sign(keys), "amax",
                                                 include_self=True)
    table[uniq] = flip_sign(best)


class _Cta:
    def __init__(self, rank, cta_lanes, extra, n, key_dtype):
        self.first = rank * cta_lanes
        self.lanes = max(0, min(cta_lanes, n - self.first))
        self.cta_lanes = cta_lanes
        self.key = torch.zeros(cta_lanes + extra, dtype=key_dtype)  # keys held
        self.taken = torch.zeros(extra, dtype=torch.int64)  # global lane of each taken over
        self.queue = torch.zeros(0, dtype=torch.int64)  # codes

    def lane_of(self, held):
        """The global lane of each key held at `held`."""
        lane = self.first + held
        over = held >= self.cta_lanes
        lane[over] = self.taken[held[over] - self.cta_lanes]
        return lane


def _emulate(table, keys, valid, probes, ctas, hand_over=port.HAND_OVER_LANES, seed=0):
    """The kernel's schedule under a cluster of `ctas` CTAs.  Updates
    `table` in place; returns (table, slot, is_new, rounds, barriers)."""
    gen = torch.Generator().manual_seed(seed)
    cap, n = table.shape[0], keys.shape[0]
    cta_lanes = -(-n // ctas)
    assert cta_lanes <= port.MAX_CTA_LANES and ctas <= port.MAX_CLUSTER
    extra = hand_over if ctas > 1 else 0
    assert cta_lanes + extra <= LANE + 1  # codes fit 15 bits
    slot = torch.full((n,), -7, dtype=torch.int32)
    is_new = torch.zeros(n, dtype=torch.bool)
    writes = torch.zeros(n, dtype=torch.int64)

    def finish(g, s, nw):
        slot[g] = s.to(torch.int32) if isinstance(s, torch.Tensor) else s
        is_new[g] = nw
        writes.index_add_(0, g, torch.ones_like(g))

    def shuffled(q):
        return q[torch.randperm(q.numel(), generator=gen)]

    rank_ctas = [_Cta(r, cta_lanes, extra, n, keys.dtype) for r in range(ctas)]
    if int(probes) <= 0:
        finish(torch.arange(n), -1, False)
        return table, slot, is_new, 0, 0
    barriers = 1  # after the counts are cleared
    for cta in rank_ctas:  # A(0), from registers
        ls = torch.arange(cta.lanes)
        g = cta.first + ls
        live = valid[g]
        finish(g[~live], -1, False)
        ls, g = ls[live], g[live]
        cand = port.probe_hash(keys[g], cap, 0)
        cur = table[cand]
        hit = (cur == keys[g]) & (cur != 0)
        finish(g[hit], cand[hit], False)
        cta.key[ls] = keys[g]
        stay = ~hit
        cta.queue = shuffled(ls[stay] | torch.where(cur[stay] == 0, CLAIM, 0))
    active, clustered = rank_ctas, ctas > 1
    i = 0
    while True:
        barriers += 1  # barrier 1
        total = sum(c.queue.numel() for c in active)
        if total == 0:
            barriers += clustered  # no CTA leaves while another reads its count
            break
        if clustered and total <= hand_over:
            c0 = active[0]
            at = c0.queue.numel()
            parts = [c0.queue]
            for c in active[1:]:
                e = torch.arange(c.queue.numel())
                held = cta_lanes + at - c0.queue.numel() + e
                ls = c.queue & LANE
                c0.key[held] = c.key[ls]
                c0.taken[held - cta_lanes] = c.first + ls
                parts.append(held | (c.queue & CLAIM))
                at += c.queue.numel()
            c0.queue = torch.cat(parts)
            barriers += 1
            active, clustered = [c0], False
        for c in active:  # B(i): the claims
            claim = c.queue[(c.queue & CLAIM) != 0] & LANE
            k = c.key[claim]
            _claim(table, port.probe_hash(k, cap, i), k)
        barriers += 1  # barrier 2
        last = i + 1 >= int(probes)
        for c in active:  # A(i + 1): check-back of round i, read of round i+1
            held = c.queue & LANE
            claim = (c.queue & CLAIM) != 0
            k, g = c.key[held], c.lane_of(held)
            c0, c1 = port.probe_hash(k, cap, i), port.probe_hash(k, cap, i + 1)
            back = table[c0]
            won = claim & (back == k)
            zero = claim & ~won & (k == 0)
            finish(g[won], c0[won], True)
            finish(g[zero], c0[zero], False)
            reads = ~won & ~zero
            if last:
                finish(g[reads], -1, False)
                c.queue = c.queue[:0]
                continue
            got = table[c1]
            hit = reads & (got == k) & (got != 0)
            finish(g[hit], c1[hit], False)
            stay = reads & ~hit
            c.queue = shuffled(held[stay] | torch.where(got[stay] == 0, CLAIM, 0))
        if last:
            break
        i += 1
    assert bool((writes == 1).all()), "every lane's outputs are written exactly once"
    return table, slot, is_new, i + 1, barriers


def _emulated(table, keys, valid, probes, ctas, **kw):
    tk, slot, new, rounds, barriers = _emulate(
        _tensor(table), _tensor(keys), torch.from_numpy(valid.copy()), probes, ctas, **kw)
    # two barriers a round, one to clear the counts, and at most one to
    # end the loop and one to hand the lanes over
    assert barriers <= 2 * rounds + 3
    return unsigned_view(tk.numpy()), slot.numpy(), new.numpy()


_REFS = {}


def _refs(key, table, keys, valid, probes):
    """The reference's Pallas kernel (interpret mode; its jnp oracle for a
    batch of no lanes, which the interpreter cannot block) and the port's
    plain version on one case, computed once per test process."""
    if key not in _REFS:
        want = (_ref_upsert(ref.fused_upsert, table, keys, valid, probes, interpret=True)
                if keys.size else _ref_upsert(ref.fused_upsert_ref, table, keys, valid, probes))
        _REFS[key] = want, _port_upsert(port.fused_upsert_ref, table, keys, valid, probes)
    return _REFS[key]


def _assert_same(got, want, what):
    for name, g, w in zip(("table", "slot", "is_new"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


WIDTHS = [1, 2, 4, 8, 16]


@pytest.mark.parametrize("ctas", WIDTHS)
@pytest.mark.parametrize("probes", [32, 64, 128])
@pytest.mark.parametrize("load", [0.0, 0.5, 0.85])
def test_schedule_matches_pallas_and_plain(load, probes, ctas):
    table, keys, valid = _case(int(load * 100) + probes, load)
    pallas, plain = _refs(("case", load, probes), table, keys, valid, probes)
    _assert_same(plain, pallas, "plain version")
    # the kernel's hand-over, and one late enough that the cluster runs
    # several rounds first
    for hand_over in (port.HAND_OVER_LANES, 8):
        _assert_same(_emulated(table, keys, valid, probes, ctas, hand_over=hand_over), pallas,
                     f"ctas={ctas} hand_over={hand_over}")


def _special(kind):
    """(table, keys, valid, probes) of a corner case."""
    rng = np.random.default_rng(11)
    if kind == "cap7":  # no power of two, lanes dropped at the budget
        table = np.zeros(7, np.uint64)
        table[[1, 4]] = _distinct_keys(rng, 2)
        return table, _distinct_keys(rng, 64), rng.random(64) >= 0.1, 8
    table, keys, valid = _case(21, 0.5)
    if kind == "zero_and_duplicates":  # 1,000 lanes: no multiple of a warp
        pool = np.concatenate([[np.uint64(0)], keys[:200]])
        return table, pool[rng.integers(0, 201, 1_000)], rng.random(1_000) >= 0.1, 64
    if kind == "zero_loses_claim":  # key 0 and larger keys claim empty slot 0 at once
        pool = _distinct_keys(rng, 1 << 14)
        first = _first_slot(pool, CAP)
        rivals = pool[first == 0][:3]
        keys = np.concatenate([[np.uint64(0)], rivals, pool[first != 0][:60]])
        return np.zeros(CAP, np.uint64), keys, np.ones(keys.size, bool), 8
    if kind == "dropped":
        table, keys, valid = _case(22, 0.85)
        return table, keys, valid, 2
    if kind == "all_invalid":
        return table, keys, np.zeros_like(valid), 32
    if kind in ("budget0", "budget1"):
        return table, keys, valid, int(kind[-1])
    if kind == "keys32":  # 32-bit keys, key 0 among them, contended claims
        table, keys, valid = _case(23, 0.5, zero_key=True, dtype=np.uint32)
        return table, keys, valid, 64
    assert kind == "no_lanes"
    return table, keys[:0], valid[:0], 32


SPECIALS = ["cap7", "zero_and_duplicates", "zero_loses_claim", "dropped", "all_invalid",
            "budget0", "budget1", "no_lanes", "keys32"]


@pytest.mark.parametrize("ctas", WIDTHS)
@pytest.mark.parametrize("kind", SPECIALS)
def test_schedule_corner_cases_match_pallas_and_plain(kind, ctas):
    table, keys, valid, probes = _special(kind)
    pallas, plain = _refs(("special", kind), table, keys, valid, probes)
    _assert_same(plain, pallas, "plain version")
    for hand_over in (port.HAND_OVER_LANES, 4):
        got = _emulated(table, keys, valid, probes, ctas, hand_over=hand_over)
        _assert_same(got, pallas, f"{kind} ctas={ctas} hand_over={hand_over}")
    if kind == "zero_and_duplicates":
        slot, new = pallas[1], pallas[2]
        assert (keys == 0).any() and len(np.unique(keys[valid])) < valid.sum()
        dup = keys[valid & new]
        assert len(np.unique(dup)) < len(dup)  # duplicates both won one slot
    if kind == "zero_loses_claim":  # placed where a larger key won, not new
        assert pallas[1][0] == 0 and not pallas[2][0] and pallas[0][0] != 0
    if kind == "dropped":
        assert (pallas[1][valid] < 0).any()
    if kind == "keys32":
        assert pallas[0].dtype == np.uint32 and pallas[2].any() and (pallas[1] >= 0).any()


@pytest.mark.parametrize("ctas", [1, 4, 8, 16])
@pytest.mark.parametrize("load", [0.0, 0.5, 0.85])
def test_schedule_at_the_node_sweeps_width(load, ctas):
    """16,384 lanes, the main path's node sweep, into a 2^16-slot table:
    the cluster runs its rounds before handing over, as on the card."""
    rng = np.random.default_rng(int(load * 100) + 5)
    cap, n = 1 << 16, 1 << 14
    pool = _distinct_keys(rng, int(0.85 * cap) + n)
    m = int(load * cap)
    table = np.zeros(cap, np.uint64)
    if m:
        table = _ref_upsert(ref.fused_upsert_ref, table, pool[:m], np.ones(m, bool), 1 << 12)[0]
    keys = np.concatenate([rng.choice(pool[:m], int(0.3 * n), replace=False) if m else pool[:0],
                           pool[-(n - (int(0.3 * n) if m else 0)):]])[rng.permutation(n)]
    valid = rng.random(n) >= 0.1
    want = _ref_upsert(ref.fused_upsert_ref, table, keys, valid, 128)
    _assert_same(_port_upsert(port.fused_upsert_ref, table, keys, valid, 128), want, "plain")
    _assert_same(_emulated(table, keys, valid, 128, ctas), want, f"ctas={ctas}")


@pytest.mark.parametrize("n", [0, 1, 64, 1_000, 16_384, 16_385, 1 << 17, port.MAX_LANES])
def test_cluster_plan_fits_the_kernel(n):
    ctas = port.cluster_plan(n)
    assert ctas in WIDTHS and -(-n // ctas) <= port.MAX_CTA_LANES
    # one CTA below CLUSTER_LANES, else PLAN_CTAS unless more must hold n
    want = 1 if n < port.CLUSTER_LANES else max(port.PLAN_CTAS, 1 << max(
        0, (-(-n // port.MAX_CTA_LANES) - 1).bit_length()))
    assert ctas == want


def test_cluster_plan_refuses_more_lanes_than_the_kernel_takes():
    with pytest.raises(ValueError):
        port.cluster_plan(port.MAX_LANES + 1)
