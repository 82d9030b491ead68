"""Port parity: the ingestion-time graph sketch (`query/sketch.py`) and
its scatter kernel's plain version (`kernels/sketch.py`).

The same numpy inputs go through `repro.query.sketch` (x64, as the
query CLI runs it) and `repro_torch.query.sketch` on the CPU.  Every
result is integer, so every comparison is exact (tolerance 0): the hash
coordinates, the scatter, each update's arrays and heavy-hitter table,
and every query.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.edge_table import from_raw_batch as ref_from_raw
from repro.core.transform import RawEdgeBatch as RefRawEdgeBatch
from repro.kernels import sketch as RK
from repro.query import sketch as RQ
from repro_torch import convert
from repro_torch.core.edge_table import from_raw_batch
from repro_torch.core.transform import RawEdgeBatch
from repro_torch.kernels import build, ops
from repro_torch.kernels import sketch as PK
from repro_torch.query import sketch as PQ


def _keys(rng, n):
    """n uint64 keys: a quarter narrow, the rest full width (about half
    of those with bit 63 set)."""
    k = rng.integers(1, 2**64 - 1, size=n, dtype=np.uint64)
    k[: n // 4] >>= np.uint64(40)
    return k


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _kt(keys):
    return _t(keys.astype(np.uint64).view(np.int64))


def _assert_sketch_equal(got, want, msg=""):
    g = convert.sketch_to_numpy(got)
    for f in dataclasses.fields(RQ.GraphSketch):
        w = np.asarray(getattr(want, f.name))
        np.testing.assert_array_equal(g[f.name], w.astype(g[f.name].dtype),
                                      err_msg=f"{msg}{f.name}")


@pytest.mark.parametrize("width", [128, 256, 512, 1000])
def test_node_hash_matches_reference(width):
    keys = _keys(np.random.default_rng(width), 4096)
    keys[:3] = [0, 2**64 - 1, 2**63]
    with jax.enable_x64(True):
        want = np.asarray(RQ.node_hash(jnp.asarray(keys), 4, width))
    got = PQ.node_hash(_kt(keys), 4, width)
    assert got.dtype == torch.int32 and got.shape == (4, 4096)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_plain_version_matches_pallas_kernel():
    D, W, n = 2, 128, 256
    rng = np.random.default_rng(1)
    ew = rng.integers(0, 50, size=(D, W, W), dtype=np.int32)
    od = rng.integers(0, 50, size=(D, W), dtype=np.int32)
    idg = rng.integers(0, 50, size=(D, W), dtype=np.int32)
    r = rng.integers(0, W, size=(D, n), dtype=np.int32)
    c = rng.integers(0, W, size=(D, n), dtype=np.int32)
    r[:, :32] = 7  # contended cells
    cnt = rng.integers(1, 5, size=n, dtype=np.int32)
    cnt[rng.random(n) < 0.1] = 0
    want = RK.sketch_scatter(*(jnp.asarray(a) for a in (ew, od, idg, r, c, cnt)),
                             interpret=True)
    launches = dict(build.launches)
    for fn in (PK.sketch_scatter_ref, ops.sketch_scatter):
        got = fn(*(_t(a.copy()) for a in (ew, od, idg, r, c, cnt)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert dict(build.launches) == launches  # CPU tensors never launch the kernel


def test_scatter_wrapper_checks_its_operands():
    D, W, n = 2, 8, 4
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.sketch_scatter(z(D, W, W), z(D, W), z(D, W), z(D, n), z(D, n), z(n).long())
    with pytest.raises(ValueError):
        ops.sketch_scatter(z(D, W, W), z(D, W), z(D, W), z(D, n + 1), z(D, n), z(n))
    meta = [t.to("meta") for t in (z(D, W, W), z(D, W), z(D, W), z(D, n), z(D, n), z(n))]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.sketch_scatter(*meta)


def _tables(seed, n_batches, batch, n_ids):
    """Pairs of (reference, port) edge tables from the same raw batches
    over `n_ids` ids, so nodes recur and the heavy-hitter table churns.
    One capacity for all of them, so the reference compiles once."""
    rng = np.random.default_rng(seed)
    ids = np.unique(_keys(rng, n_ids))
    cap = 1 << int(np.ceil(np.log2(batch)))
    out = []
    for _ in range(n_batches):
        n = int(rng.integers(batch // 2, batch + 1))
        src, dst = rng.choice(ids, n), rng.choice(ids[: len(ids) // 3], n)
        et = rng.integers(0, 3, size=n).astype(np.int32)
        z = np.zeros(n, np.int32)
        with jax.enable_x64(True):
            ref = ref_from_raw(RefRawEdgeBatch(src, dst, et, z, z, n), cap)
        out.append((ref, from_raw_batch(RawEdgeBatch(src, dst, et, z, z, n), cap, device="cpu")))
    return out


# one sketch and batch shape for every test, so the reference compiles
# its update once per worker: W=128 makes hash collisions, 8 slots churn
D, W, HH, BATCH = 4, 128, 8, 300


def test_sketch_update_matches_reference():
    depth, width, hh = D, W, HH
    tables = _tables(4, 6, BATCH, 500)
    with jax.enable_x64(True):
        want = RQ.init_sketch(depth=depth, width=width, hh_slots=hh)
    got = PQ.init_sketch(depth=depth, width=width, hh_slots=hh, device="cpu")
    for i, (ret, pet) in enumerate(tables):
        with jax.enable_x64(True):
            want = RQ.sketch_update(want, ret)
        got = PQ.sketch_update(got, pet)
        _assert_sketch_equal(got, want, f"update {i}: ")
    assert int((got.hh_keys != 0).sum()) == hh  # the table filled and churned

    # every query, on stored and on absent keys
    rng = np.random.default_rng(7)
    stored = np.asarray(tables[-1][0].src)[:40]
    q_src = np.concatenate([stored, _keys(rng, 24)])
    q_dst = np.concatenate([np.asarray(tables[-1][0].dst)[:40], _keys(rng, 24)])
    with jax.enable_x64(True):
        w_ew = np.asarray(RQ.sketch_edge_weight(want, jnp.asarray(q_src), jnp.asarray(q_dst)))
        w_deg = {m: np.asarray(RQ.sketch_degree(want, jnp.asarray(q_src), mode=m))
                 for m in ("out", "in", "total")}
        w_hh = [tuple(np.asarray(a) for a in RQ.sketch_heavy_hitters(want, k))
                for k in (1, 5, hh)]
        w_bound = RQ.sketch_error_bound(want)
    np.testing.assert_array_equal(PQ.sketch_edge_weight(got, _kt(q_src), _kt(q_dst)).numpy(),
                                  w_ew)
    for m, w in w_deg.items():
        np.testing.assert_array_equal(PQ.sketch_degree(got, _kt(q_src), mode=m).numpy(), w,
                                      err_msg=m)
    for k, (wk, wc) in zip((1, 5, hh), w_hh):
        gk, gc = PQ.sketch_heavy_hitters(got, k)
        np.testing.assert_array_equal(gk.numpy().view(np.uint64), wk, err_msg=f"k={k}")
        np.testing.assert_array_equal(gc.numpy(), wc, err_msg=f"k={k}")
    assert PQ.sketch_error_bound(got) == w_bound


def test_heavy_hitter_merge_breaks_ties_like_the_reference():
    """Equal counts everywhere: the table keeps the K smallest keys in
    unsigned order (lax.top_k's lower-index-first), duplicates keep their
    larger count, and zeros and -1 counts never enter."""
    K = 6
    hi = [2**63 + 5, 2**63 + 1, 2**64 - 2]
    hh_keys = np.array([9, 3, hi[0], 0, 0, 11], np.uint64)
    hh_counts = np.array([4, 4, 4, 0, 0, 2], np.int32)
    cand_keys = np.array([3, 7, hi[1], 0, 1, hi[2], 11, 5, 2, 9], np.uint64)
    cand_counts = np.array([4, 4, 4, -1, 4, 4, 4, 2, -1, 3], np.int32)
    with jax.enable_x64(True):
        wk, wc = (np.asarray(a) for a in RQ._merge_top_k(
            jnp.asarray(hh_keys), jnp.asarray(hh_counts), jnp.asarray(cand_keys),
            jnp.asarray(cand_counts)))
    gk, gc = PQ._merge_top_k(_kt(hh_keys), _t(hh_counts), _kt(cand_keys), _t(cand_counts))
    np.testing.assert_array_equal(gk.numpy().view(np.uint64), wk)
    np.testing.assert_array_equal(gc.numpy(), wc)
    assert wk.tolist() == [1, 3, 7, 9, 11, hi[1]] and len(wk) == K


def test_sketch_numpy_round_trips():
    tables = _tables(3, 2, BATCH, 500)
    with jax.enable_x64(True):
        want = RQ.init_sketch(depth=D, width=W, hh_slots=HH)
        for ret, _ in tables:
            want = RQ.sketch_update(want, ret)
        arrays = {f.name: np.asarray(getattr(want, f.name))
                  for f in dataclasses.fields(RQ.GraphSketch)}
    port = convert.sketch_from_numpy(arrays, device="cpu")
    _assert_sketch_equal(port, want)
    assert port.hh_keys.dtype == torch.int64 and port.n_updates.dtype == torch.int64
    back = convert.sketch_to_numpy(port)
    assert back["hh_keys"].dtype == np.uint64
    again = convert.sketch_to_numpy(convert.sketch_from_numpy(back, device="cpu"))
    for name, a in back.items():
        np.testing.assert_array_equal(again[name], a, strict=True)
    # a loaded reference sketch keeps absorbing like the reference
    with jax.enable_x64(True):
        want2 = RQ.sketch_update(want, tables[0][0])
    _assert_sketch_equal(PQ.sketch_update(port, tables[0][1]), want2)


def test_sketch_update_leaves_a_held_sketch_unchanged():
    (_, et), = _tables(5, 1, BATCH, 500)
    old = PQ.sketch_update(PQ.init_sketch(depth=D, width=W, hh_slots=HH, device="cpu"), et)
    before = convert.sketch_to_numpy(old)
    before = {k: v.copy() for k, v in before.items()}
    new = PQ.sketch_update(old, et)
    assert int(new.n_updates) == 2 * int(old.n_updates) > 0
    for name, a in convert.sketch_to_numpy(old).items():
        np.testing.assert_array_equal(a, before[name], err_msg=name)


# ---------------------------------------------------------------------------
# the fused entry (keys in, hashed in the kernel) and the launch plan
# ---------------------------------------------------------------------------


def _absorb_batch(seed, n, width, dist="uniform", depth=D):
    """(edge_w, out_deg, in_deg, src, dst, cnt) as numpy: a running
    sketch's arrays, keys with bit 63 set, key 0 and the all-ones key,
    zero counts and invalid lanes (count 0, as `sketch_update` masks
    them); "zipf" draws ranks over a pool of ids, "hub" gives every
    lane one src."""
    rng = np.random.default_rng(seed)
    if dist == "zipf":
        pool = _keys(rng, 4096)
        src, dst = (pool[np.minimum(rng.zipf(1.3, n), pool.size) - 1] for _ in range(2))
    else:
        src, dst = _keys(rng, n), _keys(rng, n)
        if dist == "hub":
            src[:] = src[0]
    src[:3], dst[:3] = [0, 2**64 - 1, 2**63][: min(n, 3)], [2**63 + 9, 0, 7][: min(n, 3)]
    cnt = rng.integers(1, 5, size=n).astype(np.int32)
    cnt[rng.random(n) < 0.1] = 0
    cnt[n - n // 8:] = 0  # the padded tail of an edge table
    return (rng.integers(0, 50, size=(depth, width, width), dtype=np.int32),
            rng.integers(0, 50, size=(depth, width), dtype=np.int32),
            rng.integers(0, 50, size=(depth, width), dtype=np.int32), src, dst, cnt)


def test_absorb_plain_version_matches_reference():
    ew, od, idg, src, dst, cnt = _absorb_batch(11, BATCH, W)
    assert (src >> np.uint64(63)).any() and (src == 0).any() and (cnt == 0).any()
    with jax.enable_x64(True):
        k = (jnp.asarray(src), jnp.asarray(dst))
        want = RQ.sketch_scatter_ref(jnp.asarray(ew), jnp.asarray(od), jnp.asarray(idg),
                                     RQ.node_hash(k[0], D, W), RQ.node_hash(k[1], D, W),
                                     jnp.asarray(cnt))
        want = [np.asarray(w) for w in want]
    launches = dict(build.launches)
    for fn in (PK.sketch_absorb_ref, ops.sketch_absorb):
        got = fn(_t(ew.copy()), _t(od.copy()), _t(idg.copy()), _kt(src), _kt(dst), _t(cnt))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    assert dict(build.launches) == launches  # CPU tensors never launch the kernel


def test_absorb_wrapper_checks_its_operands():
    Dp, Wp, n = 2, 8, 4
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    k = lambda m=n: torch.zeros(m, dtype=torch.int64)
    sk = (z(Dp, Wp, Wp), z(Dp, Wp), z(Dp, Wp))
    with pytest.raises(TypeError):  # keys of two widths (int32 keys alone are 32-bit keys)
        ops.sketch_absorb(*sk, k(), k().int(), z(n))
    with pytest.raises(TypeError):  # keys of no key width
        ops.sketch_absorb(*sk, k().short(), k().short(), z(n))
    with pytest.raises(TypeError):  # counts as int64
        ops.sketch_absorb(*sk, k(), k(), z(n).long())
    with pytest.raises(ValueError):  # src one lane longer than cnt
        ops.sketch_absorb(*sk, k(n + 1), k(), z(n))
    with pytest.raises(ValueError):  # (D, n) coordinates where keys belong
        ops.sketch_absorb(*sk, k().expand(Dp, n).contiguous(), k(), z(n))
    with pytest.raises(ValueError, match="contiguous"):
        ops.sketch_absorb(*sk, k(2 * n)[::2], k(), z(n))
    with pytest.raises(ValueError, match="one device"):
        ops.sketch_absorb(*sk, k().to("meta"), k(), z(n))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.sketch_absorb(*(t.to("meta") for t in (*sk, k(), k(), z(n))))


PLAN_LANES = (1, 2, 31, 32, 33, 63, 64, 100, 256, 512, 1_000, 1_024, 1_025, 2_048, 4_096,
              8_192, 10_000, 16_384, 65_535, 65_536)
PLAN_WIDTHS = (128, 256, 512, 1_000, 4_096)


def _cta_lanes(n, plan, cta):
    """The lanes CTA `cta` takes under `plan`, in the kernel's order:
    trip by trip, thread t of each trip taking base + t."""
    chunk = PK.cta_lanes(n, plan.ctas)
    lo, hi = cta * chunk, min(n, (cta + 1) * chunk)
    return [base + t for base in range(lo, hi, plan.threads) for t in range(plan.threads)
            if base + t < hi]


@pytest.mark.parametrize("width", PLAN_WIDTHS)
def test_launch_plan_covers_every_lane_once(width):
    for depth in (1, 4, 8):
        for n in PLAN_LANES:
            plan = PK.launch_plan(n, depth, width)
            assert 1 <= plan.ctas and plan.threads % 32 == 0, (n, plan)
            assert 32 <= plan.threads <= PK.MAX_THREADS, (n, plan)
            lanes = sorted(i for b in range(plan.ctas) for i in _cta_lanes(n, plan, b))
            assert lanes == list(range(n)), (n, depth, width, plan)
            # private rows only where they fit the opt-in shared memory,
            # hold at most PRIVATE_MAX_CELLS cells, and have as many lanes
            # as cells, and PRIVATE_LANES
            cells = 2 * depth * width
            want = cells <= PK.PRIVATE_MAX_CELLS and n >= max(PK.PRIVATE_LANES, cells)
            assert plan.private == want, (n, depth, width, plan)
            assert not plan.private or cells * 4 <= PK.SMEM_BYTES, (n, depth, width, plan)
    # at D = 8, W = 4,096 the rows (256 KB) exceed it: direct atomics
    assert not PK.launch_plan(8_192, 8, 4_096).private
    assert not PK.rows_fit(8, 4_096) and PK.rows_fit(4, 4_096)
    # the sweep's widths at D = 4: private from 4,096 lanes at W 256 and
    # 512, from 8,192 at 1,024, never at 2,048 and wider
    assert [PK.launch_plan(n, 4, w).private for w in (256, 512, 1_024, 2_048, 4_096)
            for n in (4_096, 8_192)] == [True, True, True, True, False, True] + [False] * 4


def _emulate(edge_w, out_deg, in_deg, r, c, cnt, plan):
    """The kernel's schedule in torch, in place: each CTA's lanes in
    trips of `plan.threads`; with `plan.private` the degree rows added
    into the CTA's own zeroed copy, then only its non-zero cells flushed
    into device memory."""
    D, W = out_deg.shape
    n = cnt.shape[0]
    depth = torch.arange(D).unsqueeze(1)
    for b in range(plan.ctas):
        lanes = torch.tensor(_cta_lanes(n, plan, b), dtype=torch.int64)
        if lanes.numel() == 0 and not plan.private:
            continue
        v = cnt[lanes].expand(D, -1)
        rr, cc = r[:, lanes].long(), c[:, lanes].long()
        live = (v != 0) & (rr >= 0) & (rr < W) & (cc >= 0) & (cc < W)
        edge_w.view(-1).index_add_(0, (depth * W * W + rr * W + cc)[live], v[live])
        rows = (torch.zeros(2 * D * W, dtype=torch.int32) if plan.private
                else torch.cat([out_deg.view(-1), in_deg.view(-1)]))
        for half, coord in ((0, rr), (1, cc)):
            rows.index_add_(0, (half * D * W + depth * W + coord)[live], v[live])
        if plan.private:
            nz = torch.nonzero(rows).squeeze(1)
            flat = torch.cat([out_deg.view(-1), in_deg.view(-1)]).index_add_(0, nz, rows[nz])
        else:
            flat = rows
        out_deg.view(-1).copy_(flat[: D * W])
        in_deg.view(-1).copy_(flat[D * W:])
    return edge_w, out_deg, in_deg


EMULATED = [(w, n, 4) for w in (128, 256, 512, 1_000) for n in (1, 64, 2_048, 65_536)]
EMULATED += [(4_096, 65_536, 1), (4_096, 512, 8)]  # D = 8 at 4,096: rows do not fit
EMULATED = [(*shape, ("uniform", "zipf", "hub")[i % 3]) for i, shape in enumerate(EMULATED)]


@pytest.mark.parametrize("width,n,depth,dist", EMULATED)
def test_kernel_schedule_emulation_matches_plain(width, n, depth, dist):
    ew, od, idg, src, dst, cnt = _absorb_batch(n + width, n, width, dist, depth)
    r, c = (PQ.node_hash(_kt(k), depth, width) for k in (src, dst))
    planned = PK.launch_plan(n, depth, width)
    fits = 2 * depth * width * 4 <= PK.SMEM_BYTES
    # the plan, each mode on its grid, one CTA and a CTA a warp
    plans = {planned, planned._replace(private=fits), planned._replace(private=False),
             PK.Plan(1, 1_024, fits), PK.Plan(-(-n // 32), 32, False)}
    want = PK.sketch_absorb_ref(_t(ew.copy()), _t(od.copy()), _t(idg.copy()), _kt(src),
                                _kt(dst), _t(cnt))
    for plan in plans:
        got = _emulate(_t(ew.copy()), _t(od.copy()), _t(idg.copy()), r, c, _t(cnt), plan)
        for g, w in zip(got, want):
            assert torch.equal(g, w), plan
