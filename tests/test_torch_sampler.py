"""Port parity: the workload generator's samplers (kernel K4's plain
version and the tick-rate process).

  * `counter_mix` and `uniform01` are integer and exact float32 maps:
    bit-exact against `repro.kernels.sampler` over 2^16 counters and
    three seeds.
  * `traffic_ids` on CPU tensors (the plain version) against
    `repro.kernels.sampler.traffic_ids_ref` for every registry scenario
    at burst levels 0 and 1, n = 2,048 (the source's block), two seeds,
    one `ctr0` near the uint32 wrap.  The spare uniforms are exact.
    The Zipf ranks are not (ROADMAP F1): the reference is jitted, and
    XLA contracts `1 + u*top` into one fused multiply-add, while the
    port rounds each operation on its own (so that the CUDA kernel can
    match it bit for bit).  On these 24 blocks 10 of 49,152 uid lanes
    and 6 mention lanes differ, no tag lane; over 2^19 lanes of one
    scenario the uid rate was 3.5e-4.  The stated bound is 1 in 10^3
    lanes per column, uid and tag ranks off by one, and every copied
    mention equals the uid of the earlier record it copies.
  * `rate_trajectory` against the reference for the six scenarios x 3
    seeds x 256 ticks: rates within rtol 1e-6 (the same FMA contraction
    and XLA's own sin/exp/log), counts equal; and 4 chunks of 64 ticks
    equal one chunk of 256 in the port.
  * K4's kernel schedule (`csrc/traffic_ids.cu`: a rank a thread on a
    ctas x 3 grid, each CTA's constants once, one pow a thread on
    selected operands), emulated in torch under `launch_plan` and, at 33
    and 2,049 records, every plan of the sweep: bit for bit against the
    plain version for every scenario at bursts 0 and 1, at 1 to 65,536
    records, at corner parameters and near the uint32 wrap (tolerance
    0; each pow at the plain version's position, ROADMAP F25).
  * `launch_plan` at every power of two to `MAX_LANES` and its
    neighbours: each record exactly once, the grid within the card's
    limits and no empty CTA.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sampler as RS
from repro.workloads import samplers as RW
from repro.workloads.scenarios import list_scenarios as ref_scenarios
from repro_torch.kernels import sampler as PS
from repro_torch.workloads import samplers as PW
from repro_torch.workloads.scenarios import list_scenarios

BLOCK = 2048
SEEDS_CTR = ((0, 0), (7, 2**32 - 5000))  # the second block wraps the uint32 counter
RANK_MISMATCH_MAX = 1e-3  # per column, F1
RATE_RTOL = 1e-6
TICKS = 256


def test_the_registry_is_the_reference_registry():
    assert [dataclasses.asdict(s) for s in list_scenarios()] == \
        [dataclasses.asdict(r) for r in ref_scenarios()]
    for s, r in zip(list_scenarios(), ref_scenarios()):
        np.testing.assert_array_equal(s.iparams(), r.iparams())
        for b in (0.0, 0.3, 1.0):
            np.testing.assert_array_equal(s.fparams(b), r.fparams(b))


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF])
def test_counter_mix_and_uniform01_are_bit_exact(seed):
    ctr = np.arange(1 << 16, dtype=np.uint32) * np.uint32(2654435761)
    with jax.enable_x64(True):
        want_bits = np.asarray(RS.counter_mix(jnp.uint32(seed), jnp.asarray(ctr)))
        want_u = np.asarray(RS.uniform01(jnp.asarray(want_bits)))
    got_bits = PS.counter_mix(seed, torch.from_numpy(ctr.astype(np.int64)))
    np.testing.assert_array_equal(got_bits.numpy(), want_bits.astype(np.int64))
    got_u = PS.uniform01(got_bits).numpy()
    assert got_u.dtype == np.float32 and got_u.tobytes() == want_u.tobytes()


def _blocks():
    for scn in list_scenarios():
        for burst in (0.0, 1.0):
            for seed, ctr0 in SEEDS_CTR:
                yield scn, burst, seed, ctr0


def test_traffic_ids_matches_reference_within_the_f1_bound():
    lanes, mismatched = 0, np.zeros(3, dtype=np.int64)
    for scn, burst, seed, ctr0 in _blocks():
        ip, fp = scn.iparams(), scn.fparams(burst)
        with jax.enable_x64(True):
            want = [np.asarray(w) for w in
                    RS.traffic_ids_ref(np.uint32(seed), np.uint32(ctr0), BLOCK, ip, fp)]
        got = [g.numpy() for g in
               PS.traffic_ids(seed, ctr0, BLOCK, torch.from_numpy(ip), torch.from_numpy(fp))]
        for k in (3, 4):  # the spare uniforms: exact
            assert got[k].dtype == np.float32 and got[k].tobytes() == want[k].tobytes()
        for k in range(3):
            assert got[k].dtype == np.int32
            diff = got[k] != want[k]
            mismatched[k] += int(diff.sum())
            if k < 2:  # a flipped rank moves by one
                assert np.abs(got[k][diff] - want[k][diff]).max(initial=0) <= 1
        # a copied mention is the uid of an earlier record of the block
        pos = torch.arange(BLOCK)
        ctr = (ctr0 + 8 * pos) & 0xFFFFFFFF
        u_cas, u_src = (PS.uniform01(PS.counter_mix(seed, (ctr + s) & 0xFFFFFFFF))
                        for s in (3, 4))
        copied = ((u_cas < float(fp[4])) & (pos > 0)).numpy()
        j = (u_src * pos.to(torch.float32)).to(torch.int64).numpy()
        assert copied.sum() > 0.5 * BLOCK * scn.copy_frac
        assert (j[copied] < pos.numpy()[copied]).all()
        np.testing.assert_array_equal(got[2][copied], got[0][j[copied]])
        lanes += BLOCK
    assert (mismatched <= RANK_MISMATCH_MAX * lanes).all(), (mismatched, lanes)


def test_traffic_ids_wrapper_checks_its_inputs():
    scn = list_scenarios()[0]
    ip, fp = torch.from_numpy(scn.iparams()), torch.from_numpy(scn.fparams(0.0))
    with pytest.raises(ValueError, match="block size"):
        PS.traffic_ids(0, 0, 0, ip, fp)
    with pytest.raises(ValueError, match="uint32"):
        PS.traffic_ids(-1, 0, 8, ip, fp)
    with pytest.raises(TypeError, match="iparams"):
        PS.traffic_ids(0, 0, 8, ip.to(torch.int64), fp)
    with pytest.raises(TypeError, match="fparams"):
        PS.traffic_ids(0, 0, 8, ip, fp[:4])


def _rate_args(scn):
    base = scn.base_rate
    return (base, scn.noise_frac, scn.hawkes_alpha, scn.hawkes_beta, scn.diurnal_amp,
            scn.diurnal_period, scn.flash_t, scn.flash_mult, scn.flash_decay,
            scn.rate_cap_mult * base)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_rate_trajectory_matches_reference(seed):
    for scn in list_scenarios():
        with jax.enable_x64(True):
            want = RW.rate_trajectory(np.uint32(seed), TICKS, 0, 0.0, *_rate_args(scn))
            want = {k: np.asarray(getattr(want, k)) for k in want._fields}
        got = PW.rate_trajectory(seed, TICKS, 0, 0.0, *_rate_args(scn), device="cpu")
        assert got.rates.dtype == torch.float32 and got.counts.dtype == torch.int32
        np.testing.assert_allclose(got.env.numpy(), want["env"], rtol=RATE_RTOL,
                                   err_msg=scn.name)
        np.testing.assert_allclose(got.rates.numpy(), want["rates"], rtol=RATE_RTOL,
                                   err_msg=scn.name)
        np.testing.assert_array_equal(got.counts.numpy(), want["counts"],
                                      err_msg=scn.name)
        np.testing.assert_allclose(float(got.excite), float(want["excite"]), rtol=RATE_RTOL)
        assert (got.rates.numpy() >= 0).all()


def test_rate_chunks_compose():
    scn = list_scenarios()[5]  # election_night: every mechanism at once
    whole = PW.rate_trajectory(4, TICKS, 0, 0.0, *_rate_args(scn), device="cpu")
    rates, counts, excite = [], [], 0.0
    for t0 in range(0, TICKS, TICKS // 4):
        part = PW.rate_trajectory(4, TICKS // 4, t0, excite, *_rate_args(scn), device="cpu")
        rates.append(part.rates)
        counts.append(part.counts)
        excite = float(part.excite)
    assert torch.cat(rates).numpy().tobytes() == whole.rates.numpy().tobytes()
    assert torch.equal(torch.cat(counts), whole.counts)
    assert excite == float(whole.excite)


# ---------------------------------------------------------------------------
# K4's kernel schedule (csrc/traffic_ids.cu), emulated on the CPU
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _block_constants(ip, fp):
    """(3, 2) float32: (top, inv) of the user, tag and mention ranks, by
    the plain version's operations on 0-d tensors (what three lanes of
    warp 0 compute once a CTA)."""
    n_users, n_tags = ip[0], ip[1]
    rows = []
    for nk, a in ((n_users, fp[0]), (n_tags, fp[1]), (n_users, fp[2])):
        one_m_a = 1.0 - a
        rows.append(torch.stack([torch.pow(nk.to(torch.float32) + 1.0, one_m_a) - 1.0,
                                 1.0 / one_m_a]))
    return torch.stack(rows)


def plan_records(plan):
    """(ctas, records_a_thread, threads) int64: the record each thread's
    k-th slot takes under `plan` in each rank's CTAs, c T R + k T + t, as
    csrc/traffic_ids.cu lays them out (slots at n or past it write
    nothing)."""
    c = torch.arange(plan.ctas, dtype=torch.int64).view(-1, 1, 1)
    k = torch.arange(plan.records_a_thread, dtype=torch.int64).view(1, -1, 1)
    t = torch.arange(plan.threads, dtype=torch.int64).view(1, 1, -1)
    return (c * plan.records_a_thread + k) * plan.threads + t


def kernel_emulation(seed, ctr0, n, ip, fp, plan):
    """The kernel's schedule in torch: a (plan.ctas, 3) grid, CTA (c, r)
    computing rank r (uid, tag, mention) of the records its threads take
    as `plan` lays them out; each CTA's constants computed once and
    shared by its threads; a thread's counter hashes taken before its
    one pow; the rank's operands selected (the mention's between the
    copied record's uniform with the user's constants and u5 with its
    own), then the hot tag; each live slot writing its record once."""
    slots = plan_records(plan)
    cta = torch.arange(plan.ctas).view(-1, 1, 1).expand_as(slots)
    live = slots < n
    i, cta = slots[live], cta[live]  # the live slots in the kernel's order
    consts = _block_constants(ip, fp).expand(plan.ctas, 3, 2)[cta]  # (m, rank, top/inv)
    n_users, n_tags, burst_ntags, topic_base = ip.unbind()
    burst_frac, copy_frac = fp[3], fp[4]

    lanes = (ctr0 + i * PS.NSTREAMS) & _M32

    def u(s, base=lanes):
        return PS.uniform01(PS.counter_mix(seed, (base + s) & _M32))

    j = (u(4) * i.to(torch.float32)).to(torch.int64)
    written = torch.zeros(n, dtype=torch.int64).index_add_(0, i, torch.ones_like(i))
    assert (written == 1).all(), "a record is written other than once"

    def scatter(col):
        out = torch.empty(n, dtype=col.dtype)
        out[i] = col
        return out

    ids = []
    for rank, (s_a, s_b) in enumerate(((0, 6), (1, 2), (5, 3))):  # the kernel's streams
        ua, ub = u(s_a), u(s_b)
        uc = u(0, (ctr0 + j * PS.NSTREAMS) & _M32) if rank == 2 else u(7)
        copy = (ub < copy_frac) & (i > 0) & (rank == 2)
        top = torch.where(copy, consts[:, 0, 0], consts[:, rank, 0])
        inv = torch.where(copy, consts[:, 0, 1], consts[:, rank, 1])
        n_rank = n_tags if rank == 1 else n_users
        x = torch.pow(1.0 + torch.where(copy, uc, ua) * top, inv)
        r = torch.clamp(x.to(torch.int32) - 1, min=0).minimum(n_rank - 1)
        hot = (topic_base + (ua * burst_ntags.to(torch.float32)).to(torch.int32)) % n_tags
        ids.append(scatter(torch.where((ub < burst_frac) & (rank == 1), hot, r)))
        if rank == 0:
            spare = scatter(ub), scatter(uc)  # u_dup, u_dupi
    return [*ids, *spare]


def _scn(name):
    return next(s for s in list_scenarios() if s.name == name)


def _emulation_cases():
    for scn in list_scenarios():
        for burst in (0.0, 1.0):
            yield f"{scn.name}-burst{burst:g}", scn, burst, None, 0, 0, BLOCK
    flash = _scn("flash_crowd")
    for n in (1, 31, 33, 2_047, 2_049, 65_536):
        yield f"flash_crowd-n{n}", flash, 1.0, None, 3, 0, n
    ip0 = flash.iparams()
    corners = {  # (fparams index or iparams field, value)
        "copy_frac0": ("f", 4, 0.0), "copy_frac1": ("f", 4, 1.0),
        "hot_share0": ("f", 3, 0.0), "hot_share1": ("f", 3, 1.0),
        # topic_base + h past n_tags: the hot tag wraps
        "topic_past_n_tags": ("i", 3, int(ip0[1]) - 3),
    }
    for label, (kind, k, v) in corners.items():
        yield label, flash, 0.5, (kind, k, v), 1, 0, BLOCK
    yield "ctr0_near_wrap", flash, 1.0, None, 7, 2**32 - 5_000, BLOCK


@pytest.mark.parametrize("label,scn,burst,corner,seed,ctr0,n",
                         [pytest.param(*case, id=case[0]) for case in _emulation_cases()])
def test_kernel_schedule_emulation_matches_plain(label, scn, burst, corner, seed, ctr0, n):
    ip, fp = torch.from_numpy(scn.iparams()), torch.from_numpy(scn.fparams(burst))
    if corner is not None:
        kind, k, v = corner
        (fp if kind == "f" else ip)[k] = v
    want = PS.traffic_ids_ref(seed, ctr0, n, ip, fp)
    plans = [PS.launch_plan(n)]
    if n in (33, 2_049):  # and every plan of the sweep, on both sides of a CTA's records
        plans += [PS.Plan(-(-n // (t * r)), t, r) for t in (32, 64, 128, 256) for r in (1, 2, 3, 4)]
    for plan in plans:
        got = kernel_emulation(seed, ctr0, n, ip, fp, plan)
        for g, w, name in zip(got, want, ("uid", "tag", "mention", "u_dup", "u_dupi")):
            assert g.dtype == w.dtype and g.numpy().tobytes() == w.numpy().tobytes(), \
                f"{label}: {name} differs under {plan}"
    if label == "topic_past_n_tags":  # the corner is reached
        hot = (ip[3] + (PS.uniform01(PS.counter_mix(seed, (ctr0 + 8 * torch.arange(n) + 1)
                                                    & _M32)) * ip[2]).to(torch.int32))
        assert (hot >= ip[1]).any()


@pytest.mark.parametrize("k", range(PS.MAX_LANES.bit_length()))
def test_launch_plan_covers_every_record_once(k):
    for n in (m for m in ((1 << k) - 1, 1 << k, (1 << k) + 1) if 1 <= m <= PS.MAX_LANES):
        plan = PS.launch_plan(n)
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= PS.MAX_THREADS, plan
        assert 1 <= plan.records_a_thread <= PS.MAX_RECORDS, plan
        assert 1 <= plan.ctas <= 2**31 - 1, plan  # the card's grid limit in x
        per_cta = plan.threads * plan.records_a_thread
        assert (plan.ctas - 1) * per_cta < n <= plan.ctas * per_cta, (n, plan)  # no empty CTA
        slots = plan_records(plan).flatten()
        live = slots[slots < n]
        assert live.numel() == n and torch.equal(live.sort().values, torch.arange(n)), (n, plan)
