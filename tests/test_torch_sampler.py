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
