"""Port parity: the RLS predictors and the Algorithm-2 buffer controller.

The predictors are float32 in both packages, but the sums run in other
orders, so they agree within a float32 tolerance and not bit for bit:
the two RLS states drift apart from the first update.  The tolerances
below are about three times the largest gap measured over seeds 0-5
of these traces on CPU (mu model: 4.7e-3 absolute in theta after 400
updates; beta model: 1.9e-3 of the largest coefficient, 8e-4 of the
prediction).  The reference runs under x64, as the ingest loop does,
so its feature maps take the log in double like the port's.

The controller's action rules are checked on fed signals, in the port
alone and against the reference from one shared PerfMon state.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_ingest import IngestConfig as RefIngestConfig
from repro.core import buffer as RB
from repro.core import predictor as RP
from repro_torch import convert
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.core import buffer as PB
from repro_torch.core import predictor as PP

MU_THETA_ATOL = 1.5e-2
BETA_THETA_RTOL = 5e-3
BETA_PRED_RTOL = 2.5e-3


@pytest.mark.parametrize("rho,d", [(0.0, 0.0), (0.37, 0.12), (1.0, 3.5)])
@pytest.mark.parametrize("mu_prev,beta_e", [(0.0, 0.5), (0.42, 1.0), (0.99, 12345.678)])
def test_feature_maps_and_seed_predictions_match(rho, d, mu_prev, beta_e):
    with jax.enable_x64(True):
        np.testing.assert_array_equal(PP.beta_features(rho, d).numpy(),
                                      np.asarray(RP.beta_features(rho, d)))
        np.testing.assert_array_equal(PP.mu_features(mu_prev, beta_e).numpy(),
                                      np.asarray(RP.mu_features(mu_prev, beta_e)))
        want_b = float(RP.predict_beta_e(RP.init_beta_model(), rho, d))
        want_m = float(RP.predict_mu(RP.init_mu_model(), mu_prev, beta_e))
    assert float(PP.predict_beta_e(PP.init_beta_model(), rho, d)) == pytest.approx(
        want_b, rel=1e-6, abs=1e-6)
    assert float(PP.predict_mu(PP.init_mu_model(), mu_prev, beta_e)) == pytest.approx(
        want_m, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cpu_slope_matches(seed):
    hist = np.random.default_rng(seed).random(16).astype(np.float32)
    with jax.enable_x64(True):
        want = float(RP.cpu_slope(hist))
    assert float(PP.cpu_slope(torch.from_numpy(hist))) == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mu_model_rls_trace_within_tolerance(seed):
    """Model (g) of Table I fed a noisy load trace, 400 updates."""
    rng = np.random.default_rng(seed)
    with jax.enable_x64(True):
        r, p = RP.init_mu_model(), PP.init_mu_model()
        mu_prev = 0.2
        for _ in range(400):
            beta = float(rng.uniform(50, 20000))
            mu = float(np.clip(0.3 * mu_prev + 0.05 * np.log(beta) + rng.normal(0, 0.02), 0, 1))
            r = RP.rls_update(r, RP.mu_features(mu_prev, beta), np.float32(mu))
            p = PP.rls_update(p, PP.mu_features(mu_prev, beta), float(np.float32(mu)))
            mu_prev = mu
            np.testing.assert_allclose(p.theta.numpy(), np.asarray(r.theta), atol=MU_THETA_ATOL)
        for mp, b in ((0.1, 100.0), (0.5, 3000.0), (0.9, 20000.0)):
            assert float(PP.predict_mu(p, mp, b)) == pytest.approx(
                float(RP.predict_mu(r, mp, b)), abs=MU_THETA_ATOL)
    assert int(p.n) == 400


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_beta_model_rls_trace_within_tolerance(seed):
    """Eq. 2 fed a trace drawn from a linear-in-rho, quadratic-in-d model."""
    rng = np.random.default_rng(seed)
    with jax.enable_x64(True):
        r, p = RP.init_beta_model(), PP.init_beta_model()
        for _ in range(400):
            rho, d = float(rng.uniform(0, 1)), float(rng.uniform(0, 1))
            be = float(300 * rho + 900 * d * d + 50 + rng.normal(0, 20))
            r = RP.rls_update(r, RP.beta_features(rho, d), np.float32(be))
            p = PP.rls_update(p, PP.beta_features(rho, d), float(np.float32(be)))
            want = np.asarray(r.theta)
            np.testing.assert_allclose(p.theta.numpy(), want,
                                       atol=BETA_THETA_RTOL * np.abs(want).max())
            w = float(RP.predict_beta_e(r, 0.5, 0.5))
            assert float(PP.predict_beta_e(p, 0.5, 0.5)) == pytest.approx(
                w, rel=BETA_PRED_RTOL, abs=1.0)


# ---- controller action rules (port alone) --------------------------------


def _controller(tmp_path, **cfg):
    return PB.BufferController(IngestConfig(**cfg), spill_dir=str(tmp_path / "spill"),
                               device="cpu")


def _feed(ctl, mus, rate=100.0):
    for i, mu in enumerate(mus):
        ctl.perfmon.observe_mu(float(mu))
        ctl.perfmon.observe_rate(float(i), rate)


def test_controller_beta_stays_in_bounds(tmp_path):
    cfg = dict(beta_min=100, beta_max=5000, beta_init=1500)
    ctl = _controller(tmp_path, **cfg)
    rng = np.random.default_rng(0)
    for i in range(200):
        ctl.perfmon.observe_rate(float(i), float(rng.uniform(10, 3000)))
        ctl.perfmon.observe_mu(float(rng.uniform(0, 1)))
        dec = ctl.decide(edge_table_size=float(rng.uniform(10, 1e4)),
                         density=float(rng.uniform(0, 1)))
        assert cfg["beta_min"] <= dec.beta <= cfg["beta_max"]
        assert dec.action in ("push", "hold", "throttle", "drain+push")


def test_controller_grows_under_load_and_throttles_when_rising(tmp_path):
    ctl = _controller(tmp_path, beta_init=1000, beta_max=50_000)
    _feed(ctl, np.linspace(0.8, 0.99, 16), rate=5000.0)
    dec = ctl.decide(edge_table_size=40_000, density=0.5)
    assert dec.action == "throttle" and dec.reason == "load"
    assert ctl.beta > 1000


def test_controller_holds_when_load_is_falling(tmp_path):
    ctl = _controller(tmp_path, cpu_max=0.5, theta2=0.2)
    _feed(ctl, np.linspace(0.95, 0.55, 16))
    dec = ctl.decide(edge_table_size=1e5, density=0.9)
    assert dec.action == "hold" and dec.slope < 0


def test_controller_shrinks_when_calm_and_drains_spill(tmp_path):
    ctl = _controller(tmp_path, beta_init=10_000, beta_min=200)
    _feed(ctl, [0.05] * 16, rate=10.0)
    dec = ctl.decide(edge_table_size=50, density=0.1)
    assert dec.action == "push" and ctl.beta < 10_000
    ctl.spill.flush([{"id": 1}])
    # a tiny bucket predicts a load under theta2 * cpu_max: drain
    assert ctl.decide(edge_table_size=1, density=0.0).action == "drain+push"


def test_controller_pressure_throttle_is_one_shot(tmp_path):
    ctl = _controller(tmp_path)
    _feed(ctl, [0.05] * 16, rate=10.0)
    ctl.perfmon.observe_pressure(0.9, 3)
    dec = ctl.decide(edge_table_size=50, density=0.1)
    assert (dec.action, dec.reason) == ("throttle", "pressure")
    assert ctl.pressure_throttles == 1 and ctl.perfmon.dropped_inserts == 0
    assert ctl.decide(edge_table_size=50, density=0.1).action == "push"


# ---- against the reference -----------------------------------------------


def test_controller_decisions_match_reference_on_fed_signals(tmp_path):
    """Both controllers see the same signal stream (no RLS updates, so
    their predictors stay equal up to float32 rounding) and must take
    the same actions with the same buffer sizes."""
    rng = np.random.default_rng(11)
    ref = RB.BufferController(RefIngestConfig(), spill_dir=str(tmp_path / "ref"))
    port = PB.BufferController(IngestConfig(), spill_dir=str(tmp_path / "port"), device="cpu")
    actions = set()
    with jax.enable_x64(True):
        for i in range(300):
            mu = float(np.clip(0.4 + 0.4 * np.sin(i / 9.0) + rng.normal(0, 0.05), 0, 1))
            rate, dropped = float(rng.uniform(10, 3000)), int(rng.random() < 0.05)
            size, dens = float(np.exp(rng.uniform(0, 10))), float(rng.uniform(0, 1))
            for ctl in (ref, port):
                ctl.perfmon.observe_mu(mu)
                ctl.perfmon.observe_rate(float(i), rate)
                ctl.perfmon.observe_pressure(0.5, dropped)
            if i % 40 == 39:
                for ctl in (ref, port):
                    ctl.spill.flush([{"id": i}])
            w, g = ref.decide(size, dens), port.decide(size, dens)
            assert (g.action, g.beta, g.reason) == (w.action, w.beta, w.reason), i
            assert g.mu_exp == pytest.approx(w.mu_exp, abs=1e-6)
            assert g.beta_e == pytest.approx(w.beta_e, rel=1e-6)
            actions.add(g.action)
    assert actions == {"push", "hold", "throttle", "drain+push"}


def test_controller_from_numpy_loads_reference_rls_state(tmp_path):
    rng = np.random.default_rng(2)
    ref = RB.BufferController(RefIngestConfig(), spill_dir=str(tmp_path / "ref"))
    with jax.enable_x64(True):
        for _ in range(50):
            ref.perfmon.observe_bucket(float(rng.random()), float(rng.random()),
                                       float(rng.uniform(10, 5000)))
            ref.perfmon.observe_mu_outcome(float(rng.random()), float(rng.uniform(10, 5000)),
                                           float(rng.random()))
        state = ref.perfmon.state()
        port = PB.BufferController(IngestConfig(), spill_dir=str(tmp_path / "port"),
                                   device="cpu")
        convert.controller_from_numpy(port, state)
        for name in ("beta_model", "mu_model"):
            for f in ("theta", "P", "n"):
                got = getattr(getattr(port.perfmon, name), f)
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(getattr(state[name], f)))
        for rho, d in ((0.2, 0.1), (0.9, 0.7)):
            assert float(PP.predict_beta_e(port.perfmon.beta_model, rho, d)) == pytest.approx(
                float(RP.predict_beta_e(ref.perfmon.beta_model, rho, d)), rel=1e-6, abs=1e-4)
