"""Predictive models of §III-A, learned online (counterpart of
`repro.core.predictor`).

  Eq. 2   beta_e[i] = K[i] * phi1(rho[i]) + R[i] * phi2(d[i])
  Eq. 4/5 mu_exp[n] = A * mu[n-1] + B * log(beta_e[n]) + c

Both are fit by recursive least squares (RLS) with a forgetting factor.
The state is float32 tensors on the pipeline's device.  Float32 sums
run in another order than the reference's, so the two agree within a
float32 tolerance, not bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch

Device = Union[str, torch.device]


@dataclasses.dataclass
class RLSState:
    """Recursive least squares over features x: theta ~ P * x * err."""

    theta: torch.Tensor  # (k,)
    P: torch.Tensor  # (k,k) inverse covariance
    n: torch.Tensor  # scalar observation count


def rls_init(k: int, theta0: Optional[Sequence[float]] = None, p0: float = 100.0,
             device: Device = "cpu") -> RLSState:
    theta = (torch.zeros(k, dtype=torch.float32, device=device) if theta0 is None
             else torch.tensor(theta0, dtype=torch.float32, device=device))
    return RLSState(theta=theta,
                    P=torch.eye(k, dtype=torch.float32, device=device) * p0,
                    n=torch.zeros((), dtype=torch.float32, device=device))


def rls_update(s: RLSState, x: torch.Tensor, y: float, lam: float = 0.98) -> RLSState:
    """One RLS step with forgetting factor lam."""
    x = x.to(torch.float32)
    Px = s.P @ x
    denom = lam + x @ Px
    k_gain = Px / denom
    err = torch.tensor(y, dtype=torch.float32, device=x.device) - s.theta @ x
    theta = s.theta + k_gain * err
    P = (s.P - torch.outer(k_gain, Px)) / lam
    return RLSState(theta=theta, P=P, n=s.n + 1)


def rls_predict(s: RLSState, x: torch.Tensor) -> torch.Tensor:
    return s.theta @ x.to(torch.float32)


# ---- Eq. 2: effective buffer size from content statistics ----


def beta_features(rho: float, d: float, device: Device = "cpu") -> torch.Tensor:
    """phi1 linear in rho, phi2 quadratic in d, plus intercept."""
    return torch.tensor([rho, d * d, 1.0], dtype=torch.float32, device=device)


def init_beta_model(K: float = 0.597, R: float = 1.48, device: Device = "cpu") -> RLSState:
    """Seeded with the paper's fitted coefficients."""
    return rls_init(3, theta0=[K, R, 0.0], device=device)


def predict_beta_e(s: RLSState, rho: float, d: float) -> torch.Tensor:
    return rls_predict(s, beta_features(rho, d, s.theta.device)).clamp(min=0.0)


# ---- Eq. 4/5: expected consumer load from effective buffer size ----


def mu_features(mu_prev: float, beta_e: float, device: Device = "cpu") -> torch.Tensor:
    # the log is taken in double and rounded once, as the reference
    # does under x64
    return torch.tensor([mu_prev, math.log(max(beta_e, 1.0)), 1.0],
                        dtype=torch.float32, device=device)


def init_mu_model(A: float = 0.01, B: float = 0.09, c: float = 0.0,
                  device: Device = "cpu") -> RLSState:
    """Model (g) of Table I: mu = A*mu[n-1] + B*log(beta_e) + c."""
    return rls_init(3, theta0=[A, B, c], device=device)


def predict_mu(s: RLSState, mu_prev: float, beta_e: float) -> torch.Tensor:
    return rls_predict(s, mu_features(mu_prev, beta_e, s.theta.device)).clamp(0.0, 1.0)


# ---- CPU-slope estimator (PerfMon's `s <- getCPUSlope()`) ----


def cpu_slope(mu_hist: torch.Tensor, window: int = 8) -> torch.Tensor:
    """Least-squares slope of the last `window` load samples."""
    y = mu_hist[-window:].to(torch.float32)
    x = torch.arange(window, dtype=torch.float32, device=y.device)
    xm = x - x.mean()
    ym = y - y.mean()
    return (xm @ ym) / (xm @ xm).clamp(min=1e-9)
