"""Traffic-rate trajectory sampler (counter-based PRNG).
Counterpart of `repro.workloads.samplers`.

`rate_trajectory` produces a chunk of per-tick (intensity, count) pairs
combining the burst mechanisms of real social streams: a diurnal
sinusoid, a flash-crowd step relaxing exponentially, Hawkes
self-excitation (every event raises future intensity, branching ratio
~alpha) and multiplicative noise.  Counts are a Gaussian approximation
to Poisson(lam) from the same counter-based PRNG as the id sampler, so
the trajectory is a pure function of (seed, t0, excite0) and chunks
compose: 4 chunks of 64 ticks equal one chunk of 256.

The scan is a Python loop of float32 tensor ops on `device`: the draws
of all ticks come first as whole-chunk ops, then the loop carries the
Hawkes state tick by tick.  Every parameter is a float32 tensor on that
device, so each operation rounds in float32 as the reference's does
(a Python float operand would let PyTorch divide by a reciprocal on the
card).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.device import resolve
from repro_torch.kernels.sampler import counter_mix, uniform01

# rate draws salt the seed so tick counters never collide with the
# per-record lanes of the id sampler (which use the unsalted seed)
RATE_SALT = 0xA511CE5
_TWO_PI = 6.2831853
_M32 = 0xFFFFFFFF


class RateChunk(NamedTuple):
    rates: torch.Tensor   # (ticks,) float32 realised intensity lambda_k
    env: torch.Tensor     # (ticks,) float32 deterministic envelope (no Hawkes/noise)
    counts: torch.Tensor  # (ticks,) int32 records per tick
    excite: torch.Tensor  # 0-d float32 Hawkes state to carry into the next chunk


def _normal(seed: int, ctr: torch.Tensor, f) -> torch.Tensor:
    """One standard normal per lane (Box-Muller on counter draws)."""
    u1 = uniform01(counter_mix(seed, ctr))
    u2 = uniform01(counter_mix(seed, (ctr + 1) & _M32))
    r = torch.sqrt(f(-2.0) * torch.log(torch.maximum(f(1.0) - u1, f(1e-7))))
    return r * torch.cos(f(_TWO_PI) * u2)


def rate_trajectory(seed: int, ticks: int, t0: int, excite0: float, base_rate: float,
                    noise_frac: float, hawkes_alpha: float, hawkes_beta: float,
                    diurnal_amp: float, diurnal_period: float, flash_t: float,
                    flash_mult: float, flash_decay: float, rate_cap: float,
                    dt: float = 1.0,
                    device: Union[str, torch.device] = "cuda") -> RateChunk:
    """One chunk of the tick-rate process on `device` (default the card).

    t0 is the absolute tick index of the chunk start; excite0 the Hawkes
    state carried from the previous chunk (0.0 at stream start)."""
    dev = resolve(device)

    def f(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    seed = (int(seed) ^ RATE_SALT) & _M32
    tick_abs = int(t0) + torch.arange(ticks, dtype=torch.int64, device=dev)
    t = tick_abs.to(torch.float32) * f(dt)

    env = f(base_rate) * (f(1.0) + f(diurnal_amp) * torch.sin(f(_TWO_PI) * t / f(diurnal_period)))
    flash = torch.where(
        t >= f(flash_t),
        f(1.0) + (f(flash_mult) - f(1.0)) * torch.exp(-(t - f(flash_t)) / f(flash_decay)),
        f(1.0))
    env = env * flash

    # the draws of every tick, ahead of the sequential scan
    ctr = (tick_abs * 4) & _M32
    jitter = f(1.0) + f(noise_frac) * (f(2.0) * uniform01(counter_mix(seed, ctr)) - f(1.0))
    z = _normal(seed, (ctr + 1) & _M32, f)

    g = torch.exp(-f(hawkes_beta) * f(dt))  # per-tick decay of the excitation state
    gain = f(hawkes_alpha) * f(hawkes_beta)
    lo, cap, dt_t, cap_dt = f(0.0), f(rate_cap), f(dt), f(rate_cap) * f(dt)
    excite = f(excite0)
    rates, counts = [], []
    for k in range(ticks):
        lam = (env[k] + gain * excite) * jitter[k]
        lam = torch.minimum(torch.maximum(lam, lo), cap)
        c = torch.maximum(torch.round(lam * dt_t + torch.sqrt(lam * dt_t) * z[k]), lo)
        c = torch.minimum(c, cap_dt)
        excite = g * (excite + c)
        rates.append(lam)
        counts.append(c)
    rates_t = torch.stack(rates) if rates else env.new_zeros(0)
    counts_t = (torch.stack(counts) if counts else env.new_zeros(0)).to(torch.int32)
    return RateChunk(rates=rates_t, env=env, counts=counts_t, excite=excite)
