"""Named workload scenarios: the adversarial-stream family.
Counterpart of `repro.workloads.scenarios` (numpy only, the same six
built-ins in the same order).

A `Scenario` is a frozen parameter bundle for the tick-rate process
(`repro_torch.workloads.samplers.rate_trajectory`) and the id sampler
(`repro_torch.kernels.sampler`), registered by name:

  steady_state      calm baseline: the controller should stay in push mode.
  flash_crowd       breaking news: an 8x rate step decaying over ~80 s
                    while hashtag diversity collapses onto the hot topic.
  celebrity_cascade self-exciting retweet storms (Hawkes branching ~0.85).
  diurnal           compressed day/night cycle (+-85% around the mean).
  spam_storm        bot flood: 6x step, half the records duplicates, a
                    tiny hot-tag set, steep Zipf.
  election_night    diurnal swell + flash spike + strong self-excitation.

`register()` adds custom scenarios; the registry keeps insertion order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    # --- tick-rate process (samplers.rate_trajectory) ---
    base_rate: float = 60.0      # records/s baseline (paper: ~60 at 1% sample)
    noise_frac: float = 0.25     # multiplicative tick jitter (paper: 15-45%)
    hawkes_alpha: float = 0.0    # self-excitation branching ratio, < 1
    hawkes_beta: float = 0.5     # excitation decay (1/s)
    diurnal_amp: float = 0.0     # sinusoidal envelope amplitude, < 1
    diurnal_period: float = 240.0  # compressed "day" length (s)
    flash_t: float = 1e9         # flash-crowd step time (s); 1e9 = never
    flash_mult: float = 1.0      # step height (x base)
    flash_decay: float = 40.0    # step relaxation time constant (s)
    rate_cap_mult: float = 50.0  # safety clip: lambda <= cap * base_rate
    # --- id sampling (kernels.sampler.traffic_ids) ---
    n_users: int = 20_000
    n_tags: int = 4_000
    zipf_user: float = 1.3       # user-activity skew (a != 1)
    zipf_tag: float = 1.2        # long-tail hashtag skew
    zipf_mention: float = 2.0    # celebrity-mention skew
    copy_frac: float = 0.3       # retweet-cascade copy-model probability
    topic_frac: float = 0.1      # calm-time share of hot-topic hashtags
    topic_frac_burst: float = 0.8  # hot-topic share at full burst
    burst_ntags: int = 12        # size of the hot-topic set
    topic_base: int = 17         # first hot-topic hashtag id
    duplicate_frac: float = 0.125  # paper: 5-20% duplicate tweets
    # --- harness defaults ---
    ticks: int = 240             # suggested run length (ticks of dt=1s)

    def iparams(self) -> np.ndarray:
        """int32 params for `repro_torch.kernels.sampler.traffic_ids`."""
        return np.asarray([self.n_users, self.n_tags, self.burst_ntags,
                           self.topic_base], np.int32)

    def fparams(self, burst_level: float = 0.0) -> np.ndarray:
        """float32 params for `traffic_ids` at a given burst level
        in [0, 1]: hot-topic share interpolates topic_frac ->
        topic_frac_burst (diversity drops exactly when volume spikes)."""
        b = float(np.clip(burst_level, 0.0, 1.0))
        frac = self.topic_frac + (self.topic_frac_burst - self.topic_frac) * b
        return np.asarray([self.zipf_user, self.zipf_tag, self.zipf_mention,
                           frac, self.copy_frac], np.float32)


_REGISTRY: Dict[str, Scenario] = {}


def register(scenario: Scenario, overwrite: bool = False) -> Scenario:
    if scenario.name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: {', '.join(_REGISTRY)}"
        ) from None


def list_scenarios() -> List[Scenario]:
    return list(_REGISTRY.values())


register(Scenario(
    name="steady_state",
    description="calm baseline: jittered Poisson at the paper's ~60 rec/s; "
                "the controller should never leave push mode",
))
register(Scenario(
    name="flash_crowd",
    description="breaking news: 8x rate step at t=30s decaying over ~80s, "
                "hashtag diversity collapsing onto the hot topic",
    flash_t=30.0, flash_mult=8.0, flash_decay=80.0,
    hawkes_alpha=0.25, topic_frac_burst=0.85, burst_ntags=8,
))
register(Scenario(
    name="celebrity_cascade",
    description="self-exciting retweet storms (Hawkes branching ~0.85) with "
                "copy-model cascades and steep celebrity-mention skew",
    hawkes_alpha=0.85, hawkes_beta=0.4, copy_frac=0.75,
    zipf_user=1.6, zipf_mention=2.5, noise_frac=0.2,
))
register(Scenario(
    name="diurnal",
    description="compressed day/night cycle: +-85% sinusoidal swing over a "
                "240s 'day' with mild self-excitation",
    diurnal_amp=0.85, diurnal_period=240.0, hawkes_alpha=0.2,
))
register(Scenario(
    name="spam_storm",
    description="bot flood: 6x step, ~50% duplicates, 3 hot tags and a few "
                "bot accounts dominating (steep Zipf) — max table pressure",
    flash_t=20.0, flash_mult=6.0, flash_decay=120.0,
    duplicate_frac=0.5, zipf_user=2.5, zipf_tag=2.0,
    topic_frac=0.4, topic_frac_burst=0.95, burst_ntags=3, n_tags=500,
))
register(Scenario(
    name="election_night",
    description="torture test: diurnal swell + flash spike + strong "
                "self-excitation, all at once",
    diurnal_amp=0.6, diurnal_period=300.0,
    flash_t=45.0, flash_mult=5.0, flash_decay=60.0,
    hawkes_alpha=0.6, topic_frac_burst=0.9, copy_frac=0.5,
))
