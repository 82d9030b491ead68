"""Bursty social-media scenario generator + closed-loop evaluation.
Counterpart of `repro.workloads`.

  * `repro_torch.workloads.samplers`: the counter-based tick-rate
    process (Hawkes self-excitation, diurnal cycles, flash-crowd steps,
    multiplicative jitter),
  * `repro_torch.kernels.sampler`: the per-record id sampler (Zipf
    heavy-hitter users, hot-topic hashtags, retweet-cascade mentions),
    kernel K4 beside its plain version,
  * `Scenario` / `register` / `get_scenario` / `list_scenarios`: the
    named registry,
  * `ScenarioSource`: a `Source`-protocol adapter,
  * `run_scenario` / `WorkloadReport`: the closed-loop harness that
    scores the Algorithm-2 controller per scenario, and
    `scenario_builder`, the pipeline it drives.

CLI: `python -m repro_torch.launch.workload --scenario flash_crowd`.
"""
from repro_torch.workloads.scenarios import (
    Scenario,
    get_scenario,
    list_scenarios,
    register,
)
from repro_torch.workloads.source import ScenarioSource
from repro_torch.workloads.harness import WorkloadReport, run_scenario, scenario_builder
from repro_torch.workloads.samplers import RateChunk, rate_trajectory

__all__ = [
    "Scenario", "register", "get_scenario", "list_scenarios",
    "ScenarioSource",
    "WorkloadReport", "run_scenario", "scenario_builder",
    "RateChunk", "rate_trajectory",
]
