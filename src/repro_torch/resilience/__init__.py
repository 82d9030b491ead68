"""`repro_torch.resilience` — fault injection and commit retry.
Counterpart of `repro.resilience`, without its checkpoint half
(`PipelineCheckpointer`, `drive`, `pytree_digest`), which comes with
ROADMAP §1 Slice E.4.

  * `FaultPlan` / `FaultInjector` — counter-deterministic commit
    failures, latency spikes and crash-at-tick kills through
    `GraphIngestor.fail_hook`; `PipelineKilled` is the kill signal.
  * `RetryPolicy` — capped exponential backoff + deterministic jitter
    governing `retry_archive` and the ingestor's degraded mode.

Composable through `PipelineBuilder.with_faults`/`with_retry` and
`run_scenario(fault_plan=..., retry=...)`; `python -m
repro_torch.launch.lineage --outage t0:t1` drives a store outage.
"""
from repro_torch.resilience.faults import FaultInjector, FaultPlan, PipelineKilled
from repro_torch.resilience.retry import RetryPolicy

__all__ = [
    "FaultInjector",
    "FaultPlan",
    "PipelineKilled",
    "RetryPolicy",
]
