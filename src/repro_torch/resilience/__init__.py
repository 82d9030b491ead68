"""`repro_torch.resilience`: checkpoint/resume, fault injection, commit
retry.  Counterpart of `repro.resilience`.

Three pieces, composable through `PipelineBuilder` and `run_scenario`:

  * `PipelineCheckpointer`: step-atomic `_COMMITTED`-manifest snapshots
    of the FULL ingest state (store, sketches, pattern dictionary as
    `.npy` leaves in the reference's layout; controller + spill
    contents, ingestor pool/archive, source cursor, loop scalars as a
    host blob), background writes, keep-N GC; `drive` wraps a tick
    iterator with the checkpoint cadence and the crash-at-tick kill;
    `pytree_digest` is the byte-identity witness.
    `run_scenario(..., resume=True)` replays bit-exactly.
  * `FaultPlan` / `FaultInjector`: counter-deterministic commit
    failures, latency spikes and crash-at-tick kills through
    `GraphIngestor.fail_hook`; `PipelineKilled` is the kill signal.
  * `RetryPolicy`: capped exponential backoff + deterministic jitter
    governing `retry_archive` and the ingestor's degraded mode.

CLI: ``python -m repro_torch.launch.chaos`` (kill mid-flash_crowd,
resume, verify store/snapshot/accounting invariants); ``python -m
repro_torch.launch.lineage --outage t0:t1`` drives a store outage.
"""
from repro_torch.resilience.checkpoint import PipelineCheckpointer, drive, pytree_digest
from repro_torch.resilience.faults import FaultInjector, FaultPlan, PipelineKilled
from repro_torch.resilience.retry import RetryPolicy

__all__ = [
    "FaultInjector",
    "FaultPlan",
    "PipelineCheckpointer",
    "PipelineKilled",
    "RetryPolicy",
    "drive",
    "pytree_digest",
]
