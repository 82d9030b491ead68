"""Controller audit trail: every Algorithm-2 decision, explainable.
Counterpart of `repro.telemetry.audit`.

The paper's controller reacts to *observed* data rate, data content
and machine resources (§III, Algorithm 2) — so a throttle that cannot
show its inputs is indistinguishable from a bug.  `AuditTrail` hooks
`BufferController.decide` and records, per decision:

  * the decision itself (action, reason, new beta) and the
    predictions it was based on (`beta_e_pred`, `mu_pred`, CPU slope);
  * the **full PerfMon input vector** at decision time: rate velocity
    + acceleration, last observed mu, windowed diversity rho, store
    table pressure, dropped inserts (captured *before* the pressure
    throttle consumes them), the sketch-concentration hint and the
    dictionary hit-rate hint, and the spill depth;
  * the **realized outcome** once the tick completes (`resolve`):
    measured mu and the actual effective buffer size, so
    predicted-vs-realized model error is queryable after a run.

Records append to the owning `TelemetryRegistry.audit` (bounded by
``max_audit``), tagged with the trail's shard, so one sharded run
yields one merged, time-ordered decision log.

Every input is a host float the controller already holds (`PerfMon`
keeps its histories, pressure and hints on the host), so recording a
decision reads no tensor and adds no device synchronisation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.telemetry.spans import TelemetryRegistry


@dataclasses.dataclass
class AuditRecord:
    """One controller decision + its inputs and (later) its outcome."""

    seq: int                 # global order within the registry
    t: float                 # stream time of the decision
    ts_ns: int               # monotonic clock (aligns with span events)
    shard: int
    action: str              # push | hold | throttle | drain+push
    reason: str              # throttle cause: "" | "load" | "pressure"
    beta: int                # buffer size the decision set
    beta_e_pred: float       # predicted effective buffer (Eq. 2)
    mu_pred: float           # predicted consumer occupancy (Eq. 4/5)
    slope: float             # CPU slope s
    inputs: Dict[str, Optional[float]]  # full PerfMon vector (below)
    mu_real: Optional[float] = None     # measured mu after the tick
    beta_e_real: Optional[float] = None  # actual effective buffer pushed
    # decision-quality verdict (repro_torch.monitor.quality.score_record):
    # score in [0,1], prediction error, regret vs do-nothing baseline
    quality: Optional[Dict] = None

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


# the PerfMon input-vector keys every record carries
INPUT_KEYS = ("rate", "accel", "mu", "rho", "pressure", "dropped_inserts",
              "sketch_rho", "dict_hit", "spill_depth")


class AuditTrail:
    """Per-controller recorder appending to a shared registry.

    `record` is called by `BufferController.decide` (when a trail is
    attached); `resolve` by the tick loop once the decision's outcome
    (measured mu, realized beta_e) is known.  Resolution applies to
    the most recent unresolved record of this trail — decisions and
    outcomes strictly alternate within one controller's tick loop."""

    def __init__(self, registry: TelemetryRegistry, shard: int = 0):
        self.registry = registry._root
        self.shard = int(shard)
        self._open: Optional[AuditRecord] = None

    def record(self, dec, perfmon, t: Optional[float],
               spill_depth: int, dropped: int) -> None:
        reg = self.registry
        if not reg.enabled or len(reg.audit) >= reg.max_audit:
            return
        vel, acc = perfmon.velocity()
        rho = float(np.mean(perfmon.rho_hist)) if perfmon.rho_hist else 1.0
        rec = AuditRecord(
            seq=len(reg.audit),
            t=float(t) if t is not None else 0.0,
            ts_ns=time.perf_counter_ns(),
            shard=self.shard,
            action=dec.action,
            reason=dec.reason,
            beta=int(dec.beta),
            beta_e_pred=float(dec.beta_e),
            mu_pred=float(dec.mu_exp),
            slope=float(dec.slope),
            inputs={
                "rate": float(vel),
                "accel": float(acc),
                "mu": float(perfmon.mu_hist[-1]) if perfmon.mu_hist else 0.0,
                "rho": rho,
                "pressure": float(perfmon.table_pressure),
                "dropped_inserts": int(dropped),
                "sketch_rho": None if perfmon.sketch_rho is None
                else float(perfmon.sketch_rho),
                "dict_hit": None if perfmon.dict_hit is None
                else float(perfmon.dict_hit),
                "spill_depth": int(spill_depth),
            },
        )
        reg.audit.append(rec)
        self._open = rec

    def resolve(self, mu: float, beta_e: float) -> None:
        rec = self._open
        if rec is None:
            return
        rec.mu_real = float(mu)
        rec.beta_e_real = float(beta_e)
        self._open = None
