"""Adaptive buffer controller: Algorithm 2 + PerfMon (§III).
Counterpart of `repro.core.buffer`.

The controller senses data rate (velocity, acceleration), data content
(bucket diversity rho, graph density d, and the dictionary hit rate
when GraphZip compression is on) and consumer load mu.

Control law (paper steps 1-7):
  1. PerfMon predicts beta_e (Eq. 2), mu_exp (Eq. 4/5) and the slope s.
  2. mu_exp >= cpu_max            -> grow buffer by theta1 * headroom
  3. mu_exp >= (1+theta2)*cpu_max
     and load still rising (s>=0) -> THROTTLE: spill batch to disk
  4. mu_exp < cpu_max             -> push to the store (GRAPHPUSH)
  5. buffer > beta_min and calm   -> shrink by theta2 (latency recovery)
  6. mu_exp <= theta2 * cpu_max   -> drain spilled data from disk
  7. predictors updated online (RLS) from observed (rho, d, beta_e, mu)

The RLS states live on the pipeline's device (`device`).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import tempfile
from typing import Callable, Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.core import predictor as P
from repro_torch.device import resolve


def default_spill_dir() -> str:
    """A fresh directory under the system's temporary directory, so that
    concurrent pipelines never share spill files."""
    return tempfile.mkdtemp(prefix="repro_torch_spill_")


@dataclasses.dataclass
class PerfSample:
    t: float
    mu: float  # consumer occupancy [0,1]
    rho: float  # bucket diversity ratio
    density: float
    beta: int  # current buffer size (records)
    beta_e: float  # effective (output) buffer size
    velocity: float  # records/s
    accel: float
    action: str
    spill_depth: int
    compression: float
    delay_s: float = 0.0  # system delay alpha (Eq. 3): queued work at consumer


def rls_to_numpy(s: P.RLSState) -> P.RLSState:
    return P.RLSState(*(t.cpu().numpy() for t in (s.theta, s.P, s.n)))


def rls_from_numpy(s, device) -> P.RLSState:
    return P.RLSState(*(torch.tensor(np.asarray(getattr(s, f)), dtype=torch.float32,
                                     device=device)
                        for f in ("theta", "P", "n")))


class PerfMon:
    """PERFMON (Alg. 2 lines 16-23): content stats + load predictions."""

    # weight of the sketch's diversity hint when blended into rho (the
    # window mean stays the anchor; the sketch refines it)
    SKETCH_RHO_WEIGHT = 0.5
    # weight of the dictionary-compression hint when shrinking the
    # predicted effective buffer: referenced edges commit by direct
    # scatter (no probing), so a compressible bucket loads the consumer
    # less than its size suggests
    COMPRESS_BETA_WEIGHT = 0.5

    def __init__(self, cfg: IngestConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.beta_model = P.init_beta_model(cfg.K, cfg.R, device=self.device)
        self.mu_model = P.init_mu_model(cfg.A, cfg.B, device=self.device)
        self.mu_hist: Deque[float] = collections.deque([0.0] * 16, maxlen=16)
        self.rate_hist: Deque[Tuple[float, float]] = collections.deque(maxlen=16)
        self.rho_hist: Deque[float] = collections.deque(maxlen=cfg.diversity_window)
        # store table pressure (fused-upsert commit stats): load factor
        # of the fuller table, and inserts dropped by the last commit
        self.table_pressure = 0.0
        self.dropped_inserts = 0
        # sketch-guided diversity hint (None until a "sketch" event is
        # observed; then blended into predict()'s rho)
        self.sketch_rho: Optional[float] = None
        # dictionary-compression hint (None until a compressed commit
        # reports; the paper's "data content" signal, §III-A)
        self.dict_hit: Optional[float] = None

    # ---- signal ingestion ----
    def observe_rate(self, t: float, records: float):
        self.rate_hist.append((t, records))

    def observe_mu(self, mu: float):
        self.mu_hist.append(float(mu))

    def observe_pressure(self, pressure: float, dropped: int):
        """Table-pressure signal from commit stats: the store's load
        factor and the inserts its (already escalated) probing dropped."""
        self.table_pressure = float(pressure)
        self.dropped_inserts = int(dropped)

    def observe_sketch(self, concentration: float):
        """Sketch-guided control: the heavy-hitter mass fraction of the
        ingestion-time sketch, as a diversity hint rho ~ 1 - concentration
        that `predict` blends in."""
        self.sketch_rho = float(np.clip(1.0 - concentration, 0.0, 1.0))

    def observe_compression(self, hit_rate: float, ratio: float):
        """Compressibility signal from the dictionary-compression path:
        the fraction of the last commit's unique edges that became
        pattern references, a hint that scales the predicted effective
        buffer in `predict`."""
        del ratio  # reported for observability; the hit rate drives beta_e
        self.dict_hit = float(np.clip(hit_rate, 0.0, 1.0))

    def observe_bucket(self, rho: float, density: float, beta_e: float):
        self.rho_hist.append(float(rho))
        # online refinement of Eq. 2 (K[i], R[i] tracked per time chunk)
        x = P.beta_features(float(np.mean(self.rho_hist)), float(density), self.device)
        self.beta_model = P.rls_update(self.beta_model, x, float(np.float32(beta_e)))

    def observe_mu_outcome(self, mu_prev: float, beta_e: float, mu_now: float):
        x = P.mu_features(float(mu_prev), float(beta_e), self.device)
        self.mu_model = P.rls_update(self.mu_model, x, float(np.float32(mu_now)))

    # ---- derived signals ----
    def velocity(self) -> Tuple[float, float]:
        """(records/s, d(records/s)/dt) from the rate history."""
        if len(self.rate_hist) < 3:
            return 0.0, 0.0
        ts = np.asarray([t for t, _ in self.rate_hist])
        rs = np.asarray([r for _, r in self.rate_hist])
        dt = np.maximum(np.diff(ts), 1e-6)
        v = rs[1:] / dt
        vel = float(v[-1])
        acc = float((v[-1] - v[0]) / max(ts[-1] - ts[1], 1e-6))
        return vel, acc

    def predict(self, edge_table_size: float, density: float) -> Tuple[float, float, float]:
        """Returns (beta_e, mu_exp, slope) — Alg. 2 line 2."""
        rho = float(np.mean(self.rho_hist)) if self.rho_hist else 1.0
        if self.sketch_rho is not None:
            w = self.SKETCH_RHO_WEIGHT
            rho = (1.0 - w) * rho + w * self.sketch_rho
        beta_e = float(P.predict_beta_e(self.beta_model, rho, density))
        beta_e = max(beta_e, float(edge_table_size))
        if self.dict_hit is not None:
            # referenced edges skip probing: shrink the effective load
            beta_e *= 1.0 - self.COMPRESS_BETA_WEIGHT * self.dict_hit
        mu_prev = self.mu_hist[-1]
        mu_exp = float(P.predict_mu(self.mu_model, mu_prev, beta_e))
        hist = torch.tensor(list(self.mu_hist), dtype=torch.float32, device=self.device)
        s = float(P.cpu_slope(hist))
        return beta_e, mu_exp, s

    # ---- checkpoint surface: numpy leaves, the reference's layout ----
    def state(self) -> dict:
        return {
            "beta_model": rls_to_numpy(self.beta_model),
            "mu_model": rls_to_numpy(self.mu_model),
            "mu_hist": list(self.mu_hist),
            "rate_hist": list(self.rate_hist),
            "rho_hist": list(self.rho_hist),
            "table_pressure": self.table_pressure,
            "dropped_inserts": self.dropped_inserts,
            "sketch_rho": self.sketch_rho,
            "dict_hit": self.dict_hit,
        }

    def restore_state(self, s: dict) -> None:
        """Restore from `state()` output, the port's or the reference's
        (any object with theta/P/n attributes per model)."""
        self.beta_model = rls_from_numpy(s["beta_model"], self.device)
        self.mu_model = rls_from_numpy(s["mu_model"], self.device)
        self.mu_hist = collections.deque(s["mu_hist"], maxlen=self.mu_hist.maxlen)
        self.rate_hist = collections.deque(s["rate_hist"], maxlen=self.rate_hist.maxlen)
        self.rho_hist = collections.deque(s["rho_hist"], maxlen=self.rho_hist.maxlen)
        self.table_pressure = float(s["table_pressure"])
        self.dropped_inserts = int(s["dropped_inserts"])
        self.sketch_rho = s.get("sketch_rho")
        self.dict_hit = s.get("dict_hit")


class SpillStore:
    """Data-throttling spill file (Alg. 2 FlushDataToDisk / LoadFromDisk)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._n = 0
        self._order: List[str] = []

    def flush(self, records: list):
        fn = os.path.join(self.path, f"spill_{self._n:08d}.pkl")
        with open(fn, "wb") as f:
            pickle.dump(records, f)
        self._order.append(fn)
        self._n += 1

    def drain(self, max_batches: int = 1) -> list:
        out = []
        for _ in range(min(max_batches, len(self._order))):
            fn = self._order.pop(0)
            with open(fn, "rb") as f:
                out.extend(pickle.load(f))
            os.unlink(fn)
        return out

    @property
    def depth(self) -> int:
        return len(self._order)

    def state(self) -> dict:
        """Spill-file CONTENTS, not just names: files drained between a
        checkpoint and a crash would otherwise be unreadable on resume."""
        files = []
        for fn in self._order:
            with open(fn, "rb") as f:
                files.append((os.path.basename(fn), f.read()))
        return {"n": self._n, "files": files}

    def restore_state(self, s: dict) -> None:
        os.makedirs(self.path, exist_ok=True)
        self._order = []
        for base, blob in s["files"]:
            fn = os.path.join(self.path, base)
            with open(fn, "wb") as f:
                f.write(blob)
            self._order.append(fn)
        self._n = int(s["n"])


@dataclasses.dataclass
class ControllerDecision:
    action: str  # "push" | "hold" | "throttle" | "drain+push"
    beta: int  # new buffer size
    beta_e: float
    mu_exp: float
    slope: float
    reason: str = ""  # throttle cause: "load" (step 3) | "pressure" (table)


class BufferController:
    """Algorithm 2.  Host-side control; the predictor math runs on
    `device` (default the card).  `spill_dir` defaults to a fresh
    directory under the system's temporary directory."""

    def __init__(self, cfg: IngestConfig, spill_dir: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.beta = cfg.beta_init
        self.perfmon = PerfMon(cfg, device=resolve(device))
        self.spill = SpillStore(spill_dir or default_spill_dir())
        self.trace: List[PerfSample] = []
        # per-action decision counts, table-pressure throttle count, and
        # an optional decision hook
        self.decision_counts: collections.Counter = collections.Counter()
        self.pressure_throttles = 0
        self.on_decision: Optional[Callable[[ControllerDecision], None]] = None
        # audit trail (repro_torch.telemetry.AuditTrail): when attached,
        # every decision is recorded with the full PerfMon input vector
        # and later resolved with the realized (mu, beta_e) by the tick loop
        self.audit = None

    def decide(self, edge_table_size: float, density: float,
               now: Optional[float] = None) -> ControllerDecision:
        cfg = self.cfg
        # dropped_inserts is consumed by the pressure throttle below;
        # capture it first so the audit trail sees what decide() saw
        dropped_in = self.perfmon.dropped_inserts
        beta_e, mu_exp, s = self.perfmon.predict(edge_table_size, density)
        beta = self.beta
        action = "push"
        reason = ""

        if mu_exp >= cfg.cpu_max:
            # step 2: high alert -- absorb by growing the buffer
            grow = int(cfg.theta1 * (cfg.beta_max - beta))
            if beta + grow <= cfg.beta_max:
                beta = beta + max(grow, 1)
            action = "hold"
            if mu_exp >= (1.0 + cfg.theta2) * cfg.cpu_max and s >= 0.0:
                # step 3: still rising -> data throttling to disk
                action = "throttle"
                reason = "load"
        else:
            # step 4: push; step 5: recover latency by shrinking
            if beta - cfg.theta2 * beta >= cfg.beta_min:
                beta = int(beta - cfg.theta2 * beta)
            action = "push"
            if mu_exp <= cfg.theta2 * cfg.cpu_max and self.spill.depth > 0:
                action = "drain+push"  # step 6

        # table pressure: if the last push dropped inserts even under
        # escalated probing, the store is saturating — spill this bucket
        # instead of losing data.  One-shot: the signal is consumed so
        # the next tick retries a push.
        if self.perfmon.dropped_inserts > 0 and action in ("push", "drain+push"):
            action = "throttle"
            reason = "pressure"
            self.pressure_throttles += 1
            self.perfmon.dropped_inserts = 0

        self.beta = max(cfg.beta_min, min(beta, cfg.beta_max))
        dec = ControllerDecision(action, self.beta, beta_e, mu_exp, s, reason)
        self.decision_counts[action] += 1
        if self.audit is not None:
            self.audit.record(dec, self.perfmon, now,
                              spill_depth=self.spill.depth,
                              dropped=dropped_in)
        if self.on_decision is not None:
            self.on_decision(dec)
        return dec

    def observe_sketch(self, payload: Dict):
        """Policy hook for MetricsHub "sketch" events (QuerySink): the
        mass the top-k nodes hold of everything the sketch absorbed, fed
        to PerfMon as a diversity hint (sketch-guided control)."""
        absorbed = float(payload.get("absorbed", 0) or 0)
        hh = payload.get("hh_counts") or []
        if absorbed <= 0 or not len(hh):
            return
        conc = float(np.clip(float(np.sum(hh)) / absorbed, 0.0, 1.0))
        self.perfmon.observe_sketch(conc)

    def record(self, sample: PerfSample):
        self.trace.append(sample)

    def state(self) -> dict:
        return {
            "beta": self.beta,
            "perfmon": self.perfmon.state(),
            "spill": self.spill.state(),
            "trace": list(self.trace),
            "decision_counts": dict(self.decision_counts),
            "pressure_throttles": self.pressure_throttles,
        }

    def restore_state(self, s: dict) -> None:
        self.beta = int(s["beta"])
        self.perfmon.restore_state(s["perfmon"])
        self.spill.restore_state(s["spill"])
        self.trace = list(s["trace"])
        self.decision_counts = collections.Counter(s["decision_counts"])
        self.pressure_throttles = int(s["pressure_throttles"])

    def trace_arrays(self):
        keys = [f.name for f in dataclasses.fields(PerfSample) if f.name != "action"]
        return {k: np.asarray([getattr(s, k) for s in self.trace]) for k in keys}, [
            s.action for s in self.trace
        ]
