"""`ScenarioSource`: a registry scenario as a pipeline `Source`.
Counterpart of `repro.workloads.source`.

Drives the ingestion API with the bursty traffic a named `Scenario`
describes.  The device does the sampling in two strides:

  * tick rates and counts come from `rate_trajectory` one CHUNK of
    ticks at a time (the Hawkes state carried across chunks),
  * record ids come from the counter-based id sampler
    (`kernels.sampler.traffic_ids`) one fixed-size block per tick,
    fetched to the host in one copy per block.

Everything downstream of (scenario, seed) is deterministic, and the
per-tick hot-topic share follows the realised intensity (burst level
b = 1 - base/lambda), so content diversity collapses exactly when
volume spikes.  Records are tweet-shaped dicts (`id`/`user`/
`hashtags`/`mentions`/`text`/`ts`) built on the host.

The source samples on `device` (default the card): a CUDA device runs
the sampler's kernel, the CPU its plain version.
"""
from __future__ import annotations

import collections
from typing import Iterator, List, Union

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.ingest.sources import StreamTick
from repro_torch.kernels.sampler import NSTREAMS, traffic_ids
from repro_torch.workloads.samplers import rate_trajectory
from repro_torch.workloads.scenarios import Scenario, get_scenario

CHUNK = 64  # ticks of rate trajectory per device call


class ScenarioSource:
    """Source-protocol adapter over a named (or inline) `Scenario`."""

    def __init__(self, scenario: Union[Scenario, str], seed: int = 0,
                 dt: float = 1.0, block: int = 2048,
                 rate_scale: float = 1.0, recent_window: int = 500,
                 device: Union[str, torch.device, None] = None):
        self.scenario = (get_scenario(scenario)
                         if isinstance(scenario, str) else scenario)
        self.seed = int(seed)
        self.dt = float(dt)
        self.block = int(block)
        self.rate_scale = float(rate_scale)
        self.device = resolve(device)
        self.t = 0.0
        self._tick_no = 0
        self._rec_no = 0     # record counter: ids AND PRNG lane base
        self._excite = 0.0   # Hawkes carry across trajectory chunks
        self._recent: collections.deque = collections.deque(maxlen=recent_window)
        # (rate, count) pairs of the current trajectory chunk not yet
        # yielded, kept on the instance so `state()` captures the cursor
        # mid-chunk
        self._pending: List[tuple] = []
        self._iparams = torch.from_numpy(self.scenario.iparams()).to(self.device)

    # ------------------------------------------------------------------
    def _sample_ids(self, n: int, burst_level: float):
        """n record-id tuples from the sampler (blocked, padded)."""
        fp = torch.from_numpy(self.scenario.fparams(burst_level)).to(self.device)
        out = []
        taken = 0
        while taken < n:
            # uint32 counter space wraps for streams past ~500M records
            ctr0 = ((self._rec_no + taken) * NSTREAMS) & 0xFFFFFFFF
            uid, tag, men, u_dup, u_dupi = traffic_ids(
                self.seed, ctr0, self.block, self._iparams, fp)
            k = min(self.block, n - taken)
            # one device->host copy per block: the floats travel as bits
            cols = torch.stack([uid, tag, men, u_dup.view(torch.int32),
                                u_dupi.view(torch.int32)])[:, :k].cpu().numpy()
            out.append([cols[0], cols[1], cols[2], cols[3].view(np.float32),
                        cols[4].view(np.float32)])
            taken += k
        return [np.concatenate(parts) for parts in zip(*out)]

    def _materialise(self, n: int, burst_level: float) -> List[dict]:
        scn = self.scenario
        if n == 0:
            return []
        uid, tag, mention, u_dup, u_dupi = self._sample_ids(n, burst_level)
        recs: List[dict] = []
        for i in range(n):
            self._rec_no += 1
            if self._recent and float(u_dup[i]) < scn.duplicate_frac:
                j = int(float(u_dupi[i]) * len(self._recent))
                recs.append(dict(self._recent[min(j, len(self._recent) - 1)]))
                continue
            rec = {
                "id": f"t{self._rec_no}",
                "user": f"u{int(uid[i])}",
                "hashtags": [f"h{int(tag[i])}"],
                "mentions": [f"u{int(mention[i])}"],
                "text": f"{scn.name} record {self._rec_no}",
                "ts": self.t,
            }
            recs.append(rec)
            self._recent.append(rec)
        return recs

    # ------------------------------------------------------------------
    def ticks(self) -> Iterator[StreamTick]:
        scn = self.scenario
        base = scn.base_rate * self.rate_scale
        while True:
            if not self._pending:
                chunk = rate_trajectory(
                    self.seed, CHUNK, self._tick_no, self._excite,
                    base, scn.noise_frac, scn.hawkes_alpha, scn.hawkes_beta,
                    scn.diurnal_amp, scn.diurnal_period, scn.flash_t,
                    scn.flash_mult, scn.flash_decay, scn.rate_cap_mult * base,
                    dt=self.dt, device=self.device)
                rates = chunk.rates.cpu().numpy()
                counts = chunk.counts.cpu().numpy()
                self._excite = float(chunk.excite)
                self._tick_no += CHUNK
                self._pending = [(float(lam), int(c))
                                 for lam, c in zip(rates, counts)]
            lam, c = self._pending.pop(0)
            # burst level in [0,1): 0 at baseline, ->1 as lam >> base;
            # drives the hot-topic share (diversity drops in bursts)
            b = max(0.0, 1.0 - base / max(lam, base))
            self.t += self.dt
            yield StreamTick(self.t, self._materialise(c, b))

    # ---- checkpoint surface ------------------------------------------
    def state(self) -> dict:
        """Exact stream cursor: counters, Hawkes carry, the un-yielded
        chunk remainder, and the duplicate-sampling window."""
        return {
            "t": self.t,
            "tick_no": self._tick_no,
            "rec_no": self._rec_no,
            "excite": self._excite,
            "pending": list(self._pending),
            "recent": [dict(r) for r in self._recent],
        }

    def restore_state(self, s: dict) -> None:
        self.t = float(s["t"])
        self._tick_no = int(s["tick_no"])
        self._rec_no = int(s["rec_no"])
        self._excite = float(s["excite"])
        self._pending = [tuple(p) for p in s["pending"]]
        self._recent = collections.deque(s["recent"],
                                         maxlen=self._recent.maxlen)
