"""Stream sources (§IV Data Set).

`BurstyTweetSource` synthesises a politically-themed tweet stream with
the statistics the paper reports: ~60 records/s baseline (1% Twitter
sample), 15-45% velocity fluctuation on normal days, >250% during
bursts, 5-20% duplicate tweets, and — crucially for graph compression —
*temporal clustering*: during a burst many users reuse a small set of
hot hashtags (the #ReleaseTheMemo effect of Fig. 13), so content
diversity drops exactly when volume spikes.

`FileReplaySource` replays stored records at a programmable rate
multiplier (the paper's experiment mode (b): "streaming data from
tweets stored in files, where we programmatically control the
streaming rate to test the limits").
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class StreamTick:
    t: float
    records: List[dict]


class BurstyTweetSource:
    def __init__(
        self,
        mean_rate: float = 60.0,
        burst_multiplier: float = 5.0,
        duplicate_frac: float = 0.15,
        n_users: int = 20_000,
        n_hashtags: int = 4_000,
        burst_hashtags: int = 12,
        p_burst_start: float = 0.01,
        p_burst_end: float = 0.08,
        seed: int = 0,
        dt: float = 1.0,
    ):
        self.rng = np.random.default_rng(seed)
        self.mean_rate = mean_rate
        self.burst_multiplier = burst_multiplier
        self.duplicate_frac = duplicate_frac
        self.n_users = n_users
        self.n_hashtags = n_hashtags
        self.burst_hashtags = burst_hashtags
        self.p_burst_start = p_burst_start
        self.p_burst_end = p_burst_end
        self.dt = dt
        self.t = 0.0
        self.in_burst = False
        self.burst_topic: Optional[np.ndarray] = None
        self._tweet_no = 0
        self._recent: List[dict] = []

    # Zipf-ish popularity over users/hashtags
    def _zipf_pick(self, n: int, size: int, a: float = 1.3) -> np.ndarray:
        r = self.rng.zipf(a, size=size)
        return np.minimum(r, n) - 1

    def _make_tweet(self) -> dict:
        self._tweet_no += 1
        uid = int(self._zipf_pick(self.n_users, 1)[0])
        if self.in_burst and self.rng.random() < 0.8:
            # burst: hot-topic hashtags, heavy reuse (low diversity)
            k = self.rng.integers(2, 5)
            tags = self.rng.choice(self.burst_topic, size=k, replace=False)
        else:
            k = self.rng.integers(1, 4)
            tags = self._zipf_pick(self.n_hashtags, k)
        # political mentions concentrate on few accounts (zipf)
        nm = self.rng.integers(1, 4)
        mentions = self._zipf_pick(self.n_users, nm, a=2.0)
        return {
            "id": f"t{self._tweet_no}",
            "user": f"u{uid}",
            "hashtags": [f"h{int(h)}" for h in np.atleast_1d(tags)],
            "mentions": [f"u{int(m)}" for m in np.atleast_1d(mentions)],
            "text": f"synthetic tweet {self._tweet_no}",
            "ts": self.t,
        }

    def ticks(self) -> Iterator[StreamTick]:
        while True:
            # burst state machine
            if not self.in_burst and self.rng.random() < self.p_burst_start:
                self.in_burst = True
                self.burst_topic = self.rng.integers(
                    0, self.n_hashtags, size=self.burst_hashtags
                )
            elif self.in_burst and self.rng.random() < self.p_burst_end:
                self.in_burst = False

            rate = self.mean_rate * (
                self.burst_multiplier if self.in_burst else 1.0
            )
            # 15-45% fluctuation on top
            rate *= 1.0 + self.rng.uniform(-0.25, 0.35)
            n = self.rng.poisson(max(rate, 0.1) * self.dt)
            recs = []
            for _ in range(n):
                if self._recent and self.rng.random() < self.duplicate_frac:
                    recs.append(dict(self.rng.choice(self._recent)))
                else:
                    tw = self._make_tweet()
                    recs.append(tw)
                    self._recent.append(tw)
                    if len(self._recent) > 500:
                        self._recent.pop(0)
            self.t += self.dt
            yield StreamTick(self.t, recs)


class FileReplaySource:
    """Replay a jsonl file at `rate_multiplier` x its natural rate.

    The replay cursor — byte offset, undelivered record buffer and the
    fractional-rate carry — lives on the instance, so a checkpoint
    (repro.resilience) can capture it mid-file and a resumed source
    continues from the exact next record."""

    def __init__(self, path: str, rate_multiplier: float = 1.0, dt: float = 1.0,
                 natural_rate: float = 4.9):
        self.path = path
        self.rate = natural_rate * rate_multiplier
        self.dt = dt
        self.t = 0.0
        self._offset = 0  # byte offset of the next unread line
        self._buf: List[dict] = []  # read but not yet delivered
        self._acc = 0.0  # fractional-record carry (non-integer rates)

    def ticks(self) -> Iterator[StreamTick]:
        per_tick = self.rate * self.dt
        if per_tick <= 0:
            raise ValueError("replay rate must be positive")
        with open(self.path) as f:
            f.seek(self._offset)
            while True:
                line = f.readline()
                if not line:
                    break
                self._offset = f.tell()
                self._buf.append(json.loads(line))
                want = self._acc + per_tick
                k = int(want)
                if len(self._buf) >= k:
                    self._acc = want - k
                    out, self._buf = self._buf[:k], self._buf[k:]
                    self.t += self.dt
                    yield StreamTick(self.t, out)
        # drain the tail at the programmed rate (no EOF burst)
        while self._buf:
            want = self._acc + per_tick
            k = min(int(want), len(self._buf))
            self._acc = want - k
            out, self._buf = self._buf[:k], self._buf[k:]
            self.t += self.dt
            yield StreamTick(self.t, out)

    # ---- checkpoint surface (repro.resilience) -----------------------
    def state(self) -> dict:
        return {"t": self.t, "offset": self._offset,
                "buf": [dict(r) for r in self._buf], "acc": self._acc}

    def restore_state(self, s: dict) -> None:
        self.t = float(s["t"])
        self._offset = int(s["offset"])
        self._buf = list(s["buf"])
        self._acc = float(s["acc"])
