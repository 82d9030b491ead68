"""Graph Ingestor + Commit (Algorithm 3 GRAPHPUSH).
Counterpart of `repro.core.ingestor`.

Bridges the pipeline to the graph store: converts compressed edge
tables into store commits, respecting a bounded ingestion pool (the
paper's bolt-connector pool), with commit-failure archiving and retry.
A GraphZip `compress.CompressedCommit` commits through
`commit_compressed`, and its commit reports `refs` and `dict_hit_rate`.
mu = busy time of the ingest engine over the sampling window; a commit's
busy time ends with a synchronize on the store's device, so it covers
the device's work.

  * the archive is BOUNDED: past `max_archive` in-memory batches,
    failed commits spill to disk (pickled numpy edge tables) and refill
    FIFO as retries drain them;
  * the pool has a hard cap (`pool_cap`, default 4x `max_pool_size`):
    overflow batches divert to the archive, counted in `pool_overflows`;
  * with a retry policy attached (any object with `delay(k)`, such as
    `repro_torch.resilience.RetryPolicy`), consecutive commit failures
    arm a capped-exponential-backoff gate (`next_retry_t`), and after
    `degrade_after` consecutive failures `push` archives directly
    (DEGRADED mode);
  * with a `repro_torch.lineage.LineageTracker` attached (`lineage`),
    each batch's tag rides beside it through the pool and the archive,
    and the tracker hears of every pool, archive, replay, commit and
    queryable hop.  No tag goes into a spill file.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import tempfile
import time
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compression import signed_view, unsigned_view
from repro_torch.core.edge_table import EdgeTable
from repro_torch.graphstore.store import GraphStore, commit_compressed, ingest_step
from repro_torch.telemetry.spans import NULL_REGISTRY

# key fields of an EdgeTable and of a compress.CompressedCommit
_KEY_FIELDS = ("src", "dst", "node_ids", "res_psig", "ref_src", "ref_dst")
# commit stats the host reads after every commit, fetched in one copy
_HOST_STATS = ("instructions", "new_nodes", "batch_nodes", "probe_rounds",
               "dropped_inserts", "node_load", "edge_load")
_DICT_STATS = ("dict_refs", "dict_hit_rate")  # compressed commits only


@dataclasses.dataclass
class CommitRecord:
    t: float
    busy_s: float
    instructions: int
    new_nodes: int
    batch_nodes: int
    ok: bool
    probe_rounds: int = 0  # adaptive probe budget the commit ran with
    dropped: int = 0  # inserts lost to table pressure (probing exhausted)
    refs: int = 0  # dictionary pattern references applied (compressed commits)


def _map_fields(batch, fn):
    """A copy of an EdgeTable or CompressedCommit with `fn(name, leaf)`
    applied to every leaf, nested tables included."""
    def one(name, x):
        return _map_fields(x, fn) if dataclasses.is_dataclass(x) else fn(name, x)

    return type(batch)(**{f.name: one(f.name, getattr(batch, f.name))
                          for f in dataclasses.fields(batch)})


def _to_host(et):
    """Batch -> numpy leaves (pickle/spill-safe), keys as uint64 or
    uint32 by their width: the layout of the reference's archive files.
    Every leaf is a copy, on the host too, where `.numpy()` would share
    the tensor's memory."""
    def host(name, x):
        x = x.detach()
        a = (x.clone() if x.device.type == "cpu" else x).cpu().numpy()
        return unsigned_view(a) if name in _KEY_FIELDS else a

    return _map_fields(et, host)


def _to_device(et, device: torch.device):
    """Inverse of `_to_host`: numpy leaves back to tensors on `device`.
    The reference's batches (a checkpoint's host state) hold their scalar
    counters as int64 under x64: they come back as the port's int32."""
    def dev(name, a):
        a = signed_view(np.asarray(a))
        if name not in _KEY_FIELDS and a.dtype == np.int64:
            a = a.astype(np.int32)
        # a copy: an unpickled array may be read-only
        return torch.from_numpy(np.array(a)).to(device)

    return _map_fields(et, dev)


class GraphIngestor:
    def __init__(self, store: GraphStore, max_pool_size: int = 4, fail_hook=None,
                 occupancy_window: float = 10.0, retry_policy=None,
                 pool_cap: Optional[int] = None, max_archive: int = 128,
                 archive_dir: Optional[str] = None, degrade_after: int = 3):
        self.store = store
        self.max_pool_size = max_pool_size
        # hard admission ceiling: beyond it, batches divert to the archive
        self.pool_cap = pool_cap if pool_cap is not None else 4 * max_pool_size
        self.pool: Deque[EdgeTable] = collections.deque()
        self.archive: Deque[EdgeTable] = collections.deque()  # Alg. 3 line 18
        self.commits: List[CommitRecord] = []
        self.fail_hook = fail_hook  # nullary, or callable(now) with `wants_now = True`
        # observers of every SUCCESSFUL commit: hook(et, stats).  Push can
        # drain pooled batches and retry_archive replays old ones, so a
        # commit-consistent observer hooks here rather than on push().
        self.commit_hook = None
        self.commit_hooks: List = []
        self.occupancy_window = occupancy_window
        self._busy: Deque[Tuple[float, float]] = collections.deque(maxlen=512)
        # commit sub-spans: upsert-dispatch / device-wait / observer hooks
        self.telemetry = NULL_REGISTRY
        self.retry_policy = retry_policy
        self.max_archive = max_archive
        self.archive_dir = archive_dir
        self.degrade_after = degrade_after
        self._archive_spill: List[str] = []  # on-disk overflow, FIFO
        self._archive_n = 0  # monotone spill-file counter
        self.consecutive_failures = 0
        self.next_retry_t = float("-inf")  # backoff gate (simulated time)
        # accounting: archived_total == replayed + archive_depth always
        self.archived_total = 0
        self.replayed = 0
        self.attempts = 0
        self.pool_overflows = 0
        # provenance (None tracker = nothing done): `_lineage_next` is the
        # tag the pipeline staged for the very next push;
        # `_pool_tags`/`_archive_tags` ride parallel to the pool and the
        # LOGICAL archive (memory + disk spill, FIFO), so the spill
        # files keep the reference's layout.  Every tag op is guarded on
        # the tracker and on deque depth.
        self.lineage = None
        self._lineage_next = None
        self._pool_tags: Deque = collections.deque()
        self._archive_tags: Deque = collections.deque()

    # ---- archive (bounded, disk-spilled past max_archive) -----------
    @property
    def archive_depth(self) -> int:
        """Failed batches awaiting replay, memory + disk."""
        return len(self.archive) + len(self._archive_spill)

    @property
    def degraded(self) -> bool:
        """Store considered down: policy attached and the consecutive-
        failure count passed `degrade_after`."""
        return (self.retry_policy is not None
                and self.consecutive_failures >= self.degrade_after)

    def _spill_path(self) -> str:
        if self.archive_dir is None:
            self.archive_dir = tempfile.mkdtemp(prefix="repro_torch_archive_")
        os.makedirs(self.archive_dir, exist_ok=True)
        fn = os.path.join(self.archive_dir, f"archive_{self._archive_n:08d}.pkl")
        self._archive_n += 1
        return fn

    def _archive_put(self, et, tag=None, now: Optional[float] = None,
                     degraded: bool = False) -> None:
        if self.lineage is not None and tag is not None:
            self._archive_tags.append(tag)
            self.lineage.mark_archived(tag, now if now is not None else time.time(),
                                       degraded=degraded)
        self.archived_total += 1
        # keep FIFO across the memory/disk boundary: once anything
        # spilled, later batches must spill too or replay reorders
        if self._archive_spill or len(self.archive) >= self.max_archive:
            fn = self._spill_path()
            with open(fn, "wb") as f:
                pickle.dump(_to_host(et), f, pickle.HIGHEST_PROTOCOL)
            self._archive_spill.append(fn)
            self.telemetry.count("archive.spilled")
        else:
            self.archive.append(et)

    def _archive_refill(self) -> None:
        """Pull spilled batches back into memory headroom, in order."""
        while self._archive_spill and len(self.archive) < self.max_archive:
            fn = self._archive_spill.pop(0)
            with open(fn, "rb") as f:
                self.archive.append(_to_device(pickle.load(f), self.store.device))
            os.unlink(fn)

    # ------------------------------------------------------------------
    def push(self, et: EdgeTable, now: Optional[float] = None) -> dict:
        """GRAPHPUSH: pool admission + commit.  Returns commit stats."""
        tag, self._lineage_next = self._lineage_next, None
        wall = now if now is not None else time.time()
        if self.retry_policy is not None and self.degraded:
            if wall < self.next_retry_t:
                # degraded mode: the store is down and the backoff gate
                # is closed — preserve the batch without a doomed probe
                self._archive_put(et, tag, now=wall, degraded=True)
                return {"committed": False, "archived": self.archive_depth,
                        "degraded": True}
        if len(self.pool) >= self.max_pool_size:
            if len(self.pool) >= self.pool_cap:
                self.pool_overflows += 1
                self._archive_put(et, tag, now=wall)
                return {"committed": False, "pooled": len(self.pool),
                        "pool_overflow": self.pool_overflows}
            # pool full: hold in local memory until timeout (paper §III-B)
            self.pool.append(et)
            if self.lineage is not None and tag is not None:
                self._pool_tags.append(tag)
                self.lineage.mark_pooled(tag, wall)
            return {"committed": False, "pooled": len(self.pool)}
        self.pool.append(et)
        if self.lineage is not None and tag is not None:
            self._pool_tags.append(tag)
        stats = {}
        while self.pool:
            batch = self.pool.popleft()
            btag = self._pool_tags.popleft() if self._pool_tags else None
            stats = self._commit(batch, now, tag=btag)
            if not stats["committed"]:
                break
        return stats

    def _sync(self) -> None:
        if self.store.device.type == "cuda":
            torch.cuda.synchronize(self.store.device)

    def _commit(self, et: EdgeTable, now: Optional[float],
                archive_on_fail: bool = True, tag=None) -> dict:
        tel = self.telemetry
        wall = now if now is not None else time.time()
        t0 = time.perf_counter()
        self.attempts += 1
        try:
            if self.fail_hook is not None:
                fh = self.fail_hook
                hit = fh(wall) if getattr(fh, "wants_now", False) else fh()
                if hit:
                    raise ConnectionError("injected commit failure")
            compressed = hasattr(et, "residual")
            fetch = _HOST_STATS + (_DICT_STATS if compressed else ())
            with tel.span("commit.upsert"):
                if compressed:
                    # pattern-aware path: compress.CompressedCommit
                    self.store, s = commit_compressed(self.store, et)
                else:
                    self.store, s = ingest_step(self.store, et)
            with tel.span("commit.wait"):
                self._sync()
                host = dict(zip(fetch, torch.stack(
                    [s[k].to(torch.float64) for k in fetch]).tolist()))
            busy = time.perf_counter() - t0
            tel.observe("commit.total", busy)
            self._busy.append((wall, busy))
            self.consecutive_failures = 0
            self.next_retry_t = float("-inf")
            rec = CommitRecord(
                t=wall,
                busy_s=busy,
                instructions=int(host["instructions"]),
                new_nodes=int(host["new_nodes"]),
                batch_nodes=int(host["batch_nodes"]),
                ok=True,
                probe_rounds=int(host["probe_rounds"]),
                dropped=int(host["dropped_inserts"]),
                refs=int(host.get("dict_refs", 0)),
            )
            self.commits.append(rec)
            if self.lineage is not None and tag is not None:
                # the store took it (the wait above synchronised the
                # card): the committed low watermark may advance
                self.lineage.mark_committed(tag, wall)
            with tel.span("commit.hooks"):
                if self.commit_hook is not None:
                    self.commit_hook(et, s)
                for hook in self.commit_hooks:
                    hook(et, s)
            if self.lineage is not None and tag is not None:
                # the hook fan-out (the snapshot absorb, the sketch
                # update, the dictionary admission) has run: queries now
                # see these records, so the queryable watermark may move.
                # On the card the hooks' device work is only enqueued
                # here: the hop's stream time is exact, its wall stamp
                # is the enqueue's, as with every span
                self.lineage.mark_queryable(tag, wall)
            out = {
                "committed": True,
                "stats": s,
                "busy_s": busy,
                "rho": rec.new_nodes / max(rec.batch_nodes, 1),
                "instructions": rec.instructions,
                # table-pressure signals for the Algorithm-2 controller
                "dropped": rec.dropped,
                "probe_rounds": rec.probe_rounds,
                "pressure": max(host["node_load"], host["edge_load"]),
            }
            if compressed:
                # compressibility signals (GraphZip -> controller)
                out["refs"] = rec.refs
                out["dict_hit_rate"] = host["dict_hit_rate"]
            return out
        except ConnectionError:
            # commit failed (network/DBMS) -> archive for replay
            self.consecutive_failures += 1
            out = {"committed": False}
            if self.retry_policy is not None:
                delay = self.retry_policy.delay(self.consecutive_failures - 1)
                self.next_retry_t = wall + delay
                out["retry_in_s"] = delay
                tel.count("retry.backoff")
                if self.degraded:
                    out["degraded"] = True
            if archive_on_fail:
                self._archive_put(et, tag, now=wall, degraded=bool(out.get("degraded")))
            self.commits.append(CommitRecord(wall, 0.0, 0, 0, 0, ok=False))
            out["archived"] = self.archive_depth
            return out

    # ------------------------------------------------------------------
    def retry_archive(self, now: Optional[float] = None) -> int:
        """Re-commit archived batches (connection restored).  With a
        retry policy attached the backoff gate is honoured: while
        `now < next_retry_t` nothing is attempted."""
        if self.retry_policy is not None:
            wall = now if now is not None else time.time()
            if wall < self.next_retry_t:
                return 0
        n = 0
        while self.archive_depth:
            self._archive_refill()
            et = self.archive.popleft()
            tag = None
            if self.lineage is not None and self._archive_tags:
                tag = self._archive_tags.popleft()
                self.lineage.mark_replay(tag, now if now is not None else time.time())
            if self._commit(et, now, archive_on_fail=False, tag=tag)["committed"]:
                n += 1
                self.replayed += 1
                continue
            # failed head returns to the FRONT, with its tag: replay
            # order is FIFO
            self.archive.appendleft(et)
            if tag is not None:
                self._archive_tags.appendleft(tag)
            break
        if n:
            self.telemetry.count("retry.replayed", n)
        return n

    def occupancy(self, now: float, sim_busy: Optional[float] = None) -> float:
        """mu in [0,1]: ingest busy-fraction over the trailing window."""
        w0 = now - self.occupancy_window
        busy = sum(b for (t, b) in self._busy if t >= w0)
        return min(busy / self.occupancy_window, 1.0)

    def pending_work_s(self) -> float:
        """Estimated seconds of work queued in the pool (system delay
        alpha for the measured path)."""
        busy = [b for (_, b) in self._busy]
        mean_busy = sum(busy) / len(busy) if busy else 0.0
        return len(self.pool) * mean_busy

    # ---- checkpoint surface -------------------------------------------
    def state(self) -> dict:
        """Everything except `store`: pool/archive batches as numpy edge
        tables, archive spill CONTENTS, counters and the backoff gate."""
        spilled = []
        for fn in self._archive_spill:
            with open(fn, "rb") as f:
                spilled.append(f.read())
        fh = self.fail_hook
        return {
            "pool": [_to_host(et) for et in self.pool],
            "archive": [_to_host(et) for et in self.archive],
            "archive_spill": spilled,
            "archive_n": self._archive_n,
            "commits": list(self.commits),
            "busy": list(self._busy),
            "attempts": self.attempts,
            "archived_total": self.archived_total,
            "replayed": self.replayed,
            "pool_overflows": self.pool_overflows,
            "consecutive_failures": self.consecutive_failures,
            "next_retry_t": self.next_retry_t,
            "fail_hook": fh.state() if hasattr(fh, "state") else None,
            "pool_tags": list(self._pool_tags),
            "archive_tags": list(self._archive_tags),
            "lineage_next": self._lineage_next,
        }

    def restore_state(self, s: dict) -> None:
        dev = self.store.device
        self.pool = collections.deque(_to_device(et, dev) for et in s["pool"])
        self.archive = collections.deque(_to_device(et, dev) for et in s["archive"])
        self._archive_spill = []
        self._archive_n = int(s["archive_n"])
        for blob in s["archive_spill"]:
            # rewrite under fresh (still-monotone) names: the original
            # files may live in a dead temp dir or have been drained
            fn = self._spill_path()
            with open(fn, "wb") as f:
                f.write(blob)
            self._archive_spill.append(fn)
        self.commits = list(s["commits"])
        self._busy = collections.deque(s["busy"], maxlen=self._busy.maxlen)
        self.attempts = int(s["attempts"])
        self.archived_total = int(s["archived_total"])
        self.replayed = int(s["replayed"])
        self.pool_overflows = int(s["pool_overflows"])
        self.consecutive_failures = int(s["consecutive_failures"])
        self.next_retry_t = float(s["next_retry_t"])
        if s.get("fail_hook") is not None and hasattr(self.fail_hook, "restore_state"):
            self.fail_hook.restore_state(s["fail_hook"])
        # .get: states saved without lineage's keys
        self._pool_tags = collections.deque(s.get("pool_tags", ()))
        self._archive_tags = collections.deque(s.get("archive_tags", ()))
        self._lineage_next = s.get("lineage_next")
