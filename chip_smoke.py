#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, one card

Builds every CUDA kernel of the port from `src/repro_torch/kernels/csrc`
(one nvcc per source, all at once), then:
  1. holds the fused upsert (K1) against its plain PyTorch version on
     the card, bit for bit (tolerance 0: table, slot, is_new) under every
     cluster width its kernel takes (1, 2, 4, 8, 16 CTAs, each with at
     least a warp's lanes, and the plan's), at the node and edge sweeps
     (16,384 and 8,192 lanes) at loads 0 to 0.85 and budgets 32 to 128,
     at the paths' own lane counts (node 128 to 8,192, edge 64 to 4,096)
     at loads 0 and 0.5, at the GraphZip dictionary's table (cap 4,096,
     budget 16, 64 to 8,192 lanes), and at eight corner cases (a
     capacity of 7, key 0 and duplicates, key 0 losing a claim, all
     lanes invalid, budgets 0 and 1, no lanes, 1,024 lanes crowding 8
     slots); times the plan's
     launch and the plain version (CUDA events) and gives each row's
     bound and the most rounds a lane took;
  2. drives the port's main path, `repro_torch.launch.ingest.main`, for
     120 ticks at the default deployment, with the launch counters set
     to 0 just before and read just after, and counts K1's launches by
     lane count;
  3. runs that loop again with span telemetry on and under
     torch.profiler, and prints where a tick goes (host stages, device
     busy time, the device's idle share) and K1's device ms a launch;
  4. runs the uncontrolled loop (seed 0, 40 ticks, 2^12/2^14 store) on
     the card and on the host and requires equal stores and reports;
  5. holds the sketch scatter (K3) against its plain versions on the
     card, bit for bit, through both entries (`sketch_scatter` on hash
     coordinates, `sketch_absorb` on keys, hashed in the kernel) under
     every plan its kernel takes (direct or private degree rows, on the
     planned grid, one CTA and a CTA a warp), at the query path's shapes
     (D=4, W=256 and 512) and the paths' 64 to 8,192 lanes, with
     uniform, Zipf-skewed and single-hub keys, and at corner cases (one
     lane, all lanes invalid, W=1,000, every key with bit 63 set); times both entries under the plan,
     their plain versions and the three `index_add_` calls that are the
     closest library equivalent beside each bound and an empty launch,
     and counts the device kernels of one `sketch_update` call in a
     fresh process;
  6. drives the query path, `repro_torch.launch.query.run`, for 120
     ticks in live mode at the default deployment (D=4, W=512, a 2^20-
     node, 2^21-edge store), with the launch counters set to 0 just
     before and read just after, and counts K3's launches by lane count;
  7. runs that query path again, its first 40 ticks, with spans on and
     under torch.profiler, and prints K3's device ms;
  8. runs the uncontrolled query loop (seed 0, 40 ticks, 2^12/2^14
     store, W=512) on the card and on the host and requires equal
     stores, sketches, snapshots and query answers (the card's sketches
     through the fused K3 entry);
  9. holds the traffic-id sampler kernel (K4) against its plain version
     on the card, bit for bit (tolerance 0), through its wrapper and
     under every plan its kernel takes (CTAs of 32 to 256 threads, 1 to
     4 records a thread, and the planned one), for every registry
     scenario at burst levels 0 and 1, at the workload path's
     2,048-record block and at 65,536 records, for two seeds and a
     counter start near the uint32 wrap, at 1, 33 and 2,049 records, and
     at corner parameters (copy_frac 0 and 1, hot-tag share 0 and 1,
     topic_base + h past n_tags); times the planned kernel and the plain
     version beside the bound and an empty launch;
 10. drives the workload path, `repro_torch.launch.workload.run`, at its
     default deployment with GraphZip compression (`flash_crowd`, 240
     ticks, seed 0, a 2^20-node, 2^21-edge store, a 4,096-entry
     dictionary), with the launch counters set to 0 just before and
     read just after;
 11. runs that path again, from `run_scenario`'s own builder, with
     spans on and under torch.profiler, prints K4's device ms and its
     launches by block size, counts the mined batches of each
     edge-table size and keeps the largest;
 12. holds the pattern miner (K5) against its plain version on the
     card, bit for bit, at 1, 2, 64, 512, 1,024, 2,048, 4,096, 8,192,
     16,384 and 65,536 edges (both sides of each step of its cluster
     plan: 1 CTA a vector below 2,048 edges, 8 from there),
     on random batches with invalid lanes, batches built to hold star
     bursts, cascade chains and hot edges, one hub owning every lane,
     ids 0 and 2^64 - 1 as src and dst with and without an invalid
     lane, and all lanes invalid or valid, and on the batch phase 11
     kept; times the kernel and the plain version on the random,
     patterned, hub and phase-11 batches, and counts the device kernels
     of one call (torch.profiler, in a fresh process: two);
 13. compares CUDA with CPU at the workload CLI's `--dryrun` size: the
     sampled lanes and tick counts that differ (printed), then, on one
     shared record stream, the uncontrolled loop with compression on
     both devices (equal stores, dictionaries and reports), and on the
     card the raw and the compressed loop (byte-identical stores);
 14. drives the kernel-ops entry point's `sort_dedup` (K2) at 16 to 2^20
     keys (the sizes where its design changes level, and the first past
     each) of six kinds (5 values, n/4, 2^31, all equal, sorted,
     reversed), counters set to 0 just before and read just after, holds
     sorted, order and head bit for bit against the plain version and
     `dedup_sorted_counts` on both, and times the kernel, the plain
     version and `torch.sort`, with the device kernels of one call
     (torch.profiler) beside the launches its plan makes;
 15. drives the entry point's Bloom ops (K6a probe, K6b build) at 2 to
     64 rows and 64 to 16,384 keys and `bloom_diversity` (one launch of
     the fused entry a step) over 120 Zipf batches into one 64-row
     filter, the same way (9 probes, 9 builds, 120 fused launches), held
     bit for bit against the plain versions; holds the probe, the build
     and the fused entry under every plan of the sweep (the build's
     striped route at 1 to 16 rows a CTA and the grid route, the fused
     entry's grid route, 128 to 1,024 threads; probe CTAs of 32 to 256
     threads, a key a thread) at
     those shapes, the diversity step's and corners (rows 1, 3, 48; 1, 33
     and 2,049 keys; one hub key in all 16,384 lanes; keys 0 and
     2^32 - 1): no false negatives, inputs unchanged; refuses a probe grid
     with an empty CTA; times the planned kernels and the plain versions
     beside an empty launch, and a diversity step with its device kernels
     (torch.profiler, in a fresh process);
 16. drives the sharded ingest CLI, `launch.ingest --shards 4
     --dict-compress`, for 120 ticks at the default deployment, with the
     launch counters set to 0 just before and read just after;
 17. runs that loop again, spans on and under torch.profiler for ticks
     40 to 79, and prints K5's and K1's device time over those ticks,
     with K1's launches by lane count;
 18. drives the workload CLI's own example, `launch.workload --scenario
     flash_crowd --shards 4 --sketch-control`, at its default deployment
     (240 ticks), the same way, and counts K3's launches by lane count;
 19. runs the sharded loop (2 shards, 2^12/2^14 store, 40 ticks,
     `--dict-compress`) on the card, and on the host replaying the card's
     per-shard decisions: equal stores, dictionaries and reports;
 20. holds the flash-attention kernel (K7) against its plain version on
     the card: the serving path's own call (qwen2.5-3b's grouped heads,
     16,384 positions, bf16, causal), the (BH, S, d) op at S 128 to
     4,096, d 64 and 128, f32 and bf16, causal or not, a 4,096 window at
     S = 8,192 and a 48-key window inside a 64-key block (f32 and bf16),
     bf16 at d 16 and 32, and bf16 at S = 192, no multiple of the bf16
     kernel's 128-row tiles; f32 within 2e-6 up to S = 1,024 and
     2e-6 x S/1,024 beyond, bf16 within rtol 1e-2 (one bf16 rounding of
     the output) and atol 1e-4; times the kernel, the plain version and
     scaled_dot_product_attention, and gives the kernel's TFLOP/s and
     its share of the bound;
 21. holds the SSD scan kernel (K8) against its plain version on the
     card, y and final state within 1e-4: the serving path's own call
     (mamba2-780m, 4 x 48 heads, 4,096 positions, chunk 256), 8 heads
     sharing B and C over 4 chunks at the path's widths (float32 and
     bf16 x), and smaller shapes (one a single chunk); times both, and
     gives the kernel's TFLOP/s and its share of the bound;
 22. drives the serving CLI, `launch.serve --arch qwen2.5-3b --batch 1
     --prompt-len 16384 --gen 16`, at full width and depth (random
     weights), counters set to 0 just before and read just after: 36
     flash_attention launches; prints prefill and decode times, tokens
     per second and peak memory, then profiles that prefill (K7's
     device time) and four decode steps (device idle share, launches);
 23. drives `launch.serve` at its defaults (batch 4, prompt 32): the
     materialised-attention branch, no flash_attention launch;
 24. drives `launch.serve --arch mamba2-780m --batch 4 --prompt-len 4096
     --gen 16` the same way: 48 ssd_scan calls, and profiles that
     prefill and four decode steps, with the count of K8's device
     kernels (three a call);
 25. serves one set of smoke-size float32 weights on the card and on the
     host, both archs (the dense prefill on the chunked branch): logits
     within 1e-4 at every step and equal greedy ids;
 26. runs phase 18's deployment from `run_scenario`'s own builder, ticks
     40 to 79 with spans on and under torch.profiler, and prints K3's
     and K4's device ms over them, with K4's launches by block size;
 27. runs phase 10's deployment through `run_scenario` with span
     telemetry, the controller audit trail, the health monitor and both
     trace exporters on, with the launch counters set to 0 just before
     and read just after (K1, K4 and K5 counted against the run's
     commits, mined batches and ticks); validates the Chrome trace (the
     telemetry CLI's dryrun stages and `commit.wait`) and the JSONL
     sink, requires one audit record per decision; runs the same
     deployment on the host on the card's record stream, its controller
     deciding for itself, and requires the same decisions, records,
     audit trail (actions, reasons, betas, PerfMon inputs and outcomes),
     the trail's predictions within F2's tolerances, detector events on
     the series that are not wall-clock and SLO breaches but
     `commit_p99`'s; and times the card's run with telemetry and the
     monitor off and on, in the order off, on, on, off;
 28. runs the ingest deployment (2^20/2^21, 60 records/s, 5x bursts, 120
     ticks, controlled) at 32-bit keys through `PipelineBuilder(...,
     key_dtype=torch.int32)` with the query sink (D=4, W=512) and GraphZip
     on, counters set to 0 just before and read just after (K1, K3 and
     K5 launches by width: no 64-bit instance runs), then on the host
     replaying the card's decisions: equal records, commits, drops,
     store, sketch and dictionary arrays; holds K1's 32-bit instance to
     its plain version bit for bit under every cluster width at phase
     1's node sweep, on a table at load 0.7 (budget 64) and at 512 lanes,
     and K5's at 512 and 8,192 lanes (every kind of phase 12's batches,
     ids cut to 32 bits) and on the path's largest mined batch; times
     both beside the 64-bit instances on the same keys zero-extended;
 29. drives the lineage CLI, `launch.lineage --outage 30:42`, at its
     defaults (`flash_crowd`, 240 ticks, seed 0, speed 0.5, a 2^20-node,
     2^21-edge store; the default RetryPolicy) with its trace, JSONL and
     Prometheus files, counters set to 0 just before and read just
     after: requires exit 0, a final queryable watermark, balanced
     conservation, the `archived` path with a complete flow chain for
     every path, a slower archived queryable p99 than direct's, one
     queryable watermark on every timeline row inside the outage, the
     archive drained and a `freshness` burn-alert onset before the
     outage's records are queryable, K1 two launches a stored commit
     (replays included) and K4 one a tick with records; runs the same
     deployment on the host on the card's records, its controller
     deciding for itself (the card's decisions replayed only if one
     differs), and requires the same tracker state (hop wall clock
     masked), timeline, freshness table, path mix, conservation,
     lineage gauges, hop logs, freshness SLO and ingestor accounting;
     prints the tracker's host ms a tick and the exporters' ms once;
 30. drives the chaos CLI, `launch.chaos`, at its defaults (`flash_crowd`,
     120 ticks, seed 0, a store outage over 30:45, a checkpoint every 16
     ticks, a crash at 60, a 2^20-node, 2^21-edge store), counters set to
     0 just before and read just after: requires exit 0, every check of
     its verdict (bit-exact store and snapshot, equal records, no batch
     lost, no hot retry loop), the resume from 48 of the kill at 60, K1
     two launches a commit that reached the store in the three runs
     (replays included) and K4 one a 2,048-record block of every tick
     the sources yielded; resumes the card's step-48 checkpoint on the
     host (its controller deciding for itself, the card's decisions
     replayed only if one differs) onto the card's uninterrupted
     digests; then kills at 24 and resumes, through `run_scenario` on the
     card, the sketch-guided run with GraphZip (48 ticks, an outage over
     10:16, a checkpoint every 8) and requires its digests and every
     leaf of its store, sketch and dictionary equal to an uninterrupted
     run's, K3 and K5 launched; prints the launches, a checkpoint's
     bytes, the capture's ms, the write's and the restore's seconds and
     the digests' seconds.
 31. drives phase 30's deployment (`flash_crowd`, 120 ticks, a store
     outage over 30:45, a checkpoint every 16 ticks, a kill at 60,
     2^20/2^21) through `run_scenario(key_dtype=torch.int32)` on the
     card with the sketch-guided GraphZip path and lineage on,
     uninterrupted, killed and resumed, counters set to 0 just before
     the three runs and read just after: requires the resume from 48 on
     the uninterrupted run's digests, 32-bit keys in every pipeline and
     checkpoint (int32 counters), K1's and K5's 32-bit instances, K3 and
     K4 launched and the 64-bit instances never, K1 three launches a
     commit that reached the store (two for the store, one for the
     dictionary's admission; replays included), K3 one and K4 one a
     block a tick; resumes the card's 32-bit
     step 48 on the host onto the card's digests (the card's decisions
     replayed only if one differs); requires a small 64-bit pipeline to
     refuse that checkpoint; prints wall ms a tick, records a wall second, a
     checkpoint's bytes, the capture's and write's ms and the launches
     by kernel.
 32. initialises an NCCL process group of one rank in its own process
     (a `file://` rendezvous under the gitignored `build/`, a 60 s
     timeout), builds `launch.mesh.make_dev_mesh(1, 1)` and drives
     `make_distributed_ingest` on it: 24 commits of 2^17 raw edges
     (Zipf-skewed sources and destinations over 2^21 users, 10% of the
     lanes invalid) into a 2^22-node, 2^23-edge store, the reference
     dryrun's caps, counters set to 0 just before and read just after:
     requires K1 two launches a commit (2^18 and 2^17 lanes), the store
     and every stat equal to the same commits through the plain route on
     the host (`ingest_ranks`, one rank) and to `ingest_step` on the
     card, and the tables about a third full; holds K1 to its plain
     version bit for bit at one more commit's node and edge sweeps and
     times both; prints the wall ms a commit and K1's device ms a commit
     (a second run under torch.profiler), then destroys the process
     group.
The profiled phases (3, 7, 11, 17, 26 and 32) record device activity only.
Any failure raises; no phase is caught.  It prints the card, the build
time, each phase's seconds, a `kernels` JSON line and, last, the `ok`
JSON line.  It exits non-zero without a CUDA device or without the port
beside it.
"""
import collections
import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA H100 SXM data sheet
NODE_SWEEP = ("node", 1 << 20, 16_384)  # store_nodes, 2 x max_edges_per_batch lanes
EDGE_SWEEP = ("edge", 1 << 21, 8_192)  # store_edges, max_edges_per_batch lanes
LOADS = (0.0, 0.5, 0.7, 0.85)
PROBES = (32, 64, 128)
# K1 at the paths' own lane counts: the edge table's power-of-two caps (64
# to 8,192, api/stages.py) and twice that for nodes, at the loads below
# 0.6, where the store's budget is MAX_PROBES (32); and the GraphZip
# dictionary's table (cap 4,096, DICT_PROBES 16), whose lanes are the
# edge table's
PATH_LANES = {"node": tuple(1 << k for k in range(7, 14)),
              "edge": tuple(1 << k for k in range(6, 13))}
PATH_LOADS, PATH_PROBES = (0.0, 0.5), 32
DICT_SWEEP, DICT_LANES, DICT_PROBES = ("dict", 4_096, 8_192), (64, 512, 8_192), 16
UPSERT_CTAS = (1, 2, 4, 8, 16)  # every cluster width K1's kernel takes
FILL_PROBES = 1 << 12  # fills the test tables without dropping keys
KERNEL_REPS, PLAIN_REPS = 20, 5
SLEEP_CYCLES = 2_000_000  # about 1 ms at the H100's clock: covers a launch's host work
MAIN_TICKS = 120
SKETCH_SHAPES = ((4, 256), (4, 512))  # (D, W): the CLI's dryrun and default widths
# the edge-table caps of a sketch update on the paths: max(64, the next
# power of two of the edges), at most 8,192 (api/stages.py, query/stage.py)
SKETCH_LANES = (64, 512, 2_048, 8_192)
SKETCH_KEYS = ("uniform", "zipf", "hub")
SKETCH_UPDATE_LANES = (64, 512, 8_192)  # device kernels a sketch_update call
# (fn, args) of one sketch_update call, for _kernels_a_call
SKETCH_UPDATE_CALL = ("QS.sketch_update", "cs._sketch_update_args(torch, n)")
ZIPF_A = 1.3
TRAFFIC_LANES = (2_048, 65_536)  # the workload source's block, and a large one
TRAFFIC_SEEDS = ((0, 0), (7, 12_345), (0, 2**32 - 5_000))  # (seed, ctr0), the last wraps
TRAFFIC_SMALL = (1, 33, 2_049)  # one record, a warp and one, a block and one
# every grid K4's kernel takes: CTA widths and records a thread
TRAFFIC_THREADS, TRAFFIC_RECORDS = (32, 64, 128, 256), (1, 2, 3, 4)
# corner parameters of flash_crowd at burst 0.5: (label, "i" or "f", index, value)
TRAFFIC_CORNERS = (("copy_frac 0", "f", 4, 0.0), ("copy_frac 1", "f", 4, 1.0),
                   ("hot-tag share 0", "f", 3, 0.0), ("hot-tag share 1", "f", 3, 1.0),
                   ("topic_base + h past n_tags", "i", 3, 3_997))  # n_tags 4,000, 8 hot
# K5 on either side of each step of its cluster plan (1 CTA a vector up to
# 1,024 edges, 8 from 2,048; a CTA takes 8 lanes a thread at 65,536, the
# largest), the smallest batches, 512 (the path's commonest mined batch)
# and 8,192 (the path's edge-table cap)
MINE_LANES = (1, 2, 64, 512, 1_024, 2_048, 4_096, 8_192, 16_384, 65_536)
MINE_KINDS = ("random", "patterned", "hub", "extremes", "extremes_all_valid", "all_invalid",
              "all_valid")
MINE_TIMED = ("random", "patterned", "hub")
WORKLOAD_ARGV = ["--scenario", "flash_crowd", "--dict-compress"]  # 240 ticks, 2^20/2^21
DRYRUN_TICKS = 60
H100_FP32_PER_S = 67e12  # float32 outside the tensor cores, NVIDIA H100 SXM data sheet
# K2 at the sizes where its design changes level: one thread's registers
# (16), a warp (512), a CTA (4,096), a cluster (65,536), and the first size
# past each (32, 1,024, 8,192, 2^17: the first device-memory pass); 64,
# 16,384 (the old one-CTA tile) and 2^20 as before
DEDUP_LANES = (16, 32, 64, 512, 1_024, 4_096, 8_192, 16_384, 65_536, 1 << 17, 1 << 20)
DEDUP_KINDS = ("5", "n/4", "2^31", "equal", "sorted", "reversed")
BLOOM_ROWS = (2, 16, 64)
BLOOM_LANES = (64, 1_024, 16_384)  # up to the default node table's 16,384 lanes
DIVERSITY_STEPS, DIVERSITY_ROWS = 120, 64
BLOOM_CORNER_ROWS = (1, 3, 48)  # one row, an odd count, and no power of two
BLOOM_SMALL = (1, 33, 2_049)  # one key, a warp and one, 2,048 and one
# args of one diversity step in a fresh process, for _kernels_a_call: a
# Zipf batch into the 64-row filter
DIVERSITY_CALL_ARGS = ("(torch.from_numpy(cs._bloom_zipf(np.random.default_rng(1), "
                       "np.random.default_rng(2).integers(0, 2**32, size=1 << 18), n)).cuda(), "
                       "torch.zeros((cs.DIVERSITY_ROWS, 1024), dtype=torch.int32, device='cuda'))")
SHARDS = 4
PROFILED_TICKS = 40  # the profiled query and sharded windows (phases 7 and 17)
SHARDED_ARGV = ["--shards", str(SHARDS), "--dict-compress", "--ticks", str(MAIN_TICKS)]
SHARDED_WORKLOAD_ARGV = ["--scenario", "flash_crowd", "--shards", str(SHARDS),
                         "--sketch-control"]  # 240 ticks, 2^20/2^21
QUERY_ARGV = ["--ticks", str(MAIN_TICKS), "--mode", "live", "--depth", "4", "--width", "512",
              "--node-cap", str(1 << 20), "--edge-cap", str(1 << 21)]
H100_BF16_PER_S = 989e12  # bf16 dense tensor-core peak, NVIDIA H100 SXM data sheet
SERVE_LONG_ARGV = ["--arch", "qwen2.5-3b", "--batch", "1", "--prompt-len", "16384",
                   "--gen", "16"]  # over attn_full_max (8,192): the chunked branch, K7
SERVE_DEFAULT_ARGV = []  # the CLI's defaults: qwen2.5-3b, batch 4, prompt 32, gen 16
SERVE_SSM_ARGV = ["--arch", "mamba2-780m", "--batch", "4", "--prompt-len", "4096",
                  "--gen", "16"]
FLASH_PATH = (1, 16_384, 16, 2, 128)  # qwen2.5-3b's prefill in phase 22: B, S, n, m, d
FLASH_PATH_CHUNK = 1_024  # qwen2.5-3b's attn_chunk, the plain version's KV block
FLASH_SWEEP_S, FLASH_SWEEP_D, FLASH_SWEEP_BH = (128, 1_024, 4_096), (64, 128), 4
FLASH_SMALL_D = (16, 32)  # head widths of no served model, held in bf16 at two S
SSD_PATH = (4, 4_096, 48, 64, 128, 256)  # mamba2-780m's prefill in phase 24: B, S, nh, p, N, Q
SSD_SMALL = ((2, 64, 16, 8, 16), (2, 128, 32, 16, 32), (2, 256, 64, 64, 128),
             (2, 128, 64, 128, 128), (8, 144, 16, 16, 16))  # (BH, S, p, N, Q); Q = S is one chunk
# the path's p, N and Q with 8 heads sharing B and C over 4 chunks: B, S, nh, p, N, Q
SSD_SHARED = (2, 1_024, 8, 64, 128, 256)
SSD_TOL = 1e-4  # the reference test's float32 tolerance (tests/test_kernels.py:116)
# K7 in bf16: the plain version weighs v in float32, the kernel by two
# bf16 parts of each weight (about 2^-17 relative); they differ by one
# bf16 rounding of the output (2^-7 relative) where it is well above
# atol, and by under atol where it is near 0
BF16_RTOL, BF16_ATOL = 1e-2, 1e-4
PARITY_TOL = 1e-4  # CUDA against CPU logits at the smoke size, float32
# per-tick latencies: wall clock, so they differ between any two runs
WALL_SERIES, WALL_SLOS = ("commit_ms", "commit_p99_ms"), ("commit_p99",)



def _random_keys(rng, n, bits=64):
    """n distinct nonzero keys of `bits` (64 or 32), about half with the
    top bit set, as int64 or int32 bits."""
    top, signed = (2**64 - 1, np.int64) if bits == 64 else (2**32 - 1, np.int32)
    keys = np.unique(rng.integers(1, top, size=int(n * 1.01) + 16, dtype=np.uint64))
    rng.shuffle(keys)
    return keys[:n].astype(np.uint64 if bits == 64 else np.uint32).view(signed)


def _time_ms(torch, fn, base, args, reps):
    """Median ms of `fn(*copies, *args)` over `reps` runs, each on fresh
    copies of the tensor `base` or of each tensor of the tuple `base`
    (the copies are made outside the timed region).  A device sleep is
    queued before the start event, so the host has enqueued the work
    before the device reaches it, and the events time the device alone,
    not the host's enqueue (a function that waits for the device inside
    still counts the host time after that wait)."""
    bases = base if isinstance(base, tuple) else (base,)
    times = []
    for _ in range(reps):
        copies = [b.clone() for b in bases]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn(*copies, *args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _least_bytes(torch, probe_hash, keys, valid, slot, is_new, cap, probes):
    """Bytes the sweep must move on these inputs: keys and valid read,
    slot and is_new written, the probe budget, one table slot (a key: 8
    or 4 bytes) read per probe round each valid lane takes, one written
    per new key.  A placed lane took (slot - first candidate) mod cap + 1
    rounds (cap is a power of two), a dropped lane the whole budget.
    Returns (bytes, probe reads, the most rounds a lane took)."""
    n, kb = keys.shape[0], keys.element_size()
    first = probe_hash(keys, cap, 0)
    rounds = torch.where(slot >= 0, (slot.long() - first) % cap + 1,
                         torch.full_like(first, probes))[valid]
    reads = int(rounds.sum())
    max_rounds = int(rounds.max()) if rounds.numel() else 0
    return (n * (kb + 1) + n * (4 + 1) + 4 + kb * reads + kb * int(is_new.sum()), reads,
            max_rounds)


def upsert_tables(torch, dev, rng, cap, lanes, loads):
    """Yields (load, table, fill_keys, m) for each load: `table` (cap,)
    on `dev` holds the first m = load x cap of `fill_keys`, placed by the
    plain version (not the kernel under test); the last `lanes` of
    `fill_keys` are never placed."""
    from repro_torch.kernels.upsert import fused_upsert_ref

    fill_keys = torch.from_numpy(_random_keys(rng, int(max(loads) * cap) + lanes)).to(dev)
    table = torch.zeros(cap, dtype=torch.int64, device=dev)
    filled = 0
    for load in loads:
        m = int(load * cap)
        if m > filled:
            part = fill_keys[filled:m]
            _, fslot, _ = fused_upsert_ref(table, part, torch.ones_like(part, dtype=torch.bool),
                                           FILL_PROBES)
            if bool((fslot < 0).any()):
                raise AssertionError(f"fill of a {cap}-slot table to load {load} dropped keys")
            filled = m
        yield load, table, fill_keys, m


def upsert_batch(torch, dev, rng, fill_keys, m, n):
    """n keys and valid flags: 30% of the lanes (at most m) look up keys
    already in the table, the rest are new; about 10% are invalid."""
    perm = torch.from_numpy(rng.permutation(m)[: int(0.3 * n)]).to(dev)
    present = fill_keys[perm]
    fresh = fill_keys[-(n - present.numel()):]
    keys = torch.cat([present, fresh])[torch.from_numpy(rng.permutation(n)).to(dev)]
    valid = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    return keys.contiguous(), valid


def upsert_widths(n):
    """The cluster widths K1 is held to at n lanes: every width of
    UPSERT_CTAS that leaves each CTA at least a warp's lanes and at most
    MAX_CTA_LANES, and the plan's own."""
    from repro_torch.kernels import upsert

    widths = {c for c in UPSERT_CTAS if n >= 32 * c and -(-n // c) <= upsert.MAX_CTA_LANES}
    return sorted(widths | {upsert.cluster_plan(n)})


def upsert_row(torch, sweep, cap, table, filled, keys, valid, probes):
    """One phase-1 row: the kernel under every width of `upsert_widths`,
    each bit-equal to the plain version (table, slot and is_new), on a
    fresh copy of `table`; the plan's time and the plain version's, the
    bound, and the most rounds a lane took."""
    from repro_torch.kernels import upsert

    n, dev = keys.shape[0], keys.device
    budget = torch.tensor(probes, dtype=torch.int32, device=dev)
    tp, sp, np_ = upsert.fused_upsert_ref(table.clone(), keys, valid, budget)
    widths, err = upsert_widths(n), 0
    for c in widths:
        tk, sk, nk = upsert.launch(table.clone(), keys, valid, budget, c)
        torch.cuda.synchronize()
        table_equal = torch.equal(tk, tp)
        err = max(err, int((sk.long() - sp.long()).abs().max()) if n else 0,
                  int((nk.int() - np_.int()).abs().max()) if n else 0,
                  0 if table_equal else int((tk != tp).sum()))
        if not (table_equal and torch.equal(sk, sp) and torch.equal(nk, np_)):
            raise AssertionError(f"fused_upsert kernel != plain: {sweep} lanes={n} "
                                 f"load={filled / cap} probes={probes} ctas={c} "
                                 f"max_abs_err={err}")
    nbytes, reads, max_rounds = _least_bytes(torch, upsert.probe_hash, keys, valid, sp, np_,
                                             cap, probes)
    first = upsert.probe_hash(keys[valid], cap, 0)
    return {
        "sweep": sweep, "cap": cap, "lanes": n, "table_load": filled / cap, "probes": probes,
        "hits": int(((sp >= 0) & ~np_).sum()), "new": int(np_.sum()),
        "dropped": int((valid & (sp < 0)).sum()),
        "contended_lanes": int(first.numel() - torch.unique(first).numel()),
        "probe_reads": reads, "max_rounds": max_rounds, "max_abs_err": err,
        "ctas": upsert.cluster_plan(n), "widths_checked": widths,
        "ms": _time_ms(torch, upsert.fused_upsert, table, (keys, valid, budget), KERNEL_REPS),
        "plain_ms": _time_ms(torch, upsert.fused_upsert_ref, table, (keys, valid, budget),
                             PLAIN_REPS),
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
    }


def upsert_specials(torch, dev):
    """K1's corner cases, held bit for bit to the plain version under
    every cluster width that fits (CTAs without lanes included), untimed:
    a capacity of 7 (no power of two) that drops lanes; key 0 and
    duplicate keys in 1,000 lanes (no multiple of a warp); key 0 and three
    larger keys claiming empty slot 0 in one round; an all-invalid
    batch; budgets 0 and 1; no lanes at all; and 8,192 lanes of which
    1,024 crowd onto 8 first slots of a 16,384-slot table at load 0.5,
    so that claims of one CTA decide another's.  Returns the count."""
    from repro_torch.kernels import upsert

    rng = np.random.default_rng(4)

    def table_at(cap, load, pool):
        table = torch.zeros(cap, dtype=torch.int64, device=dev)
        m = int(load * cap)
        part = torch.from_numpy(pool[:m]).to(dev)
        upsert.fused_upsert_ref(table, part, torch.ones(m, dtype=torch.bool, device=dev),
                                FILL_PROBES)
        return table

    cases = []
    pool = _random_keys(rng, 1 << 16)
    cases.append(("cap 7", table_at(7, 0.3, pool), pool[-64:], rng.random(64) >= 0.1, 8))
    dup = np.concatenate([[0], pool[-300:]])[rng.integers(0, 301, 1_000)]
    cases.append(("key 0 and duplicates", table_at(1_024, 0.5, pool), dup,
                  rng.random(1_000) >= 0.1, 64))
    first = upsert.probe_hash(torch.from_numpy(pool), 1_024, 0).numpy()
    rivals = np.concatenate([[0], pool[first == 0][:3], pool[first != 0][:60]])
    cases.append(("key 0 losing a claim", table_at(1_024, 0.0, pool), rivals,
                  np.ones(rivals.size, bool), 8))
    cases.append(("all invalid", table_at(1 << 14, 0.5, pool), pool[-4_096:],
                  np.zeros(4_096, bool), 32))
    for budget in (0, 1):
        cases.append((f"budget {budget}", table_at(1 << 14, 0.5, pool), pool[-2_048:],
                      rng.random(2_048) >= 0.1, budget))
    cases.append(("no lanes", table_at(1 << 10, 0.5, pool), pool[:0], np.zeros(0, bool), 32))
    cap = 1 << 14
    many = _random_keys(rng, 1 << 21)
    first = upsert.probe_hash(torch.from_numpy(many), cap, 0).numpy()
    hot = np.flatnonzero(np.isin(first, rng.choice(cap, 8, replace=False)))[:1_024]
    crowd = np.concatenate([many[hot], np.setdiff1d(many[-8_192:], many[hot])[:8_192 - hot.size]])
    cases.append(("crowded", table_at(cap, 0.5, pool), crowd[rng.permutation(8_192)],
                  rng.random(8_192) >= 0.1, 128))
    for what, table, keys, valid, budget in cases:
        keys = torch.from_numpy(np.ascontiguousarray(keys).view(np.int64)).to(dev)
        valid = torch.from_numpy(np.ascontiguousarray(valid)).to(dev)
        n = keys.shape[0]
        want = upsert.fused_upsert_ref(table.clone(), keys, valid, budget)
        for c in (c for c in UPSERT_CTAS if -(-n // c) <= upsert.MAX_CTA_LANES):
            got = upsert.launch(table.clone(), keys, valid, budget, c)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"fused_upsert kernel != plain: {what}, ctas={c}")
    print(f"fused_upsert kernel == plain bit for bit at {len(cases)} corner cases "
          f"under every cluster width", flush=True)
    return len(cases)


def kernel_vs_plain(torch, dev):
    """Phase 1: fused_upsert kernel vs its plain version, bit-equal under
    every cluster width, at the phase's 24 shapes, the paths' own lane
    counts and the dictionary's table."""
    rng, path_rng = np.random.default_rng(0), np.random.default_rng(1)
    rows = []

    def add(row, **extra):
        rows.append({**extra, **row})
        print("upsert", json.dumps(rows[-1]), flush=True)

    for sweep, cap, n in (NODE_SWEEP, EDGE_SWEEP):
        for load, table, fill_keys, m in upsert_tables(torch, dev, rng, cap, n, LOADS):
            keys, valid = upsert_batch(torch, dev, rng, fill_keys, m, n)
            for probes in PROBES:
                add(upsert_row(torch, sweep, cap, table, m, keys, valid, probes), load=load)
            if load in PATH_LOADS:
                for lanes in PATH_LANES[sweep]:
                    keys, valid = upsert_batch(torch, dev, path_rng, fill_keys, m, lanes)
                    add(upsert_row(torch, sweep, cap, table, m, keys, valid, PATH_PROBES),
                        load=load, batch="path")
    sweep, cap, n = DICT_SWEEP
    for load, table, fill_keys, m in upsert_tables(torch, dev, path_rng, cap, n, PATH_LOADS):
        for lanes in DICT_LANES:
            keys, valid = upsert_batch(torch, dev, path_rng, fill_keys, m, lanes)
            add(upsert_row(torch, sweep, cap, table, m, keys, valid, DICT_PROBES),
                load=load, batch="path")
    print("fused_upsert kernel == plain bit for bit (tolerance 0) at all "
          f"{len(rows)} shapes, under every cluster width checked", flush=True)
    upsert_specials(torch, dev)
    return rows


@contextlib.contextmanager
def _launch_lanes(module, lanes_of):
    """Counts a kernel's launches by lane count inside the block: wraps
    `module.launch`, which the kernel's entries look up at each call;
    `lanes_of(*args)` gives a call's lanes."""
    hist, real = collections.Counter(), module.launch

    def counted(*args):
        hist[lanes_of(*args)] += 1
        return real(*args)

    module.launch = counted
    try:
        yield hist
    finally:
        module.launch = real


def k1_lanes():
    """K1's launches by lane count (`upsert.launch(table, keys, ...)`)."""
    from repro_torch.kernels import upsert

    return _launch_lanes(upsert, lambda table, keys, *rest: keys.shape[0])


def k3_lanes():
    """K3's launches by lane count, both entries (`sketch.launch(edge_w,
    out_deg, in_deg, a, b, cnt, ...)`)."""
    from repro_torch.kernels import sketch

    return _launch_lanes(sketch, lambda *args: args[5].shape[0])


def k4_lanes():
    """K4's launches by block size (`sampler.launch(seed, ctr0, n, ...)`)."""
    from repro_torch.kernels import sampler

    return _launch_lanes(sampler, lambda seed, ctr0, n, *rest: n)


def kernel_device(label, kernel, match, device, hist=None):
    """Prints and returns a kernel's device ms over a profiled run
    (`_profiled`'s events whose name holds `match`), beside its launches
    by lane count where `hist` counted them."""
    own = [(name, ms, c) for name, ms, c in device if match in name]
    ms, count = sum(ms for _, ms, _ in own), sum(c for _, _, c in own)
    out = {
        "device_ms": ms, "device_kernels": count,
        "device_ms_per_launch": ms / count if count else None,
        "share_of_device_busy": ms / sum(m for _, m, _ in device) if device else None,
        **({"launches": sum(hist.values()), "lanes": dict(sorted(hist.items()))}
           if hist is not None else {}),
        "kernels": [{"name": name[:80], "ms": m, "count": c} for name, m, c in own]}
    print(f"{label} {kernel} device: " + json.dumps(out), flush=True)
    return out


def main_path(torch):
    """Phase 2: the port's CLI at the default deployment, 120 ticks."""
    from repro_torch.kernels import build
    from repro_torch.launch import ingest

    build.launches.clear()
    t0 = time.perf_counter()
    with k1_lanes() as hist:
        rep, pipe = ingest.main(["--ticks", str(MAIN_TICKS)])
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(build.launches)
    commits = [c for c in pipe.sink.ingestor.commits if c.ok]
    if not commits or launches.get("fused_upsert", 0) != 2 * len(commits):
        raise AssertionError(f"expected 2 upsert launches per commit: "
                             f"{launches} for {len(commits)} commits")
    mu = rep.samples["mu"]
    if not (np.isfinite(mu).all() and rep.total_records > 0
            and int(pipe.store.n_nodes) > 0 and int(pipe.store.n_edges) > 0):
        raise AssertionError("main path produced no finite, non-empty result")
    busy = [c.busy_s * 1e3 for c in commits]
    print(f"main path: ticks={MAIN_TICKS} commits={len(commits)} "
          f"wall_ms_per_tick={wall_s * 1e3 / MAIN_TICKS} "
          f"wall_ms_per_commit={wall_s * 1e3 / len(commits)} "
          f"commit_busy_ms_mean={statistics.mean(busy)} "
          f"commit_busy_ms_p50={statistics.median(busy)} commit_busy_ms_max={max(busy)} "
          f"launches={launches}", flush=True)
    print("main path K1 lanes: " + json.dumps(dict(sorted(hist.items()))), flush=True)
    return launches


def _profiled(torch, label, reg, drive, ticks=MAIN_TICKS):
    """Run `drive()` with span telemetry `reg` on and under
    torch.profiler; print the host span totals per stage, and the
    device's busy time (kernels and copies) against the wall time.
    Returns the device events as (name, ms, count), largest first.
    The profiler records device activity only: nothing here reads its
    host events (the spans time the host), and recording them made the
    profiler's own processing most of a profiled phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                     for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in device)
    spans = {name: {"total_ms": st["total_s"] * 1e3, "count": st["count"]}
             for name, st in reg.summary().items()}
    ported = {name: {"ms": sum(ms for k, ms, _ in device if name in k),
                     "count": sum(c for k, _, c in device if name in k)}
              for name in build.kernel_names()}
    print(label, json.dumps({
        "ticks": ticks, "wall_ms": wall_ms, "spans": spans,
        "device_busy_ms": busy_ms if device else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if device else "not measured",
        "ported_kernels_device": ported if device else "not measured",
        "top_device": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in device[:10]],
    }), flush=True)
    return device


def tick_breakdown(torch):
    """Phase 3: where a tick of the main path goes.  The same loop as
    phase 2, built through the builder with span telemetry on."""
    from repro_torch.api import MetricsHub, PipelineBuilder
    from repro_torch.configs.paper_ingest import IngestConfig
    from repro_torch.ingest.sources import BurstyTweetSource
    from repro_torch.telemetry.spans import TelemetryRegistry

    reg = TelemetryRegistry(enabled=True)
    pipe = (PipelineBuilder(IngestConfig(), device="cuda")
            .with_source(BurstyTweetSource(seed=0))
            .with_metrics(MetricsHub(telemetry=reg)).build())
    pipe.transform.telemetry = reg
    pipe.sink.ingestor.telemetry = reg
    with k1_lanes() as hist:
        device = _profiled(torch, "breakdown", reg, lambda: pipe.run(max_ticks=MAIN_TICKS))
    kernel_device("breakdown", "K1", "fused_upsert", device, hist)


def cuda_vs_cpu(torch):
    """Phase 4: uncontrolled loop on the card and on the host, equal."""
    from repro_torch.api import PipelineBuilder
    from repro_torch.configs.paper_ingest import IngestConfig
    from repro_torch.convert import store_to_numpy
    from repro_torch.ingest.sources import BurstyTweetSource

    digests = {}
    for device in ("cuda", "cpu"):
        cfg = IngestConfig(store_nodes=1 << 12, store_edges=1 << 14)
        pipe = (PipelineBuilder(cfg, device=device)
                .with_source(BurstyTweetSource(seed=0)).uncontrolled().build())
        rep = pipe.run(max_ticks=40)
        ing = pipe.sink.ingestor
        digests[device] = (
            store_to_numpy(pipe.store),
            {"records": rep.total_records, "instructions": rep.total_instructions,
             "raw": rep.raw_instructions, "commits": len(ing.commits),
             "dropped": sum(c.dropped for c in ing.commits)},
            rep.compression_ratios, rep.samples["mu"])
    (sg, cg, crg, mug), (sc, cc, crc, muc) = digests["cuda"], digests["cpu"]
    for name in sg:
        if not np.array_equal(sg[name], sc[name]):
            raise AssertionError(f"cuda and cpu stores differ in {name}")
    if cg != cc or not np.array_equal(crg, crc) or not np.array_equal(mug, muc):
        raise AssertionError(f"cuda and cpu reports differ: {cg} vs {cc}")
    print(f"cuda vs cpu uncontrolled digest equal: {cg}", flush=True)


def _sketch_keys(rng, n, dist):
    """n uint64 node keys (int64 bits): uniform; Zipf-skewed ranks over a
    pool of 2^17 ids, which sends many lanes to the same cells; or "hub",
    one key on every lane."""
    if dist == "uniform":
        return rng.integers(1, 2**64 - 1, size=n, dtype=np.uint64).view(np.int64)
    if dist == "hub":
        return np.full(n, _random_keys(rng, 1)[0])
    pool = _random_keys(rng, 1 << 17)
    return pool[np.minimum(rng.zipf(ZIPF_A, size=n), pool.size) - 1]


def sketch_batch(torch, dev, rng, D, W, n, dist):
    """One sketch update's operands on `dev`: ((edge_w, out_deg, in_deg),
    src, dst, cnt).  src from `dist` (a hub is a source: every lane one
    out-degree cell), dst Zipf-skewed unless uniform, counts 1 to 3 with
    about 10% zeros; the arrays start non-zero, as in a running sketch."""
    src = torch.from_numpy(_sketch_keys(rng, n, dist)).to(dev)
    dst = torch.from_numpy(_sketch_keys(rng, n, "uniform" if dist == "uniform" else "zipf"))
    cnt = rng.integers(1, 4, size=n).astype(np.int32)
    cnt[rng.random(n) < 0.1] = 0
    base = (torch.randint(0, 100, (D, W, W), dtype=torch.int32, device=dev),
            torch.randint(0, 100, (D, W), dtype=torch.int32, device=dev),
            torch.randint(0, 100, (D, W), dtype=torch.int32, device=dev))
    return base, src, dst.to(dev), torch.from_numpy(cnt).to(dev)


def sketch_plans(n, D, W):
    """Every plan choice of K3's kernel at n lanes: direct or private
    degree rows (private only where they fit), on the planned grid, on
    one CTA of 1,024 threads and on a CTA a warp."""
    from repro_torch.kernels import sketch as SK

    planned = SK.launch_plan(n, D, W)
    grids = sorted({(planned.ctas, planned.threads), (1, 1_024), (-(-n // 32), 32)})
    privs = (False, True) if SK.rows_fit(D, W) else (False,)
    return [SK.Plan(c, t, p) for c, t in grids for p in privs]


def sketch_hold(torch, label, base, src, dst, cnt):
    """Holds both K3 entries to their plain versions, bit for bit:
    through the public wrappers, then under every plan of
    `sketch_plans`; returns (r, c, the largest error)."""
    from repro_torch.kernels import sketch as SK

    D, W = base[1].shape
    n = cnt.shape[0]
    r, c = SK.node_hash(src, D, W), SK.node_hash(dst, D, W)
    wants = {False: SK.sketch_scatter_ref(*(b.clone() for b in base), r, c, cnt),
             True: SK.sketch_absorb_ref(*(b.clone() for b in base), src, dst, cnt)}
    if not all(torch.equal(x, y) for x, y in zip(*wants.values())):
        raise AssertionError(f"sketch_absorb_ref != sketch_scatter_ref at {label}")
    # the public wrappers, under the plan they pick
    for fused, entry, (a, b) in ((False, SK.sketch_scatter, (r, c)),
                                 (True, SK.sketch_absorb, (src, dst))):
        got = entry(*(x.clone() for x in base), a, b, cnt)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, wants[fused])):
            raise AssertionError(f"K3 {entry.__name__} != plain at {label}")
    worst = 0
    for plan in sketch_plans(n, D, W):
        for fused, (a, b) in ((False, (r, c)), (True, (src, dst))):
            got = SK.launch(*(x.clone() for x in base), a, b, cnt, fused, plan)
            torch.cuda.synchronize()
            err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, wants[fused]))
            worst = max(worst, err)
            if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, wants[fused])):
                raise AssertionError(f"K3 {'sketch_absorb' if fused else 'sketch_scatter'} "
                                     f"!= plain at {label} under {plan}: max_abs_err={err}")
    return r, c, worst


def _sketch_update_args(torch, n):
    """(sketch, edge table) for one `sketch_update` call at n lanes on
    the card: the query path's widths (D=4, W=512, 64 heavy-hitter
    slots), Zipf ids (`SKETCH_UPDATE_CALL`)."""
    from repro_torch.core.edge_table import from_raw_batch
    from repro_torch.core.transform import RawEdgeBatch
    from repro_torch.query.sketch import init_sketch

    rng = np.random.default_rng(5)
    src, dst = (_sketch_keys(rng, n, "zipf").view(np.uint64) for _ in range(2))
    z = np.zeros(n, np.int32)
    et = from_raw_batch(RawEdgeBatch(src, dst, rng.integers(0, 3, n).astype(np.int32), z, z, n),
                        n, device="cuda")
    return init_sketch(depth=4, width=512, hh_slots=64, device="cuda"), et


def sketch_vs_plain(torch, dev):
    """Phase 5: K3 through both entries against its plain versions, bit
    for bit under every plan, at every shape, size and key mix and at
    the corner cases; then each entry under its plan timed beside its
    plain version, the library's three `index_add_`, its bound and an
    empty launch; and the device kernels of one `sketch_update` call."""
    from repro_torch.kernels.sketch import (
        launch_plan, sketch_absorb, sketch_absorb_ref, sketch_scatter, sketch_scatter_ref)

    floor_ms = _time_ms(torch, lambda: torch.cuda._sleep(0), (), (), KERNEL_REPS)
    print(f"sketch: an empty launch (torch.cuda._sleep(0)) takes {floor_ms} ms", flush=True)
    rng = np.random.default_rng(1)
    rows = []
    for D, W in SKETCH_SHAPES:
        for n in SKETCH_LANES:
            for dist in SKETCH_KEYS:
                base, src, dst, cnt = sketch_batch(torch, dev, rng, D, W, n, dist)
                r, c, err = sketch_hold(torch, f"D={D} W={W} n={n} {dist}", base, src, dst, cnt)
                # library: the three index_add_ calls on precomputed flat indices
                depth = torch.arange(D, device=dev).unsqueeze(1)
                rl, cl = r.long(), c.long()
                flat = ((depth * (W * W) + rl * W + cl).reshape(-1),
                        (depth * W + rl).reshape(-1), (depth * W + cl).reshape(-1))
                vals = cnt.expand(D, -1).reshape(-1).contiguous()

                def library(ew, od, idg):
                    ew.view(-1).index_add_(0, flat[0], vals)
                    od.view(-1).index_add_(0, flat[1], vals)
                    idg.view(-1).index_add_(0, flat[2], vals)

                # least bytes: every lane's count read once, the coordinates
                # (or keys) of the counted lanes only (a lane of count 0
                # adds nothing), and 4 B read plus 4 B written per distinct
                # cell a counted lane touches
                live = (cnt != 0).expand(D, -1).reshape(-1)
                cells = sum(int(torch.unique(f[live]).numel()) for f in flat)
                counted = int((cnt != 0).sum())
                coords_bytes = 4 * n + 2 * D * 4 * counted + 8 * cells
                keys_bytes = 4 * n + (8 + 8) * counted + 8 * cells
                rows.append({
                    "depth": D, "width": W, "lanes": n, "keys": dist,
                    "counted_lanes": counted, "cells": cells,
                    "plan": launch_plan(n, D, W)._asdict(), "max_abs_err": err,
                    "ms": _time_ms(torch, sketch_scatter, base, (r, c, cnt), KERNEL_REPS),
                    "plain_ms": _time_ms(torch, sketch_scatter_ref, base, (r, c, cnt),
                                         KERNEL_REPS),
                    "library_ms": _time_ms(torch, library, base, (), KERNEL_REPS),
                    "bound_ms": coords_bytes / H100_BYTES_PER_S * 1e3,
                    "absorb_ms": _time_ms(torch, sketch_absorb, base, (src, dst, cnt),
                                          KERNEL_REPS),
                    "absorb_plain_ms": _time_ms(torch, sketch_absorb_ref, base,
                                                (src, dst, cnt), KERNEL_REPS),
                    "absorb_bound_ms": keys_bytes / H100_BYTES_PER_S * 1e3,
                    "launch_floor_ms": floor_ms,
                })
                print("sketch", json.dumps(rows[-1]), flush=True)
    # corner cases, each under every plan and through both entries
    corners = 0
    for label, D, W, n, dist in (("one lane", 4, 512, 1, "uniform"),
                                 ("all lanes invalid", 4, 512, 512, "zipf"),
                                 ("W=1,000", 4, 1_000, 2_048, "zipf"),
                                 ("W=1,000 hub", 4, 1_000, 512, "hub"),
                                 ("bit 63 on every key", 4, 512, 512, "uniform")):
        base, src, dst, cnt = sketch_batch(torch, dev, rng, D, W, n, dist)
        if label == "one lane":
            src.zero_()  # key 0, counted
            cnt.fill_(3)
        if label == "all lanes invalid":
            cnt.zero_()
        if label == "bit 63 on every key":
            src |= -(1 << 63)
            dst |= -(1 << 63)
            src[:2] = -1  # the all-ones key
        sketch_hold(torch, label, base, src, dst, cnt)
        corners += 1
    kernels = _kernels_a_call(*SKETCH_UPDATE_CALL, SKETCH_UPDATE_LANES)
    print("sketch_update device kernels a call (fresh process): " + json.dumps(kernels),
          flush=True)
    print("K3 (sketch_scatter and sketch_absorb) == plain bit for bit (tolerance 0) at all "
          f"{len(rows)} shapes and {corners} corner cases, under every plan", flush=True)
    return rows, kernels


def query_path(torch):
    """Phase 6: the query CLI in live mode at the default deployment."""
    from repro_torch.kernels import build
    from repro_torch.launch import query

    build.launches.clear()
    t0 = time.perf_counter()
    with k3_lanes() as hist:
        out = query.run(QUERY_ARGV)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(build.launches)
    qsink = out.pipe.sink
    commits = [c for c in qsink.ingestor.commits if c.ok]
    if not commits or qsink.commits != len(commits):
        raise AssertionError(f"QuerySink absorbed {qsink.commits} of {len(commits)} commits")
    if launches.get("sketch_scatter", 0) < qsink.commits:
        raise AssertionError(f"expected a sketch_scatter launch per absorbed commit: "
                             f"{launches} for {qsink.commits} commits")
    if launches.get("fused_upsert", 0) != 2 * len(commits):
        raise AssertionError(f"expected 2 upsert launches per commit: "
                             f"{launches} for {len(commits)} commits")
    snap, m = out.snapshot, qsink.maintainer
    if not (out.code == 0 and int(snap.n_edges) > 0 and len(out.exact_w) > 0
            and (out.est_w >= out.exact_w).all()):
        raise AssertionError(f"query path: sketch below exact weight or empty snapshot: "
                             f"{list(zip(out.exact_w.tolist(), out.est_w.tolist()))}")
    print(f"query path: ticks={MAIN_TICKS} commits={len(commits)} "
          f"wall_ms_per_tick={wall_s * 1e3 / MAIN_TICKS} "
          f"run_wall_ms_per_tick={out.report.wall_s * 1e3 / MAIN_TICKS} "
          f"snapshot_serve_ms={out.serve_ms} full_builds={m.full_builds} "
          f"delta_applies={m.delta_applies} "
          f"filter_sketch_updates={launches['sketch_scatter'] - qsink.commits} "
          f"launches={launches}", flush=True)
    print("query path K3 lanes: " + json.dumps(dict(sorted(hist.items()))), flush=True)
    return launches


def query_breakdown(torch):
    """Phase 7: where a tick of the query path goes (phase 6's run, cut
    to its first PROFILED_TICKS ticks, with spans on and under
    torch.profiler), and K3's device ms."""
    from repro_torch.launch import query
    from repro_torch.telemetry.spans import TelemetryRegistry

    reg = TelemetryRegistry(enabled=True)
    argv = QUERY_ARGV[:]
    argv[argv.index("--ticks") + 1] = str(PROFILED_TICKS)
    device = _profiled(torch, "query breakdown", reg, lambda: query.run(argv, telemetry=reg),
                       ticks=PROFILED_TICKS)
    kernel_device("query breakdown", "K3", "sketch_scatter", device)


def query_cuda_vs_cpu(torch):
    """Phase 8: the uncontrolled query loop on the card and on the host:
    equal stores, sketches, snapshots and answers."""
    from repro_torch import convert
    from repro_torch.api import PipelineBuilder
    from repro_torch.configs.paper_ingest import IngestConfig
    from repro_torch.ingest.sources import BurstyTweetSource
    from repro_torch.query import (
        degree_distribution, edge_lookup, k_hop, top_k_degree, triangle_count)

    def numpy(x):
        return x.cpu().numpy()

    runs = {}
    for device in ("cuda", "cpu"):
        events = []
        cfg = IngestConfig(store_nodes=1 << 12, store_edges=1 << 14)
        b = (PipelineBuilder(cfg, device=device).with_source(BurstyTweetSource(seed=0))
             .uncontrolled().with_sketch(width=512).with_query_sink(width=512, exact_topk=3)
             .on_event(lambda ev: events.append(ev.payload) if ev.kind == "sketch" else None))
        pipe = b.build()
        pipe.run(max_ticks=40)
        snap = pipe.sink.snapshot()
        m = pipe.sink.maintainer
        live = snap.edge_row < snap.node_cap
        s_keys = snap.node_key[snap.edge_row[live].long()]
        d_keys = snap.node_key[snap.edge_col[live].long()]
        top_keys, top_degs = top_k_degree(snap, 10)
        arrays = {
            **{f"store.{k}": v for k, v in convert.store_to_numpy(pipe.store).items()},
            **{f"filter_sketch.{k}": v
               for k, v in convert.sketch_to_numpy(b.sketch_stage.sketch).items()},
            **{f"commit_sketch.{k}": v
               for k, v in convert.sketch_to_numpy(pipe.sink.sketch).items()},
            **{f"snapshot.{k}": v for k, v in convert.snapshot_to_numpy(snap).items()},
            "degree_distribution": numpy(degree_distribution(snap)),
            "top_k_degree.keys": numpy(top_keys), "top_k_degree.degrees": numpy(top_degs),
            "edge_lookup": numpy(edge_lookup(snap, s_keys, d_keys)),
        }
        for hops in (1, 2, 3):
            for directed in (False, True):
                arrays[f"k_hop.{hops}.{directed}"] = numpy(
                    k_hop(snap, top_keys[:2], hops=hops, directed=directed))
        scalars = {"triangles": triangle_count(snap), "full_builds": m.full_builds,
                   "delta_applies": m.delta_applies, "commits": pipe.sink.commits,
                   "live_edges": int(live.sum()), "events": events}
        runs[device] = arrays, scalars
    (ag, sg), (ac, sc) = runs["cuda"], runs["cpu"]
    for name in ag:
        if not np.array_equal(ag[name], ac[name]):
            raise AssertionError(f"cuda and cpu query loops differ in {name}")
    if sg != sc:
        raise AssertionError(f"cuda and cpu query loops differ: {sg} vs {sc}")
    if not (sg["delta_applies"] > 0 and sg["live_edges"] > 0 and sg["events"]):
        raise AssertionError(f"query loop did not exercise the path: {sg}")
    print("cuda vs cpu query loop equal: " + json.dumps(
        {k: v for k, v in sg.items() if k != "events"} | {"sketch_events": len(sg["events"])}),
        flush=True)


def _traffic_bound(n):
    """(least ms, what bounds it) for one traffic_ids block: 5 x 4 bytes
    written per record and 36 bytes of parameters read, against about 36
    float32 operations per record (the three Zipf ranks with pow counted
    as one operation, the uniforms, the hot-tag and cascade products)."""
    bytes_s = (20 * n + 36) / H100_BYTES_PER_S
    ops_s = 36 * n / H100_FP32_PER_S
    return max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations"


def traffic_plans(n):
    """Every plan of K4's kernel at n records: each CTA width of
    TRAFFIC_THREADS with each of TRAFFIC_RECORDS records a thread, and the
    planned one."""
    from repro_torch.kernels import sampler as SA

    plans = [SA.Plan(-(-n // (t * r)), t, r) for t in TRAFFIC_THREADS for r in TRAFFIC_RECORDS]
    return plans + [p for p in [SA.launch_plan(n)] if p not in plans]


def traffic_hold(torch, label, args):
    """Holds K4 to its plain version bit for bit (tolerance 0), through
    the wrapper and under every plan of `traffic_plans`; returns the
    largest error."""
    from repro_torch.kernels import sampler as SA

    want = SA.traffic_ids_ref(*args)
    worst = 0.0
    for plan in [None] + traffic_plans(args[2]):
        got = SA.traffic_ids(*args) if plan is None else SA.launch(*args, plan)
        torch.cuda.synchronize()
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        worst = max(worst, err)
        if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"traffic_ids kernel != plain at {label} under "
                                 f"{plan or 'the wrapper'}: max_abs_err={err}")
    return worst


def traffic_vs_plain(torch, dev):
    """Phase 9: K4 against its plain version, bit for bit under every
    plan, at every scenario, burst level, size, seed and corner; the
    planned kernel timed beside the plain version, its bound and an
    empty launch."""
    from repro_torch.kernels.sampler import launch, launch_plan, traffic_ids, traffic_ids_ref
    from repro_torch.workloads.scenarios import get_scenario, list_scenarios

    floor_ms = _time_ms(torch, lambda: torch.cuda._sleep(0), (), (), KERNEL_REPS)
    print(f"traffic: an empty launch (torch.cuda._sleep(0)) takes {floor_ms} ms", flush=True)
    rows = []
    for scn in list_scenarios():
        ip = torch.from_numpy(scn.iparams()).to(dev)
        for burst in (0.0, 1.0):
            fp = torch.from_numpy(scn.fparams(burst)).to(dev)
            for n in TRAFFIC_LANES:
                for seed, ctr0 in TRAFFIC_SEEDS:
                    args = (seed, ctr0, n, ip, fp)
                    err = traffic_hold(torch, f"{scn.name} burst={burst} n={n} seed={seed} "
                                       f"ctr0={ctr0}", args)
                    row = {"scenario": scn.name, "burst": burst, "lanes": n, "seed": seed,
                           "ctr0": ctr0, "max_abs_err": err}
                    if (seed, ctr0) == TRAFFIC_SEEDS[0]:
                        bound_ms, bound_by = _traffic_bound(n)
                        row.update(plan=launch_plan(n)._asdict(),
                                   ms=_time_ms(torch, traffic_ids, (), args, KERNEL_REPS),
                                   plain_ms=_time_ms(torch, traffic_ids_ref, (), args,
                                                     PLAIN_REPS),
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   launch_floor_ms=floor_ms)
                    rows.append(row)
                    print("traffic", json.dumps(row), flush=True)
    scn = get_scenario("flash_crowd")
    corners = 0
    for n in TRAFFIC_SMALL:
        for seed, ctr0 in TRAFFIC_SEEDS:
            args = (seed, ctr0, n, torch.from_numpy(scn.iparams()).to(dev),
                    torch.from_numpy(scn.fparams(1.0)).to(dev))
            traffic_hold(torch, f"flash_crowd n={n} seed={seed} ctr0={ctr0}", args)
            corners += 1
    for label, kind, k, value in TRAFFIC_CORNERS:
        ip, fp = scn.iparams(), scn.fparams(0.5)
        (ip if kind == "i" else fp)[k] = value
        for n in TRAFFIC_LANES:
            traffic_hold(torch, f"{label} n={n}", (1, 0, n, torch.from_numpy(ip).to(dev),
                                                   torch.from_numpy(fp).to(dev)))
            corners += 1
    # the launcher refuses a grid with a CTA past the last record (its
    # record indices would leave int range on a large enough grid)
    n = TRAFFIC_LANES[0]
    plan = launch_plan(n)._replace(ctas=launch_plan(n).ctas + 1)
    try:
        launch(0, 0, n, torch.from_numpy(scn.iparams()).to(dev),
               torch.from_numpy(scn.fparams(1.0)).to(dev), plan)
    except RuntimeError:
        pass
    else:
        raise AssertionError(f"traffic_ids launched under {plan}, which has an empty CTA")
    print("traffic_ids kernel == plain bit for bit (tolerance 0) at all "
          f"{len(rows)} shapes and {corners} small sizes and corner cases, under every plan "
          f"({len(traffic_plans(TRAFFIC_LANES[0]))} at {TRAFFIC_LANES[0]} records)", flush=True)
    return rows


def workload_path(torch):
    """Phase 10: the workload CLI at its default deployment with
    --dict-compress."""
    from repro_torch.kernels import build
    from repro_torch.launch import workload

    seen = {"ticks_with_records": 0, "encodes": 0, "commits": 0}

    def count(ev):
        if ev.kind == "tick" and ev.payload["raw"] > 0:
            seen["ticks_with_records"] += 1
        elif ev.kind in ("commit", "commit-failed"):
            seen["encodes"] += 1
            seen["commits"] += ev.kind == "commit"

    build.launches.clear()
    t0 = time.perf_counter()
    code, rep = workload.run(WORKLOAD_ARGV, on_event=count)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(build.launches)
    want = {"pattern_mine": seen["encodes"],
            "fused_upsert": 3 * seen["commits"]}  # 2 store sweeps + 1 dictionary admit
    # one sampled block per tick with records; the loop also reads the
    # tick after its last, as the reference's does, which may add one
    extra = launches.get("traffic_ids", 0) - seen["ticks_with_records"]
    if code != 0 or extra not in (0, 1) or any(launches.get(k, 0) != v
                                               for k, v in want.items()):
        raise AssertionError(f"workload path launches {launches}, expected {want} and "
                             f"{seen['ticks_with_records']} or one more traffic_ids")
    if not (rep.total_records > 0 and rep.pattern_refs > 0 and np.isfinite(rep.mu_mean)
            and rep.store_nodes > 0 and rep.store_edges > 0):
        raise AssertionError(f"workload path produced no references or no result: "
                             f"{rep.summary()}")
    print(f"workload path: ticks={rep.ticks} records={rep.total_records} "
          f"commits={seen['commits']} wall_s={wall_s} "
          f"records_per_wall_s={rep.total_records / wall_s} "
          f"run_records_per_wall_s={rep.records_per_wall_s} "
          f"wall_ms_per_tick={wall_s * 1e3 / rep.ticks} "
          f"commit_ms_mean={rep.commit_ms_mean} pattern_refs={rep.pattern_refs} "
          f"dict_hit_rate={rep.dict_hit_rate} launches={launches}", flush=True)
    return launches


def workload_breakdown(torch):
    """Phase 11: where a tick of the workload path goes.  Phase 10's
    deployment from `run_scenario`'s own builder, with spans on and
    under torch.profiler; keeps the largest batch the miner saw (a
    reference, no copy), counts the batches of each edge-table size and
    prints K4's device ms.  Returns (the batch, K4's device summary)."""
    from repro_torch.api import MetricsHub
    from repro_torch.telemetry.spans import TelemetryRegistry
    from repro_torch.workloads import get_scenario, scenario_builder

    scn = get_scenario("flash_crowd")
    reg = TelemetryRegistry(enabled=True)
    b, _, _ = scenario_builder(scn, dict_compress=True, device="cuda")
    pipe = b.with_metrics(MetricsHub(telemetry=reg)).build()
    pipe.transform.telemetry = reg
    pipe.sink.ingestor.telemetry = reg
    dstage = b.dictionary_stage
    rewrite = dstage.rewrite
    sizes = {}
    kept = {"et": None}

    def keep_largest(et):
        n = et.src.shape[0]
        sizes[n] = sizes.get(n, 0) + 1
        if kept["et"] is None or n > kept["et"].src.shape[0]:
            kept["et"] = et
        return rewrite(et)

    dstage.rewrite = keep_largest
    with k4_lanes() as hist:
        device = _profiled(torch, "workload breakdown", reg,
                           lambda: pipe.run(max_ticks=scn.ticks), ticks=scn.ticks)
    k4 = kernel_device("workload breakdown", "K4", "traffic_ids", device, hist)
    print("workload mined batches by edge-table size:",
          json.dumps({str(n): c for n, c in sorted(sizes.items())}), flush=True)
    et = kept["et"]
    return (et.src, et.dst, et.etype, et.count, et.edge_valid, dstage.star_min,
            dstage.hot_min), k4


def _mine_batch(torch, rng, n, kind):
    """A batch for the miner: random ids with ~20% invalid lanes; the
    same with star bursts, cascade chains and hot edges planted
    ("patterned"); one (src, etype) hub owning every lane, all valid
    ("hub"); ids 0, 2^64 - 1 and others on both sides of the packing
    limit with one invalid lane ("extremes") or none; all lanes invalid
    or all valid."""
    pool = np.unique(rng.integers(1, 2**64 - 1, size=max(n // 2, 8), dtype=np.uint64))
    pool[: pool.size // 2] >>= np.uint64(40)  # half packed, half hashed keys
    src, dst = pool[rng.integers(0, pool.size, n)], pool[rng.integers(0, pool.size, n)]
    et = rng.integers(0, 3, n).astype(np.int32)
    count = rng.integers(1, 3, n).astype(np.int32)
    valid = rng.random(n) >= 0.2
    if kind == "hub":
        src[:], et[:], valid[:] = src[0], 1, True
        dst[rng.random(n) < 0.1] = src[0]
    elif kind.startswith("extremes"):
        ids = np.array([0, 2**64 - 1, 1, 2**63, (1 << 27) - 1, 1 << 27], dtype=np.uint64)
        src, dst = ids[rng.integers(0, ids.size, n)], ids[rng.integers(0, ids.size, n)]
        valid[:] = True
        if kind == "extremes":
            valid[rng.integers(0, n)] = False
    elif kind in ("all_invalid", "all_valid"):
        valid[:] = kind == "all_valid"
    elif kind == "patterned":
        lanes = iter(rng.permutation(n))
        for _ in range(n // 32):
            hub, e = pool[rng.integers(pool.size)], rng.integers(3)
            for _ in range(5):  # a star, out or in
                i = next(lanes)
                if rng.random() < 0.5:
                    src[i] = hub
                else:
                    dst[i] = hub
                et[i], valid[i] = e, True
            chain = pool[rng.integers(0, pool.size, 3)]
            for a, b in zip(chain, chain[1:]):
                i = next(lanes)
                src[i], dst[i], valid[i] = a, b, True
            i = next(lanes)
            count[i], valid[i] = 4, True
    return tuple(torch.from_numpy(x) for x in (src.view(np.int64), dst.view(np.int64), et,
                                               count, valid))


def mine_vs_plain(torch, dev, real_batch):
    """Phase 12: the pattern miner (K5) against its plain version, bit
    for bit, at every size and kind and on phase 11's batch; timed on
    the MINE_TIMED kinds and phase 11's batch, with the device kernels
    of one call at each size."""
    from repro_torch.kernels.pattern_mine import cluster_plan, pattern_mine, pattern_mine_ref

    rng = np.random.default_rng(2)
    cases = [(kind, tuple(t.to(dev) for t in _mine_batch(torch, rng, n, kind)) + (4, 2))
             for n in MINE_LANES for kind in MINE_KINDS]
    cases.append(("path", real_batch))
    kernels_a_call = _kernels_a_call(
        "PM.pattern_mine", "tuple(t.cuda() for t in cs._mine_batch(torch, "
        "np.random.default_rng(2), n, 'random')) + (4, 2)",
        sorted(set(MINE_LANES) | {real_batch[0].shape[0]}))
    if any(k != 2 for k in kernels_a_call.values()):
        raise AssertionError(f"pattern_mine: expected 2 device kernels a call: {kernels_a_call}")
    rows = []
    for kind, args in cases:
        got, want = pattern_mine(*args), pattern_mine_ref(*args)
        torch.cuda.synchronize()
        err = max(int((g - w).abs().max()) for g, w in zip(got[:3], want[:3]))
        err = max(err, int((got[3] != want[3]).sum()))
        if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"pattern_mine kernel != plain: {kind} n={args[0].shape[0]} "
                                 f"max_abs_err={err}")
        n = args[0].shape[0]
        row = {"batch": kind, "lanes": n, "valid": int(args[4].sum()),
               "flagged": int((want[2] != 0).sum()), "max_abs_err": err}
        if kind in MINE_TIMED or kind == "path":
            nbytes = 45 * n  # src, dst 8 B, etype, count 4 B, valid 1 B read; 3 x 4 + 8 B written
            row.update(ms=_time_ms(torch, pattern_mine, (), args, KERNEL_REPS),
                       plain_ms=_time_ms(torch, pattern_mine_ref, (), args, PLAIN_REPS),
                       bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes",
                       ctas_a_vector=cluster_plan(n), device_kernels=kernels_a_call[n])
        rows.append(row)
        print("mine", json.dumps(row), flush=True)
    print("pattern_mine kernel == plain bit for bit (tolerance 0) at all "
          f"{len(rows)} batches; device kernels a call {json.dumps(kernels_a_call)}", flush=True)
    return rows


def _stream(device, ticks):
    from repro_torch.workloads import ScenarioSource

    src = ScenarioSource("flash_crowd", seed=0, device=device)
    return [(t.t, t.records) for t, _ in zip(src.ticks(), range(ticks))]


def _replay_loop(device, stream, compress):
    """The uncontrolled loop with the harness's consumer on `stream`."""
    from repro_torch.api import PipelineBuilder
    from repro_torch.configs.paper_ingest import IngestConfig
    from repro_torch.ingest.sources import StreamTick

    b = (PipelineBuilder(IngestConfig(store_nodes=1 << 12, store_edges=1 << 14),
                         device=device)
         .simulated_consumer(speed=0.5).uncontrolled())
    if compress:
        b = b.with_compression(capacity=4096)
    pipe = b.build()
    rep = pipe.run((StreamTick(t, copy.deepcopy(r)) for t, r in stream), max_ticks=len(stream))
    return pipe, rep, b.dictionary_stage


def workload_cuda_vs_cpu(torch):
    """Phase 13: the workload path on the card against the host."""
    from repro_torch import convert
    from repro_torch.kernels.sampler import traffic_ids, traffic_ids_ref
    from repro_torch.workloads import rate_trajectory
    from repro_torch.workloads.scenarios import get_scenario

    scn = get_scenario("flash_crowd")
    ip = {d: torch.from_numpy(scn.iparams()).to(d) for d in ("cuda", "cpu")}
    lanes = differ = 0
    for burst in (0.0, 0.5, 1.0):
        fp = {d: torch.from_numpy(scn.fparams(burst)).to(d) for d in ("cuda", "cpu")}
        for block in range(DRYRUN_TICKS):
            ctr0 = (block * 2048 * 8) & 0xFFFFFFFF
            g = traffic_ids(0, ctr0, 2048, ip["cuda"], fp["cuda"])
            w = traffic_ids_ref(0, ctr0, 2048, ip["cpu"], fp["cpu"])
            differ += sum(int((a.cpu() != b).sum()) for a, b in zip(g, w))
            lanes += 2048
    base = scn.base_rate
    args = (0, DRYRUN_TICKS, 0, 0.0, base, scn.noise_frac, scn.hawkes_alpha, scn.hawkes_beta,
            scn.diurnal_amp, scn.diurnal_period, scn.flash_t, scn.flash_mult,
            scn.flash_decay, scn.rate_cap_mult * base)
    rc, rh = rate_trajectory(*args, device="cuda"), rate_trajectory(*args, device="cpu")
    tick_counts_differ = int((rc.counts.cpu() != rh.counts).sum())
    rate_rel = float(((rc.rates.cpu() - rh.rates).abs() / rh.rates.clamp(min=1e-30)).max())
    streams = {d: _stream(d, DRYRUN_TICKS) for d in ("cuda", "cpu")}
    records_differ = sum(a != b for (_, ra), (_, rb) in zip(streams["cuda"], streams["cpu"])
                         for a, b in zip(ra, rb))
    print(f"cuda vs cpu sampling: lanes_differ={differ} of {lanes} "
          f"tick_counts_differ={tick_counts_differ} rate_max_rel_diff={rate_rel} "
          f"records_differ={records_differ}", flush=True)

    # one shared record stream (the card's), uncontrolled, on both devices
    stream = streams["cuda"]
    runs = {}
    for device in ("cuda", "cpu"):
        pipe, rep, dstage = _replay_loop(device, stream, compress=True)
        ing = pipe.sink.ingestor
        runs[device] = (
            convert.store_to_numpy(pipe.store), convert.dictionary_to_numpy(dstage.dct),
            {"records": rep.total_records, "instructions": rep.total_instructions,
             "raw": rep.raw_instructions, "commits": len(ing.commits),
             "dropped": sum(c.dropped for c in ing.commits),
             "refs": sum(c.refs for c in ing.commits), "dict": dstage.stats()},
            rep.compression_ratios, rep.samples["mu"])
    (sg, dg, cg, crg, mug), (sc, dc, cc, crc, muc) = runs["cuda"], runs["cpu"]
    for name in sg:
        if not np.array_equal(sg[name], sc[name]):
            raise AssertionError(f"cuda and cpu stores differ in {name}")
    for name in dg:
        if not np.array_equal(dg[name], dc[name]):
            raise AssertionError(f"cuda and cpu dictionaries differ in {name}")
    if cg != cc or not np.array_equal(crg, crc) or not np.array_equal(mug, muc):
        raise AssertionError(f"cuda and cpu reports differ: {cg} vs {cc}")
    if cg["refs"] == 0:
        raise AssertionError(f"the shared stream made no references: {cg}")
    raw_pipe, _, _ = _replay_loop("cuda", stream, compress=False)
    raw = convert.store_to_numpy(raw_pipe.store)
    for name in raw:
        if raw[name].tobytes() != sg[name].tobytes():
            raise AssertionError(f"raw and compressed stores differ in {name}")
    print("cuda vs cpu workload loop (uncontrolled, --dict-compress, one shared stream) "
          f"equal, raw == compressed store on the card: {json.dumps(cg)}", flush=True)


def _dedup_keys(rng, n, kind):
    """n uint32 keys (as int64) of one kind; the random kinds hold 0xFFFFFFFF."""
    if kind == "equal":
        return np.full(n, 123_456_789, np.int64)
    if kind in ("sorted", "reversed"):
        keys = np.sort(rng.integers(0, n, size=n))
        return keys if kind == "sorted" else keys[::-1].copy()
    keys = rng.integers(0, {"5": 5, "n/4": n // 4, "2^31": 2**31}[kind], size=n)
    keys[rng.integers(0, n, size=max(n // 16, 1))] = 2**32 - 1
    return keys


def _dedup_bound(n):
    """(least ms, what bounds it) for one sort_dedup call: 16 bytes a
    lane, what the function's uint32 data needs (key read; key, int32
    position and head written; the port's int64 carrier for the keys is
    not counted) against the network's compare-exchanges,
    log2(n)(log2(n)+1)/2 stages of n/2 each, one operation apiece at the
    float32 peak."""
    stages = n.bit_length() * (n.bit_length() - 1) // 2
    bytes_s = 16 * n / H100_BYTES_PER_S
    ops_s = stages * (n // 2) / H100_FP32_PER_S
    return max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations"


def _device_kernels(torch, fn, args):
    """The device kernels one call of `fn(*args)` runs, counted by
    torch.profiler (after one call outside the window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def _kernels_a_call(fn, args, sizes):
    """{n: device kernels of one call of `fn(*args)`}, counted by
    `_device_kernels` in a fresh process (`fn` and `args` are Python
    expressions there, `args` of n, with `cs` this module, `ops`, `PM`
    and `QS` the kernel, pattern-miner and sketch modules).  In this
    process, after the profiled phases, a window of one call read no
    device event at all (where a fresh process reads every kernel the
    call launches); the launches depend on n alone, not on the data."""
    code = ("import json, sys, torch; import numpy as np; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke as cs; "
            "from repro_torch.kernels import ops, pattern_mine as PM; "
            "from repro_torch.query import sketch as QS; "
            f"print(json.dumps({{n: cs._device_kernels(torch, {fn}, {args}) "
            "for n in map(int, sys.argv[2:])}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), *map(str, sizes)],
                         check=True, capture_output=True, text=True).stdout
    return {int(n): count for n, count in json.loads(out.strip().splitlines()[-1]).items()}


def dedup_vs_plain(torch, dev):
    """Phase 14: the kernel-ops entry point's sort_dedup (K2) at every
    shape, with the launch counters set to 0 just before and read just
    after; each result held bit for bit against the plain version, and
    dedup_sorted_counts equal on both; then the kernel, the plain version
    and torch.sort (the library yardstick) timed, with the device kernels
    of one call and the launches its plan makes."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.edge_dedup import launch_plan, resident_clusters, sort_dedup_plain

    rng = np.random.default_rng(3)
    inputs = [(n, kind, torch.from_numpy(_dedup_keys(rng, n, kind)).to(dev))
              for n in DEDUP_LANES for kind in DEDUP_KINDS]
    build.launches.clear()
    outs = []
    for _, _, keys in inputs:
        got = ops.sort_dedup(keys)
        outs.append((got, ops.dedup_sorted_counts(got[0], got[2])))
    torch.cuda.synchronize()
    launches = dict(build.launches)
    if launches.get("sort_dedup", 0) != len(inputs):
        raise AssertionError(f"expected one sort_dedup launch per call: {launches}")
    kernels_a_call = _kernels_a_call("ops.sort_dedup",
                                     "(torch.arange(n, device='cuda') % 1009,)", DEDUP_LANES)
    rows = []
    for (n, kind, keys), (got, got_counts) in zip(inputs, outs):
        want = sort_dedup_plain(keys)
        want_counts = ops.dedup_sorted_counts(want[0], want[2])
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        if err != 0 or not all(torch.equal(g, w) for g, w in zip(got + got_counts,
                                                                 want + want_counts)):
            raise AssertionError(f"sort_dedup kernel != plain: n={n} {kind} max_abs_err={err}")
        if not torch.equal(keys[got[1].long()], got[0]):
            raise AssertionError(f"sort_dedup order does not sort the keys: n={n} {kind}")
        row = {"lanes": n, "keys": kind, "runs": int(got_counts[1]), "max_abs_err": err}
        if kind == "n/4":
            bound_ms, bound_by = _dedup_bound(n)
            row.update(ms=_time_ms(torch, ops.sort_dedup, (), (keys,), KERNEL_REPS),
                       plain_ms=_time_ms(torch, sort_dedup_plain, (), (keys,), PLAIN_REPS),
                       library_ms=_time_ms(torch, lambda k: torch.sort(k), (), (keys,),
                                           KERNEL_REPS),
                       bound_ms=bound_ms, bound_by=bound_by,
                       device_kernels=kernels_a_call[n],
                       planned_launches=len(launch_plan(n, keys.device)))
        rows.append(row)
        print("dedup", json.dumps(row), flush=True)
    print("sort_dedup kernel == plain bit for bit (tolerance 0), dedup_sorted_counts equal, "
          f"at all {len(rows)} shapes; library_ms is torch.sort, whose tie order differs "
          f"(a yardstick of time only); {resident_clusters(dev)} clusters of 16 CTAs "
          "fit on the card at once, one CTA to an SM", flush=True)
    return rows, launches


def _bloom_filter(torch, dev, rng, rows):
    """A filter already in use: a few bits set in each word."""
    from repro_torch.kernels.bloom import LANES

    return torch.from_numpy((rng.integers(0, 2**32, size=(rows, LANES), dtype=np.uint32)
                             & np.uint32(0x00100001)).view(np.int32)).to(dev)


def _bloom_zipf(rng, pool, n):
    """n Zipf (a = ZIPF_A) draws from `pool`."""
    return pool[np.minimum(rng.zipf(ZIPF_A, size=n), pool.size) - 1]


def bloom_hold(torch, label, keys, start, queries=None):
    """Holds K6a, K6b and the fused entry to the plain versions bit for
    bit (tolerance 0) under every plan of the sweep and `launch_plan`'s
    (`bloom.build_plans`, `bloom.probe_plans`): the build, the fused
    entry's bitmap and its float32 hits against `start` (on the grid
    route, the only one it takes), the probe of
    `queries` (default the keys) against the built filter; no false
    negatives and `start` unchanged.  Returns the largest error."""
    from repro_torch.kernels import bloom as BL

    rows, n = start.shape[0], keys.shape[0]
    before = start.clone()
    queries = keys if queries is None else queries
    want_b = BL.bloom_build_plain(keys, start)
    want_fh = BL.bloom_probe_plain(keys, start).to(torch.float32)
    want_hit = BL.bloom_probe_plain(queries, want_b)
    worst = 0
    for plan in BL.build_plans(rows, n):
        b = BL.launch("bloom_build", keys, start, plan)
        torch.cuda.synchronize()
        err = int((b != want_b).sum())
        worst = max(worst, err)
        if err or not torch.equal(b, want_b):
            raise AssertionError(f"bloom build != plain at {label} under {plan}: "
                                 f"max_abs_err={err}")
    for plan in BL.build_plans(rows, n, fused=True):
        fh, fb = BL.launch("bloom_diversity", keys, start, plan)
        torch.cuda.synchronize()
        err = max(int((fb != want_b).sum()), float((fh - want_fh).abs().max()))
        worst = max(worst, err)
        if err or not (torch.equal(fb, want_b) and torch.equal(fh, want_fh)):
            raise AssertionError(f"bloom_diversity != plain at {label} under {plan}: "
                                 f"max_abs_err={err}")
    for plan in BL.probe_plans(rows, n):
        hit = BL.launch("bloom_probe", queries, want_b, plan)
        if not torch.equal(hit, want_hit):
            raise AssertionError(f"bloom probe != plain at {label} under {plan}")
        if not bool((BL.launch("bloom_probe", keys, want_b, plan) == 1).all()):
            raise AssertionError(f"bloom false negative at {label} under {plan}")
    if not torch.equal(start, before):
        raise AssertionError(f"a Bloom entry changed its input bitmap at {label}")
    return worst


def _bloom_bounds(torch, keys, queries, rows):
    """(probe, build, diversity step) least ms, all bytes: the uint32
    keys (4 B each, not the port's int64 carrier) read; a probe reads the
    distinct words it tests and writes its int32 hits, a build reads the
    bitmap and writes its new copy, a diversity step does the build and
    writes a float32 hit a key."""
    from repro_torch.kernels.bloom import LANES, _bit_coords

    n, words = keys.shape[0], rows * LANES
    touched = int(torch.unique(torch.cat([_bit_coords(queries, r, words)[0]
                                          for r in range(4)])).numel())
    probe, build = 4 * n + 4 * touched + 4 * n, 4 * n + 2 * 4 * words
    return [b / H100_BYTES_PER_S * 1e3 for b in (probe, build, build + 4 * n)]


def bloom_vs_plain(torch, dev):
    """Phase 15: the kernel-ops entry point's Bloom ops (K6a probe, K6b
    build) at every shape and bloom_diversity (one launch of the fused
    entry a step) over successive Zipf batches into one filter, with the
    launch counters set to 0 just before and read just after; each
    result and every step held bit for bit against the plain versions;
    then every entry held under every plan at every shape and at corners
    (rows 1, 3, 48; 1, 33, 2,049 keys; one hub key in all lanes; keys 0
    and 2^32 - 1), a plan with an empty CTA refused; then the planned
    kernels, the plain versions, an empty launch and a diversity step
    timed, with the device kernels of one step."""
    from repro_torch.kernels import bloom as BL
    from repro_torch.kernels import build, ops

    rng = np.random.default_rng(4)
    cases = []
    for rows in BLOOM_ROWS:
        for n in BLOOM_LANES:
            start = _bloom_filter(torch, dev, rng, rows)
            keys = torch.from_numpy(rng.integers(0, 2**32, size=n)).to(dev)
            queries = torch.cat([keys[: n // 2],
                                 torch.from_numpy(rng.integers(0, 2**32, size=n // 2)).to(dev)])
            cases.append((rows, n, start, keys, queries))
    pool = rng.integers(0, 2**32, size=1 << 18)
    batches = [torch.from_numpy(_bloom_zipf(rng, pool, BLOOM_LANES[-1])).to(dev)
               for _ in range(DIVERSITY_STEPS)]

    build.launches.clear()
    built = [ops.bloom_build(keys, start) for _, _, start, keys, _ in cases]
    hits = [ops.bloom_probe(q, b) for (_, _, _, _, q), b in zip(cases, built)]
    bm = BL.init_bitmap(DIVERSITY_ROWS, device=dev)
    steps = []
    for batch in batches:
        rho, new_bm = ops.bloom_diversity(batch, bm)
        steps.append((bm, rho, new_bm))
        bm = new_bm
    torch.cuda.synchronize()
    launches = dict(build.launches)
    want = {"bloom_build": len(cases), "bloom_probe": len(cases),
            "bloom_diversity": DIVERSITY_STEPS}
    if launches != want:
        raise AssertionError(f"expected Bloom launches {want}, got {launches}")

    for (rows, n, start, keys, queries), b, hit in zip(cases, built, hits):
        want_b = BL.bloom_build_plain(keys, start)
        want_hit = BL.bloom_probe_plain(queries, want_b)
        if not (torch.equal(b, want_b) and torch.equal(hit, want_hit)):
            raise AssertionError(f"bloom kernels != plain on the path: rows={rows} n={n}")
    for i, (bm_in, rho, new_bm) in enumerate(steps):
        before = bm_in.clone()
        hit = BL.bloom_probe_plain(batches[i], bm_in)
        want_rho = 1.0 - hit.to(torch.float32).mean()
        if not (torch.equal(rho, want_rho) and torch.equal(new_bm,
                                                         BL.bloom_build_plain(batches[i], bm_in))):
            raise AssertionError(f"bloom_diversity kernel != plain at step {i}")
        if not torch.equal(bm_in, before):
            raise AssertionError("bloom_diversity changed its input bitmap")
    rhos = [float(r) for _, r, _ in steps]
    print(f"bloom_diversity: {DIVERSITY_STEPS} Zipf batches of {BLOOM_LANES[-1]} into one "
          f"{DIVERSITY_ROWS}-row filter equal to plain on every step, one launch a step; rho "
          f"first {rhos[0]} last {rhos[-1]}", flush=True)

    worst = {(rows, n): bloom_hold(torch, f"rows={rows} n={n}", keys, start, queries)
             for rows, n, start, keys, queries in cases}
    # the diversity step's shape, on the filter of its 60th step
    worst[("step", BLOOM_LANES[-1])] = bloom_hold(torch, "diversity step 60", batches[60],
                                                  steps[60][0])
    corners = 0
    for rows in BLOOM_CORNER_ROWS:
        for n in BLOOM_SMALL:
            keys = rng.integers(0, 2**32, size=n)
            keys[: min(n, 2)] = [0, 2**32 - 1][: min(n, 2)]
            bloom_hold(torch, f"rows={rows} n={n}", torch.from_numpy(keys).to(dev),
                       _bloom_filter(torch, dev, rng, rows))
            corners += 1
    for rows in (2,) + BLOOM_CORNER_ROWS + (DIVERSITY_ROWS,):
        for label, keys in (("one hub key", np.full(BLOOM_LANES[-1], 0x9E3779B9)),
                            ("keys 0 and 2^32 - 1", np.tile([0, 2**32 - 1], 8))):
            bloom_hold(torch, f"{label} rows={rows}", torch.from_numpy(keys).to(dev),
                       _bloom_filter(torch, dev, rng, rows))
            corners += 1
    # the launcher refuses a probe grid with a CTA past the last key and
    # builds its kernels do not run
    keys, start = cases[0][3], cases[0][2]  # 64 keys, 2 rows
    own = BL.launch_plan(2, keys.shape[0])
    for entry, plan in (("bloom_probe", own._replace(probe_ctas=own.probe_ctas + 1)),
                        ("bloom_build", own._replace(route="striped", stripe=BL.MAX_STRIPE + 1)),
                        ("bloom_diversity", own._replace(route="grid", stripe=1)),
                        ("bloom_diversity", own._replace(route="striped", stripe=1)),
                        ("bloom_build", own._replace(threads=48))):
        try:
            BL.launch(entry, keys, start, plan)
        except RuntimeError:
            continue
        raise AssertionError(f"{entry} launched under {plan} on {start.shape[0]} rows")
    print("bloom_probe, bloom_build and bloom_diversity kernels == plain bit for bit "
          f"(tolerance 0) under every plan ({len(BL.build_plans(64, 16_384))} build, "
          f"{len(BL.build_plans(64, 16_384, fused=True))} fused, "
          f"{len(BL.probe_plans(64, 16_384))} probe at 64 rows) at all {len(cases)} shapes, "
          f"the diversity step and {corners} corners; no false negatives, inputs unchanged; "
          "a probe grid with an empty CTA, builds the kernels do not run and the fused entry "
          "off the grid route refused", flush=True)

    floor_ms = _time_ms(torch, lambda: torch.cuda._sleep(0), (), (), KERNEL_REPS)
    print(f"bloom: an empty launch (torch.cuda._sleep(0)) takes {floor_ms} ms", flush=True)
    out = []
    for (rows, n, start, keys, queries), b in zip(cases, built):
        probe_bound, build_bound, _ = _bloom_bounds(torch, keys, queries, rows)
        row = {"rows": rows, "lanes": n, "hit_share": float(BL.bloom_probe_plain(queries, b)
                                                            .float().mean()),
               "max_abs_err": worst[(rows, n)], "plan": BL.launch_plan(rows, n)._asdict(),
               "probe_ms": _time_ms(torch, ops.bloom_probe, (), (queries, b), KERNEL_REPS),
               "probe_plain_ms": _time_ms(torch, BL.bloom_probe_plain, (), (queries, b),
                                          PLAIN_REPS),
               "probe_bound_ms": probe_bound,
               "build_ms": _time_ms(torch, ops.bloom_build, (), (keys, start), KERNEL_REPS),
               "build_plain_ms": _time_ms(torch, BL.bloom_build_plain, (), (keys, start),
                                          PLAIN_REPS),
               "build_bound_ms": build_bound, "launch_floor_ms": floor_ms}
        out.append(row)
        print("bloom", json.dumps(row), flush=True)

    def plain_step(keys, bitmap):
        return (1.0 - BL.bloom_probe_plain(keys, bitmap).to(torch.float32).mean(),
                BL.bloom_build_plain(keys, bitmap))

    batch, bm_in = batches[60], steps[60][0]
    device_kernels = _kernels_a_call("ops.bloom_diversity", DIVERSITY_CALL_ARGS,
                                     [BLOOM_LANES[-1]])[BLOOM_LANES[-1]]
    step = {"rows": DIVERSITY_ROWS, "lanes": BLOOM_LANES[-1], "keys": "zipf",
            "plan": BL.launch_plan(DIVERSITY_ROWS, BLOOM_LANES[-1], fused=True)._asdict(),
            "step_ms": _time_ms(torch, ops.bloom_diversity, (), (batch, bm_in), KERNEL_REPS),
            "step_plain_ms": _time_ms(torch, plain_step, (), (batch, bm_in), PLAIN_REPS),
            "step_bound_ms": _bloom_bounds(torch, batch, batch, DIVERSITY_ROWS)[2],
            "device_kernels": device_kernels, "launch_floor_ms": floor_ms,
            "max_abs_err": worst[("step", BLOOM_LANES[-1])]}
    print("bloom_diversity step", json.dumps(step), flush=True)
    return out, launches, step


def sharded_path(torch):
    """Phase 16: the ingest CLI sharded with GraphZip at the default
    deployment, with the launch counters set to 0 just before and read
    just after."""
    from repro_torch.kernels import build
    from repro_torch.launch import ingest

    build.launches.clear()
    t0 = time.perf_counter()
    rep, pipe = ingest.main(SHARDED_ARGV)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(build.launches)
    counters = pipe.metrics.counters
    commits, encodes = counters["commit"], counters["commit"] + counters["commit-failed"]
    want = {"fused_upsert": 3 * commits,  # 2 store sweeps + 1 dictionary admit
            "pattern_mine": encodes}
    if not commits or any(launches.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"sharded path launches {launches}, expected {want}")
    mus = rep.mu_arrays()
    if not (rep.total_records == sum(r.total_records for r in rep.shards) > 0
            and all(len(m) and np.isfinite(m).all() for m in mus)
            and int(pipe.store.n_nodes) > 0 and int(pipe.store.n_edges) > 0):
        raise AssertionError("sharded path produced no finite, non-empty result")
    dstage = pipe.stages[0]
    print("sharded path: " + json.dumps({
        "ticks": MAIN_TICKS, "shards": len(rep.shards), "records": rep.total_records,
        "instructions": rep.total_instructions, "raw": rep.raw_instructions,
        "shard_records": [r.total_records for r in rep.shards],
        "mu_mean": [float(m.mean()) for m in mus], "mu_max": [float(m.max()) for m in mus],
        "buffer_hwm": rep.max_buffered, "spills": rep.spill_events,
        "drains": rep.drain_events, "mean_compression": rep.mean_compression,
        "store_nodes": int(pipe.store.n_nodes), "store_edges": int(pipe.store.n_edges),
        "dict": dstage.stats(), "commits": commits, "wall_s": wall_s,
        "wall_ms_per_tick": wall_s * 1e3 / MAIN_TICKS, "launches": launches}), flush=True)
    return launches


def sharded_breakdown(torch):
    """Phase 17: where a tick of the sharded path goes.  Phase 16's
    deployment from the ingest CLI's own builder: PROFILED_TICKS ticks
    run first with spans off, then the next PROFILED_TICKS with spans on
    and under torch.profiler (the profiler slows a tick some twentyfold,
    so the window is short); the spans are summed over shards."""
    import itertools

    from repro_torch.api import MetricsHub
    from repro_torch.launch import ingest
    from repro_torch.telemetry.spans import TelemetryRegistry

    reg = TelemetryRegistry(enabled=False)
    b = ingest.cli_builder(ingest.parse_args(SHARDED_ARGV))
    pipe = b.with_metrics(MetricsHub(telemetry=reg)).build()
    pipe.transform.telemetry = reg
    pipe.sink.ingestor.telemetry = reg
    ticks = pipe.source.ticks()
    pipe.run(itertools.islice(ticks, PROFILED_TICKS), max_ticks=PROFILED_TICKS)
    reg.enabled = True
    commits = dict(pipe.metrics.counters)
    with k1_lanes() as hist:
        device = _profiled(
            torch, f"sharded breakdown (ticks {PROFILED_TICKS} to {2 * PROFILED_TICKS - 1})",
            reg, lambda: pipe.run(itertools.islice(ticks, PROFILED_TICKS),
                                  max_ticks=PROFILED_TICKS),
            ticks=PROFILED_TICKS)
    mined = sum(pipe.metrics.counters[k] - commits.get(k, 0) for k in ("commit", "commit-failed"))
    k5 = [(name, ms, c) for name, ms, c in device if "pattern_mine" in name]
    k5_ms = sum(ms for _, ms, _ in k5)
    print("sharded K5 device: " + json.dumps({
        "ticks": PROFILED_TICKS, "mined_commits": mined, "device_ms": k5_ms,
        "device_ms_per_mined_commit": k5_ms / mined if mined else None,
        "share_of_device_busy": k5_ms / sum(ms for _, ms, _ in device) if device else None,
        "kernels": [{"name": name[:80], "ms": ms, "count": c} for name, ms, c in k5]}),
        flush=True)
    kernel_device("sharded", "K1", "fused_upsert", device, hist)


def sharded_workload_path(torch):
    """Phase 18: the workload CLI's own example, sharded and
    sketch-guided, at its default deployment, with the launch counters
    set to 0 just before and read just after."""
    from repro_torch.kernels import build
    from repro_torch.launch import workload

    seen = {"ticks_with_records": 0, "commits": 0}

    def count(ev):
        if ev.kind == "tick" and ev.payload["raw"] > 0:
            seen["ticks_with_records"] += 1
        elif ev.kind == "commit":
            seen["commits"] += 1

    build.launches.clear()
    t0 = time.perf_counter()
    with k3_lanes() as hist:
        code, rep = workload.run(SHARDED_WORKLOAD_ARGV, on_event=count)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(build.launches)
    want = {"fused_upsert": 2 * seen["commits"],  # the node and edge sweeps
            "sketch_scatter": seen["commits"]}  # the QuerySink absorbs every commit
    extra = launches.get("traffic_ids", 0) - seen["ticks_with_records"]
    if code != 0 or extra not in (0, 1) or any(launches.get(k, 0) != v
                                               for k, v in want.items()):
        raise AssertionError(f"sharded workload path launches {launches}, expected {want} "
                             f"and {seen['ticks_with_records']} or one more traffic_ids")
    if not (rep.total_records > 0 and rep.shards == SHARDS and np.isfinite(rep.mu_mean)
            and rep.store_nodes > 0 and rep.store_edges > 0):
        raise AssertionError(f"sharded workload path produced no result: {rep.summary()}")
    print("sharded workload path: " + json.dumps({
        **{k: v for k, v in rep.to_dict().items() if not isinstance(v, (list, dict))},
        "action_counts": rep.action_counts, "commits": seen["commits"], "wall_s": wall_s,
        "records_per_wall_s": rep.total_records / wall_s,
        "wall_ms_per_tick": wall_s * 1e3 / rep.ticks, "launches": launches}), flush=True)
    print("sharded workload path K3 lanes: " + json.dumps(dict(sorted(hist.items()))),
          flush=True)
    return launches


def sharded_workload_breakdown(torch):
    """Phase 26: where a tick of the sharded workload path goes.  Phase
    18's deployment from `run_scenario`'s own builder: PROFILED_TICKS
    ticks run first with spans off, then the next PROFILED_TICKS with
    spans on and under torch.profiler; K3's and K4's device ms over them."""
    import itertools

    from repro_torch.api import MetricsHub
    from repro_torch.telemetry.spans import TelemetryRegistry
    from repro_torch.workloads import get_scenario, scenario_builder

    reg = TelemetryRegistry(enabled=False)
    b, _, _ = scenario_builder(get_scenario("flash_crowd"), sketch_guided=True, shards=SHARDS,
                               device="cuda")
    pipe = b.with_metrics(MetricsHub(telemetry=reg)).build()
    for part in (pipe.transform, pipe.sink.ingestor, pipe.sink):
        part.telemetry = reg
    ticks = pipe.source.ticks()
    pipe.run(itertools.islice(ticks, PROFILED_TICKS), max_ticks=PROFILED_TICKS)
    reg.enabled = True
    label = (f"sharded workload breakdown (ticks {PROFILED_TICKS} to "
             f"{2 * PROFILED_TICKS - 1})")
    with k4_lanes() as hist:
        device = _profiled(torch, label, reg,
                           lambda: pipe.run(itertools.islice(ticks, PROFILED_TICKS),
                                            max_ticks=PROFILED_TICKS),
                           ticks=PROFILED_TICKS)
    kernel_device("sharded workload breakdown", "K3", "sketch_scatter", device)
    kernel_device("sharded workload breakdown", "K4", "traffic_ids", device, hist)


# beta_e, in hold and throttle rows, is the controller's own float32 RLS
# prediction (ROADMAP F2): held at F2's relative tolerance, as
# tests/test_torch_query_pipeline.py holds the hint; every other sample
# field exactly
PREDICTED_SAMPLE, BETA_PRED_RTOL = "beta_e", 2.5e-3
# the audit trail's predictions, from the same float32 RLS (F2), card
# against host: |card - host| <= max(rel * |host|, abs), the (rel, abs)
# that tests/test_torch_telemetry.py holds the port to against the
# reference
AUDIT_PRED_TOL = {"beta_e_pred": (BETA_PRED_RTOL, 1.0), "mu_pred": (0.0, 1.5e-2),
                  "slope": (0.0, 1e-6)}


def _replaying(cfg, seq, device):
    """A BufferController on `device` that takes the (action, beta) of
    `seq`, decision by decision, in place of its own."""
    import dataclasses

    from repro_torch.core.buffer import BufferController

    class Replay(BufferController):
        def __init__(self):
            super().__init__(cfg, device=device)
            self._seq = iter(seq)

        def decide(self, size, density, now=None):
            dec = super().decide(size, density, now)
            action, beta = next(self._seq)
            self.beta = beta
            return dataclasses.replace(dec, action=action, beta=beta)

    return Replay()


def _sharded_loop(device, decisions=None):
    """The sharded loop of phase 19 on `device`: returns (pipe, report,
    dictionary stage, per-shard decisions).  With `decisions`, each
    shard's controller replays them in place of its own."""
    from repro_torch.api import PipelineBuilder
    from repro_torch.configs.paper_ingest import IngestConfig
    from repro_torch.ingest.sources import BurstyTweetSource

    cfg = IngestConfig(store_nodes=1 << 12, store_edges=1 << 14)
    b = (PipelineBuilder(cfg, device=device).with_source(BurstyTweetSource(seed=0))
         .with_compression(capacity=4096).sharded(2))
    pipe = b.build()
    seen = [[] for _ in pipe.shards]
    for si, shard in enumerate(pipe.shards):
        if decisions is not None:
            shard.controller = _replaying(cfg, decisions[si], device)
        shard.controller.on_decision = lambda d, si=si: seen[si].append((d.action, d.beta))
    rep = pipe.run(max_ticks=40)
    return pipe, rep, b.dictionary_stage, seen


def sharded_cuda_vs_cpu(torch):
    """Phase 19: the sharded loop with GraphZip on the card, and on the
    host replaying the card's per-shard decisions: equal stores,
    dictionaries and reports."""
    from repro_torch import convert

    runs = {}
    decisions = None
    for device in ("cuda", "cpu"):
        pipe, rep, dstage, seen = _sharded_loop(device, decisions)
        decisions = seen
        runs[device] = (
            convert.store_to_numpy(pipe.store), convert.dictionary_to_numpy(dstage.dct),
            {"records": rep.total_records, "instructions": rep.total_instructions,
             "raw": rep.raw_instructions, "hwm": rep.max_buffered,
             "spills": rep.spill_events, "drains": rep.drain_events,
             "actions": [r.actions for r in rep.shards],
             "commits": len(pipe.sink.ingestor.commits),
             "refs": sum(c.refs for c in pipe.sink.ingestor.commits), "dict": dstage.stats()},
            [r.samples for r in rep.shards], [r.compression_ratios for r in rep.shards])
    (sg, dg, cg, smg, crg), (sc, dc, cc, smc, crc) = runs["cuda"], runs["cpu"]
    for name in sg:
        if not np.array_equal(sg[name], sc[name]):
            raise AssertionError(f"cuda and cpu sharded stores differ in {name}")
    for name in dg:
        if not np.array_equal(dg[name], dc[name]):
            raise AssertionError(f"cuda and cpu sharded dictionaries differ in {name}")
    differ = sorted({k for a, b in zip(smg, smc) for k in a
                     if k != PREDICTED_SAMPLE and not np.array_equal(a[k], b[k])})
    beta_e_rel = max(float(np.max(np.abs(a[PREDICTED_SAMPLE] - b[PREDICTED_SAMPLE])
                                  / np.maximum(np.abs(b[PREDICTED_SAMPLE]), 1e-30),
                                  initial=0.0))
                     for a, b in zip(smg, smc))
    if beta_e_rel > BETA_PRED_RTOL:
        differ.append(f"{PREDICTED_SAMPLE} (relative gap {beta_e_rel} > {BETA_PRED_RTOL})")
    if cg != cc or differ or not all(np.array_equal(a, b) for a, b in zip(crg, crc)):
        raise AssertionError(f"cuda and cpu sharded reports differ: samples {differ}, "
                             f"{cg} vs {cc}")
    if cg["refs"] == 0 or not all(cg["actions"]):
        raise AssertionError(f"the sharded loop made no references or a shard never ran: {cg}")
    print("cuda vs cpu sharded loop (2 shards, --dict-compress, the card's decisions replayed "
          f"on the host) equal, every sample field exactly but {PREDICTED_SAMPLE}, whose "
          f"largest relative gap is {beta_e_rel} (tolerance {BETA_PRED_RTOL}): "
          + json.dumps({k: v for k, v in cg.items() if k != "actions"}), flush=True)


def _monitored_run(device, stream=None, **options):
    """`run_scenario` at phase 10's deployment on `device`.  Records the
    ticks into `stream` when it is an empty list, replays them when it
    holds some.  Returns the report and the decisions taken as (action,
    beta, reason)."""
    from repro_torch.ingest.sources import StreamTick
    from repro_torch.workloads import harness

    taken = []

    class Recording(harness.ScenarioSource):
        def ticks(self):
            for tick in super().ticks():
                stream.append((tick.t, copy.deepcopy(tick.records)))
                yield tick

    class Replaying:
        def __init__(self, *args, **kw):
            self.dt = 1.0

        def ticks(self):
            for t, records in stream:
                yield StreamTick(t, copy.deepcopy(records))

    class Builder(harness.PipelineBuilder):
        def build(self):
            pipe = super().build()
            pipe.controller.on_decision = lambda d: taken.append((d.action, d.beta, d.reason))
            return pipe

    saved = harness.ScenarioSource, harness.PipelineBuilder
    if stream is not None:
        harness.ScenarioSource = Replaying if stream else Recording
    harness.PipelineBuilder = Builder
    try:
        rep = harness.run_scenario("flash_crowd", dict_compress=True, device=device,
                                   **options)
    finally:
        harness.ScenarioSource, harness.PipelineBuilder = saved
    return rep, taken


def _steady(events):
    """Detector events on the series that are not wall-clock."""
    return [e for e in events if e["series"] not in WALL_SERIES]


@contextlib.contextmanager
def _host_seconds(spent, targets):
    """Adds the seconds spent in each (class, method) of `targets` to
    `spent[method]` inside the block."""
    saved = [(cls, name, getattr(cls, name)) for cls, name in targets]

    def timed(real, name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    for cls, name, real in saved:
        setattr(cls, name, timed(real, name))
    try:
        yield spent
    finally:
        for cls, name, real in saved:
            setattr(cls, name, real)


def monitored_workload(torch, smi):
    """Phase 27: the workload path with telemetry and the monitor on."""
    import tempfile

    from repro_torch.kernels import build
    from repro_torch.launch.telemetry import DRYRUN_REQUIRED_STAGES
    from repro_torch.monitor import HealthMonitor
    from repro_torch.telemetry import (AuditTrail, TelemetryRegistry, validate_chrome_trace,
                                       write_chrome_trace, write_jsonl)

    seen = {"ticks_with_records": 0, "encodes": 0, "commits": 0}

    def count(ev):
        if ev.kind == "tick" and ev.payload["raw"] > 0:
            seen["ticks_with_records"] += 1
        elif ev.kind in ("commit", "commit-failed"):
            seen["encodes"] += 1
            seen["commits"] += ev.kind == "commit"

    stream = []
    with tempfile.TemporaryDirectory() as tmp:
        trace, jsonl = f"{tmp}/trace.json", f"{tmp}/trace.jsonl"
        reg = TelemetryRegistry()
        build.launches.clear()
        t0 = time.perf_counter()
        with _host_seconds(collections.Counter(), [
                (HealthMonitor, "on_event"), (AuditTrail, "record"),
                (AuditTrail, "resolve")]) as spent:
            rep, decisions = _monitored_run("cuda", stream, telemetry=reg, monitor=True,
                                               trace=trace, trace_jsonl=jsonl, on_event=count)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(build.launches)
        ok, msg = validate_chrome_trace(trace, DRYRUN_REQUIRED_STAGES + ("commit.wait",))
        with open(jsonl) as f:
            kinds = collections.Counter(json.loads(line)["type"] for line in f)
        t0 = time.perf_counter()
        write_chrome_trace(reg, trace)
        write_jsonl(reg, jsonl)
        export_s = time.perf_counter() - t0
    # the host cost of the instrumentation: the monitor's and the audit
    # trail's calls as timed on the path above, the exporters once, and
    # the spans estimated, not timed on the path: an empty span's cost on
    # this host times the spans the run opened
    probe, n_probe = TelemetryRegistry(max_events=0), 20_000
    t0 = time.perf_counter()
    for _ in range(n_probe):
        with probe.span("probe"):
            pass
    span_s = (time.perf_counter() - t0) / n_probe
    cost_ms = {"monitor_on_event": spent["on_event"] * 1e3 / rep.ticks,
               "audit_record_resolve": (spent["record"] + spent["resolve"]) * 1e3 / rep.ticks,
               "spans_estimated": span_s * sum(st["count"] for st in reg.summary().values())
               * 1e3 / rep.ticks,
               "exporters_once": export_s * 1e3 / rep.ticks}
    want = {"pattern_mine": seen["encodes"], "fused_upsert": 3 * seen["commits"]}
    extra = launches.get("traffic_ids", 0) - seen["ticks_with_records"]
    if extra not in (0, 1) or any(launches.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"monitored workload launches {launches}, expected {want} and "
                             f"{seen['ticks_with_records']} or one more traffic_ids")
    if not ok or kinds["audit"] != len(reg.audit):
        raise AssertionError(f"monitored workload trace: {msg}; JSONL lines {dict(kinds)}")
    if not (len(reg.audit) == rep.audit_decisions == len(decisions) == rep.ticks
            and all(r.mu_real is not None for r in reg.audit)):
        raise AssertionError(f"monitored workload: {len(reg.audit)} audit records "
                             f"({rep.audit_decisions} in the report) for {len(decisions)} "
                             f"decisions in {rep.ticks} ticks")
    if rep.burst_onset_tick < 0 or not rep.slo_summary or rep.total_records == 0:
        raise AssertionError(f"monitored workload: no burst onset or no SLOs: {rep.summary()}")

    # the same run on the host on the card's records, its controller
    # deciding for itself: nothing of the card's run is replayed but the
    # records, which the card's sampler drew
    host_reg = TelemetryRegistry()
    host, host_decisions = _monitored_run("cpu", stream, telemetry=host_reg, monitor=True)

    def audit(r):
        return [(a.action, a.reason, a.beta, a.inputs, a.mu_real, a.beta_e_real)
                for a in r.audit]

    # each prediction's largest gap as a share of its tolerance
    gaps = {k: max((abs(getattr(a, k) - getattr(b, k)) / max(rel * abs(getattr(b, k)), tol)
                    for a, b in zip(reg.audit, host_reg.audit)), default=0.0)
            for k, (rel, tol) in AUDIT_PRED_TOL.items()}
    same = {
        "decisions": decisions == host_decisions,
        "records": (rep.total_records, rep.total_instructions, rep.raw_instructions,
                    rep.dropped_inserts, rep.pattern_refs)
        == (host.total_records, host.total_instructions, host.raw_instructions,
            host.dropped_inserts, host.pattern_refs),
        "audit": audit(reg) == audit(host_reg),
        "predictions": max(gaps.values()) <= 1.0,
        "events": _steady(rep.health_events) == _steady(host.health_events),
        "slos": all(s == host.slo_summary[n] for n, s in rep.slo_summary.items()
                    if n not in WALL_SLOS),
    }
    if not all(same.values()):
        differing = sum(a != b for a, b in zip(decisions, host_decisions))
        raise AssertionError(f"monitored workload: card and host differ: {same}; "
                             f"{differing} of {len(decisions)} decisions differ; prediction "
                             f"gaps {gaps} (tolerances {AUDIT_PRED_TOL})")

    # wall time a tick, telemetry and the monitor off and on (off, on, on, off)
    walls = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        t0 = time.perf_counter()
        r, _ = _monitored_run("cuda", **({"telemetry": True, "monitor": True}
                                            if mode == "on" else {}))
        torch.cuda.synchronize()
        walls[mode].append((time.perf_counter() - t0) * 1e3 / r.ticks)
    off, on = statistics.mean(walls["off"]), statistics.mean(walls["on"])
    onsets = collections.Counter(f"{e['series']}/{e['detector']}" for e in rep.health_events
                                 if e["phase"] == "onset")
    print("monitored workload: " + json.dumps({
        "card": smi, "ticks": rep.ticks, "records": rep.total_records,
        "commits": seen["commits"], "wall_s": wall_s, "trace": msg, "jsonl": dict(kinds),
        "audit_records": len(reg.audit), "burst_onset_tick": rep.burst_onset_tick,
        "health_events": len(rep.health_events), "onsets": dict(sorted(onsets.items())),
        "slo_breaches": {n: s["breaches"] for n, s in rep.slo_summary.items()},
        "controller_score": rep.controller_score,
        "host_prediction_gaps": gaps, "host_prediction_tolerances": AUDIT_PRED_TOL,
        "wall_ms_per_tick_off": walls["off"], "wall_ms_per_tick_on": walls["on"],
        "wall_ms_per_tick_off_mean": off, "wall_ms_per_tick_on_mean": on,
        "overhead_share": on / off - 1.0,
        "host_ms_per_tick_of_instrumentation": cost_ms,
        "span_us": span_s * 1e6,
        "launches": {k: launches.get(k, 0) for k in ("fused_upsert", "traffic_ids",
                                                     "pattern_mine")}}), flush=True)
    print(f"monitored workload on {smi}: wall ms a tick off {off} on {on}; launches K1 "
          f"{launches.get('fused_upsert', 0)} K4 {launches.get('traffic_ids', 0)} K5 "
          f"{launches.get('pattern_mine', 0)}; the host, on the card's records, takes the "
          f"same decisions and gives the same records, audit trail, predictions within "
          f"{AUDIT_PRED_TOL}, non-wall-clock detector events "
          f"and SLO breaches", flush=True)
    return launches


# Phase 28: the 32-bit key path (the reference's default width, uint32 keys
# without x64).  K1 at phase 1's node sweep, on a table past 0.6 load (the
# store's budget doubles there) and at 512 lanes; K5 at 512 and 8,192 lanes
# and the path's largest mined batch; each timed beside the 64-bit instance on
# the same keys, zero-extended
KEYS32_UPSERT = ((1 << 20, 16_384, 0.0, 32), (1 << 20, 16_384, 0.7, 64), (1 << 20, 512, 0.0, 32))
KEYS32_MINE_LANES = (512, 8_192)
KEYS32_MINE_TIMED = "patterned"
KEYS32_QS = dict(depth=4, width=512)


def _keys32_loop(device, decisions=None):
    """The ingest CLI's deployment (configs/paper_ingest.py: 2^20 nodes,
    2^21 edges, 60 records/s, 5x bursts, seed 0), controlled, at 32-bit
    keys, with the query sink (D=4, W=512) and GraphZip compression on,
    for MAIN_TICKS ticks on `device`.  With `decisions`, its controller
    replays them.  Returns (pipe, report, dictionary stage, decisions,
    the largest edge table the miner saw, K3's calls by key dtype)."""
    import torch

    from repro_torch.api import PipelineBuilder
    from repro_torch.configs.paper_ingest import IngestConfig
    from repro_torch.ingest.sources import BurstyTweetSource
    from repro_torch.kernels import ops

    cfg = IngestConfig()
    b = (PipelineBuilder(cfg, device=device, key_dtype=torch.int32)
         .with_source(BurstyTweetSource(seed=0)).with_query_sink(**KEYS32_QS)
         .with_compression(capacity=4096))
    if decisions is not None:
        b = b.with_controller(_replaying(cfg, decisions, device))
    pipe = b.build()
    seen = []
    pipe.controller.on_decision = lambda d: seen.append((d.action, d.beta))
    dstage, rewrite, kept = b.dictionary_stage, b.dictionary_stage.rewrite, {"et": None}

    def keep_largest(et):
        if kept["et"] is None or et.src.shape[0] > kept["et"].src.shape[0]:
            kept["et"] = et
        return rewrite(et)

    dstage.rewrite = keep_largest
    absorb, k3_keys = ops.sketch_absorb, collections.Counter()

    def counted(*args):
        k3_keys[str(args[3].dtype)] += 1
        return absorb(*args)

    ops.sketch_absorb = counted
    try:
        rep = pipe.run(max_ticks=MAIN_TICKS)
    finally:
        ops.sketch_absorb = absorb
    return pipe, rep, dstage, seen, kept["et"], k3_keys


def keys32_upsert(torch, dev):
    """K1's 32-bit instance against its plain version, bit for bit under
    every cluster width, at KEYS32_UPSERT; each shape also through the
    64-bit instance on the same keys zero-extended, both timed."""
    from repro_torch.kernels import upsert

    rows = []
    for cap, lanes, load, probes in KEYS32_UPSERT:
        seed = int(load * 10) + lanes
        pool = torch.from_numpy(_random_keys(np.random.default_rng(seed), int(load * cap) + lanes,
                                             bits=32)).to(dev)
        m = int(load * cap)
        for bits in (32, 64):
            keys_pool = pool if bits == 32 else pool.long() & 0xFFFFFFFF
            table = torch.zeros(cap, dtype=keys_pool.dtype, device=dev)
            if m:
                _, fslot, _ = upsert.fused_upsert_ref(
                    table, keys_pool[:m], torch.ones(m, dtype=torch.bool, device=dev),
                    FILL_PROBES)
                if bool((fslot < 0).any()):
                    raise AssertionError(f"fill of a {cap}-slot table to load {load} dropped")
            keys, valid = upsert_batch(torch, dev, np.random.default_rng(seed + 1), keys_pool,
                                       m, lanes)
            row = upsert_row(torch, f"node{bits}", cap, table, m, keys, valid, probes)
            rows.append({"key_bits": bits, "load": load, **row})
            print("keys32 upsert", json.dumps(rows[-1]), flush=True)
    return rows


def keys32_mine(torch, dev, path_batch):
    """K5's 32-bit instance against its plain version, bit for bit, at
    KEYS32_MINE_LANES on every kind of `_mine_batch` (its ids cut to
    their low 32 bits) and on the path's largest mined batch; the
    KEYS32_MINE_TIMED kind and the path batch timed beside the 64-bit
    instance on the same keys zero-extended."""
    from repro_torch.kernels.pattern_mine import cluster_plan, pattern_mine, pattern_mine_ref

    rng = np.random.default_rng(28)
    cases = []
    for n in KEYS32_MINE_LANES:
        for kind in MINE_KINDS:
            src, dst, et, count, valid = _mine_batch(torch, rng, n, kind)
            cases.append((kind, tuple(t.to(dev) for t in (src.to(torch.int32),
                                                         dst.to(torch.int32), et, count,
                                                         valid)) + (4, 2)))
    cases.append(("path", path_batch))
    rows = []
    for kind, args in cases:
        if args[0].dtype != torch.int32:
            raise AssertionError(f"keys32 mine: a {args[0].dtype} batch")
        got, want = pattern_mine(*args), pattern_mine_ref(*args)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got[:3], want[:3]))
        err = max(err, int((got[3] != want[3]).sum()))
        if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"pattern_mine 32-bit kernel != plain: {kind} "
                                 f"n={args[0].shape[0]} max_abs_err={err}")
        n = args[0].shape[0]
        row = {"batch": kind, "lanes": n, "valid": int(args[4].sum()),
               "flagged": int((want[2] != 0).sum()), "max_abs_err": err}
        if kind in (KEYS32_MINE_TIMED, "path"):
            wide = (args[0].long() & 0xFFFFFFFF, args[1].long() & 0xFFFFFFFF) + args[2:]
            # src, dst, etype, count, valid read (key, key, 4, 4, 1 B); fans, flags
            # (3 x 4 B) and psig (a key) written
            row.update(ms=_time_ms(torch, pattern_mine, (), args, KERNEL_REPS),
                       plain_ms=_time_ms(torch, pattern_mine_ref, (), args, PLAIN_REPS),
                       bound_ms=33 * n / H100_BYTES_PER_S * 1e3, bound_by="bytes",
                       ms_64=_time_ms(torch, pattern_mine, (), wide, KERNEL_REPS),
                       bound_ms_64=45 * n / H100_BYTES_PER_S * 1e3,
                       ctas_a_vector=cluster_plan(n))
        rows.append(row)
        print("keys32 mine", json.dumps(row), flush=True)
    return rows


def keys32_path(torch):
    """Phase 28: the 32-bit key path.  (a) `_keys32_loop` on the card,
    counters set to 0 just before and read just after, then on the host
    replaying the card's decisions: equal records, commits, drops, store,
    sketch and dictionary; (b) K1's and (c) K5's 32-bit instances against
    their plain versions, bit for bit, timed beside the 64-bit ones."""
    from repro_torch import convert
    from repro_torch.kernels import build

    build.launches.clear()
    t0 = time.perf_counter()
    pipe, rep, dstage, decisions, mined, k3_keys = _keys32_loop("cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(build.launches)
    commits = [c for c in pipe.sink.ingestor.commits if c.ok]
    by_width = {k: launches.get(k, 0) for k in ("fused_upsert", "fused_upsert32",
                                                 "pattern_mine", "pattern_mine32",
                                                 "sketch_scatter")}
    if (pipe.store.node_keys.dtype != torch.int32 or not commits
            or by_width["fused_upsert"] or by_width["pattern_mine"]
            or by_width["fused_upsert32"] < 2 * len(commits)
            or by_width["pattern_mine32"] != dstage.rewrites
            or by_width["sketch_scatter"] != pipe.sink.commits
            or set(k3_keys) != {"torch.int32"}):
        raise AssertionError(f"keys32 path: launches {by_width} for {len(commits)} commits, "
                             f"{dstage.rewrites} rewrites, {pipe.sink.commits} sketch "
                             f"updates; K3 calls by key dtype {dict(k3_keys)}")
    mu = rep.samples["mu"]
    if not (np.isfinite(mu).all() and rep.total_records > 0 and int(pipe.store.n_edges) > 0
            and sum(c.refs for c in commits) > 0):
        raise AssertionError("keys32 path produced no finite, non-empty, compressed result")

    def digest(pipe, rep, dstage):
        ing = pipe.sink.ingestor
        return (
            {**{f"store.{k}": v for k, v in convert.store_to_numpy(pipe.store).items()},
             **{f"sketch.{k}": v for k, v in convert.sketch_to_numpy(pipe.sink.sketch).items()},
             **{f"dictionary.{k}": v
                for k, v in convert.dictionary_to_numpy(dstage.dct).items()}},
            {"records": rep.total_records, "instructions": rep.total_instructions,
             "raw": rep.raw_instructions, "dropped_total": sum(c.dropped for c in ing.commits),
             "refs": sum(c.refs for c in ing.commits), "dict": dstage.stats(),
             "commits": [(c.ok, c.instructions, c.new_nodes, c.batch_nodes, c.probe_rounds,
                          c.dropped, c.refs) for c in ing.commits]})

    card = digest(pipe, rep, dstage)
    hpipe, hrep, hdstage, hdecisions, _, _ = _keys32_loop("cpu", decisions)
    host = digest(hpipe, hrep, hdstage)
    for name, a in card[0].items():
        if a.dtype != host[0][name].dtype or not np.array_equal(a, host[0][name]):
            raise AssertionError(f"keys32 path: card and host differ in {name}")
    if card[1] != host[1] or hdecisions != decisions:
        raise AssertionError(f"keys32 path: card and host reports differ")
    summary = {k: v for k, v in card[1].items() if k != "commits"}
    print("keys32 path: " + json.dumps({
        "ticks": MAIN_TICKS, "commits": len(commits), "wall_s": wall_s,
        "wall_ms_per_tick": wall_s * 1e3 / MAIN_TICKS, "store_nodes": int(pipe.store.n_nodes),
        "store_edges": int(pipe.store.n_edges), "launches_by_width": by_width,
        "k3_calls_by_key_dtype": dict(k3_keys), "largest_mined_batch": mined.src.shape[0],
        **summary}), flush=True)
    print(f"keys32 path: card == host (the card's {len(decisions)} decisions replayed): "
          "store, sketch and dictionary arrays, records, commits and drops", flush=True)
    upsert_rows = keys32_upsert(torch, torch.device("cuda"))
    mine_rows = keys32_mine(torch, torch.device("cuda"),
                            (mined.src, mined.dst, mined.etype, mined.count, mined.edge_valid,
                             dstage.star_min, dstage.hot_min))
    return by_width, upsert_rows, mine_rows


# Phase 29: launch.lineage at its defaults (flash_crowd, 240 ticks, seed 0,
# speed 0.5, a 2^20-node, 2^21-edge store) with a 12-tick store outage at
# the burst's onset (tick 30, phase 27's burst_onset_tick)
LINEAGE_OUTAGE = (30.0, 42.0)
LINEAGE_ARGV = ["--outage", "30:42"]
# the tracker's calls on the path, timed by _host_seconds
LINEAGE_CALLS = ("observe_intake", "open_batch", "stage_commit", "after_commit", "mark_pooled",
                 "mark_archived", "mark_replay", "mark_committed", "mark_queryable",
                 "mark_dropped", "on_event")


def _lineage_run(device, tmp, stream, decisions=None):
    """`launch.lineage.run` at phase 29's deployment on `device`, writing
    its trace, JSONL and Prometheus files into `tmp`.  Records the ticks
    into `stream` when it is empty, replays them when it holds some; with
    `decisions`, the controller replays those (action, beta) in place of
    its own.  Returns the CLI's (exit code, report, tracker, monitor),
    the pipeline, the decisions taken as (action, beta), the "retry"
    events as (t, remaining) and the printout."""
    import io

    from repro_torch.ingest.sources import StreamTick
    from repro_torch.launch import lineage as cli
    from repro_torch.workloads import harness

    taken, retries, built = [], [], {}

    class Recording(harness.ScenarioSource):
        def ticks(self):
            for tick in super().ticks():
                stream.append((tick.t, copy.deepcopy(tick.records)))
                yield tick

    class Replaying:
        def __init__(self, *args, **kw):
            self.dt = 1.0

        def ticks(self):
            for t, records in stream:
                yield StreamTick(t, copy.deepcopy(records))

    class Builder(harness.PipelineBuilder):
        def build(self):
            if decisions is not None:
                self.with_controller(_replaying(self.cfg, decisions, self.device))
            self.on_event(lambda ev: ev.kind == "retry"
                          and retries.append((ev.t, ev.payload["remaining"])))
            pipe = built["pipe"] = super().build()
            pipe.controller.on_decision = lambda d: taken.append((d.action, d.beta))
            return pipe

    saved = harness.ScenarioSource, harness.PipelineBuilder
    harness.ScenarioSource = Replaying if stream else Recording
    harness.PipelineBuilder = Builder
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            result = cli.run(LINEAGE_ARGV + [
                "--device", device, "--trace-out", f"{tmp}/{device}.json",
                "--jsonl-out", f"{tmp}/{device}.jsonl", "--prom-out", f"{tmp}/{device}.prom"])
    finally:
        harness.ScenarioSource, harness.PipelineBuilder = saved
    return result, built["pipe"], taken, retries, out.getvalue()


def _lineage_digest(device, tmp, result, pipe):
    """What the card's lineage run must share with the host's: the
    tracker's state and hop logs without the hops' host clock (it only
    places flow events on the span timeline), the timeline, the
    printed views, the conservation counts and gauges, the freshness
    SLO, and the ingestor's accounting."""
    from repro_torch import lineage as L

    code, rep, trk, mon = result

    def tag(t):
        d = {k: v for k, v in vars(t).items() if k != "hops"}
        return {**d, "hops": [(h, at) for h, at, _ in t.hops]}

    state = trk.state()
    state = {**state, "completed": [tag(t) for t in state["completed"]],
             "open_tags": {k: tag(t) for k, t in state["open_tags"].items()}}
    with open(f"{tmp}/{device}.jsonl") as f:
        hops = [json.loads(line) for line in f]
    for line in hops:
        line.pop("exporter", None)
        for h in line.get("hops", ()):
            h.pop("wall_ns")
    ing = pipe.sink.ingestor
    return {
        "state": state, "timeline": list(trk.timeline),
        "freshness_table": L.freshness_table(trk),
        "watermark_timeline": L.watermark_timeline(trk), "path_mix": rep.path_mix,
        "conservation": trk.conservation(), "prometheus_lines": L.prometheus_lines(trk),
        "jsonl": hops, "freshness_slo": rep.slo_summary["freshness"],
        "ingestor": {"attempts": ing.attempts, "archived_total": ing.archived_total,
                     "replayed": ing.replayed}}


def lineage_path(torch, smi):
    """Phase 29: batch lineage on the card through `launch.lineage`."""
    import tempfile

    from repro_torch.kernels import build
    from repro_torch.lineage import LineageTracker, validate_flow_events
    from repro_torch.lineage import export as LX

    lo, hi = LINEAGE_OUTAGE
    stream = []
    with tempfile.TemporaryDirectory() as tmp:
        build.launches.clear()
        t0 = time.perf_counter()
        with _host_seconds(collections.Counter(), [(LineageTracker, name)
                                                   for name in LINEAGE_CALLS]) as spent:
            card = _lineage_run("cuda", tmp, stream)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(build.launches)
        (code, rep, trk, mon), pipe, decisions, retries, printed = card
        ing = pipe.sink.ingestor
        stored = sum(c.ok for c in ing.commits)
        k4_ticks = sum(1 for _, records in stream if records)
        fresh = trk.freshness()
        wm = trk.watermarks()
        held = {r["queryable"] for r in trk.timeline if lo < r["t"] <= hi}
        drained = next((t for t, left in retries if t >= hi and left == 0), None)
        # the outage's backlog lasts until its records are queryable: the
        # first timeline row past the outage whose queryable watermark
        # reached its end (the run's end if none did)
        caught_up = next((r["t"] for r in trk.timeline
                          if r["t"] > hi and r["queryable"] >= hi), float(rep.ticks))
        slo = rep.slo_summary["freshness"]
        onsets = [a["t"] for a in slo["alerts"] if a["phase"] == "onset"]
        flows_ok, flows = validate_flow_events(f"{tmp}/cuda.json",
                                               require_paths=sorted(rep.path_mix))
        checks = {
            "exit 0": code == 0,
            "queryable watermark": wm["queryable"] is not None,
            "conservation": not rep.conservation_warning
            and rep.records_in == rep.records_committed + rep.records_dropped
            + rep.records_in_flight,
            "archived path": rep.path_mix.get("archived", 0) > 0,
            "flow chains": flows_ok,
            "archived slower": "archived" in fresh and "direct" in fresh
            and fresh["archived"]["queryable"]["p99_ms"]
            > fresh["direct"]["queryable"]["p99_ms"],
            "watermark held through the outage": len(held) == 1,
            "archive drained": drained is not None,
            "freshness alert in the backlog": any(lo <= t <= caught_up for t in onsets),
            "K1 two a stored commit": launches.get("fused_upsert", 0) == 2 * stored > 0,
            "K4 one a tick with records": launches.get("traffic_ids", 0) == k4_ticks > 0,
            "no batch lost": ing.archived_total == ing.replayed + ing.archive_depth,
        }
        if not all(checks.values()):
            raise AssertionError(f"lineage path: {checks}; flows: {flows}; retries "
                                 f"{retries[:8]}; onsets {onsets}; path_mix {rep.path_mix}\n"
                                 + printed)
        # the exporters once, after the run
        t0 = time.perf_counter()
        LX.sample_tags(trk)
        LX.flow_events(trk, 0)
        LX.write_lineage_jsonl(trk, f"{tmp}/again.jsonl")
        LX.freshness_table(trk)
        LX.watermark_timeline(trk)
        LX.prometheus_lines(trk)
        export_s = time.perf_counter() - t0

        # the same deployment on the host, on the card's records, its
        # controller deciding for itself; the card's decisions replayed
        # only where one differs
        host = _lineage_run("cpu", tmp, stream)
        replayed = host[2] != decisions
        if replayed:
            host = _lineage_run("cpu", tmp, stream, decisions)
        want = _lineage_digest("cuda", tmp, card[0], pipe)
        got = _lineage_digest("cpu", tmp, host[0], host[1])
        differ = sorted(k for k in want if want[k] != got[k])
        if differ or host[2] != decisions:
            raise AssertionError(f"lineage path: card and host differ in {differ} "
                                 f"(decisions replayed: {replayed})")
    ticks = rep.ticks
    tracker_ms = {name: spent[name] * 1e3 / ticks for name in LINEAGE_CALLS if spent[name]}
    print("lineage path: " + json.dumps({
        "card": smi, "ticks": ticks, "records": rep.total_records, "wall_s": wall_s,
        "wall_ms_per_tick": wall_s * 1e3 / ticks, "outage": LINEAGE_OUTAGE,
        "path_mix": rep.path_mix, "watermarks": wm,
        "conservation": {k: getattr(rep, k) for k in ("records_in", "records_committed",
                                                      "records_dropped", "records_in_flight")},
        "ingest_lag_ms_p50": rep.ingest_lag_ms_p50, "ingest_lag_ms_p99": rep.ingest_lag_ms_p99,
        "queryable_lag_ms_p99": rep.queryable_lag_ms_p99,
        "queryable_p99_ms_by_path": {p: r["queryable"]["p99_ms"] for p, r in fresh.items()},
        "held_queryable_watermark": sorted(held), "archive_drained_at": drained,
        "outage_records_queryable_at": caught_up,
        "freshness_slo": {k: slo[k] for k in ("objective", "ticks", "breaches",
                                              "budget_consumed", "first_alert_tick")},
        "freshness_onsets": onsets, "flows": flows,
        "commits_stored": stored, "commit_failures": rep.commit_failures,
        "archived_total": ing.archived_total, "replayed": ing.replayed,
        "attempts": ing.attempts, "degraded_events": rep.degraded_events,
        "tracker_host_ms_per_tick": sum(tracker_ms.values()),
        "tracker_host_ms_per_tick_by_call": tracker_ms,
        "exporters_once_ms": export_s * 1e3,
        "host_decided_alike": not replayed,
        "launches": {k: launches.get(k, 0) for k in ("fused_upsert", "traffic_ids")}}),
        flush=True)
    print(f"lineage path on {smi}: K1 {launches.get('fused_upsert', 0)} launches for "
          f"{stored} stored commits (replays included), K4 {launches.get('traffic_ids', 0)} "
          f"for {k4_ticks} ticks with records; the tracker's host cost "
          f"{sum(tracker_ms.values())} ms a tick, the exporters {export_s * 1e3} ms once; "
          f"the host, on the card's records"
          + (" and decisions" if replayed else ", deciding for itself,")
          + " gives the same tracker state, timeline, views, gauges, hop logs, "
          "freshness SLO and ingestor accounting", flush=True)
    return launches


# Phase 30: launch.chaos at its defaults (flash_crowd, 120 ticks, seed 0, a
# crash at 60, a checkpoint every 16, a store outage over 30:45, the default
# RetryPolicy, a 2^20-node, 2^21-edge store), whose resume starts from 48;
# then one kill and resume through run_scenario with the sketch and the
# dictionary on (48 ticks, an outage over 10:16, a crash at 24, a checkpoint
# every 8, RetryPolicy(jitter=0.0), the default store)
CHAOS_DEFAULTS = dict(scenario="flash_crowd", ticks=120, seed=0, crash_at=60, every=16,
                      outage=(30.0, 45.0), resumed_from=48)
CKPT_RUN = dict(ticks=48, seed=0, sketch_guided=True, dict_compress=True, checkpoint_every=8)
CKPT_OUTAGE, CKPT_CRASH = (10.0, 16.0), 24
SAMPLER_BLOCK = 2_048  # ScenarioSource's block: one K4 launch a block a tick


@contextlib.contextmanager
def _chaos_watch(decisions=None):
    """Inside the block `harness.run_scenario` builds pipelines that
    record, build by build: the record count of every tick the source
    yields, the commits that reached the store (the ingestor's commit
    hooks, replays included), the (action, beta) decisions and the
    pipeline; and each checkpoint restore first keeps a copy of the step
    it reads.  With `decisions`, the controller replays those in place
    of its own.  Yields the dict the records land in."""
    import os
    import shutil

    from repro_torch.resilience import checkpoint as CK
    from repro_torch.workloads import harness

    seen = {"ticks": [], "stored": [], "decisions": [], "pipes": [], "kept": []}
    restore = CK.PipelineCheckpointer.restore

    class Recording(harness.ScenarioSource):
        def ticks(self):
            counts = []
            seen["ticks"].append(counts)
            for tick in super().ticks():
                counts.append(len(tick.records))
                yield tick

    class Builder(harness.PipelineBuilder):
        def build(self):
            if decisions is not None:
                self.with_controller(_replaying(self.cfg, decisions, self.device))
            pipe = super().build()
            stored, taken = [0], []
            pipe.sink.ingestor.commit_hooks.append(
                lambda et, s: stored.__setitem__(0, stored[0] + 1))
            pipe.controller.on_decision = lambda d: taken.append((d.action, d.beta))
            seen["stored"].append(stored)
            seen["decisions"].append(taken)
            seen["pipes"].append(pipe)
            return pipe

    def keeping(self, pipe, source=None, step=None, expect=None):
        s = step if step is not None else self.latest_step()
        kept = f"{self.dir}_kept_{s}"
        shutil.copytree(os.path.join(self.dir, f"step_{s:08d}"),
                        os.path.join(kept, f"step_{s:08d}"))
        seen["kept"].append(kept)
        return restore(self, pipe, source, step, expect)

    saved = harness.ScenarioSource, harness.PipelineBuilder
    harness.ScenarioSource, harness.PipelineBuilder = Recording, Builder
    CK.PipelineCheckpointer.restore = keeping
    try:
        yield seen
    finally:
        harness.ScenarioSource, harness.PipelineBuilder = saved
        CK.PipelineCheckpointer.restore = restore


def _dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def _span_seconds(reg, name):
    """Each recorded `name` span of `reg`, in seconds (its exact ns)."""
    return [(t1 - t0) / 1e9 for n, _, t0, t1 in reg.events if n == name]


def _components(pipe):
    """The reference's numpy view of every array leaf (a checkpoint's
    leaves), by leaf key."""
    from repro_torch import convert
    from repro_torch.resilience import checkpoint as CK

    return {f"{name}.{i}": a for name, obj in CK._array_components(pipe).items()
            for i, a in enumerate(convert.reference_arrays(obj).values())}


def chaos_path(torch, smi):
    """Phase 30: kill and resume on the card through `launch.chaos` and
    `run_scenario`, the card's checkpoint resumed on the host."""
    import io
    import os
    import shutil
    import tempfile

    from repro_torch.kernels import build
    from repro_torch.launch import chaos
    from repro_torch.query.snapshot import build_snapshot
    from repro_torch.resilience import FaultPlan, PipelineKilled, RetryPolicy, pytree_digest
    from repro_torch.telemetry import TelemetryRegistry
    from repro_torch.workloads import harness

    d = CHAOS_DEFAULTS
    lo, hi = d["outage"]
    with tempfile.TemporaryDirectory() as tmp:
        # ---- launch.chaos at its defaults --------------------------------
        work = os.path.join(tmp, "chaos")
        out = io.StringIO()
        build.launches.clear()
        t0 = time.perf_counter()
        with _chaos_watch() as card, contextlib.redirect_stdout(out):
            code, verdict = chaos.run(["--dir", work, "--json", os.path.join(tmp, "v.json")])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = dict(build.launches)
        printed = out.getvalue()
        stored = sum(s[0] for s in card["stored"])
        k4_want = sum(-(-n // SAMPLER_BLOCK) for counts in card["ticks"] for n in counts)
        checks = {
            "exit 0": code == 0 and "chaos ok" in printed,
            "every check": verdict is not None and all(verdict["checks"].values()),
            "resumed from 48, killed at 60": verdict is not None
            and (verdict["resumed_from"], verdict["killed_at"])
            == (d["resumed_from"], d["crash_at"]),
            "three runs": len(card["pipes"]) == 3 and len(card["kept"]) == 1,
            "K1 two a stored commit": launches.get("fused_upsert", 0) == 2 * stored > 0,
            "K4 one a block a tick": launches.get("traffic_ids", 0) == k4_want > 0,
        }
        if not all(checks.values()):
            raise AssertionError(f"chaos path: {checks}; launches {launches}, stored "
                                 f"{stored}, K4 wanted {k4_want}\n{printed}")
        step_bytes = _dir_bytes(card["kept"][0])

        # ---- the card's step-48 checkpoint, resumed on the host ----------
        def host_resume(name, decisions=None):
            ckpt = shutil.copytree(card["kept"][0], os.path.join(tmp, name))
            with _chaos_watch(decisions) as host:
                rep = harness.run_scenario(
                    d["scenario"], ticks=d["ticks"], seed=d["seed"], device="cpu",
                    fault_plan=FaultPlan(fail_times=((lo, hi),)), retry=RetryPolicy(),
                    checkpoint_dir=ckpt, checkpoint_every=d["every"], resume=True,
                    spill_dir=os.path.join(tmp, f"{name}_spill"))
            return rep, host["decisions"][0]

        t0 = time.perf_counter()
        rep, taken = host_resume("host")
        replayed = taken != card["decisions"][2]
        if replayed:
            rep, taken = host_resume("host_replayed", card["decisions"][2])
        host_s = time.perf_counter() - t0
        want = (verdict["ref"]["store_digest"], verdict["ref"]["snapshot_digest"])
        if (rep.store_digest, rep.snapshot_digest) != want \
                or rep.resumed_from_tick != d["resumed_from"] \
                or rep.total_records != verdict["ref"]["records"]:
            raise AssertionError(f"chaos path: the host's resume of the card's step "
                                 f"{d['resumed_from']} gives {rep.store_digest[:16]}, "
                                 f"{rep.snapshot_digest[:16]} against the card's "
                                 f"{want[0][:16]}, {want[1][:16]} (decisions replayed: "
                                 f"{replayed})")

        # ---- the sketch and the dictionary, killed and resumed on the card
        plan = FaultPlan(fail_times=(CKPT_OUTAGE,), crash_at_tick=CKPT_CRASH)
        kw = dict(CKPT_RUN, retry=RetryPolicy(jitter=0.0), device="cuda")
        ckdir = os.path.join(tmp, "sketch_dict")
        regs = TelemetryRegistry(), TelemetryRegistry()
        build.launches.clear()
        with _chaos_watch() as sd:
            ref = harness.run_scenario("flash_crowd", fault_plan=plan.without_crash(),
                                       spill_dir=os.path.join(tmp, "sd_ref"), **kw)
            try:
                harness.run_scenario("flash_crowd", fault_plan=plan, checkpoint_dir=ckdir,
                                     telemetry=regs[0], spill_dir=os.path.join(tmp, "sd"), **kw)
                raise AssertionError("chaos path: crash_at_tick never fired")
            except PipelineKilled as killed:
                killed_at = killed.tick
            res = harness.run_scenario("flash_crowd", fault_plan=plan.without_crash(),
                                       checkpoint_dir=ckdir, resume=True, telemetry=regs[1],
                                       spill_dir=os.path.join(tmp, "sd"), **kw)
        torch.cuda.synchronize()
        sd_launches = dict(build.launches)
        got, want_leaves = _components(sd["pipes"][2]), _components(sd["pipes"][0])
        differ = sorted(k for k in want_leaves if k not in got
                        or got[k].dtype != want_leaves[k].dtype
                        or not np.array_equal(got[k], want_leaves[k]))
        sd_checks = {
            "killed at 24, resumed from 24": (killed_at, res.resumed_from_tick)
            == (CKPT_CRASH, CKPT_CRASH),
            "digests": (res.store_digest, res.snapshot_digest)
            == (ref.store_digest, ref.snapshot_digest) and bool(ref.store_digest),
            "sketch and dictionary leaves": not differ and set(got) == set(want_leaves)
            and {"sink_sketch.0", "stage0_dict.0"} <= set(got),
            "records": res.total_records == ref.total_records,
            "outage bit": ref.commit_failures > 0,
            "K3 and K5 ran": sd_launches.get("sketch_scatter", 0) > 0
            and sd_launches.get("pattern_mine", 0) > 0,
        }
        if not all(sd_checks.values()):
            raise AssertionError(f"chaos path, sketch and dictionary: {sd_checks}; leaves "
                                 f"that differ: {differ}")
        sd_bytes = _dir_bytes(os.path.join(ckdir, f"step_{CKPT_RUN['ticks']:08d}"))
        store = sd["pipes"][2].store
        t0 = time.perf_counter()
        pytree_digest(store)
        store_digest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pytree_digest(build_snapshot(store))
        snapshot_digest_s = time.perf_counter() - t0

    capture = [s * 1e3 for r in regs for s in _span_seconds(r, "checkpoint.capture")]
    write = [s for r in regs for s in _span_seconds(r, "checkpoint.write")]
    restore = _span_seconds(regs[1], "checkpoint.restore")
    store_bytes = sum(a.nbytes for k, a in _components(sd["pipes"][2]).items()
                      if k.startswith("store."))
    print("chaos path: " + json.dumps({
        "card": smi, "deployment": d, "cli_s": cli_s, "verdict": verdict,
        "commits_stored": stored, "k4_launches_wanted": k4_want,
        "launches": {k: launches.get(k, 0) for k in ("fused_upsert", "traffic_ids")},
        "checkpoint_bytes_step48": step_bytes,
        "host_resume_s": host_s, "host_decided_alike": not replayed,
        "sketch_dict": {"ticks": CKPT_RUN["ticks"], "outage": CKPT_OUTAGE, "crash": CKPT_CRASH,
                        "every": CKPT_RUN["checkpoint_every"], "records": res.total_records,
                        "commit_failures": ref.commit_failures,
                        "launches": {k: sd_launches.get(k, 0) for k in
                                     ("fused_upsert", "traffic_ids", "sketch_scatter",
                                      "pattern_mine")},
                        "checkpoint_bytes": sd_bytes, "store_leaf_bytes": store_bytes},
        "checkpoint_capture_ms": capture, "checkpoint_write_s": write,
        "checkpoint_restore_s": restore, "store_digest_s": store_digest_s,
        "snapshot_digest_s": snapshot_digest_s}), flush=True)
    print(f"chaos path on {smi}: launch.chaos killed at {verdict['killed_at']} and resumed "
          f"from {verdict['resumed_from']} bit-exact ({cli_s} s for the three runs); K1 "
          f"{launches.get('fused_upsert', 0)} launches for {stored} stored commits (replays "
          f"included), K4 {launches.get('traffic_ids', 0)} for {k4_want} blocks; the card's "
          f"step-48 checkpoint ({step_bytes} bytes) resumed on the host onto the card's "
          f"digests" + (" under the card's decisions" if replayed else ", deciding for itself")
          + f" ({host_s} s); the sketch and dictionary run resumed bit-exact with K3 "
          f"{sd_launches.get('sketch_scatter', 0)} and K5 {sd_launches.get('pattern_mine', 0)} "
          f"launches, its checkpoint {sd_bytes} bytes; capture "
          f"{statistics.mean(capture)} ms, write {statistics.mean(write)} s, restore "
          f"{restore[0]} s a checkpoint, digests {store_digest_s} s (store) and "
          f"{snapshot_digest_s} s (snapshot)", flush=True)
    return launches


# Phase 31: phase 30's deployment (flash_crowd, 120 ticks, seed 0, a store
# outage over 30:45, the default RetryPolicy, a checkpoint every 16, a kill
# at 60, a 2^20-node, 2^21-edge store) through run_scenario at 32-bit keys,
# with the sketch-guided GraphZip path and lineage on
SCN32_OPTIONS = dict(sketch_guided=True, dict_compress=True, lineage=True)
K32_ENTRIES = ("fused_upsert32", "pattern_mine32", "sketch_scatter", "traffic_ids")
K64_ENTRIES = ("fused_upsert", "pattern_mine")


def scenario32_path(torch, smi):
    """Phase 31: `run_scenario(key_dtype=torch.int32)` on the card,
    uninterrupted and killed and resumed, the card's 32-bit checkpoint
    resumed on the host, and a restore at 64-bit keys refused."""
    import os
    import shutil
    import tempfile

    from repro_torch.kernels import build
    from repro_torch.resilience import FaultPlan, PipelineKilled, RetryPolicy
    from repro_torch.telemetry import TelemetryRegistry
    from repro_torch.workloads import harness

    d = CHAOS_DEFAULTS
    plan = FaultPlan(fail_times=(d["outage"],), crash_at_tick=d["crash_at"])
    kw = dict(ticks=d["ticks"], seed=d["seed"], retry=RetryPolicy(),
              checkpoint_every=d["every"], key_dtype=torch.int32, **SCN32_OPTIONS)
    with tempfile.TemporaryDirectory() as tmp:
        ckdir = os.path.join(tmp, "ck")
        regs = TelemetryRegistry(), TelemetryRegistry()
        build.launches.clear()
        with _chaos_watch() as card:
            t0 = time.perf_counter()
            ref = harness.run_scenario(d["scenario"], fault_plan=plan.without_crash(),
                                       spill_dir=os.path.join(tmp, "ref"), device="cuda", **kw)
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
            try:
                harness.run_scenario(d["scenario"], fault_plan=plan, checkpoint_dir=ckdir,
                                     telemetry=regs[0], spill_dir=os.path.join(tmp, "chaos"),
                                     device="cuda", **kw)
                raise AssertionError("scenario32 path: crash_at_tick never fired")
            except PipelineKilled as killed:
                killed_at = killed.tick
            res = harness.run_scenario(d["scenario"], fault_plan=plan.without_crash(),
                                       checkpoint_dir=ckdir, resume=True, telemetry=regs[1],
                                       spill_dir=os.path.join(tmp, "chaos"), device="cuda",
                                       **kw)
        torch.cuda.synchronize()
        launches = dict(build.launches)
        stored = sum(s[0] for s in card["stored"])
        k4_want = sum(-(-n // SAMPLER_BLOCK) for counts in card["ticks"] for n in counts)
        kept = os.path.join(card["kept"][0], f"step_{d['resumed_from']:08d}")
        with open(os.path.join(kept, "manifest.json")) as f:
            leaves = {leaf["key"]: leaf for leaf in json.load(f)["leaves"]}
        checks = {
            "killed at 60, resumed from 48": (killed_at, res.resumed_from_tick)
            == (d["crash_at"], d["resumed_from"]),
            "digests": (res.store_digest, res.snapshot_digest)
            == (ref.store_digest, ref.snapshot_digest) and bool(ref.store_digest),
            "records": res.total_records == ref.total_records > 0,
            "outage bit": ref.commit_failures > 0,
            "32-bit pipelines": len(card["pipes"]) == 3 and all(
                p.store.node_keys.dtype == p.sink.sketch.hh_keys.dtype == torch.int32
                for p in card["pipes"]),
            "32-bit leaves": leaves["store.0"]["dtype"] == "uint32" and all(
                leaf["dtype"] == "int32" for leaf in leaves.values() if leaf["shape"] == []),
            "32-bit instances ran": all(launches.get(k, 0) > 0 for k in K32_ENTRIES),
            "no 64-bit instance": all(launches.get(k, 0) == 0 for k in K64_ENTRIES),
            "K1 three a stored commit": launches.get("fused_upsert32", 0) == 3 * stored > 0,
            "K3 one a stored commit": launches.get("sketch_scatter", 0) == stored,
            "K4 one a block a tick": launches.get("traffic_ids", 0) == k4_want,
        }
        if not all(checks.values()):
            raise AssertionError(f"scenario32 path: {checks}; launches {launches}, stored "
                                 f"{stored}, K4 wanted {k4_want}")
        step_bytes = _dir_bytes(kept)

        # ---- the card's 32-bit step 48, resumed on the host --------------
        def host_resume(name, decisions=None):
            ckpt = shutil.copytree(card["kept"][0], os.path.join(tmp, name))
            with _chaos_watch(decisions) as host:
                rep = harness.run_scenario(d["scenario"], fault_plan=plan.without_crash(),
                                           checkpoint_dir=ckpt, resume=True, device="cpu",
                                           spill_dir=os.path.join(tmp, f"{name}_spill"), **kw)
            return rep, host["decisions"][0]

        t0 = time.perf_counter()
        host, taken = host_resume("host")
        replayed = taken != card["decisions"][2]
        if replayed:
            host, taken = host_resume("host_replayed", card["decisions"][2])
        host_s = time.perf_counter() - t0
        if (host.store_digest, host.snapshot_digest) != (ref.store_digest, ref.snapshot_digest) \
                or host.total_records != ref.total_records:
            raise AssertionError(f"scenario32 path: the host's resume of the card's step "
                                 f"{d['resumed_from']} gives {host.store_digest[:16]}, "
                                 f"{host.snapshot_digest[:16]} against the card's "
                                 f"{ref.store_digest[:16]}, {ref.snapshot_digest[:16]} "
                                 f"(decisions replayed: {replayed})")

        # ---- the same checkpoint refused at 64-bit keys -------------------
        # the refusal reads the first key leaf before any device work, so a
        # small 64-bit pipeline shows it; the restore writes nothing
        try:
            harness.run_scenario(d["scenario"], checkpoint_dir=card["kept"][0], resume=True,
                                 spill_dir=os.path.join(tmp, "wide_spill"), device="cuda",
                                 node_cap=1 << 10, edge_cap=1 << 12,
                                 **dict(kw, key_dtype=torch.int64))
            raise AssertionError("scenario32 path: a 64-bit pipeline restored 32-bit keys")
        except ValueError as refused:
            if "32-bit keys" not in str(refused) or "64-bit keys" not in str(refused):
                raise
            refusal = str(refused)

    capture = [s * 1e3 for r in regs for s in _span_seconds(r, "checkpoint.capture")]
    write = [s * 1e3 for r in regs for s in _span_seconds(r, "checkpoint.write")]
    restore = [s * 1e3 for s in _span_seconds(regs[1], "checkpoint.restore")]
    wall_ms = 1e3 * ref.wall_s / ref.ticks
    print("scenario32 path: " + json.dumps({
        "card": smi, "deployment": dict(d, **SCN32_OPTIONS, key_bits=32),
        "uninterrupted_s": ref_s, "wall_ms_per_tick": wall_ms,
        "records_per_wall_s": ref.records_per_wall_s, "records": ref.total_records,
        "commit_failures": ref.commit_failures, "pattern_refs": ref.pattern_refs,
        "dict_hit_rate": ref.dict_hit_rate, "commits_stored": stored,
        "launches": {k: launches.get(k, 0) for k in K32_ENTRIES + K64_ENTRIES},
        "k4_launches_wanted": k4_want, "checkpoint_bytes_step48": step_bytes,
        "checkpoint_capture_ms": capture, "checkpoint_write_ms": write,
        "checkpoint_restore_ms": restore, "host_resume_s": host_s,
        "host_decided_alike": not replayed, "refused": refusal}), flush=True)
    print(f"scenario32 path on {smi}: 32-bit keys, killed at {killed_at} and resumed from "
          f"{res.resumed_from_tick} onto the uninterrupted run's digests; {wall_ms} ms a tick "
          f"and {ref.records_per_wall_s} records a wall s uninterrupted; K1 (32-bit) "
          f"{launches.get('fused_upsert32', 0)} for {stored} stored commits, K5 (32-bit) "
          f"{launches.get('pattern_mine32', 0)}, K3 {launches.get('sketch_scatter', 0)}, K4 "
          f"{launches.get('traffic_ids', 0)} for {k4_want} blocks, the 64-bit instances 0; "
          f"the step-48 checkpoint ({step_bytes} bytes) resumed on the host onto the card's "
          f"digests" + (" under the card's decisions" if replayed else ", deciding for itself")
          + f" ({host_s} s) and was refused at 64-bit keys; capture "
          f"{statistics.mean(capture)} ms, write {statistics.mean(write)} ms a checkpoint",
          flush=True)
    return launches


# Phase 32: the distributed ingest over an NCCL world of one, at the
# reference's dryrun caps (src/repro/launch/ingest_dryrun.py:26-27) and
# 2^17 raw edges a commit: the node sweep then takes 2^18 lanes, K1's
# MAX_LANES (the dryrun's 2^18-edge commit would need 2^19, ROADMAP F37)
DIST_CAPS = (1 << 22, 1 << 23)
DIST_COMMITS = 24
DIST_LANES = 1 << 17
DIST_USERS = 1 << 21
DIST_ZIPF_S = 0.8  # a bounded Zipf exponent: both tables end about a third full
DIST_INVALID = 0.1
DIST_INIT_TIMEOUT_S = 60


def _zipf_ranks(rng, n, users, s):
    """n ranks in [0, users) with P(k) about (k + 1)^-s (s < 1), by the
    inverse CDF of the continuous power law."""
    e = 1.0 - s
    x = (((users + 1) ** e - 1) * rng.random(n) + 1) ** (1 / e)
    return np.minimum(x.astype(np.int64) - 1, users - 1)


def _dist_commits(torch, n_commits):
    """Phase 32's raw commits on the host: Zipf-skewed sources and
    destinations over DIST_USERS random 64-bit ids, three edge types,
    DIST_INVALID of the lanes invalid."""
    rng = np.random.default_rng(32)
    users = _random_keys(rng, DIST_USERS)
    out = []
    for _ in range(n_commits):
        src = users[_zipf_ranks(rng, DIST_LANES, DIST_USERS, DIST_ZIPF_S)]
        dst = users[_zipf_ranks(rng, DIST_LANES, DIST_USERS, DIST_ZIPF_S)]
        etype = rng.integers(0, 3, size=DIST_LANES).astype(np.int32)
        valid = rng.random(DIST_LANES) >= DIST_INVALID
        out.append(tuple(torch.from_numpy(a) for a in (src, dst, etype, valid)))
    return out


def _stores_equal(torch, a, b):
    import dataclasses

    return all(torch.equal(getattr(a, f.name).cpu(), getattr(b, f.name).cpu())
               for f in dataclasses.fields(a))


def distributed_path(torch, smi):
    """Phase 32: `make_distributed_ingest` over `make_dev_mesh(1, 1)` in
    an NCCL world of one, 24 commits into the 2^22/2^23 store; the same
    commits through the plain route on the host and through `ingest_step`
    on the card; K1 held at the path's sweeps and its device ms."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core.compression import mix_keys
    from repro_torch.core.counters import int64_counters
    from repro_torch.core.edge_table import build_edge_table
    from repro_torch.graphstore import store as PS
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as M
    from repro_torch.telemetry.spans import TelemetryRegistry

    init = ROOT / "build" / "distributed_pg"
    init.parent.mkdir(parents=True, exist_ok=True)
    init.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=DIST_INIT_TIMEOUT_S))
    try:
        mesh = M.make_dev_mesh(1, 1)
        ingest = PS.make_distributed_ingest(mesh)
        init_s = time.perf_counter() - t0
        host = _dist_commits(torch, DIST_COMMITS + 1)
        extra = host.pop()  # one more commit's sweeps hold K1 below
        card_commits = [tuple(t.cuda() for t in c) for c in host]

        # ---- the card, counted and timed ------------------------------
        card = PS.init_store(*DIST_CAPS)
        torch.cuda.synchronize()
        wall_ms, card_stats = [], []
        build.launches.clear()
        with k1_lanes() as hist:
            for c in card_commits:
                t1 = time.perf_counter()
                card, stats = ingest(card, *c)
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t1) * 1e3)
                card_stats.append(stats)
        launches = dict(build.launches)
        card_stats = [{k: v.cpu() for k, v in s.items()} for s in card_stats]

        # ---- ingest_step on the card (D = 1) ----------------------------
        whole = PS.init_store(*DIST_CAPS)
        step_equal = True
        for c, got in zip(card_commits, card_stats):
            whole, want = PS.ingest_step(whole, build_edge_table(*c))
            step_equal &= all(got[k].item() == want[k].item() for k in got)
        step_equal &= _stores_equal(torch, card, whole) and \
            int64_counters(card) == int64_counters(whole)
        del whole

        # ---- the plain route on the host: the same ranks in one process --
        t1 = time.perf_counter()
        shards = [PS.init_store(*DIST_CAPS, device="cpu")]
        host_equal = True
        for c, got in zip(host, card_stats):
            shards, want = PS.ingest_ranks(shards, *c)
            host_equal &= list(got) == list(want) and all(
                got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in got)
        host_s = time.perf_counter() - t1
        host_equal &= _stores_equal(torch, card, shards[0]) and \
            int64_counters(card) == int64_counters(shards[0])
        del shards

        # ---- K1 at the path's sweeps, against the plain version ---------
        et = build_edge_table(*(t.cuda() for t in extra))
        n_nodes, n_edges = int(card.n_nodes), int(card.n_edges)
        k1_rows = [
            upsert_row(torch, "node", DIST_CAPS[0], card.node_keys, n_nodes, et.node_ids,
                       et.node_valid, int(PS.probe_budget(card.n_nodes, DIST_CAPS[0]))),
            upsert_row(torch, "edge", DIST_CAPS[1], card.edge_keys, n_edges,
                       mix_keys(et.src, et.dst, et.etype).contiguous(), et.edge_valid,
                       int(PS.probe_budget(card.n_edges, DIST_CAPS[1])))]

        # ---- K1's device ms a commit, under torch.profiler --------------
        again = PS.init_store(*DIST_CAPS)
        torch.cuda.synchronize()

        def drive():
            nonlocal again
            for c in card_commits:
                again, _ = ingest(again, *c)

        with k1_lanes() as prof_hist:
            device = _profiled(torch, "distributed ingest", TelemetryRegistry(), drive,
                               ticks=DIST_COMMITS)
        k1 = kernel_device("distributed ingest", "K1", "fused_upsert", device, prof_hist)
        again_equal = _stores_equal(torch, card, again)
        del again
    finally:
        dist.destroy_process_group()
        init.unlink(missing_ok=True)

    last = card_stats[-1]
    new_nodes = sum(int(s["new_nodes"]) for s in card_stats)
    new_edges = sum(int(s["new_edges"]) for s in card_stats)
    lanes = dict(sorted(hist.items()))
    checks = {
        "K1 two a commit": launches.get("fused_upsert", 0) == 2 * DIST_COMMITS
        and set(launches) <= {"fused_upsert"},
        "K1 at 2^18 and 2^17 lanes": lanes == {DIST_LANES: DIST_COMMITS,
                                              2 * DIST_LANES: DIST_COMMITS},
        "equal to the host's plain route": host_equal,
        "equal to ingest_step on the card": step_equal,
        "the profiled run alike": again_equal,
        "counters": (n_nodes, n_edges) == (new_nodes, new_edges) > (0, 0)
        and int64_counters(card) == {"n_nodes", "n_edges"},
        "stats": all(bool(torch.isfinite(v).all()) and v.dim() == 0
                     for s in card_stats for v in s.values()),
        "a third full": 0.25 < n_nodes / DIST_CAPS[0] < 0.45
        and 0.25 < n_edges / DIST_CAPS[1] < 0.45,
    }
    if not all(checks.values()):
        raise AssertionError(f"distributed path: {checks}; launches {launches}, lanes {lanes}")
    out = {
        "card": smi, "world": 1, "backend": "nccl", "mesh": M.mesh_sizes(mesh),
        "caps": DIST_CAPS, "commits": DIST_COMMITS, "raw_edges_a_commit": DIST_LANES,
        "users": DIST_USERS, "zipf_s": DIST_ZIPF_S, "invalid": DIST_INVALID,
        "init_s": init_s, "wall_ms_first_commit": wall_ms[0],
        "wall_ms_a_commit": statistics.mean(wall_ms[1:]),
        "wall_ms_a_commit_median": statistics.median(wall_ms[1:]),
        "wall_ms_a_commit_max": max(wall_ms[1:]),
        "k1_device_ms_a_commit": k1["device_ms"] / DIST_COMMITS,
        "k1_device_ms_a_launch": k1["device_ms_per_launch"],
        "k1_launches": launches.get("fused_upsert", 0), "k1_lanes": lanes,
        "host_route_s": host_s, "n_nodes": n_nodes, "n_edges": n_edges,
        "node_load": float(last["node_load"]), "edge_load": float(last["edge_load"]),
        "probe_rounds_max": max(int(s["probe_rounds"]) for s in card_stats),
        "dropped_inserts": sum(int(s["dropped_inserts"]) for s in card_stats),
        "k1_rows": [{k: r[k] for k in ("sweep", "cap", "lanes", "table_load", "probes", "ms",
                                       "plain_ms", "bound_ms", "max_rounds", "ctas",
                                       "widths_checked", "new", "dropped")} for r in k1_rows],
    }
    print("distributed path: " + json.dumps(out), flush=True)
    print(f"distributed path on {smi}: NCCL world of one, {DIST_COMMITS} commits of "
          f"{DIST_LANES} raw edges into {DIST_CAPS[0]}/{DIST_CAPS[1]}: "
          f"{out['wall_ms_a_commit']} ms a commit after the first ({wall_ms[0]} ms), K1 "
          f"{out['k1_device_ms_a_commit']} device ms a commit over "
          f"{launches.get('fused_upsert', 0)} launches; loads {out['node_load']} / "
          f"{out['edge_load']}; equal to the host's plain route ({host_s} s) and to "
          f"ingest_step on the card", flush=True)
    return launches, k1_rows


def _flash_tol(dtype, S, torch):
    """K7's (atol, rtol) against its plain version: the reference test's
    2e-6 in float32 up to S = 1,024 (its largest S is 512); beyond, 2e-6
    grown with S / 1,024, since each output sums up to S float32 terms
    whose rounding the two versions take in different orders; bf16 at
    BF16_ATOL and BF16_RTOL, tighter than the reference test's 2e-2, which
    at S = 16,384 would be as large as the outputs of the long rows."""
    if dtype == torch.bfloat16:
        return BF16_ATOL, BF16_RTOL
    tol = 2e-6 * max(1.0, S / 1_024)
    return tol, tol


def _valid_pairs(S, causal, window):
    """Unmasked (query, key) pairs of one head: the work K7 must do."""
    i = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, np.int64)
    hi = i + 1 if causal else np.full(S, S, np.int64)
    return int((hi - lo).sum())


def _flash_flops(q, causal, window):
    """K7's work: 4·d flops per unmasked pair per query head."""
    B, S, n, d = q.shape
    return 4 * d * _valid_pairs(S, causal, window) * B * n


def _flash_bound(torch, q, k, causal, window):
    """(least ms, what bounds it) for one K7 launch: its flops at the
    inputs' peak (bf16 tensor cores or float32), against q, k, v and o
    each moved once at their own shapes (k and v at their m kv heads)."""
    flops = _flash_flops(q, causal, window)
    peak = H100_BF16_PER_S if q.dtype == torch.bfloat16 else H100_FP32_PER_S
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    ops_s, bytes_s = flops / peak, nbytes / H100_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def _close(torch, got, want, tol, rtol=None):
    """(within atol = tol and rtol (default tol), largest absolute error),
    in float32."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    rtol = tol if rtol is None else rtol
    return bool(torch.all((g - w).abs() <= tol + rtol * w.abs())), err


def _rel_err(torch, got, want, floor):
    """Largest |got - want| / |want| over the entries with |want| >= floor."""
    g, w = got.float(), want.float()
    big = w.abs() >= floor
    return float(((g - w).abs()[big] / w.abs()[big]).max()) if bool(big.any()) else 0.0


def flash_vs_plain(torch, dev):
    """Phase 20: K7 against its plain version on the card: the path's own
    call (grouped heads, bf16, causal), the (BH, S, d) op over S, d,
    dtype and causality, a 4,096 window at S = 8,192, a 48-key window
    inside a 64-key block, bf16 at d 16 and 32 and at a ragged S = 192;
    then the kernel, the plain version and scaled_dot_product_attention
    (the yardstick only) timed at the path's shape, with the kernel's
    TFLOP/s (4·d flops per unmasked pair) and its share of the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = []
    B, S, n, m, d = FLASH_PATH
    q, k, v = (rnd(B, S, h, d, dtype=torch.bfloat16) for h in (n, m, m))
    chunk = FLASH_PATH_CHUNK
    got = fa.attention(q, k, v, True, None, chunk)
    want = fa.sdpa_chunked_plain(q, k, v, True, None, chunk)
    atol, rtol = _flash_tol(torch.bfloat16, S, torch)
    ok, err = _close(torch, got, want, atol, rtol)
    rel = _rel_err(torch, got, want, atol)
    if not ok:
        raise AssertionError(f"flash_attention kernel != plain at the path's shape: "
                             f"abs {err}, rel {rel}")
    bound_ms, bound_by = _flash_bound(torch, q, k, True, None)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=True, enable_gqa=True)

    path = {"case": "path", "B": B, "S": S, "heads": n, "kv_heads": m, "d": d,
            "dtype": "bfloat16", "causal": True, "window": None, "atol": atol, "rtol": rtol,
            "max_abs_err": err, "max_rel_err": rel,
            "ms": _time_ms(torch, fa.attention, (), (q, k, v, True, None, chunk), KERNEL_REPS),
            "plain_ms": _time_ms(torch, fa.sdpa_chunked_plain, (), (q, k, v, True, None, chunk),
                                 PLAIN_REPS),
            "library_ms": _time_ms(torch, sdpa, (), (qt, kt, vt), KERNEL_REPS),
            "bound_ms": bound_ms, "bound_by": bound_by}
    path["tflops"] = _flash_flops(q, True, None) / (path["ms"] * 1e-3) / 1e12
    path["bound_share"] = bound_ms / path["ms"]
    rows.append(path)
    print("flash", json.dumps(path), flush=True)

    cases = [(FLASH_SWEEP_BH, S_, d_, dt, causal, None, 512)
             for S_ in FLASH_SWEEP_S for d_ in FLASH_SWEEP_D
             for dt in (torch.float32, torch.bfloat16) for causal in (True, False)]
    cases += [(16, 8_192, 128, dt, True, 4_096, 512) for dt in (torch.float32, torch.bfloat16)]
    cases += [(4, 256, 64, dt, True, 48, 64)  # a window inside one 64-key block
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(FLASH_SWEEP_BH, S_, d_, torch.bfloat16, causal, None, 512)
              for S_ in (128, 1_024) for d_ in FLASH_SMALL_D for causal in (True, False)]
    # S a multiple of the plain version's 64-key block but of neither bf16 tile
    cases += [(4, 192, 128, torch.bfloat16, True, None, 64),
              (4, 192, 64, torch.bfloat16, False, None, 64)]
    for BH, S_, d_, dt, causal, window, blk in cases:
        q, k, v = (rnd(BH, S_, d_, dtype=dt) for _ in range(3))
        got = ops.flash_attention(q, k, v, causal=causal, window=window, block_q=blk,
                                  block_k=blk)
        want = fa.sdpa_chunked_plain(q[:, :, None], k[:, :, None], v[:, :, None], causal,
                                     window, min(blk, S_))[:, :, 0]
        atol, rtol = _flash_tol(dt, S_, torch)
        ok, err = _close(torch, got, want, atol, rtol)
        row = {"case": "op", "BH": BH, "S": S_, "d": d_, "dtype": str(dt)[6:],
               "causal": causal, "window": window, "atol": atol, "rtol": rtol,
               "max_abs_err": err, "max_rel_err": _rel_err(torch, got, want, atol)}
        if not ok:
            raise AssertionError(f"flash_attention kernel != plain: {row}")
        rows.append(row)
        print("flash", json.dumps(row), flush=True)
    print(f"flash_attention kernel == plain within the stated tolerances at all {len(rows)} "
          f"shapes; largest f32 error {max(r['max_abs_err'] for r in rows if r['dtype'] == 'float32')}, "
          f"bf16 {max(r['max_abs_err'] for r in rows if r['dtype'] == 'bfloat16')} (relative "
          f"{max(r['max_rel_err'] for r in rows if r['dtype'] == 'bfloat16')})", flush=True)
    return rows


def _ssd_inputs(torch, gen, dev, Bsz, S, nh, p, N, dtype=None):
    """The reference test's inputs: x, B, C normal, dt = softplus(normal),
    A = -|normal|."""
    import torch.nn.functional as F

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = rnd(Bsz, S, nh, p)
    return (x if dtype is None else x.to(dtype), F.softplus(rnd(Bsz, S, nh)),
            -rnd(nh).abs(), rnd(Bsz, S, N), rnd(Bsz, S, N))


def _ssd_flops(x, B, Q):
    """K8's own work: C·Bᵀ once per (batch row, chunk), since every head
    shares B and C, at N·Q(Q + 1) flops over the causal pairs (j <= i, as
    K7 counts only unmasked pairs); per head the intra product's
    p·Q(Q + 1) over the same pairs and 4QNp for the state's two products."""
    Bsz, S, nh, p = x.shape
    N = B.shape[-1]
    return (N * Q * (Q + 1) + nh * (p * Q * (Q + 1) + 4 * Q * N * p)) * (S // Q) * Bsz


def _ssd_bound(x, B, Q):
    """(least ms, what bounds it) for one K8 call: `_ssd_flops` at the
    float32 peak (every product of the kernel is float32 FMA), against its
    inputs and outputs at the kernel's own layout, each moved once (x and
    y, dt, A, B and C shared by the heads, the final state)."""
    Bsz, S, nh, p = x.shape
    N = B.shape[-1]
    nbytes = 4 * (2 * x.numel() + Bsz * S * nh + nh + 2 * B.numel() + Bsz * nh * N * p)
    ops_s, bytes_s = _ssd_flops(x, B, Q) / H100_FP32_PER_S, nbytes / H100_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def ssd_vs_plain(torch, dev):
    """Phase 21: K8 against its plain version on the card, y and final
    state within 1e-4: the path's own call (4 x 48 heads sharing B and C,
    S = 4,096, p = 64, N = 128, Q = 256, f32), 8 heads sharing B and C
    over 4 chunks at the path's p, N and Q in f32 and with a bf16 x, then
    the (BH, S, *) op at smaller shapes (one with Q = S, one chunk), and
    a bf16 x at the reference test's bf16 tolerance; the kernel and the
    plain version timed at the path's shape (no single PyTorch call
    computes this), with the kernel's TFLOP/s (`_ssd_flops`) and its
    share of the bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    rows = []
    Bsz, S, nh, p, N, Q = SSD_PATH
    x, dt, A, Bm, Cm = _ssd_inputs(torch, gen, dev, Bsz, S, nh, p, N)
    y, st = ss.scan(x, dt, A, Bm, Cm, Q)
    yp, stp = ss.ssd_chunked_plain(x, dt, A, Bm, Cm, Q)
    (oky, erry), (oks, errs) = _close(torch, y, yp, SSD_TOL), _close(torch, st, stp, SSD_TOL)
    if not (oky and oks):
        raise AssertionError(f"ssd_scan kernel != plain at the path's shape: y {erry} "
                             f"state {errs}")
    try:
        ss.scan(x, dt, A, Bm, Cm, Q, init_state=st)
    except ValueError:
        pass  # the kernel starts from a zero state: no fallback to the plain version
    else:
        raise AssertionError("ssd_scan on the card took an init_state")
    bound_ms, bound_by = _ssd_bound(x, Bm, Q)
    path = {"case": "path", "B": Bsz, "S": S, "heads": nh, "p": p, "N": N, "Q": Q,
            "dtype": "float32", "tol": SSD_TOL, "max_abs_err": max(erry, errs),
            "ms": _time_ms(torch, ss.scan, (), (x, dt, A, Bm, Cm, Q), KERNEL_REPS),
            "plain_ms": _time_ms(torch, ss.ssd_chunked_plain, (), (x, dt, A, Bm, Cm, Q),
                                 PLAIN_REPS),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    path["tflops"] = _ssd_flops(x, Bm, Q) / (path["ms"] * 1e-3) / 1e12
    path["bound_share"] = bound_ms / path["ms"]
    rows.append(path)
    print("ssd", json.dumps(path), flush=True)
    Bsz, S, nh, p, N, Q = SSD_SHARED
    for xdt, tol in ((torch.float32, SSD_TOL), (torch.bfloat16, 1e-1)):
        x, dt, A, Bm, Cm = _ssd_inputs(torch, gen, dev, Bsz, S, nh, p, N, xdt)
        y, st = ss.scan(x, dt, A, Bm, Cm, Q)
        yp, stp = ss.ssd_chunked_plain(x, dt, A, Bm, Cm, Q)
        (oky, erry), (oks, errs) = _close(torch, y, yp, tol), _close(torch, st, stp, tol)
        row = {"case": "shared", "B": Bsz, "S": S, "heads": nh, "p": p, "N": N, "Q": Q,
               "dtype": str(xdt)[6:], "tol": tol, "max_abs_err": max(erry, errs)}
        if not (oky and oks):
            raise AssertionError(f"ssd_scan kernel != plain: {row}")
        rows.append(row)
        print("ssd", json.dumps(row), flush=True)
    cases = [(c, torch.float32, SSD_TOL) for c in SSD_SMALL]
    cases.append((SSD_SMALL[2], torch.bfloat16, 1e-1))  # tests/test_kernels.py:116's bf16
    for (BH, S_, p_, N_, Q_), xdt, tol in cases:
        x, dt, A, Bm, Cm = _ssd_inputs(torch, gen, dev, BH, S_, 1, p_, N_, xdt)
        x, dt, A = x[:, :, 0], dt[:, :, 0], A.expand(BH).contiguous()
        y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q_)
        yp, stp = ss.ssd_chunked_plain(x[:, :, None], dt[:, :, None], A[:, None], Bm, Cm,
                                       min(Q_, S_))
        (oky, erry), (oks, errs) = (_close(torch, y, yp[:, :, 0], tol),
                                    _close(torch, st, stp[:, 0], tol))
        row = {"case": "op", "BH": BH, "S": S_, "p": p_, "N": N_, "Q": Q_,
               "dtype": str(xdt)[6:], "tol": tol, "max_abs_err": max(erry, errs)}
        if not (oky and oks):
            raise AssertionError(f"ssd_scan kernel != plain: {row}")
        rows.append(row)
        print("ssd", json.dumps(row), flush=True)
    print(f"ssd_scan kernel == plain (y and final state) within the stated tolerances at all "
          f"{len(rows)} shapes", flush=True)
    return rows


def _serve_path(torch, label, argv, kernel, want):
    """Drive `launch.serve` with `argv`, launch counters set to 0 just
    before and read just after; `kernel` must launch `want` times.
    Prints the serving figures and returns (run, launches)."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    build.launches.clear()
    t0 = time.perf_counter()
    out = serve.run(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(build.launches)
    if launches.get(kernel, 0) != want:
        raise AssertionError(f"{label}: {kernel} launched {launches.get(kernel, 0)} times, "
                             f"expected {want}: {launches}")
    args = serve.parse_args(argv)
    logits = torch.stack(out.logits)
    if not (out.gen.shape == (args.batch, args.gen) and (out.gen >= 0).all()
            and (out.gen < out.cfg.padded_vocab).all() and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{label}: no finite result of the expected shape")
    print(f"{label}: " + json.dumps({
        "arch": out.cfg.arch_id, "batch": args.batch, "prompt_len": args.prompt_len,
        "gen": args.gen, "prefill_ms": out.prefill_ms, "decode_ms": out.decode_ms,
        "decode_ms_per_step": out.decode_ms / (args.gen - 1), "tok_per_s": out.tok_per_s,
        "prefill_tok_per_s": args.batch * args.prompt_len / (out.prefill_ms / 1e3),
        "max_memory_allocated": torch.cuda.max_memory_allocated(), "wall_s": wall_s,
        "launches": launches, "ids0": out.gen[0][:8].tolist()}), flush=True)
    return out, launches


def _device_summary(torch, prof, wall_ms, kernel):
    """Device busy time, idle share, launches and `kernel`'s share from a
    profile whose window took `wall_ms` on the host clock."""
    from torch.autograd import DeviceType

    device = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                     for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in device)
    k_ms = sum(ms for name, ms, _ in device if kernel in name)
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy if device else "not measured",
        "device_idle_share": 1 - busy / wall_ms if device else "not measured",
        "device_events": sum(c for _, _, c in device),  # kernels and copies
        f"{kernel}_device_ms": k_ms if device else "not measured",
        f"{kernel}_launches": sum(c for name, _, c in device if kernel in name),
        f"{kernel}_share_of_busy": k_ms / busy if busy else None,
        "top_device": [{"name": name[:80], "ms": ms, "count": c}
                       for name, ms, c in device[:6]]}


def _serving_profile(torch, label, argv, kernel, steps=4):
    """`argv`'s deployment once more, on the CLI's own weights and prompts,
    under torch.profiler: the prefill, then `steps` decode steps.  Prints
    each window's device busy time, idle share and launches and
    `kernel`'s device time; returns the prefill's summary."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.kvcache import pad_cache_to

    cfg, model, tokens = serve.deployment(serve.parse_args(argv))
    tokens = tokens.to(next(model.parameters()).device)
    S = tokens.shape[1]
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad():
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            logits, cache = M.prefill(model, cfg, {"tokens": tokens})
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prefill = _device_summary(torch, prof, wall_ms, kernel)
        cache = pad_cache_to(cache, S + steps)
        tok = logits.argmax(dim=-1).to(torch.int32)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, cache = M.decode_step(model, cfg, cache, tok, S + i)
                tok = logits.argmax(dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        decode = _device_summary(torch, prof, wall_ms, kernel)
    print(f"{label} prefill profile: " + json.dumps(prefill), flush=True)
    print(f"{label} decode profile ({steps} steps): " + json.dumps(decode), flush=True)
    return prefill


def serve_long(torch):
    """Phase 22: `launch.serve` on qwen2.5-3b at full width and depth with
    a 16,384-token prompt: the chunked attention branch, one K7 launch a
    layer; then that prefill and four decode steps profiled."""
    out, launches = _serve_path(torch, "serve long prompt", SERVE_LONG_ARGV,
                                "flash_attention", 36)
    prefill = _serving_profile(torch, "serve long prompt", SERVE_LONG_ARGV, "flash_attention")
    return out, launches, prefill["flash_attention_device_ms"]


def serve_default(torch):
    """Phase 23: `launch.serve` at the CLI's defaults (qwen2.5-3b, batch
    4, prompt 32, gen 16): the materialised-attention branch, no K7."""
    return _serve_path(torch, "serve defaults", SERVE_DEFAULT_ARGV, "flash_attention", 0)


def serve_ssm(torch):
    """Phase 24: `launch.serve` on mamba2-780m at full width and depth,
    batch 4 x 4,096 tokens: one K8 call a layer; then that prefill and
    four decode steps profiled, with the profile's count of K8's device
    kernels beside the wrapper's count of calls."""
    out, launches = _serve_path(torch, "serve mamba2", SERVE_SSM_ARGV, "ssd_scan", 48)
    prefill = _serving_profile(torch, "serve mamba2", SERVE_SSM_ARGV, "ssd_scan")
    calls, kernels = launches["ssd_scan"], prefill["ssd_scan_launches"]
    print(f"serve mamba2: {calls} ssd_scan wrapper calls in the served run; "
          f"{kernels} ssd_scan device kernels in the profiled prefill, "
          f"{kernels / calls} a call", flush=True)
    return out, launches, prefill["ssd_scan_device_ms"]


def serve_cuda_vs_cpu(torch):
    """Phase 25: one set of smoke-size float32 weights (the port's init)
    served on the card and on the host: prefill logits and every decode
    step's logits within 1e-4, greedy ids equal.  The dense config's
    attn_full_max is lowered to 64 so its 128-token prefill takes the
    chunked branch (K7); the SSM prompt of 133 tokens pads to its chunk
    (K8)."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    rng = np.random.default_rng(25)
    for arch, S, kernel, extra in (("qwen2.5-3b", 128, "flash_attention", {"attn_full_max": 64}),
                                   ("mamba2-780m", 133, "ssd_scan", {})):
        cfg = dataclasses.replace(smoke_config(get_config(arch)), dtype="float32", **extra)
        host = M.init_params(cfg, "cpu", seed=0)
        card = copy.deepcopy(host).to("cuda")
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32))
        build.launches.clear()
        got = serve.serve(cfg, card, tokens, 8)
        launches = dict(build.launches)
        want = serve.serve(cfg, host, tokens, 8)
        if launches.get(kernel, 0) != cfg.num_layers:
            raise AssertionError(f"{arch}: {kernel} launched {launches}, expected one a layer")
        errs = []
        for i, (g, w) in enumerate(zip(got.logits, want.logits)):
            ok, err = _close(torch, g.cpu(), w, PARITY_TOL)
            errs.append(err)
            if not ok:
                raise AssertionError(f"{arch}: cuda and cpu logits differ at step {i}: {err}")
        if not np.array_equal(got.gen, want.gen):
            raise AssertionError(f"{arch}: cuda and cpu greedy ids differ: {got.gen} vs "
                                 f"{want.gen}")
        print(f"cuda vs cpu serving ({arch} smoke, float32, prompt {S}, 8 tokens): logits "
              f"within {PARITY_TOL} at every step (largest error {max(errs)}), greedy ids "
              f"equal, {kernel} launches {launches[kernel]}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    import repro_torch

    if SRC not in Path(repro_torch.__file__).resolve().parents:
        sys.exit(f"chip_smoke: repro_torch must come from {SRC}")
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s for {sorted(logs)}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    def phase(number, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {number} ({fn.__name__}): {time.perf_counter() - t:.3f} s", flush=True)
        return out

    rows = phase(1, kernel_vs_plain, torch, dev)
    launches = phase(2, main_path, torch)
    phase(3, tick_breakdown, torch)
    phase(4, cuda_vs_cpu, torch)
    sketch_rows, update_kernels = phase(5, sketch_vs_plain, torch, dev)
    query_launches = phase(6, query_path, torch)
    phase(7, query_breakdown, torch)
    phase(8, query_cuda_vs_cpu, torch)
    traffic_rows = phase(9, traffic_vs_plain, torch, dev)
    workload_launches = phase(10, workload_path, torch)
    path_batch, k4_path = phase(11, workload_breakdown, torch)
    mine_rows = phase(12, mine_vs_plain, torch, dev, path_batch)
    phase(13, workload_cuda_vs_cpu, torch)
    dedup_rows, dedup_launches = phase(14, dedup_vs_plain, torch, dev)
    bloom_rows, bloom_launches, bloom_step = phase(15, bloom_vs_plain, torch, dev)
    phase(16, sharded_path, torch)
    phase(17, sharded_breakdown, torch)
    phase(18, sharded_workload_path, torch)
    phase(19, sharded_cuda_vs_cpu, torch)
    flash_rows = phase(20, flash_vs_plain, torch, dev)
    ssd_rows = phase(21, ssd_vs_plain, torch, dev)
    _, long_launches, k7_prefill_ms = phase(22, serve_long, torch)
    phase(23, serve_default, torch)
    _, ssm_launches, k8_prefill_ms = phase(24, serve_ssm, torch)
    phase(25, serve_cuda_vs_cpu, torch)
    phase(26, sharded_workload_breakdown, torch)
    phase(27, monitored_workload, torch, smi)
    k32_by_width, k32_upsert, k32_mine = phase(28, keys32_path, torch)
    phase(29, lineage_path, torch, smi)
    phase(30, chaos_path, torch, smi)
    scn32_launches = phase(31, scenario32_path, torch, smi)
    dist_launches, dist_rows = phase(32, distributed_path, torch, smi)

    # the main path's widest sweep at its own table load (under 1%)
    ref = next(r for r in rows if r["sweep"] == "node" and r["lanes"] == NODE_SWEEP[2]
               and r["load"] == 0.0 and r["probes"] == 32)
    # the query path's widest sketch update, with skewed keys as tweets have
    sref = next(r for r in sketch_rows if r["width"] == 512 and r["lanes"] == 8_192
                and r["keys"] == "zipf")
    # the workload path's block, in its scenario at full burst
    tref = next(r for r in traffic_rows if r["scenario"] == "flash_crowd" and r["burst"] == 1.0
                and r["lanes"] == 2048 and "ms" in r)
    # the largest batch the workload path mined
    mref = next(r for r in mine_rows if r["batch"] == "path")
    # the reference's VMEM block with the bench's key distribution
    dref = next(r for r in dedup_rows if r["lanes"] == 65_536 and "ms" in r)
    # the default node table's lanes into the default 64-row filter
    bref = next(r for r in bloom_rows if r["rows"] == 64 and r["lanes"] == 16_384)
    # the serving paths' own calls: qwen2.5-3b's 16,384-token prefill and
    # mamba2-780m's 4 x 4,096-token prefill
    fref, sref8 = flash_rows[0], ssd_rows[0]
    kernels = [{
        "name": "fused_upsert", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_upsert.cu",
        "replaces": "src/repro/kernels/upsert.py:104",
        "launches": launches["fused_upsert"] + dist_launches["fused_upsert"],
        "launches_by_path": {"launch.ingest (phase 2)": launches["fused_upsert"],
                             "make_distributed_ingest (phase 32)":
                             dist_launches["fused_upsert"]},
        "matched": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows + dist_rows),
        "ms": ref["ms"], "plain_ms": ref["plain_ms"], "bound_ms": ref["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "max_rounds": ref["max_rounds"],
        "ctas": ref["ctas"],
        "shape": {k: ref[k] for k in ("sweep", "cap", "lanes", "load", "probes")},
        "distributed_sweeps": [{k: r[k] for k in ("sweep", "cap", "lanes", "table_load",
                                                  "probes", "ms", "plain_ms", "bound_ms",
                                                  "ctas")} for r in dist_rows],
    }, {
        "name": "sketch_scatter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sketch_scatter.cu",
        "replaces": "src/repro/kernels/sketch.py:63",
        "launches": query_launches["sketch_scatter"], "matched": True,
        "max_abs_err": max(r["max_abs_err"] for r in sketch_rows),
        "ms": sref["ms"], "plain_ms": sref["plain_ms"], "bound_ms": sref["bound_ms"],
        "bound_by": "bytes", "library_ms": sref["library_ms"],
        "library": "three index_add_ calls",
        "entries": [{
            "name": "sketch_scatter", "takes": "hash coordinates r, c (the Pallas kernel's)",
            "ms": sref["ms"], "plain_ms": sref["plain_ms"], "bound_ms": sref["bound_ms"],
            "library_ms": sref["library_ms"]}, {
            "name": "sketch_absorb", "takes": "src, dst key bits, hashed in the kernel",
            "ms": sref["absorb_ms"], "plain_ms": sref["absorb_plain_ms"],
            "bound_ms": sref["absorb_bound_ms"], "library_ms": None,
            "library": "none: no single PyTorch call hashes and scatters"}],
        "launch_floor_ms": sref["launch_floor_ms"], "plan": sref["plan"],
        "sketch_update_device_kernels": update_kernels,
        "shape": {k: sref[k] for k in ("depth", "width", "lanes", "keys")},
    }, {
        "name": "traffic_ids", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/traffic_ids.cu",
        "replaces": "src/repro/kernels/sampler.py:159",
        "launches": workload_launches["traffic_ids"], "matched": True,
        "max_abs_err": max(r["max_abs_err"] for r in traffic_rows),
        "ms": tref["ms"], "plain_ms": tref["plain_ms"], "bound_ms": tref["bound_ms"],
        "bound_by": tref["bound_by"], "library_ms": None,
        "plan": tref["plan"], "launch_floor_ms": tref["launch_floor_ms"],
        "device_ms_per_launch": k4_path["device_ms_per_launch"],
        "device_ms_per_launch_of": "launch.workload's path under torch.profiler (phase 11)",
        "shape": {k: tref[k] for k in ("scenario", "burst", "lanes")},
    }, {
        "name": "pattern_mine", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pattern_mine.cu",
        "replaces": "src/repro/kernels/pattern_mine.py:174",
        "launches": workload_launches["pattern_mine"], "matched": True,
        "max_abs_err": max(r["max_abs_err"] for r in mine_rows),
        "ms": mref["ms"], "plain_ms": mref["plain_ms"], "bound_ms": mref["bound_ms"],
        "bound_by": mref["bound_by"], "library_ms": None,
        "device_kernels": mref["device_kernels"],
        "shape": {k: mref[k] for k in ("batch", "lanes", "valid")},
    }, {
        "name": "sort_dedup", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sort_dedup.cu",
        "replaces": "src/repro/kernels/edge_dedup.py:68",
        "path": "kernels.ops.sort_dedup (phase 14)",
        "launches": dedup_launches["sort_dedup"], "matched": True,
        "max_abs_err": max(r["max_abs_err"] for r in dedup_rows),
        "ms": dref["ms"], "plain_ms": dref["plain_ms"], "bound_ms": dref["bound_ms"],
        "bound_by": dref["bound_by"], "library_ms": dref["library_ms"],
        "library": "torch.sort (another tie order: a yardstick of time only)",
        "device_kernels": dref["device_kernels"],
        "shape": {k: dref[k] for k in ("lanes", "keys")},
    }, {
        "name": "bloom_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bloom.cu",
        "replaces": "src/repro/kernels/bloom.py:77",
        "path": "kernels.ops.bloom_probe and bloom_diversity (phase 15)",
        "launches": bloom_launches["bloom_probe"] + bloom_launches["bloom_diversity"],
        "matched": True, "max_abs_err": max(r["max_abs_err"] for r in bloom_rows),
        "ms": bref["probe_ms"], "plain_ms": bref["probe_plain_ms"],
        "bound_ms": bref["probe_bound_ms"], "bound_by": "bytes", "library_ms": None,
        "plan": bref["plan"], "launch_floor_ms": bref["launch_floor_ms"],
        "entries": [{"name": "bloom_probe", "launches": bloom_launches["bloom_probe"]},
                    {"name": "bloom_diversity", "launches": bloom_launches["bloom_diversity"],
                     "takes": "the probe and the build of one step in one launch"}],
        "step_ms": bloom_step["step_ms"], "step_plain_ms": bloom_step["step_plain_ms"],
        "step_bound_ms": bloom_step["step_bound_ms"],
        "device_kernels": bloom_step["device_kernels"],
        "device_kernels_of": "one ops.bloom_diversity step, 64 rows, 16,384 Zipf keys",
        "shape": {k: bref[k] for k in ("rows", "lanes")},
    }, {
        "name": "bloom_build", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bloom.cu",
        "replaces": "src/repro/kernels/bloom.py:97",
        "path": "kernels.ops.bloom_build and bloom_diversity (phase 15)",
        "launches": bloom_launches["bloom_build"] + bloom_launches["bloom_diversity"],
        "matched": True,
        "max_abs_err": max([r["max_abs_err"] for r in bloom_rows] + [bloom_step["max_abs_err"]]),
        "ms": bref["build_ms"], "plain_ms": bref["build_plain_ms"],
        "bound_ms": bref["build_bound_ms"], "bound_by": "bytes", "library_ms": None,
        "plan": bref["plan"], "launch_floor_ms": bref["launch_floor_ms"],
        "entries": [{"name": "bloom_build", "launches": bloom_launches["bloom_build"]},
                    {"name": "bloom_diversity", "launches": bloom_launches["bloom_diversity"],
                     "takes": "the probe and the build of one step in one launch"}],
        "step_ms": bloom_step["step_ms"], "step_plain_ms": bloom_step["step_plain_ms"],
        "step_bound_ms": bloom_step["step_bound_ms"],
        "device_kernels": bloom_step["device_kernels"],
        "device_kernels_of": "one ops.bloom_diversity step, 64 rows, 16,384 Zipf keys",
        "shape": {k: bref[k] for k in ("rows", "lanes")},
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96",
        "path": "launch.serve --arch qwen2.5-3b --prompt-len 16384 (phase 22)",
        "launches": long_launches["flash_attention"], "matched": True,
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "ms": fref["ms"], "plain_ms": fref["plain_ms"], "bound_ms": fref["bound_ms"],
        "bound_by": fref["bound_by"], "library_ms": fref["library_ms"],
        "library": "scaled_dot_product_attention (the yardstick only)",
        "prefill_device_ms": k7_prefill_ms, "tflops": fref["tflops"],
        "bound_share": fref["bound_share"],
        "shape": {k: fref[k] for k in ("B", "S", "heads", "kv_heads", "d", "dtype")},
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:82",
        "path": "launch.serve --arch mamba2-780m --prompt-len 4096 (phase 24)",
        "launches": ssm_launches["ssd_scan"], "matched": True,
        "max_abs_err": max(r["max_abs_err"] for r in ssd_rows),
        "ms": sref8["ms"], "plain_ms": sref8["plain_ms"], "bound_ms": sref8["bound_ms"],
        "bound_by": sref8["bound_by"], "library_ms": None,
        "prefill_device_ms": k8_prefill_ms, "tflops": sref8["tflops"],
        "bound_share": sref8["bound_share"],
        "shape": {k: sref8[k] for k in ("B", "S", "heads", "p", "N", "Q")},
    }]
    # the 32-bit instances at phase 1's node sweep and the path's largest
    # mined batch, each beside the 64-bit instance on the same keys
    uref = next(r for r in k32_upsert if r["key_bits"] == 32 and r["lanes"] == NODE_SWEEP[2]
                and r["load"] == 0.0)
    u64 = next(r for r in k32_upsert if r["key_bits"] == 64 and r["lanes"] == NODE_SWEEP[2]
               and r["load"] == 0.0)
    m32 = next(r for r in k32_mine if r["batch"] == "path")
    k32_path = ("PipelineBuilder(key_dtype=torch.int32): the ingest deployment with the "
                "query sink and GraphZip (phase 28)")
    kernels += [{
        "name": "fused_upsert32", "route": "cuda", "entry": "fused_upsert32_launch",
        "source": "src/repro_torch/kernels/csrc/fused_upsert.cu",
        "replaces": "src/repro/kernels/upsert.py:104", "path": k32_path,
        "launches": k32_by_width["fused_upsert32"], "matched": True,
        "launches_scenario32": scn32_launches.get("fused_upsert32", 0),
        "max_abs_err": max(r["max_abs_err"] for r in k32_upsert),
        "ms": uref["ms"], "plain_ms": uref["plain_ms"], "bound_ms": uref["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "ms_64": u64["ms"],
        "bound_ms_64": u64["bound_ms"], "max_rounds": uref["max_rounds"], "ctas": uref["ctas"],
        "shape": {"cap": uref["cap"], "lanes": uref["lanes"], "load": uref["load"],
                  "probes": uref["probes"], "key_bits": 32},
    }, {
        "name": "pattern_mine32", "route": "cuda", "entry": "pattern_mine32_launch",
        "source": "src/repro_torch/kernels/csrc/pattern_mine.cu",
        "replaces": "src/repro/kernels/pattern_mine.py:174", "path": k32_path,
        "launches": k32_by_width["pattern_mine32"], "matched": True,
        "launches_scenario32": scn32_launches.get("pattern_mine32", 0),
        "max_abs_err": max(r["max_abs_err"] for r in k32_mine),
        "ms": m32["ms"], "plain_ms": m32["plain_ms"], "bound_ms": m32["bound_ms"],
        "bound_by": m32["bound_by"], "library_ms": None, "ms_64": m32["ms_64"],
        "bound_ms_64": m32["bound_ms_64"],
        "shape": {"batch": "path", "lanes": m32["lanes"], "valid": m32["valid"],
                  "key_bits": 32},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
