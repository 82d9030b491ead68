"""Query-engine entry point: ingest a stream, then query the graph.

  PYTHONPATH=src python -m repro_torch.launch.query                 # ingest->query
  PYTHONPATH=src python -m repro_torch.launch.query --mode live     # query-while-ingesting
  PYTHONPATH=src python -m repro_torch.launch.query --dryrun --device cpu   # smoke, on the host

Counterpart of `repro.launch.query`, with the same flags and printout,
plus `--device {cuda,cpu}` (default the card).  Ingests a simulated
burst through the pipeline with the sketch on at two places (a
`SketchStage` after the filter and a commit-consistent `QuerySink`
around the store sink), then serves the incrementally maintained CSR
snapshot and runs the exact engine ops (degree distribution, top-k
heavy nodes, k-hop expansion, triangle count), printing the sketch
estimates next to the exact answers.  In `--mode live` the sketch's
heavy-hitter answers stream to stdout during ingestion through the
MetricsHub "sketch" events.
"""
import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api import GraphStoreSink, MetricsHub, PipelineBuilder
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.ingest.sources import BurstyTweetSource
from repro_torch.query import (
    SketchStage,
    degree_distribution,
    edge_lookup,
    k_hop,
    top_k_degree,
    triangle_count,
)
from repro_torch.query.stage import keys_to_numpy


@dataclasses.dataclass
class QueryRun:
    """What `run` did: its exit code, the pipeline and its report, the
    filter-time sketch stage, the served snapshot and its serve time,
    and the spot-checked edge weights (exact and sketched)."""

    code: int
    pipe: object
    report: object
    sketch_stage: SketchStage
    snapshot: object
    serve_ms: float
    exact_w: np.ndarray
    est_w: np.ndarray


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--rate", type=float, default=60.0)
    ap.add_argument("--burst", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", choices=["snapshot", "live"], default="snapshot",
                    help="snapshot: ingest then query; live: print sketch "
                         "answers during ingestion, then query")
    ap.add_argument("--depth", type=int, default=4, help="sketch depth D")
    ap.add_argument("--width", type=int, default=512, help="sketch width W")
    ap.add_argument("--node-cap", type=int, default=1 << 12)
    ap.add_argument("--edge-cap", type=int, default=1 << 14)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--hops", type=int, default=2)
    ap.add_argument("--query-every", type=int, default=20,
                    help="live mode: emit sketch answers every N commits")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny end-to-end run (CI smoke)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run(argv=None, telemetry=None) -> QueryRun:
    """Run the query CLI on `argv`.  `telemetry`, a `TelemetryRegistry`,
    is threaded through the hub, the transform, the ingestor, both
    sketches and the snapshot maintainer when given."""
    args = _parser().parse_args(argv)
    if args.dryrun:
        args.ticks = min(args.ticks, 25)
        args.node_cap, args.edge_cap = 1 << 11, 1 << 12
        args.width = 256
    dev = args.device

    cfg = IngestConfig(mean_rate=args.rate, burst_multiplier=args.burst,
                       store_nodes=args.node_cap, store_edges=args.edge_cap)
    src = BurstyTweetSource(seed=args.seed, mean_rate=args.rate,
                            burst_multiplier=args.burst)
    sketch_stage = SketchStage(depth=args.depth, width=args.width, device=dev)
    b = (PipelineBuilder(cfg, device=dev)
         .with_source(src)
         .with_sink(GraphStoreSink(node_cap=args.node_cap, edge_cap=args.edge_cap,
                                   device=dev))
         .with_sketch(sketch_stage)
         .with_query_sink(depth=args.depth, width=args.width,
                          answer_every=args.query_every, top_k=5,
                          exact_topk=3 if args.mode == "live" else 0))
    if telemetry is not None:
        b = b.with_metrics(MetricsHub(telemetry=telemetry))
    if args.mode == "live":
        def on_sketch(ev):
            if ev.kind == "sketch":
                pairs = list(zip(ev.payload["hh_keys"], ev.payload["hh_counts"]))
                exact = ""
                if "exact_degrees" in ev.payload:
                    exact = " exact-deg: " + " ".join(
                        f"{k:#x}:{d}" for k, d in zip(ev.payload["exact_keys"],
                                                      ev.payload["exact_degrees"])
                        if k)
                print(f"[t={ev.t:7.1f}] live sketch: commits={ev.payload['commits']} "
                      f"absorbed={ev.payload['absorbed']} top: "
                      + " ".join(f"{k:#x}:{c}" for k, c in pairs if k) + exact)
        b = b.on_event(on_sketch)
    pipe = b.build()
    qsink = pipe.sink  # QuerySink (commit-consistent sketch)
    if telemetry is not None:
        for part in (pipe.transform, qsink.ingestor, sketch_stage, qsink, qsink.maintainer):
            part.telemetry = telemetry

    rep = pipe.run(max_ticks=args.ticks)
    store = pipe.store
    print(f"ingested: {rep.total_records} records -> "
          f"{int(store.n_nodes)} nodes, {int(store.n_edges)} edges "
          f"({rep.total_instructions} instructions)")

    # ---- snapshot + exact queries (incrementally maintained CSR) ----
    _sync(dev)
    t0 = time.perf_counter()
    snap = qsink.snapshot()
    _sync(dev)
    serve_ms = (time.perf_counter() - t0) * 1e3
    m = qsink.maintainer
    print(f"snapshot: {int(snap.n_nodes)} nodes, {int(snap.n_edges)} edges, "
          f"served in {serve_ms:.1f} ms "
          f"(maintenance: {m.full_builds} full builds, "
          f"{m.delta_applies} delta applies)")
    dangling = int(store.n_edges) - int(snap.n_edges)
    if dangling:
        print(f"  ({dangling} edges dropped: endpoint node inserts failed — "
              f"node table at {int(store.n_nodes)}/{args.node_cap} load; "
              f"raise --node-cap)")

    hist = degree_distribution(snap, num_bins=16).cpu().numpy()
    print("degree distribution (bins 0..14, 15+):", hist.tolist())

    keys_t, degs_t = top_k_degree(snap, args.topk)
    keys, degs = keys_to_numpy(keys_t), degs_t.cpu().numpy()
    sk_deg = sketch_stage.degree(keys)
    qs_deg = qsink.degree(keys)
    print(f"top-{args.topk} by degree (exact | sketch@filter | sketch@commit):")
    for k, d, s1, s2 in zip(keys, degs, sk_deg, qs_deg):
        if k:
            print(f"  node {int(k):#018x}  degree={int(d):5d}  "
                  f"sketch={int(s1):5d}  commit-sketch={int(s2):5d}")
    hh_k, hh_c = qsink.heavy_hitters(args.topk)
    overlap = len(set(hh_k[hh_k != 0].tolist()) & set(keys[keys != 0].tolist()))
    print(f"sketch heavy-hitter overlap with exact top-{args.topk}: "
          f"{overlap}/{args.topk} (additive error bound "
          f"{qsink.error_bound():.1f})")

    seed_key = keys_t[:1]
    n_reach = [int(k_hop(snap, seed_key, hops=h).sum())
               for h in range(1, args.hops + 1)]
    print("k-hop from heaviest node: " +
          " ".join(f"{h+1}-hop={n}" for h, n in enumerate(n_reach)))

    if args.node_cap <= 4096:
        print(f"triangles: {triangle_count(snap)}")

    # spot-check: sketch edge weights vs exact lookups on real edges
    live = snap.edge_row < snap.node_cap
    take = torch.nonzero(live).squeeze(1)[:8]
    s_keys = snap.node_key[snap.edge_row[take].to(torch.int64)]
    d_keys = snap.node_key[snap.edge_col[take].to(torch.int64)]
    exact_w = edge_lookup(snap, s_keys, d_keys).cpu().numpy()
    est_w = qsink.edge_weight(s_keys, d_keys)
    print("edge-weight spot checks (exact vs sketch):",
          list(zip(exact_w.tolist(), est_w.tolist())))
    code = 0
    if args.dryrun:
        ok = bool((est_w >= exact_w).all()) and int(snap.n_edges) > 0
        print(f"dryrun {'ok' if ok else 'FAILED'}")
        code = 0 if ok else 1
    return QueryRun(code, pipe, rep, sketch_stage, snap, serve_ms, exact_w, est_w)


def main(argv: Optional[list] = None) -> int:
    return run(argv).code


if __name__ == "__main__":
    raise SystemExit(main())
