"""Paper-pipeline entry point: run the adaptive ingestion loop.

  PYTHONPATH=src python -m repro_torch.launch.ingest --ticks 300 --cpu-max 0.55
  PYTHONPATH=src python -m repro_torch.launch.ingest --uncontrolled   # Fig 7 mode
  PYTHONPATH=src python -m repro_torch.launch.ingest --shards 4       # scale-out
  PYTHONPATH=src python -m repro_torch.launch.ingest --dict-compress  # GraphZip
  PYTHONPATH=src python -m repro_torch.launch.ingest --device cpu     # on the host

Counterpart of `repro.launch.ingest`, with the same flags and printout,
plus `--device {cuda,cpu}` (default the card).  Keys are 64-bit.  The
reference spills under /tmp/repro_spill_shards when sharded; the port
gives the controller, or each shard, a fresh temporary directory.
"""
import argparse

import numpy as np

from repro_torch.api import PipelineBuilder
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.ingest.sources import BurstyTweetSource


def parse_args(argv=None):
    """The CLI's flags, with the reference's checks on `--shards`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--cpu-max", type=float, default=0.55)
    ap.add_argument("--uncontrolled", action="store_true")
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--dict-compress", action="store_true",
                    help="GraphZip dictionary compression (repro_torch.compress)")
    ap.add_argument("--dict-capacity", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=60.0)
    ap.add_argument("--burst", type=float, default=5.0)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.shards < 1:
        ap.error("--shards must be >= 1")
    if args.shards > 1 and args.uncontrolled:
        ap.error("--shards requires the controlled pipeline (drop --uncontrolled)")
    return args


def cli_builder(args) -> PipelineBuilder:
    """The builder of the deployment that `args` name, not yet built."""
    cfg = IngestConfig(cpu_max=args.cpu_max, mean_rate=args.rate,
                       burst_multiplier=args.burst)
    src = BurstyTweetSource(seed=args.seed, mean_rate=args.rate,
                            burst_multiplier=args.burst)
    b = (PipelineBuilder(cfg, device=args.device)
         .with_source(src)
         .uncontrolled(args.uncontrolled)
         .compressed(not args.no_compress))
    if args.dict_compress:
        b = b.with_compression(capacity=args.dict_capacity)
    if args.shards > 1:
        b = b.sharded(args.shards)
    return b


def main(argv=None):
    """Run the loop and print the report; returns (report, pipeline)."""
    args = parse_args(argv)
    b = cli_builder(args)
    pipe = b.build()
    rep = pipe.run(max_ticks=args.ticks)

    if args.shards > 1:
        print(f"mode=sharded x{args.shards} compress={not args.no_compress}")
        print(f"records={rep.total_records} instructions={rep.total_instructions} "
              f"raw={rep.raw_instructions}")
        for i, (sr, hwm) in enumerate(zip(rep.shards, rep.max_buffered)):
            mu = sr.samples["mu"]
            print(f"shard {i}: records={sr.total_records} "
                  f"mu_mean={mu.mean():.3f} mu_max={mu.max():.3f} "
                  f"buffer_hwm={hwm}")
    else:
        mu = rep.samples["mu"]
        print(f"mode={'uncontrolled' if args.uncontrolled else 'controlled'} "
              f"compress={not args.no_compress}")
        print(f"records={rep.total_records} instructions={rep.total_instructions} "
              f"raw={rep.raw_instructions}")
        print(f"mu: mean={mu.mean():.3f} p95={np.percentile(mu,95):.3f} "
              f"max={mu.max():.3f} pinned(>0.95)={float((mu>0.95).mean()):.3f}")
        print(f"delay: mean={rep.samples['delay_s'].mean():.2f}s "
              f"max={rep.samples['delay_s'].max():.2f}s")
    print(f"compression: mean={rep.mean_compression:.3f} "
          f"spills={rep.spill_events} drains={rep.drain_events}")
    print(f"store: {int(pipe.store.n_nodes)} nodes, "
          f"{int(pipe.store.n_edges)} edges")
    if args.dict_compress:
        print(f"dict: {b.dictionary_stage.stats()}")
    return rep, pipe


if __name__ == "__main__":
    main()
