"""Paper scenario config — the ingestion pipeline itself (§II–§IV).

Not an LM architecture: these are the knobs of the adaptive buffer
controller and graph-compression pipeline, set to the paper's testbed
values where the paper states them.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    # buffer bounds (records)
    beta_min: int = 200
    beta_max: int = 50_000
    beta_init: int = 1_500  # paper Fig. 12: "initial buffer size 1500 records"

    # consumer-load bounds (fraction of capacity, paper uses CPU %)
    cpu_max: float = 0.55  # paper tests 35% and 55%
    cpu_min: float = 0.10
    theta1: float = 0.10  # buffer growth fraction
    theta2: float = 0.25  # throttle threshold factor / shrink fraction

    # predictive-model seeds (paper §IV-A); refined online by RLS
    K: float = 0.597  # linear coefficient of phi1(rho)
    R: float = 1.48  # coefficient of phi2(d) (quadratic)
    A: float = 0.01  # mu[n-1] coefficient
    B: float = 0.09  # log(beta_e) coefficient

    # bucketing
    bucket_records: int = 256  # mini-batch ("bucket") size B[i]
    diversity_window: int = 8  # k temporal buckets for rho

    # device-side table capacities (per ingest step)
    max_edges_per_batch: int = 8_192
    max_nodes_per_batch: int = 8_192

    # graph store capacity
    store_nodes: int = 1 << 20
    store_edges: int = 1 << 21

    # stream shape
    mean_rate: float = 60.0  # records/s (paper: ~60 tweets/s at 1%)
    burst_multiplier: float = 5.0  # paper simulation: up to 5x
    duplicate_frac: float = 0.125  # paper: 5–20% duplicate tweets


DEFAULT = IngestConfig()
