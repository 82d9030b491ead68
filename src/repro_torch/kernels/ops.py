"""Public entry points of the port's kernels (counterpart of
`repro.kernels.ops`).

Each op dispatches on the device of its tensors: a CUDA tensor launches
the hand-written kernel, a CPU tensor runs the plain PyTorch version.
`dedup_sorted_counts` is plain tensor code over the kernel's outputs,
on either device; `bloom_diversity` is one launch of the Bloom kernel's
fused entry on the card (the plain probe, then the plain build, on the
CPU) and one mean.
"""
from typing import Tuple

import torch

from repro_torch.kernels.bloom import bloom_build, bloom_probe, bloom_probe_build
from repro_torch.kernels.edge_dedup import sort_dedup
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.pattern_mine import pattern_mine
from repro_torch.kernels.sampler import traffic_ids
from repro_torch.kernels.sketch import sketch_absorb, sketch_scatter
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.upsert import fused_upsert

__all__ = ["bloom_build", "bloom_diversity", "bloom_probe", "dedup_sorted_counts",
           "flash_attention", "fused_upsert", "pattern_mine", "sketch_absorb", "sketch_scatter",
           "sort_dedup", "ssd_scan", "traffic_ids"]


def dedup_sorted_counts(sorted_keys: torch.Tensor,
                        head: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-run counts from `sort_dedup`'s (sorted, head): (counts, n_unique),
    counts (n,) int32 with run r's length at r and 0 past the last run,
    n_unique a 0-d int32."""
    n = sorted_keys.shape[0]
    run = (torch.cumsum(head, 0) - 1).clamp(0, n - 1)
    counts = torch.zeros(n, dtype=torch.int32, device=head.device)
    counts.index_add_(0, run, torch.ones(n, dtype=torch.int32, device=head.device))
    return counts, head.sum().to(torch.int32)


def bloom_diversity(keys: torch.Tensor,
                    bitmap: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rho, new_bitmap): the share of `keys` the filter has not seen
    (0-d float32), and the filter with them inserted; the pre-commit
    diversity signal for the buffer controller.  Probes the filter as it
    was, then builds, as the reference does; `bitmap` is left unchanged.
    The hits are float32 0.0 / 1.0 on both devices, so rho is torch's
    own mean of them."""
    hit, new = bloom_probe_build(keys, bitmap)
    return 1.0 - hit.mean(), new
