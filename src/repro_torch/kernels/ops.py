"""Public entry points of the port's kernels (counterpart of
`repro.kernels.ops`).

Each op dispatches on the device of its tensors: a CUDA tensor launches
the hand-written kernel, a CPU tensor runs the plain PyTorch version.
"""
from repro_torch.kernels.pattern_mine import pattern_mine
from repro_torch.kernels.sampler import traffic_ids
from repro_torch.kernels.sketch import sketch_scatter
from repro_torch.kernels.upsert import fused_upsert

__all__ = ["fused_upsert", "pattern_mine", "sketch_scatter", "traffic_ids"]
