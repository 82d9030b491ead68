"""Parameter initialisation (counterpart of the reference's
`distributed.sharding.ParamSpec` and `init_params`).

Every module of the LM stack draws its parameters through one
`ParamInit`: the reference's init kinds, drawn in float32 from an
explicit `torch.Generator` on the target device and cast to the model's
dtype.  Shapes and dtypes are the reference's; the bits are not (torch's
generator is not JAX's), so parity tests carry the reference's weights
across with `convert.lm_params_from_numpy` instead.  Logical sharding
axes have no counterpart on one card.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

INIT_KINDS = ("normal", "small_normal", "zeros", "ones", "alog", "dtbias")


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """torch.float32 for "float32", torch.bfloat16 for "bfloat16", ..."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def init_tensor(shape: Sequence[int], init: str, gen: torch.Generator, dtype: torch.dtype,
                device: torch.device, scale: float = 1.0) -> torch.Tensor:
    """One parameter of the reference's init kind `init`:
      normal        N(0, 1) * scale / sqrt(fan_in), fan_in = shape[0]
      small_normal  N(0, 1) * 0.02 * scale
      zeros, ones
      alog          log U[1, 16]                  (Mamba A_log)
      dtbias        softplus^-1 of U[1e-3, 1e-1]  (Mamba dt bias)"""
    shape = tuple(shape)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    f32 = torch.float32
    if init in ("alog", "dtbias"):
        lo, hi = (1.0, 16.0) if init == "alog" else (1e-3, 1e-1)
        u = torch.empty(shape, dtype=f32, device=device).uniform_(lo, hi, generator=gen)
        out = torch.log(u) if init == "alog" else u + torch.log(-torch.expm1(-u))
        return out.to(dtype)
    if init == "normal":
        std = scale / max(1.0, float(shape[0]) ** 0.5)
    elif init == "small_normal":
        std = 0.02 * scale
    else:
        raise ValueError(f"unknown init kind {init!r}; one of {INIT_KINDS}")
    return torch.randn(shape, generator=gen, dtype=f32, device=device).mul_(std).to(dtype)


class ParamInit:
    """Draws a model's parameters in order from one generator seeded with
    `seed` on `device`, each as a frozen `nn.Parameter` of `dtype`."""

    def __init__(self, device: torch.device, dtype: torch.dtype, seed: int = 0):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def __call__(self, shape: Sequence[int], init: str = "normal",
                 scale: float = 1.0) -> nn.Parameter:
        t = init_tensor(shape, init, self.gen, self.dtype, self.device, scale)
        return nn.Parameter(t, requires_grad=False)
