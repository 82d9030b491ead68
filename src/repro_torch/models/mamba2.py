"""Mamba2 (SSD, state-space duality) block, chunked (counterpart of
`repro.models.mamba2`).

Within a chunk the recurrence is a masked, attention-like product;
across chunks a small state (nh, N, p) is carried.  The chunked scan is
kernel K8: on a CUDA tensor `ssd_chunked` launches
`kernels/csrc/ssd_scan.cu`.  One-token decode is the O(1) recurrent
update, plain torch.

Layout: d_inner = expand * d_model split into nh heads of head_dim p;
B/C are shared across heads (ngroups = 1), state size N.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models.params import ParamInit


class Mamba2Mixer(nn.Module):
    """The parameters of one Mamba2 block (the reference's `mamba` specs)."""

    def __init__(self, cfg: ModelConfig, mk: ParamInit):
        super().__init__()
        D, d_in, N, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        self.w_x = mk((D, d_in))
        self.w_z = mk((D, d_in))
        self.w_B = mk((D, N))
        self.w_C = mk((D, N))
        self.w_dt = mk((D, nh))
        self.conv_w = mk((cfg.ssm_conv, d_in + 2 * N))
        self.A_log = mk((nh,), "alog")
        self.D = mk((nh,), "ones")
        self.dt_bias = mk((nh,), "dtbias")
        self.norm = mk((d_in,), "ones")
        self.w_out = mk((d_in, D))


def _split_proj(x: torch.Tensor, p, cfg: ModelConfig):
    """x: (B,S,D) -> z, xs (B,S,d_in), Bs, Cs (B,S,N), dt (B,S,nh)."""
    dt_f = x.dtype
    return tuple(x @ w.to(dt_f) for w in (p.w_z, p.w_x, p.w_B, p.w_C, p.w_dt))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  u: (B,S,C), w: (K,C).  With cache
    (B,K-1,C) it is the streaming update.  Returns (y (B,S,C), new cache
    (B,K-1,C))."""
    K = w.shape[0]
    S = u.shape[1]
    if cache is None:
        pad = torch.zeros((u.shape[0], K - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    else:
        pad = cache.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    y = up[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + up[:, i:i + S] * w[i]
    new_cache = up[:, -(K - 1):] if K > 1 else None
    return y, new_cache


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bs: torch.Tensor,
                Cs: torch.Tensor, chunk: int, init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.  xh (B,S,nh,p), dt (B,S,nh) positive step
    sizes, A (nh,) negative decay rates, Bs/Cs (B,S,N).  Returns
    (y (B,S,nh,p) float32, final state (B,nh,N,p) float32).

    S is padded to a multiple of the chunk with dt = 0 steps (identity
    transition, no output) here, outside the kernel, as in the
    reference.  Kernel K8: a CUDA tensor launches the scan kernel, which
    starts from a zero state, so an `init_state` raises there; a CPU
    tensor runs the kernel's plain version."""
    S0 = xh.shape[1]
    Q = chunk
    if S0 % Q:
        pad = Q - S0 % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bs = F.pad(Bs, (0, 0, 0, pad))
        Cs = F.pad(Cs, (0, 0, 0, pad))
    f32 = torch.float32
    y, hT = _ssd.scan(xh.to(f32), dt.to(f32), A.to(f32), Bs.to(f32), Cs.to(f32), Q,
                      init_state=init_state)
    return y[:, :S0], hT


def ssd_decode_step(xh, dt, A, Bs, Cs, state):
    """One-token SSD update.  xh (B,nh,p), dt (B,nh), Bs/Cs (B,N), state
    (B,nh,N,p) -> (y (B,nh,p), new state), float32."""
    f32 = torch.float32
    xh, dt, Bs, Cs = (t.to(f32) for t in (xh, dt, Bs, Cs))
    dA = torch.exp(dt * A[None, :])  # (B,nh)
    upd = torch.einsum("bn,bhp->bhnp", Bs, xh * dt[..., None])
    state = state.to(f32) * dA[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cs, state)
    return y, state


def mamba2_block(x: torch.Tensor, p, cfg: ModelConfig, state=None, conv_cache=None,
                 decode: bool = False):
    """The full Mamba2 block.  x: (B,S,D).  Prefill: decode=False,
    returns (y, (final_state, conv_cache)).  Decode: decode=True with
    S = 1 and both caches given."""
    B, S, D = x.shape
    nh, pdim, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_in = cfg.ssm_d_inner

    z, xs, Bs, Cs, dt = _split_proj(x, p, cfg)

    # depthwise causal conv on [x, B, C]
    conv_in = torch.cat([xs, Bs, Cs], dim=-1)
    conv_out, new_conv_cache = _causal_conv(conv_in, p.conv_w, conv_cache if decode else None)
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :d_in]
    Bs = conv_out[..., d_in:d_in + N]
    Cs = conv_out[..., d_in + N:]

    dt = F.softplus(dt.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())  # (nh,)

    xh = xs.reshape(B, S, nh, pdim)
    if decode:
        y1, new_state = ssd_decode_step(xh[:, 0], dt[:, 0], A, Bs[:, 0], Cs[:, 0], state)
        y = y1[:, None]  # (B,1,nh,p)
    else:
        y, new_state = ssd_chunked(xh, dt, A, Bs, Cs, cfg.ssm_chunk, init_state=state)

    y = y + xh.float() * p.D.float()[None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype)

    # gated RMSNorm, then out_proj
    y = y * F.silu(z)
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + cfg.norm_eps) * p.norm.float()).to(x.dtype)
    out = y @ p.w_out.to(x.dtype)
    return out, (new_state, new_conv_cache)
