"""Mamba2 SSD chunked scan forward: y and the final state (every SSM
prefill's scan).

Counterpart of `repro.kernels.ssd_scan` (K8).  `scan` takes the Mamba2
block's layout: x (B, S, nh, p), dt (B, S, nh), A (nh,) or (B, nh), and
B/C (B, S, N) shared by every head (ngroups = 1), S a multiple of the
chunk:
  * on CUDA tensors it launches the hand-written kernels of
    `csrc/ssd_scan.cu` (a chunk pass, a state pass over the chunks and
    an output pass; one call, one count), which read every operand in
    place through its strides (B and C per batch row, not copied per
    head) and start from a zero state;
  * on CPU tensors it runs the plain version `ssd_chunked_plain`, the
    reference `ssd_chunked`'s chunked algebra.
y comes back in x's dtype and the final state (B, nh, N, p) in float32.
dt, A, B and C must be float32, as `ssd_chunked` casts them; the Mamba2
block hands x in float32 too, so y is not rounded before its skip term.
`ops.ssd_scan` keeps the reference's (BH, S, *) signature over it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128  # head width p the kernel takes
MAX_STATE = 128  # state width N: C's transposed tile and a CTA's rows of S_c
MAX_CHUNK = 256  # chunk Q: the output pass keeps a 64 x Q tile of C B^T


def ssd_chunked_plain(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bs: torch.Tensor,
                      Cs: torch.Tensor, chunk: int,
                      init_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the reference `ssd_chunked`'s algebra with S
    already a multiple of `chunk`.  Returns (y (B,S,nh,p) in xh's dtype,
    final state (B,nh,N,p) float32).

    As in the kernel, the float32 products dt*A are summed in float64
    and each difference of prefix sums is taken in float64 before it is
    rounded to float32 for exp: the difference of two float32 prefix
    sums near -150 would keep only 1.5e-5 of absolute precision."""
    B_, S, nh, p = xh.shape
    N = Bs.shape[-1]
    Q = chunk
    nc = S // Q
    f32 = torch.float32
    x = xh.to(f32)
    dA = dt.to(f32) * A.to(f32).expand(B_, nh)[:, None, :]  # (B,S,nh), negative, float32

    xc = x.reshape(B_, nc, Q, nh, p)
    dtc = dt.to(f32).reshape(B_, nc, Q, nh)
    Bc = Bs.to(f32).reshape(B_, nc, Q, N)
    Cc = Cs.to(f32).reshape(B_, nc, Q, N)

    seg = torch.cumsum(dA.reshape(B_, nc, Q, nh).double(), dim=2)  # within chunk, float64
    total = seg[:, :, -1, :]  # (B,nc,nh)

    # intra-chunk: L[i,j] = exp(seg_i - seg_j) * dt_j for j <= i, masked
    # before exp so no exp of a large positive is ever taken
    li = (seg[:, :, :, None, :] - seg[:, :, None, :, :]).to(f32)  # (B,nc,Q,Q,nh)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(mask[None, None, :, :, None], li, -1e30)) * dtc[:, :, None]
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", G[..., None] * L, xc)

    # chunk states: sum_j exp(total - seg_j) dt_j B_j x_j^T
    wts = torch.exp((total[:, :, None, :] - seg).to(f32)) * dtc  # (B,nc,Q,nh)
    S_c = torch.einsum("bcjh,bcjn,bcjhp->bchnp", wts, Bc, xc)

    # inter-chunk recurrence, keeping the state before each chunk
    h = (torch.zeros((B_, nh, N, p), dtype=f32, device=x.device) if init_state is None
         else init_state.to(f32))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(total[:, c].to(f32))[:, :, None, None] + S_c[:, c]
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", Cc, torch.exp(seg.to(f32)),
                           torch.stack(h_prev, dim=1))
    y = (y_intra + y_inter).reshape(B_, S, nh, p)
    return y.to(xh.dtype), h


def _check(xh, dt, A, Bs, Cs, chunk):
    if xh.dim() != 4:
        raise ValueError("x must be (B, S, nh, p)")
    B_, S, nh, p = xh.shape
    if dt.shape != (B_, S, nh) or A.shape not in ((nh,), (B_, nh)):
        raise ValueError("dt must be (B, S, nh) and A (nh,) or (B, nh)")
    if Bs.dim() != 3 or Bs.shape[:2] != (B_, S) or Cs.shape != Bs.shape:
        raise ValueError("B and C must be (B, S, N)")
    if xh.dtype not in X_DTYPES:
        raise TypeError(f"x must be one of {list(X_DTYPES)}")
    if any(t.dtype != torch.float32 for t in (dt, A, Bs, Cs)):
        raise TypeError("dt, A, B and C must be float32")
    if len({t.device for t in (xh, dt, A, Bs, Cs)}) != 1:
        raise ValueError("all operands must be on one device")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")


_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 15
             + [ctypes.c_int, ctypes.c_void_p])


def check_kernel_shape(p: int, N: int, chunk: int) -> None:
    """Raise ValueError for a shape the kernel does not take."""
    if p > MAX_HEAD_DIM:
        raise ValueError(f"the ssd_scan kernel takes head widths up to {MAX_HEAD_DIM}, not {p}")
    if N > MAX_STATE:
        raise ValueError(f"the ssd_scan kernel takes state widths up to {MAX_STATE}, not {N}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"the ssd_scan kernel takes chunks up to {MAX_CHUNK}, not {chunk}")


def _launch(xh, dt, A, Bs, Cs, chunk):
    B_, S, nh, p = xh.shape
    N = Bs.shape[-1]
    check_kernel_shape(p, N, chunk)
    if xh.stride(3) != 1 or Bs.stride(2) != 1 or Cs.stride(2) != 1:
        raise ValueError("x, B and C must be contiguous along their last dimension")
    y = torch.empty((B_, S, nh, p), dtype=xh.dtype, device=xh.device)
    state = torch.empty((B_, nh, N, p), dtype=torch.float32, device=xh.device)
    if y.numel() == 0:
        return y, state.zero_()
    nc = S // chunk
    # the chunk pass's S_c, overwritten by the state before each chunk,
    # and the prefix sums of dt*A, both read by the output pass
    states = torch.empty((B_, nc, nh, N, p), dtype=torch.float32, device=xh.device)
    segs = torch.empty((B_, nc, nh, chunk), dtype=torch.float64, device=xh.device)
    fn = build.library("ssd_scan").ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    Ab = A.expand(B_, nh)
    strides = ([xh.stride(i) for i in range(3)] + [dt.stride(i) for i in range(3)]
               + [Ab.stride(0), Ab.stride(1)] + [Bs.stride(0), Bs.stride(1)]
               + [Cs.stride(0), Cs.stride(1)] + [y.stride(i) for i in range(3)])
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    err = fn(xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bs.data_ptr(), Cs.data_ptr(),
             y.data_ptr(), state.data_ptr(), states.data_ptr(), segs.data_ptr(), B_, nh, S, p,
             N, chunk, *strides, X_DTYPES[xh.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err}")
    build.launches["ssd_scan"] += 1
    return y, state


def scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bs: torch.Tensor,
         Cs: torch.Tensor, chunk: int, init_state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward over the Mamba2 block's layout (see the module
    docstring): (y (B,S,nh,p) in x's dtype, final state (B,nh,N,p)
    float32).  CUDA tensors launch the kernel, which starts from a zero
    state: there an `init_state` raises.  CPU tensors run
    `ssd_chunked_plain`."""
    _check(xh, dt, A, Bs, Cs, chunk)
    if xh.device.type == "cuda":
        if init_state is not None:
            raise ValueError("the ssd_scan kernel starts from a zero state; "
                             "an init_state has no kernel path")
        return _launch(xh, dt, A, Bs, Cs, chunk)
    if xh.device.type == "cpu":
        return ssd_chunked_plain(xh, dt, A, Bs, Cs, chunk, init_state)
    raise ValueError(f"ssd_scan runs on cuda or cpu, not {xh.device}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference kernel's signature: x (BH,S,p), dt (BH,S), A (BH,),
    B/C (BH,S,N) -> (y (BH,S,p) in x's dtype, final state (BH,N,p)
    float32), from a zero state.  S must be a multiple of
    min(chunk, S), as the reference asserts; dt, A, B and C are read as
    float32."""
    if x.dim() != 3:
        raise ValueError("x must be (BH, S, p)")
    S = x.shape[1]
    Q = min(chunk, S)
    f32 = torch.float32
    y, state = scan(x[:, :, None], dt.to(f32)[:, :, None], A.to(f32)[:, None], B.to(f32),
                    C.to(f32), Q)
    return y[:, :, 0], state[:, 0]
