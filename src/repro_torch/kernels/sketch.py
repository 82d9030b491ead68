"""Triple scatter-add into the count-min graph sketch (the sketch
update's hot path).

Counterpart of `repro.kernels.sketch`.  For every depth d and lane i it
adds cnt[i] to edge_w[d, r[d,i], c[d,i]], out_deg[d, r[d,i]] and
in_deg[d, c[d,i]].  Integer addition does not depend on order, so the
kernel and the plain version agree bit for bit.

`sketch_scatter` is the wrapper: on CUDA tensors it launches the
hand-written kernel `csrc/sketch_scatter.cu`, on CPU tensors it runs the
plain version `sketch_scatter_ref`.  Both update the three arrays IN
PLACE and return them; the reference returns fresh copies instead.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

Sketch3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(edge_w, out_deg, in_deg, r, c, cnt):
    if edge_w.dim() != 3 or edge_w.shape[1] != edge_w.shape[2]:
        raise ValueError("edge_w must be (D, W, W)")
    D, W = edge_w.shape[0], edge_w.shape[1]
    n = cnt.shape[0] if cnt.dim() == 1 else -1
    if out_deg.shape != (D, W) or in_deg.shape != (D, W):
        raise ValueError("out_deg and in_deg must be (D, W)")
    if r.shape != (D, n) or c.shape != (D, n):
        raise ValueError("cnt must be (n,) and r, c (D, n)")
    tensors = (edge_w, out_deg, in_deg, r, c, cnt)
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("every operand of the sketch scatter must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every operand of the sketch scatter must be contiguous")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")


def sketch_scatter_ref(edge_w: torch.Tensor, out_deg: torch.Tensor, in_deg: torch.Tensor,
                       r: torch.Tensor, c: torch.Tensor, cnt: torch.Tensor) -> Sketch3:
    """Plain PyTorch version: three `index_add_` calls on flat views,
    the reference's `scatter_add` body.  Updates in place."""
    D, W = out_deg.shape
    depth = torch.arange(D, device=r.device).unsqueeze(1)
    rl, cl = r.to(torch.int64), c.to(torch.int64)
    vals = cnt.expand(D, -1).reshape(-1)
    edge_w.view(-1).index_add_(0, (depth * (W * W) + rl * W + cl).reshape(-1), vals)
    out_deg.view(-1).index_add_(0, (depth * W + rl).reshape(-1), vals)
    in_deg.view(-1).index_add_(0, (depth * W + cl).reshape(-1), vals)
    return edge_w, out_deg, in_deg


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _launch(edge_w, out_deg, in_deg, r, c, cnt) -> Sketch3:
    D, W = out_deg.shape
    n = cnt.shape[0]
    if D * n == 0:
        return edge_w, out_deg, in_deg
    fn = build.library("sketch_scatter").sketch_scatter_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(edge_w.device).cuda_stream
    err = fn(edge_w.data_ptr(), out_deg.data_ptr(), in_deg.data_ptr(), r.data_ptr(),
             c.data_ptr(), cnt.data_ptr(), D, W, n, stream)
    if err != 0:
        raise RuntimeError(f"sketch_scatter launch failed: cudaError {err}")
    build.launches["sketch_scatter"] += 1
    return edge_w, out_deg, in_deg


def sketch_scatter(edge_w: torch.Tensor, out_deg: torch.Tensor, in_deg: torch.Tensor,
                   r: torch.Tensor, c: torch.Tensor, cnt: torch.Tensor) -> Sketch3:
    """One sketch update, in place: returns (edge_w, out_deg, in_deg).

    edge_w (D, W, W) int32; out_deg/in_deg (D, W) int32; r/c (D, n)
    int32 hash coordinates in [0, W); cnt (n,) int32 edge counts (0 for
    invalid lanes).  CUDA tensors launch the kernel, CPU tensors run
    `sketch_scatter_ref`."""
    _check(edge_w, out_deg, in_deg, r, c, cnt)
    if edge_w.device.type == "cuda":
        return _launch(edge_w, out_deg, in_deg, r, c, cnt)
    if edge_w.device.type == "cpu":
        return sketch_scatter_ref(edge_w, out_deg, in_deg, r, c, cnt)
    raise ValueError(f"sketch_scatter runs on cuda or cpu, not {edge_w.device}")
