"""Triple scatter-add into the count-min graph sketch (the sketch
update's hot path).

Counterpart of `repro.kernels.sketch`.  For every depth d and lane i it
adds cnt[i] to edge_w[d, r[d,i], c[d,i]], out_deg[d, r[d,i]] and
in_deg[d, c[d,i]].  Integer addition does not depend on order, so the
kernel and the plain version agree bit for bit.

Two entries run the hand-written kernel `csrc/sketch_scatter.cu` on
CUDA tensors and their plain versions on CPU tensors:

  * `sketch_scatter(edge_w, out_deg, in_deg, r, c, cnt)` takes the hash
    coordinates, as the Pallas kernel does (plain: `sketch_scatter_ref`);
  * `sketch_absorb(edge_w, out_deg, in_deg, src, dst, cnt)` takes the
    edge table's key bits and hashes them in the kernel as `node_hash`
    does (plain: `node_hash` twice, then `sketch_scatter_ref`), so one
    launch is the whole scatter of a sketch update.

Both update the three arrays IN PLACE and return them; the reference
returns fresh copies instead.  The CTAs, threads and whether the degree
rows are privatised in shared memory come from the host's
`launch_plan`; `launch` runs the kernel under any plan it takes.

Keys are int64 tensors holding uint64 bits, or int32 tensors holding
uint32 bits.  The hash is uint32 arithmetic on the key folded to 32 bits
(key ^ key >> 32 of a uint64, the key itself of a uint32), carried in
int64 and masked to 32 bits after every add and multiply (a product of
two 32-bit values may wrap past 2^63, but its low 32 bits stay right).
`sketch_absorb` widens 32-bit keys at the wrapper, zero-extended to
int64: the fold leaves a key with a zero high word as it is, so the
kernel's 64-bit key loads hash them as the reference hashes uint32 keys.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import compression as C
from repro_torch.kernels import build

Sketch3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_M32 = 0xFFFFFFFF

# The launch plan, from tools/k3_plan.py on an H100 (D = 4, W 256 to
# 4,096, 64 to 8,192 lanes, uniform, Zipf and one-hub keys): a lane a
# thread; CTAs of DIRECT_CTA_LANES adding into device memory directly;
# or CTAs of PRIVATE_CTA_LANES with their degree rows, 2 D W int32 cells,
# in shared memory, cleared and flushed once a CTA.  That costs in cells,
# not lanes, so private rows need at least as many lanes as cells and
# PRIVATE_LANES in all, and rows of at most PRIVATE_MAX_CELLS, the widest
# where they won (W = 1,024 at 8,192 Zipf and hub lanes; at W 2,048 and
# 4,096 direct atomics won or came within 2 us).  SMEM_BYTES is the
# H100's opt-in shared memory (the kernel declares no static shared
# memory, F17).
DIRECT_CTA_LANES = 32
PRIVATE_CTA_LANES = 256
PRIVATE_LANES = 4_096
PRIVATE_MAX_CELLS = 8_192
SMEM_BYTES = 232_448
MAX_THREADS = 1_024


class Plan(NamedTuple):
    ctas: int
    threads: int  # a multiple of 32 up to MAX_THREADS
    private: bool  # degree rows in shared memory, flushed once a CTA


def rows_fit(depth: int, width: int) -> bool:
    """Whether a CTA's copy of the degree rows fits its shared memory."""
    return 2 * depth * width * 4 <= SMEM_BYTES


def cta_lanes(n: int, ctas: int) -> int:
    """Lanes of each CTA (the last may have fewer): ceil(n / ctas)."""
    return -(-n // ctas)


def launch_plan(n: int, depth: int, width: int) -> Plan:
    """The plan `sketch_scatter` and `sketch_absorb` launch at n lanes:
    private degree rows where the rows hold at most PRIVATE_MAX_CELLS
    cells and n is at least PRIVATE_LANES and the rows' cells, CTAs of
    PRIVATE_CTA_LANES (private) or DIRECT_CTA_LANES lanes, a thread a
    lane (a CTA's lanes rounded up to a warp)."""
    cells = 2 * depth * width
    private = cells <= PRIVATE_MAX_CELLS and n >= max(PRIVATE_LANES, cells)
    ctas = max(1, -(-n // (PRIVATE_CTA_LANES if private else DIRECT_CTA_LANES)))
    return Plan(ctas, max(32, -(-cta_lanes(n, ctas) // 32) * 32), private)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def widen(keys: torch.Tensor) -> torch.Tensor:
    """Key bits as int64: 64-bit keys as they are, 32-bit keys
    zero-extended (never sign-extended)."""
    if C.key_bits(keys.dtype) == 64:
        return keys
    return keys.to(torch.int64) & _M32


def _fold32(keys: torch.Tensor) -> torch.Tensor:
    """uint32(key ^ (key >> 32)) of uint64 key bits, or the uint32 key
    itself, as int64 (the reference's `_fold32` at either width)."""
    keys = widen(keys)
    return (keys ^ C.lsr(keys, 32)) & _M32


def node_hash(keys: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """(D, n) int32 hash coordinates, one independent row per depth."""
    k32 = _fold32(keys)
    return torch.stack([(C.hash_round(k32, d) % width).to(torch.int32) for d in range(depth)])


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


def sketch_absorb_ref(edge_w: torch.Tensor, out_deg: torch.Tensor, in_deg: torch.Tensor,
                      src: torch.Tensor, dst: torch.Tensor, cnt: torch.Tensor) -> Sketch3:
    """Plain PyTorch version of the fused entry: the reference's
    `node_hash` of both keys, then `sketch_scatter_ref`.  Updates in
    place."""
    D, W = out_deg.shape
    return sketch_scatter_ref(edge_w, out_deg, in_deg, node_hash(src, D, W),
                              node_hash(dst, D, W), cnt)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _check(edge_w, out_deg, in_deg, a, b, cnt, fused):
    if edge_w.dim() != 3 or edge_w.shape[1] != edge_w.shape[2]:
        raise ValueError("edge_w must be (D, W, W)")
    D, W = edge_w.shape[0], edge_w.shape[1]
    n = cnt.shape[0] if cnt.dim() == 1 else -1
    if out_deg.shape != (D, W) or in_deg.shape != (D, W):
        raise ValueError("out_deg and in_deg must be (D, W)")
    want = (n,) if fused else (D, n)
    if a.shape != want or b.shape != want:
        raise ValueError(f"cnt must be (n,) and the {'keys' if fused else 'coordinates'} "
                         f"{want}")
    if any(t.dtype != torch.int32 for t in (edge_w, out_deg, in_deg, cnt)):
        raise TypeError("edge_w, out_deg, in_deg and cnt must be int32")
    if fused and (a.dtype not in C.KEY_DTYPES or b.dtype != a.dtype):
        raise TypeError("the keys must be both int64 (uint64 bits) or both int32 (uint32 bits)")
    if not fused and (a.dtype != torch.int32 or b.dtype != torch.int32):
        raise TypeError("the coordinates must be torch.int32")
    tensors = (edge_w, out_deg, in_deg, a, b, cnt)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every operand of the sketch scatter must be contiguous")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def launch(edge_w, out_deg, in_deg, a, b, cnt, fused: bool, plan: Plan) -> Sketch3:
    """The kernel on CUDA tensors that `_check` passed, under `plan`:
    a, b are r, c (D, n) int32, or with `fused` the src, dst key bits
    (n,) int64 (`sketch_absorb` widens 32-bit keys first).  The entries
    pass `launch_plan`; tools/k3_plan.py and chip_smoke.py run every plan
    the kernel takes."""
    D, W = out_deg.shape
    n = cnt.shape[0]
    if D * n == 0:
        return edge_w, out_deg, in_deg
    fn = build.library("sketch_scatter").sketch_scatter_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(edge_w.device).cuda_stream
    err = fn(edge_w.data_ptr(), out_deg.data_ptr(), in_deg.data_ptr(), a.data_ptr(),
             b.data_ptr(), cnt.data_ptr(), int(fused), D, W, n, plan.ctas, plan.threads,
             int(plan.private), stream)
    if err != 0:
        raise RuntimeError(f"sketch_scatter launch failed: cudaError {err} under {plan}")
    build.launches["sketch_scatter"] += 1
    return edge_w, out_deg, in_deg


def sketch_scatter(edge_w: torch.Tensor, out_deg: torch.Tensor, in_deg: torch.Tensor,
                   r: torch.Tensor, c: torch.Tensor, cnt: torch.Tensor) -> Sketch3:
    """One sketch update, in place: returns (edge_w, out_deg, in_deg).

    edge_w (D, W, W) int32; out_deg/in_deg (D, W) int32; r/c (D, n)
    int32 hash coordinates in [0, W); cnt (n,) int32 edge counts (0 for
    invalid lanes).  CUDA tensors launch the kernel, CPU tensors run
    `sketch_scatter_ref`."""
    _check(edge_w, out_deg, in_deg, r, c, cnt, False)
    if edge_w.device.type == "cuda":
        D, W = out_deg.shape
        return launch(edge_w, out_deg, in_deg, r, c, cnt, False,
                      launch_plan(cnt.shape[0], D, W))
    if edge_w.device.type == "cpu":
        return sketch_scatter_ref(edge_w, out_deg, in_deg, r, c, cnt)
    raise ValueError(f"sketch_scatter runs on cuda or cpu, not {edge_w.device}")


def sketch_absorb(edge_w: torch.Tensor, out_deg: torch.Tensor, in_deg: torch.Tensor,
                  src: torch.Tensor, dst: torch.Tensor, cnt: torch.Tensor) -> Sketch3:
    """One sketch update from an edge table's keys, in place: returns
    (edge_w, out_deg, in_deg).

    edge_w (D, W, W) int32; out_deg/in_deg (D, W) int32; src/dst (n,)
    key bits, both int64 or both int32; cnt (n,) int32 edge counts (0
    for invalid lanes).  CUDA tensors launch the kernel, which hashes the
    keys itself (32-bit keys zero-extended first, `widen`); CPU tensors
    run `sketch_absorb_ref`."""
    _check(edge_w, out_deg, in_deg, src, dst, cnt, True)
    if edge_w.device.type == "cuda":
        D, W = out_deg.shape
        return launch(edge_w, out_deg, in_deg, widen(src), widen(dst), cnt, True,
                      launch_plan(cnt.shape[0], D, W))
    if edge_w.device.type == "cpu":
        return sketch_absorb_ref(edge_w, out_deg, in_deg, src, dst, cnt)
    raise ValueError(f"sketch_absorb runs on cuda or cpu, not {edge_w.device}")
