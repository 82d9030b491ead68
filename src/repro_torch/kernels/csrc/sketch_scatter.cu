// Triple scatter-add into the count-min graph sketch (the sketch
// update's hot path), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sketch.py::sketch_scatter (the
// pl.pallas_call at sketch.py:63, body scatter_add at :26).
//
// For every depth d and lane i with cnt[i] != 0 it adds cnt[i] to
//   edge_w[d, r[d,i], c[d,i]],  out_deg[d, r[d,i]]  and  in_deg[d, c[d,i]].
// The TPU kernel held the whole (D, W, W) sketch in VMEM and returned a
// new copy; here the three arrays are updated IN PLACE in device memory
// (the caller clones first where it must keep the old sketch).
//
// One thread per (d, i) lane, three int atomicAdds each.  Integer
// addition does not depend on order, so the result is bit-exact against
// the plain version whatever order the atomics resolve in.  The atomics
// return nothing to the thread, so they compile to fire-and-forget
// reductions that resolve in L2.
//
// What bounds it on this card: bytes, and contention where they meet.
// A lane reads 4 + 8 bytes of hash coordinates per depth plus its count,
// and each distinct cell it touches is read and written once: at the
// query path's widest shape (D=4, W=512, n=8,192) that is well under a
// MB, which the card's 3.35 TB/s moves in a few tenths of a microsecond.
// Skewed keys send many lanes to the same degree cell, and those atomics
// serialise in L2.  The design accepts that for now: it is simple and
// right.  Privatising the degree rows in shared memory, or fusing the
// hashing into the kernel, is later work.
//
// Coordinates lie in [0, W) by construction (node_hash takes x % W); a
// lane with any other coordinate is skipped rather than written outside
// the arrays.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sketch_scatter_kernel(int* __restrict__ edge_w, int* __restrict__ out_deg,
                      int* __restrict__ in_deg, const int* __restrict__ r,
                      const int* __restrict__ c, const int* __restrict__ cnt,
                      int depth, int width, int n) {
  const long long lane = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= static_cast<long long>(depth) * n) return;
  const int d = static_cast<int>(lane / n);
  const int i = static_cast<int>(lane - static_cast<long long>(d) * n);
  const int v = __ldg(cnt + i);
  if (v == 0) return;
  const int row = __ldg(r + lane);
  const int col = __ldg(c + lane);
  if (static_cast<unsigned>(row) >= static_cast<unsigned>(width) ||
      static_cast<unsigned>(col) >= static_cast<unsigned>(width)) {
    return;
  }
  const long long drow = static_cast<long long>(d) * width + row;
  atomicAdd(edge_w + drow * width + col, v);
  atomicAdd(out_deg + drow, v);
  atomicAdd(in_deg + static_cast<long long>(d) * width + col, v);
}

}  // namespace

// Launches the update on `stream`; allocates nothing.  Returns the
// cudaError_t of the launch (0 = success).  depth * n must be > 0.
extern "C" int sketch_scatter_launch(void* edge_w, void* out_deg, void* in_deg,
                                     const void* r, const void* c, const void* cnt,
                                     int depth, int width, int n, void* stream) {
  const long long lanes = static_cast<long long>(depth) * n;
  const unsigned int blocks = static_cast<unsigned int>((lanes + kThreads - 1) / kThreads);
  sketch_scatter_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(edge_w), static_cast<int*>(out_deg), static_cast<int*>(in_deg),
      static_cast<const int*>(r), static_cast<const int*>(c), static_cast<const int*>(cnt),
      depth, width, n);
  return static_cast<int>(cudaGetLastError());
}
