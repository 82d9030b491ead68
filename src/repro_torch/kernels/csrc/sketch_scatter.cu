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
// Two entries run one body:
//   * the coordinates entry takes r, c (D, n) int32, the Pallas kernel's
//     operands;
//   * the fused entry takes the edge table's src and dst key bits (n,)
//     int64 and hashes them in registers as the reference's node_hash
//     does (repro/query/sketch.py:97-108, which the Pallas kernel took as
//     precomputed input): fold32(k) = lo ^ hi, then per depth
//     hash_round(fold32, d) % W in uint32 arithmetic (W need not be a
//     power of two).  One launch per sketch update replaces the hundred
//     or so small device kernels that node_hash costs twice in torch.
//
// What bounds it at the paths' sizes (64 to 8,192 lanes, D = 4, W = 256
// or 512): not bytes.  A call moves 20 to 40 bytes a lane and 8 a
// touched cell, tens of nanoseconds at 3.35 TB/s.  So first the launch
// (an empty kernel takes about 5 us between CUDA events on an H100), and
// then contention: Zipf-hot nodes send many lanes to one degree cell, and
// reductions to one address serialise in L2.  What the design does:
//   * one launch a call, one thread a lane over all D depths: a thread's
//     count and keys are loaded together, once, coalesced, and the
//     hashing rides along in registers; the host plan
//     (kernels/sketch.py::launch_plan) spreads small calls over CTAs of
//     a lane a thread, so no thread waits on a second lane;
//   * from 4,096 lanes (and at least as many lanes as row cells) the plan
//     keeps each CTA's copy of the degree rows (2 D W int32) in shared
//     memory: lanes add there with shared atomics, and after a barrier
//     the CTA flushes only its non-zero cells to device memory, one
//     reduction each, so a hub costs L2 one reduction a CTA instead of
//     one a lane.  Below that, and for rows of more than 8,192 cells
//     (W > 1,024 at D = 4), clearing and flushing the rows costs more
//     than it saves, and lanes add into device memory directly
//     (tools/k3_plan.py on an H100);
//   * the edge matrix (1 to 4 MB, resident in the 50 MB L2) takes
//     fire-and-forget reductions: a hub's edges spread over W columns.
// Merging a warp's lanes of one degree cell first (__match_any_sync, then
// __reduce_add_sync) was measured and was slower in every case, so the
// kernel does not.
// Integer addition does not depend on order, so every plan is bit-exact
// against the plain version whatever order the atomics resolve in.
//
// Coordinates lie in [0, W) by construction (x % W); a lane of the
// coordinates entry with any other coordinate is skipped rather than
// written outside the arrays.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kDepthStep = 8;  // the coordinates entry loads this many depths at once

__device__ __forceinline__ unsigned fold32(unsigned long long k) {
  return static_cast<unsigned>(k) ^ static_cast<unsigned>(k >> 32);
}

// Round d of the uint32 splitmix-style hash (core/compression.py::hash_round).
__device__ __forceinline__ unsigned hash_round(unsigned k32, unsigned d) {
  const unsigned c1 = 0x9E3779B9u + 0x7F4A7C15u * d;
  unsigned x = (k32 + c1) * 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// A lane's count and, for the fused entry, its folded keys.  The loads do
// not wait on one another (nor on the count): they are in flight together.
struct Lane {
  int v;
  unsigned ks, kd;
};

template <bool kFused>
__device__ __forceinline__ Lane load_lane(const void* a, const void* b, const int* cnt,
                                          long long i, long long hi) {
  Lane l{0, 0u, 0u};
  if (i < hi) {
    l.v = __ldg(cnt + i);
    if constexpr (kFused) {
      l.ks = fold32(__ldg(static_cast<const unsigned long long*>(a) + i));
      l.kd = fold32(__ldg(static_cast<const unsigned long long*>(b) + i));
    }
  }
  return l;
}

// One CTA takes the lanes [blockIdx.x * chunk, min(n, (blockIdx.x + 1) *
// chunk)), thread t the lanes t, t + blockDim.x, ... of them (the plan
// gives one a thread).  A thread's first lane is loaded before the
// private rows are cleared, and each next lane while the current one is
// added.
template <bool kFused, bool kPriv>
__global__ void sketch_scatter_kernel(int* __restrict__ edge_w, int* __restrict__ out_deg,
                                      int* __restrict__ in_deg, const void* __restrict__ a,
                                      const void* __restrict__ b, const int* __restrict__ cnt,
                                      int depth, int width, int n, int chunk) {
  extern __shared__ int rows[];  // kPriv: D x W out-degree, then D x W in-degree
  const int cells = depth * width;
  const long long lo = static_cast<long long>(blockIdx.x) * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  Lane next = load_lane<kFused>(a, b, cnt, lo + threadIdx.x, hi);
  if constexpr (kPriv) {
    for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) rows[i] = 0;
    __syncthreads();
  }
  int* out_rows = kPriv ? rows : out_deg;
  int* in_rows = kPriv ? rows + cells : in_deg;
  const unsigned w = static_cast<unsigned>(width);
  // cell (d, row, col) gets v in all three arrays
  const auto add = [&](int d, unsigned row, unsigned col, int v) {
    const int drow = d * width;
    atomicAdd(edge_w + (static_cast<long long>(drow) + row) * width + col, v);
    atomicAdd(out_rows + drow + row, v);
    atomicAdd(in_rows + drow + col, v);
  };
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const Lane cur = next;
    next = load_lane<kFused>(a, b, cnt, i + blockDim.x, hi);
    if constexpr (kFused) {
      if (cur.v == 0) continue;
      for (int d = 0; d < depth; ++d) {
        add(d, hash_round(cur.ks, d) % w, hash_round(cur.kd, d) % w, cur.v);
      }
    } else {
      // kDepthStep depths' coordinates are loaded before the count is
      // looked at and before any add, so no load waits on another
      for (int d0 = 0; d0 < depth; d0 += kDepthStep) {
        unsigned row[kDepthStep], col[kDepthStep];
#pragma unroll
        for (int k = 0; k < kDepthStep; ++k) {
          if (d0 + k < depth) {
            const long long at = static_cast<long long>(d0 + k) * n + i;
            row[k] = static_cast<unsigned>(__ldg(static_cast<const int*>(a) + at));
            col[k] = static_cast<unsigned>(__ldg(static_cast<const int*>(b) + at));
          }
        }
        if (cur.v == 0) break;
#pragma unroll
        for (int k = 0; k < kDepthStep; ++k) {
          if (d0 + k < depth && row[k] < w && col[k] < w) add(d0 + k, row[k], col[k], cur.v);
        }
      }
    }
  }
  if constexpr (kPriv) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int o = rows[i];
      if (o != 0) atomicAdd(out_deg + i, o);
      const int q = rows[cells + i];
      if (q != 0) atomicAdd(in_deg + i, q);
    }
  }
}

using Kernel = void (*)(int*, int*, int*, const void*, const void*, const int*, int, int, int,
                        int);

// [fused][private]
const Kernel kKernels[2][2] = {
    {sketch_scatter_kernel<false, false>, sketch_scatter_kernel<false, true>},
    {sketch_scatter_kernel<true, false>, sketch_scatter_kernel<true, true>},
};

// The opt-in above 48 KB of dynamic shared memory is an attribute of
// each kernel on each device: set it to the device's limit on the first
// call there.  The kernels declare no static shared memory (F17).
// Returns the limit in bytes, or a negative cudaError_t.
int opt_in() {
  static std::atomic<int> limit[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (device >= kMaxDevices) return -static_cast<int>(cudaErrorInvalidDevice);
  int bytes = limit[device].load(std::memory_order_acquire);
  if (bytes == 0) {
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    for (const auto& by_private : kKernels) {
      err = cudaFuncSetAttribute(by_private[1], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
      if (err != cudaSuccess) return -static_cast<int>(err);
    }
    limit[device].store(bytes, std::memory_order_release);
  }
  return bytes;
}

}  // namespace

// Launches one sketch update on `stream` under the host's plan
// (kernels/sketch.py::launch_plan): `ctas` CTAs of `threads` threads (a
// multiple of 32 up to 1,024), each CTA taking ceil(n / ctas) lanes, with
// the degree rows in shared memory where `private_rows` is 1.  With
// `fused` 0, a and b are r and c, (depth, n) int32; with 1, the src and
// dst key bits, (n,) uint64.  Allocates nothing.  Returns the
// cudaError_t of the launch (0 = success), or cudaErrorInvalidValue for
// a shape or plan it does not run (private rows that exceed the device's
// opt-in shared memory among them).
extern "C" int sketch_scatter_launch(void* edge_w, void* out_deg, void* in_deg, const void* a,
                                     const void* b, const void* cnt, int fused, int depth,
                                     int width, int n, int ctas, int threads, int private_rows,
                                     void* stream) {
  if (depth < 1 || width < 1 || n < 1 || ctas < 1 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || (fused != 0 && fused != 1) ||
      (private_rows != 0 && private_rows != 1) ||
      static_cast<long long>(depth) * width > (1LL << 28)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  if (private_rows) {
    const int limit = opt_in();
    if (limit < 0) return -limit;
    smem = 2 * static_cast<size_t>(depth) * width * sizeof(int);
    if (smem > static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunk = static_cast<int>((static_cast<long long>(n) + ctas - 1) / ctas);
  kKernels[fused][private_rows]<<<ctas, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(edge_w), static_cast<int*>(out_deg), static_cast<int*>(in_deg), a, b,
      static_cast<const int*>(cnt), depth, width, n, chunk);
  return static_cast<int>(cudaGetLastError());
}
