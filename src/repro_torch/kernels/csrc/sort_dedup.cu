// Bitonic sort with run-head marking (Algorithm 1's INSERTEDGE dedup as
// a sorting network), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/edge_dedup.py::sort_dedup (the
// pl.pallas_call at edge_dedup.py:68, body _dedup_kernel at :43).
//
// Sorts n (a power of two) uint32 keys, carried in int64, together with
// their input positions, by the reference's bitonic network, compare for
// compare: for k = 2, 4, ..., n and j = k/2, ..., 1, lane i with bit j
// clear meets lane i + j; the pair ascends iff (i & k) == 0 and swaps
// iff ascending ? a > b : a < b.  Equal keys never swap, so `order` is
// exactly the reference kernel's (not a stable sort's).  Then
// head[i] = (i == 0 || sorted[i] != sorted[i-1]).
//
// The TPU kernel held the whole vector in VMEM (up to 65,536 keys).  A
// CTA here holds kTile = 16,384 (key, position) pairs, 128 KB of dynamic
// shared memory, opted in once per device:
//   * n <= kTile: one CTA runs the whole network in shared memory and
//     writes the three outputs;
//   * n > kTile: each tile first sorts itself (k <= kTile) into the
//     caller's scratch; then for each larger k, one launch per stage with
//     j >= kTile exchanges pairs across tiles in device memory, and one
//     shared-memory pass per tile runs the stages j < kTile.  The last
//     such pass (k = n) writes the outputs and marks the run heads.  By
//     then every key of tile t-1 is at most every key of tile t, so the
//     key before a tile's first is the largest key of the previous tile,
//     which the CTA reduces from the scratch (only read in that pass).
//
// What bounds it on this card: neither bytes nor operations at these
// sizes, but the network's log2(n) (log2(n) + 1) / 2 dependent stages,
// each a barrier (105 at n = 16,384, 210 at 2^20).  The bytes a call
// must move are 24 per lane (8 read, 8 + 4 + 4 written), 25 MB at 2^20,
// under 8 us at 3.35 TB/s.  The design keeps every stage it can inside
// shared memory and runs many CTAs once n exceeds a tile; a faster sort
// (register-resident sub-networks, warp shuffles) is later work.

#include <atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 1 << 14;  // pairs per CTA in shared memory (csrc of SMEM_LANES)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void compare_exchange(unsigned* key, int* pos, unsigned i, unsigned j,
                                                 bool ascending) {
  const unsigned a = key[i], b = key[i + j];
  if (ascending ? a > b : a < b) {
    key[i] = b;
    key[i + j] = a;
    const int t = pos[i];
    pos[i] = pos[i + j];
    pos[i + j] = t;
  }
}

// Lane i of the p-th pair of stage j: i = (p / j) * 2j + p % j.
__device__ __forceinline__ unsigned pair_lane(unsigned p, unsigned j) {
  return (p / j) * 2 * j + (p % j);
}

// Block-wide max of `v` (every thread must call it).
__device__ unsigned block_max(unsigned v) {
  __shared__ unsigned warp_max[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = warp_max[threadIdx.x];
    for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (threadIdx.x == 0) warp_max[0] = v;
  }
  __syncthreads();
  return warp_max[0];
}

// One tile of `tile` lanes in shared memory: load (from the int64 input
// with positions as lanes, or from the scratch), run the stages
// (k_first, j_first) .. (k_last, 1), and store (to the scratch, or to
// the outputs with run heads).
__global__ void __launch_bounds__(kThreads)
tile_kernel(const long long* __restrict__ in_keys, unsigned* s_key, int* s_pos,
            long long* __restrict__ out_sorted, int* __restrict__ out_order,
            int* __restrict__ out_head, int tile, int k_first, int j_first, int k_last) {
  extern __shared__ unsigned smem[];
  unsigned* key = smem;
  int* pos = reinterpret_cast<int*>(smem + tile);
  const unsigned base = static_cast<unsigned>(blockIdx.x) * tile;

  for (int t = threadIdx.x; t < tile; t += kThreads) {
    if (in_keys != nullptr) {
      key[t] = static_cast<unsigned>(in_keys[base + t]);
      pos[t] = static_cast<int>(base + t);
    } else {
      key[t] = s_key[base + t];
      pos[t] = s_pos[base + t];
    }
  }
  __syncthreads();

  const unsigned pairs = static_cast<unsigned>(tile) / 2;
  for (unsigned k = k_first; k <= static_cast<unsigned>(k_last); k *= 2) {
    for (unsigned j = (k == static_cast<unsigned>(k_first) ? j_first : k / 2); j >= 1; j /= 2) {
      for (unsigned p = threadIdx.x; p < pairs; p += kThreads) {
        const unsigned i = pair_lane(p, j);
        compare_exchange(key, pos, i, j, ((base + i) & k) == 0);
      }
      __syncthreads();
    }
  }

  if (out_sorted == nullptr) {
    for (int t = threadIdx.x; t < tile; t += kThreads) {
      s_key[base + t] = key[t];
      s_pos[base + t] = pos[t];
    }
    return;
  }
  // the key before this tile's first: none for tile 0, else the largest
  // key of the previous tile (still in the scratch, which this pass reads)
  unsigned before = 0;
  if (blockIdx.x > 0) {
    unsigned m = 0;
    for (int t = threadIdx.x; t < tile; t += kThreads) m = max(m, s_key[base - tile + t]);
    before = block_max(m);
  }
  for (int t = threadIdx.x; t < tile; t += kThreads) {
    out_sorted[base + t] = static_cast<long long>(key[t]);
    out_order[base + t] = pos[t];
    const bool first = t == 0 ? (blockIdx.x == 0 || key[0] != before) : key[t] != key[t - 1];
    out_head[base + t] = first ? 1 : 0;
  }
}

// One stage (k, j) with j >= kTile, in device memory: a thread per pair.
__global__ void __launch_bounds__(256)
global_stage_kernel(unsigned* __restrict__ key, int* __restrict__ pos, unsigned pairs,
                    unsigned k, unsigned j) {
  const unsigned p = blockIdx.x * 256u + threadIdx.x;
  if (p >= pairs) return;
  const unsigned i = pair_lane(p, j);
  compare_exchange(key, pos, i, j, (i & k) == 0);
}

}  // namespace

// Launches the sort on `stream`; allocates nothing.  n must be a power
// of two up to 2^30; `scratch` must hold 2 n int32 where n > 16,384 and
// may be null otherwise.  Returns the cudaError_t of the first launch
// that failed (0 = success).
extern "C" int sort_dedup_launch(const void* keys, void* sorted, void* order, void* head, int n,
                                 void* scratch, void* stream) {
  // The opt-in above 48 KB of dynamic shared memory is an attribute of
  // the kernel on each device: set it on the first launch there only.
  static std::atomic<bool> smem_opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_opted_in[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTile * 2 * static_cast<int>(sizeof(unsigned)));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opted_in[device].store(true, std::memory_order_release);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* in = static_cast<const long long*>(keys);
  long long* out_sorted = static_cast<long long*>(sorted);
  int* out_order = static_cast<int*>(order);
  int* out_head = static_cast<int*>(head);

  if (n <= kTile) {
    const size_t smem = 2 * static_cast<size_t>(n) * sizeof(unsigned);
    tile_kernel<<<1, kThreads, smem, s>>>(in, nullptr, nullptr, out_sorted, out_order, out_head,
                                          n, 2, 1, n);
    return static_cast<int>(cudaGetLastError());
  }

  unsigned* s_key = static_cast<unsigned*>(scratch);
  int* s_pos = static_cast<int*>(scratch) + n;
  const int tiles = n / kTile;
  const size_t smem = 2 * static_cast<size_t>(kTile) * sizeof(unsigned);
  const unsigned pairs = static_cast<unsigned>(n) / 2;
  const unsigned stage_blocks = (pairs + 255u) / 256u;

  tile_kernel<<<tiles, kThreads, smem, s>>>(in, s_key, s_pos, nullptr, nullptr, nullptr, kTile,
                                            2, 1, kTile);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (unsigned k = 2u * kTile; k <= static_cast<unsigned>(n); k *= 2) {
    for (unsigned j = k / 2; j >= static_cast<unsigned>(kTile); j /= 2) {
      global_stage_kernel<<<stage_blocks, 256, 0, s>>>(s_key, s_pos, pairs, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    const bool last = k == static_cast<unsigned>(n);
    tile_kernel<<<tiles, kThreads, smem, s>>>(
        nullptr, s_key, s_pos, last ? out_sorted : nullptr, last ? out_order : nullptr,
        last ? out_head : nullptr, kTile, static_cast<int>(k), kTile / 2, static_cast<int>(k));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
