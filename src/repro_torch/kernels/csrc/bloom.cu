// Blocked Bloom filter, probe and build, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/bloom.py::bloom_probe (the
// pl.pallas_call at bloom.py:77, body _probe_kernel at :41) and
// ::bloom_build (the pl.pallas_call at bloom.py:97, body _build_kernel
// at :53).
//
// The filter is a (rows, 1024) bitmap of uint32 words.  Round r of the
// hash of key k (r = 0..3) is
//   x = (k + (0x9E3779B9 + 0x7F4A7C15 r)) * 0x85EBCA6B;  x ^= x >> 13;
//   x *= 0xC2B2AE35;  x ^= x >> 16
// in native uint32 arithmetic, and picks word (x >> 5) % (rows * 1024),
// bit x % 32.  Since a row is 1,024 words, that word is row
// (x >> 15) % rows, column (x >> 5) & 1023 (the row split): which row a
// bit falls in is known from x >> 15 alone, so a CTA can own whole rows.
//
// What bounds it on this card: launches and latency.  A probe reads its
// key (8 B), 4 words and writes 4 B; a build reads the bitmap and writes
// a new one (256 KB each way at 64 rows), a few ns of HBM time.  At the
// kernel-ops entry point's sizes (2 to 64 rows, 64 to 16,384 keys) a call
// is a launch, a few dependent round trips and, where every CTA walks
// every key, the instructions of that walk.  The design:
//   * Probe: a thread a key, on a grid the host plans
//     (kernels/bloom.py::launch_plan), with a mask for the row where rows
//     is a power of two.  (2 to 4 keys a thread never beat one by more
//     than the timer's resolution.)
//   * Build, the striped route: one launch, no copy, no global atomic.
//     CTA b owns S rows; it zeroes a delta of them in shared memory,
//     walks all n keys and ORs each round that lands in its rows into the
//     delta with a shared atomicOr, read first and skipped where the bit
//     is set already (a Zipf hub's repeats cost a read, not an atomic; OR
//     is idempotent, so the race is harmless); after one barrier it writes
//     out = in | delta over its rows.  No two CTAs write one word, and
//     the caller's bitmap is only read.  The cost: every CTA hashes every
//     key, about 0.67 us a CTA for 1,000 keys on CTAs of 1,024 threads,
//     so the host takes it for small calls.  (Clusters of CTAs that split
//     the keys over distributed shared memory cost about 3 us a launch
//     and never won: PERF.md §6.)
//   * Build, the grid route: one cooperative launch.  Every CTA copies
//     its share of `in` into `out` and hashes its keys, a thread a key;
//     a grid barrier; then a thread ORs its key's 4 bits into `out` with
//     global atomics, sent at once (a read first cost 1 to 3 us), once a
//     warp for a key several of its lanes hold.  For large calls: the
//     keys are hashed once, and the barrier costs less than a copy
//     operation ahead of the kernel (the structure this kernel had
//     before).
//   * bloom_diversity: the grid route's build that also probes each key
//     against the caller's bitmap, which no CTA writes, and writes the
//     hit as float32 0.0 / 1.0.  Its calls are batches of thousands of
//     keys, where the grid route leads (PERF.md §6).
// OR does not depend on order, so every plan gives the plain version's
// bits exactly.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kHashes = 4;
constexpr uint32_t kLanes = 1024;       // words a row
constexpr uint32_t kVecs = kLanes / 4;  // uint4 a row
constexpr int kMaxThreads = 1024;       // build CTAs
constexpr int kMaxProbeThreads = 256;
constexpr int kMaxStripe = 32;  // rows of shared memory a CTA (128 KB)
constexpr int kPre = 4;         // uint4 of its rows a thread loads before the keys
constexpr int kBatch = 4;       // keys a thread loads at once
constexpr int kMaxDevices = 64;
constexpr int kRouteStriped = 0, kRouteGrid = 1;

__device__ __forceinline__ uint32_t hash_round(uint32_t k, uint32_t r) {
  uint32_t x = (k + (0x9E3779B9u + 0x7F4A7C15u * r)) * 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// word (h >> 5) % (rows * 1024), by the row split
__device__ __forceinline__ uint32_t word_of(uint32_t h, uint32_t rows) {
  return (((h >> 15) % rows) << 10) | ((h >> 5) & (kLanes - 1));
}

// 1 iff all 4 bits of the key whose rounds are h are set in `bitmap`
__device__ __forceinline__ uint32_t probe(const uint32_t* __restrict__ bitmap,
                                          const uint32_t (&h)[kHashes], uint32_t rows) {
  uint32_t v[kHashes];
#pragma unroll
  for (int r = 0; r < kHashes; ++r) v[r] = __ldg(bitmap + word_of(h[r], rows));
  uint32_t all = 1;
#pragma unroll
  for (int r = 0; r < kHashes; ++r) all &= v[r] >> (h[r] & 31u);
  return all & 1u;
}

__device__ __forceinline__ uint4 operator|(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// The row of hash h: (h >> 15) % rows, a mask where rows is a power of two.
template <bool kPow2>
__device__ __forceinline__ uint32_t row_of(uint32_t h, uint32_t rows) {
  return kPow2 ? (h >> 15) & (rows - 1) : (h >> 15) % rows;
}

// A thread a key.
template <bool kPow2>
__global__ void __launch_bounds__(kMaxProbeThreads)
bloom_probe_kernel(const long long* __restrict__ keys, const uint32_t* __restrict__ bitmap,
                   int* __restrict__ hit, int n, uint32_t rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t key = static_cast<uint32_t>(keys[i]);
  uint32_t all = 1;
#pragma unroll
  for (int r = 0; r < kHashes; ++r) {
    const uint32_t h = hash_round(key, r);
    const uint32_t w = (row_of<kPow2>(h, rows) << 10) | ((h >> 5) & (kLanes - 1));
    all &= __ldg(bitmap + w) >> (h & 31u);
  }
  hit[i] = static_cast<int>(all & 1u);
}

// The striped route (see the head of the file): CTA b owns rows
// [b S, min((b + 1) S, rows)) and walks keys k T + t.
template <bool kPow2>
__global__ void __launch_bounds__(kMaxThreads)
bloom_striped_kernel(const long long* __restrict__ keys, const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, int n, uint32_t rows, uint32_t stripe) {
  extern __shared__ uint4 delta4[];
  uint32_t* delta = reinterpret_cast<uint32_t*>(delta4);
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const uint32_t lo = blockIdx.x * stripe;  // this CTA's first row (< rows: no CTA is empty)
  const int own_vecs = static_cast<int>(min(stripe, rows - lo) * kVecs);
  const uint4* in4 = reinterpret_cast<const uint4*>(in) + lo * kVecs;

  // this CTA's rows of the caller's bitmap and the first keys, in flight
  // while the delta is zeroed
  uint4 pre[kPre];
#pragma unroll
  for (int j = 0; j < kPre; ++j) {
    if (t + j * T < own_vecs) pre[j] = __ldg(in4 + t + j * T);
  }
  uint32_t key[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int i = t + b * T;
    key[b] = i < n ? static_cast<uint32_t>(keys[i]) : 0u;
  }
  for (int v = t; v < own_vecs; v += T) delta4[v] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  for (int base = t; base < n; base += kBatch * T) {
    uint32_t cur[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      cur[b] = key[b];
      const int i = base + (kBatch + b) * T;
      key[b] = i < n ? static_cast<uint32_t>(keys[i]) : 0u;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = base + b * T;
      if (i < n) {
#pragma unroll
        for (int r = 0; r < kHashes; ++r) {
          const uint32_t h = hash_round(cur[b], r);
          const uint32_t local = row_of<kPow2>(h, rows) - lo;  // wraps below the stripe
          if (local < stripe) {
            uint32_t* word = delta + ((local << 10) | ((h >> 5) & (kLanes - 1)));
            const uint32_t bit = 1u << (h & 31u);
            if (!(*word & bit)) atomicOr(word, bit);
          }
        }
      }
    }
  }
  __syncthreads();

  uint4* out4 = reinterpret_cast<uint4*>(out) + lo * kVecs;
#pragma unroll
  for (int j = 0; j < kPre; ++j) {
    const int v = t + j * T;
    if (v < own_vecs) out4[v] = pre[j] | delta4[v];
  }
  for (int v = t + kPre * T; v < own_vecs; v += T) out4[v] = __ldg(in4 + v) | delta4[v];
}

// One key of the grid route: its words and bits, and whether this lane
// ORs them (the lowest lane of the warp that holds the key).
struct Key {
  uint32_t word[kHashes];
  uint32_t bit[kHashes];
  bool leader;
};

// Key i, called by every lane of the warp at once (lanes i to i + 31 of
// consecutive keys); a lane with i >= n holds no key and ORs nothing.  The
// warp's match is over all 32 lanes, a lane with no key matching on 2^32,
// which no uint32 key equals.
template <bool kProbe>
__device__ __forceinline__ Key hash_key(const long long* __restrict__ keys,
                                        const uint32_t* __restrict__ in,
                                        float* __restrict__ hits, int i, int n, uint32_t rows) {
  Key k;
  const bool live = i < n;
  const uint32_t key = live ? static_cast<uint32_t>(keys[i]) : 0u;
  uint32_t h[kHashes];
#pragma unroll
  for (int r = 0; r < kHashes; ++r) {
    h[r] = hash_round(key, r);
    k.word[r] = word_of(h[r], rows);
    k.bit[r] = 1u << (h[r] & 31u);
  }
  if constexpr (kProbe) {
    if (live) hits[i] = probe(in, h, rows) ? 1.0f : 0.0f;
  }
  const unsigned long long value = live ? key : 1ull << 32;
  const unsigned peers = __match_any_sync(0xffffffffu, value);
  k.leader = live && (threadIdx.x & 31) == __ffs(peers) - 1;
  return k;
}

__device__ __forceinline__ void or_key(uint32_t* __restrict__ out, const Key& k) {
  if (!k.leader) return;
#pragma unroll
  for (int r = 0; r < kHashes; ++r) atomicOr(out + k.word[r], k.bit[r]);
}

// The grid route, one cooperative launch: every thread hashes (and
// probes) its first key and copies its share of `in` into `out`; a grid
// barrier; then the atomics.  Keys past the grid's threads follow,
// grid-strided.  A warp's trips test its first lane's key index, so all
// its lanes take the same trips and reach each match together
// (blockDim.x is a multiple of 32).
template <bool kProbe>
__global__ void __launch_bounds__(kMaxThreads)
bloom_grid_kernel(const long long* __restrict__ keys, const uint32_t* __restrict__ in,
                  uint32_t* __restrict__ out, float* __restrict__ hits, int n, uint32_t rows) {
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  Key k;
  if (first - lane < n) k = hash_key<kProbe>(keys, in, hits, first, n, rows);
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (uint32_t v = first; v < rows * kVecs; v += stride) out4[v] = __ldg(in4 + v);
  cg::this_grid().sync();
  if (first - lane < n) or_key(out, k);
  for (int base = first - lane + stride; base < n; base += stride) {
    or_key(out, hash_key<kProbe>(keys, in, hits, base + lane, n, rows));
  }
}

// The striped kernels' opt-in to 128 KB of dynamic shared memory, once a
// device (the kernels declare no static shared memory, F17).
cudaError_t opt_in() {
  static std::atomic<bool> opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device].load(std::memory_order_acquire)) {
    const int bytes = kMaxStripe * kLanes * 4;
    const cudaFuncAttribute max = cudaFuncAttributeMaxDynamicSharedMemorySize;
    if ((err = cudaFuncSetAttribute(bloom_striped_kernel<false>, max, bytes)) ||
        (err = cudaFuncSetAttribute(bloom_striped_kernel<true>, max, bytes))) {
      return err;
    }
    opted_in[device].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

cudaError_t launch_striped(const long long* keys, const uint32_t* in, uint32_t* out, int n,
                           uint32_t rows, int stripe, int threads, cudaStream_t s) {
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return err;
  const unsigned int ctas = (rows + stripe - 1) / stripe;
  const size_t smem = static_cast<size_t>(stripe) * kLanes * 4;
  if ((rows & (rows - 1)) == 0) {
    bloom_striped_kernel<true><<<ctas, threads, smem, s>>>(keys, in, out, n, rows, stripe);
  } else {
    bloom_striped_kernel<false><<<ctas, threads, smem, s>>>(keys, in, out, n, rows, stripe);
  }
  return cudaGetLastError();
}

// CTAs of `threads` threads of the grid kernel resident on the card at
// once (a cooperative launch's limit), found once a device and CTA size.
template <bool kProbe>
cudaError_t resident_ctas(int threads, long long* ctas) {
  static std::atomic<int> cached[kMaxDevices][kMaxThreads / 32];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = cached[device][threads / 32 - 1];
  int resident = slot.load(std::memory_order_relaxed);
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bloom_grid_kernel<kProbe>,
                                                             threads, 0))) {
      return err;
    }
    resident = sms * per_sm;
    slot.store(resident, std::memory_order_relaxed);
  }
  *ctas = resident;
  return cudaSuccess;
}

// The grid route's CTAs: enough for a key a thread and for a uint4 of the
// copy a thread, at most as many as are resident on the card at once.
template <bool kProbe>
cudaError_t launch_grid(const long long* keys, const uint32_t* in, uint32_t* out, float* hits,
                        int n, uint32_t rows, int threads, cudaStream_t s) {
  long long resident = 0;
  cudaError_t err = resident_ctas<kProbe>(threads, &resident);
  if (err != cudaSuccess) return err;
  const long long work = std::max<long long>(n, static_cast<long long>(rows) * kVecs);
  const long long ctas = std::min<long long>((work + threads - 1) / threads, resident);
  if (ctas < 1) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute cooperative[1];
  cooperative[0].id = cudaLaunchAttributeCooperative;
  cooperative[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(ctas));
  config.blockDim = dim3(threads);
  config.stream = s;
  config.attrs = cooperative;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, bloom_grid_kernel<kProbe>, keys, in, out, hits, n, rows);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether the build takes this call: n >= 1, rows in [1, 2^21), threads a
// multiple of 32 in [32, 1,024], and the striped route with a stripe of 1
// to 32 rows (its grid, rows / stripe rounded up, has no CTA past the
// last row), or the grid route with stripe 0.
bool build_ok(int n, int rows, int route, int stripe, int threads) {
  if (n < 1 || rows < 1 || rows >= (1 << 21) || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0) {
    return false;
  }
  if (route == kRouteStriped) return stripe >= 1 && stripe <= kMaxStripe;
  return route == kRouteGrid && stripe == 0;
}

}  // namespace

// Each launch function runs on `stream`, allocates nothing, and returns
// the cudaError_t of its launch (0 = success), or cudaErrorInvalidValue
// without launching for a shape or plan its kernel does not run.

// hit[i] = 1 iff all 4 bits of keys[i] are set in `bitmap`: `ctas` CTAs
// of `threads` threads (a multiple of 32 up to 256), a key a thread;
// refused for n < 1, rows outside [1, 2^21), or a grid short of n keys
// or with a CTA past the last key.
extern "C" int bloom_probe_launch(const void* keys, const void* bitmap, void* hit, int n,
                                  int rows, int ctas, int threads, void* stream) {
  if (n < 1 || rows < 1 || rows >= (1 << 21) || ctas < 1 || threads < 32 ||
      threads > kMaxProbeThreads || threads % 32 != 0 ||
      static_cast<int64_t>(ctas) * threads < n || static_cast<int64_t>(ctas - 1) * threads >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* k = static_cast<const long long*>(keys);
  const uint32_t* b = static_cast<const uint32_t*>(bitmap);
  int* h = static_cast<int*>(hit);
  const uint32_t r = static_cast<uint32_t>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((r & (r - 1)) == 0) {
    bloom_probe_kernel<true><<<ctas, threads, 0, s>>>(k, b, h, n, r);
  } else {
    bloom_probe_kernel<false><<<ctas, threads, 0, s>>>(k, b, h, n, r);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = bitmap with the 4 bits of every key set under a plan (`route`,
// for the striped route `stripe` rows a CTA, `threads` a CTA); `bitmap`
// is not written.
extern "C" int bloom_build_launch(const void* keys, const void* bitmap, void* out, int n,
                                  int rows, int route, int stripe, int threads, void* stream) {
  if (!build_ok(n, rows, route, stripe, threads)) return static_cast<int>(cudaErrorInvalidValue);
  const long long* k = static_cast<const long long*>(keys);
  const uint32_t* in = static_cast<const uint32_t*>(bitmap);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t r = static_cast<uint32_t>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteStriped) {
    return static_cast<int>(launch_striped(k, in, o, n, r, stripe, threads, s));
  }
  return static_cast<int>(launch_grid<false>(k, in, o, nullptr, n, r, threads, s));
}

// The build above on the grid route (the only one this entry takes), and
// hits[i] = 1.0f iff all 4 bits of keys[i] are set in `bitmap` (the
// filter before the build), else 0.0f, in the same launch.
extern "C" int bloom_diversity_launch(const void* keys, const void* bitmap, void* out,
                                      void* hits, int n, int rows, int route, int stripe,
                                      int threads, void* stream) {
  if (!build_ok(n, rows, route, stripe, threads) || route != kRouteGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_grid<true>(
      static_cast<const long long*>(keys), static_cast<const uint32_t*>(bitmap),
      static_cast<uint32_t*>(out), static_cast<float*>(hits), n, static_cast<uint32_t>(rows),
      threads, static_cast<cudaStream_t>(stream)));
}
