// Blocked Bloom filter, probe and build, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/bloom.py::bloom_probe (the
// pl.pallas_call at bloom.py:77, body _probe_kernel at :41) and
// ::bloom_build (the pl.pallas_call at bloom.py:97, body _build_kernel
// at :53).
//
// The filter is `words` uint32 words (a (W, 1024) bitmap).  Round r of
// the hash of key k (r = 0..3) is
//   x = (k + (0x9E3779B9 + 0x7F4A7C15 r)) * 0x85EBCA6B;  x ^= x >> 13;
//   x *= 0xC2B2AE35;  x ^= x >> 16
// in native uint32 arithmetic, and picks word (x >> 5) % words, bit
// x % 32.  Probe: one thread per key, hit = the AND of the 4 bit tests.
// Build: one thread per (key, round), an unsigned atomicOr of the bit
// into a copy of the bitmap.  OR does not depend on order, so the
// result is bit-exact against the plain version whatever order the
// atomics resolve in.  The TPU kernel had no scatter-OR and ran 32
// scatter-max passes per round; here each bit is one atomic.
//
// Build returns a new bitmap (the reference's op is functional): the
// launch function first copies the caller's bitmap into `out` on the
// same stream, then ORs the keys' bits into `out`.
//
// What bounds it on this card: bytes and latency.  A probe reads its key
// (8 B), 4 words and writes 4 B; a build also copies the bitmap (256 KB
// each way at 64 rows).  At the filter sizes of the path (up to 64 rows,
// 256 KB) the bitmap sits in L2, so the random word accesses cost L2
// latency, not HBM bandwidth; at 16,384 keys the work is a few us of
// launch and latency.  Nothing more is done about it yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHashes = 4;

__device__ __forceinline__ uint32_t hash_round(uint32_t k, uint32_t r) {
  uint32_t x = (k + (0x9E3779B9u + 0x7F4A7C15u * r)) * 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__global__ void __launch_bounds__(kThreads)
bloom_probe_kernel(const long long* __restrict__ keys, const uint32_t* __restrict__ bitmap,
                   int* __restrict__ hit, int n, uint32_t words) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t k = static_cast<uint32_t>(keys[i]);
  uint32_t all = 1;
  for (uint32_t r = 0; r < kHashes; ++r) {
    const uint32_t h = hash_round(k, r);
    all &= (__ldg(bitmap + (h >> 5) % words) >> (h & 31u)) & 1u;
  }
  hit[i] = static_cast<int>(all);
}

__global__ void __launch_bounds__(kThreads)
bloom_build_kernel(const long long* __restrict__ keys, uint32_t* __restrict__ out, int n,
                   uint32_t words) {
  const long long lane = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= static_cast<long long>(n) * kHashes) return;
  const int i = static_cast<int>(lane / kHashes);
  const uint32_t r = static_cast<uint32_t>(lane % kHashes);
  const uint32_t h = hash_round(static_cast<uint32_t>(keys[i]), r);
  atomicOr(out + (h >> 5) % words, 1u << (h & 31u));
}

}  // namespace

// Both launch functions run on `stream`, allocate nothing, and return
// the cudaError_t of the launch (0 = success).  n must be > 0 and
// 0 < words < 2^31.

// hit[i] = 1 iff all 4 bits of keys[i] are set in `bitmap`.
extern "C" int bloom_probe_launch(const void* keys, const void* bitmap, void* hit, int n,
                                  int words, void* stream) {
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  bloom_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const uint32_t*>(bitmap),
      static_cast<int*>(hit), n, static_cast<uint32_t>(words));
  return static_cast<int>(cudaGetLastError());
}

// out = bitmap with the 4 bits of every key set; `bitmap` is not written.
extern "C" int bloom_build_launch(const void* keys, const void* bitmap, void* out, int n,
                                  int words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(out, bitmap, static_cast<size_t>(words) * sizeof(uint32_t),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long lanes = static_cast<long long>(n) * kHashes;
  const unsigned int blocks = static_cast<unsigned int>((lanes + kThreads - 1) / kThreads);
  bloom_build_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const long long*>(keys),
                                                 static_cast<uint32_t*>(out), n,
                                                 static_cast<uint32_t>(words));
  return static_cast<int>(cudaGetLastError());
}
