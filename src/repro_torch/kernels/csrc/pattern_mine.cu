// Per-batch frequent-substructure mining for GraphZip compression,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pattern_mine.py::pattern_mine
// (the pl.pallas_call at pattern_mine.py:174, body mine_body at :75 and
// the in-kernel sort _bitonic_sort at :127).
//
// For each edge e of a dedup'd batch of n edges (n a power of two):
//   fan_out[e] = #{f : tag(src, etype, A1) equal}   (hub fan-out)
//   fan_in[e]  = #{f : tag(dst, etype, A2) equal}   (hub fan-in)
//   chain      = dst[e] is the src of some valid edge, and dst != src
//   hot        = count[e] >= hot_min
// flags is the FLAG_* mask of (fan_out >= star_min, fan_in >= star_min,
// chain, hot), psig the signature of the strongest pattern (0 where
// flags is 0), and both fans are 0 on invalid lanes.
//
// Design.  One CTA of 1,024 threads does everything, so no phase needs
// a grid-wide barrier:
//   1. it builds the three key vectors (the (src,etype) and (dst,etype)
//      group keys and src; invalid lanes hold the all-ones sentinel,
//      which sorts last in unsigned order) in shared memory, or in the
//      caller's scratch where 3 n keys do not fit (n > 8,192);
//   2. it bitonic-sorts all three at once, unsigned, one barrier per
//      stage: 91 stages at n = 8,192, each thread doing 12 of the
//      3 n / 2 compare-exchanges per stage;
//   3. one thread per edge (strided) then runs the five binary searches
//      of the reference's _bisect step for step (n's bit length steps,
//      the probe clipped to [0, n), so a query above every key ends at
//      n + 1, as there), and the flag and signature logic.
// Sorted values do not depend on the sorting network, so the result is
// bit-equal to the plain version, which sorts with torch.sort.
//
// What bounds it on this card: bytes in principle (six n-vectors read,
// four written: 272 KB at the path's 8,192 edges, about 0.08 us at
// 3.35 TB/s), but one CTA on one of the 132 SMs is bound by the latency
// of its barriers and shared-memory round trips.  The design accepts
// that for now: the path launches it once per commit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 1024;
constexpr int kSmemLanes = 8192;  // 3 x 8,192 x 8 B = 192 KB of shared memory
constexpr int kMaxDevices = 64;  // devices whose shared-memory opt-in is tracked
constexpr uint64_t kSentinel = ~0ull;
constexpr uint64_t kC1 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kC2 = 0xBF58476D1CE4E5B9ull;
constexpr int kTagStarOut = 0xA1, kTagStarIn = 0xA2, kTagChain = 0xA3, kTagHot = 0xA4;

// core/compression.py::mix_keys: exact 27/27/8-bit packing when the ids
// fit, else the splitmix hash with bit 63 set; the sentinel and 0 are
// remapped away.  `dst` is the int64 value as uint64 bits.
__device__ __forceinline__ uint64_t mix_keys(uint64_t src, uint64_t dst, int etype) {
  const uint64_t et = static_cast<uint64_t>(static_cast<int64_t>(etype));
  uint64_t x = src * kC1 + dst;
  x = (x ^ (x >> 30)) * kC2;
  x = x ^ (x >> 27);
  x = x + et;
  const bool fits = src < (1ull << 27) && dst < (1ull << 27) && etype >= 0 && et < (1ull << 8);
  x = fits ? ((1ull << 62) | (src << 35) | (dst << 8) | et) : (x | (1ull << 63));
  if (x == kSentinel) x = kSentinel - 1;
  return x == 0 ? 2 : x;
}

// Pattern signature: id x etype x pattern-class tag (etype in the "dst" place).
__device__ __forceinline__ uint64_t tag_key(uint64_t id, int etype, int tag) {
  return mix_keys(id, static_cast<uint64_t>(static_cast<int64_t>(etype)), tag);
}

__device__ __forceinline__ int bisect(const uint64_t* s, int n, int steps, uint64_t q,
                                      bool right) {
  int lo = 0, hi = n;
  for (int t = 0; t < steps; ++t) {
    const int mid = (lo + hi) >> 1;
    const uint64_t v = s[min(mid, n - 1)];
    const bool go = right ? (v <= q) : (v < q);
    lo = go ? mid + 1 : lo;
    hi = go ? hi : mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
pattern_mine_kernel(const uint64_t* __restrict__ src, const uint64_t* __restrict__ dst,
                    const int* __restrict__ etype, const int* __restrict__ count,
                    const bool* __restrict__ valid, int n, int star_min, int hot_min,
                    int* __restrict__ fan_out, int* __restrict__ fan_in,
                    int* __restrict__ flags, uint64_t* __restrict__ psig,
                    uint64_t* scratch) {
  extern __shared__ uint64_t smem[];
  uint64_t* keys = n <= kSmemLanes ? smem : scratch;
  const int tid = threadIdx.x;

  // 1. the three sort vectors: group keys out, group keys in, tails
  for (int i = tid; i < n; i += kThreads) {
    const bool v = valid[i];
    keys[i] = v ? tag_key(src[i], etype[i], kTagStarOut) : kSentinel;
    keys[n + i] = v ? tag_key(dst[i], etype[i], kTagStarIn) : kSentinel;
    keys[2 * n + i] = v ? src[i] : kSentinel;
  }
  __syncthreads();

  // 2. bitonic sort of the three vectors, ascending unsigned
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < 3 * half; p += kThreads) {
        const int vec = p / half, q = p - vec * half;
        const int i = (q / j) * 2 * j + (q % j);
        uint64_t* base = keys + vec * n;
        const uint64_t a = base[i], b = base[i + j];
        const bool asc = (i & k) == 0;
        if (asc ? a > b : a < b) {
          base[i] = b;
          base[i + j] = a;
        }
      }
      __syncthreads();
    }
  }

  // 3. classify every edge
  const uint64_t* sgs = keys;
  const uint64_t* sgd = keys + n;
  const uint64_t* ssrc = keys + 2 * n;
  int steps = 0;
  for (int m = n; m > 0; m >>= 1) ++steps;  // n's bit length
  for (int e = tid; e < n; e += kThreads) {
    if (!valid[e]) {
      fan_out[e] = 0;
      fan_in[e] = 0;
      flags[e] = 0;
      psig[e] = 0;
      continue;
    }
    const uint64_t s = src[e], d = dst[e];
    const int et = etype[e];
    const uint64_t gs = tag_key(s, et, kTagStarOut), gd = tag_key(d, et, kTagStarIn);
    const int fo = bisect(sgs, n, steps, gs, true) - bisect(sgs, n, steps, gs, false);
    const int fi = bisect(sgd, n, steps, gd, true) - bisect(sgd, n, steps, gd, false);
    const int pos = bisect(ssrc, n, steps, d, false);
    const bool chain = ssrc[min(pos, n - 1)] == d && d != s;
    const bool staro = fo >= star_min, stari = fi >= star_min, hot = count[e] >= hot_min;
    const int f = (staro ? 1 : 0) + (stari ? 2 : 0) + (chain ? 4 : 0) + (hot ? 8 : 0);
    uint64_t sig = 0;
    if (staro) {
      sig = gs;
    } else if (stari) {
      sig = gd;
    } else if (chain) {
      sig = tag_key(d, et, kTagChain);
    } else if (hot) {
      sig = tag_key(s, et, kTagHot);
    }
    fan_out[e] = fo;
    fan_in[e] = fi;
    flags[e] = f;
    psig[e] = sig;
  }
}

}  // namespace

// Launches the miner on `stream`; allocates nothing.  n must be a power
// of two; `scratch` must hold 3 n keys where n > 8,192 and may be null
// otherwise.  Returns the cudaError_t of the launch (0 = success).
extern "C" int pattern_mine_launch(const void* src, const void* dst, const void* etype,
                                   const void* count, const void* valid, int n, int star_min,
                                   int hot_min, void* fan_out, void* fan_in, void* flags,
                                   void* psig, void* scratch, void* stream) {
  // The opt-in above 48 KB of dynamic shared memory is an attribute of
  // the kernel on each device: set it on the first launch there only.
  static std::atomic<bool> smem_opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_opted_in[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(pattern_mine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               3 * kSmemLanes * static_cast<int>(sizeof(uint64_t)));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opted_in[device].store(true, std::memory_order_release);
  }
  const size_t smem = n <= kSmemLanes ? 3 * static_cast<size_t>(n) * sizeof(uint64_t) : 0;
  pattern_mine_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(src), static_cast<const uint64_t*>(dst),
      static_cast<const int*>(etype), static_cast<const int*>(count),
      static_cast<const bool*>(valid), n, star_min, hot_min, static_cast<int*>(fan_out),
      static_cast<int*>(fan_in), static_cast<int*>(flags), static_cast<uint64_t*>(psig),
      static_cast<uint64_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
