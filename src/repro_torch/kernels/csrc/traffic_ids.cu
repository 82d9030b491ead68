// Counter-based traffic-id sampling for the workload generator,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sampler.py::traffic_ids (the
// pl.pallas_call at sampler.py:159, body traffic_body at :90).
//
// Record i of a block draws its uniforms from the counters lanes[i] + s,
// s = 0..7, with lanes[i] = ctr0 + 8 i in uint32 (wrapping), through the
// lowbias32 counter PRNG keyed by the seed, and produces
//   uid     = zipf_rank(u0, n_users, a_user)
//   tag     = u2 < burst_frac ? (topic_base + int(u1 * burst_ntags)) % n_tags
//                             : zipf_rank(u1, n_tags, a_tag)
//   mention = (u3 < copy_frac && i > 0) ? uid[int(u4 * i)]
//                                       : zipf_rank(u5, n_users, a_mention)
//   u_dup = u6, u_dupi = u7,
// where zipf_rank(u, n, a) = clamp(int((1 + u top)^inv) - 1, 0, n - 1)
// with top = (n + 1)^(1 - a) - 1 and inv = 1 / (1 - a).  The cascade copy
// reads another record's uid.  Instead of a grid-wide barrier the thread
// recomputes that uid itself: a uid is a pure function of its record's
// counter.
//
// What bounds it on this card: latency.  It reads 36 bytes of parameters
// and writes 5 x 4 bytes a record, 40 KB for the paths' 2,048-record
// block (about 12 ns at 3.35 TB/s).  Past the launch, the time is one
// chain: the parameters' round trip, then two powf (a rank's top, then
// its x).  The library powf branches (on special values), so one thread
// runs its powf one after another, not side by side.  The design keeps
// every thread on that one chain:
//   * A rank a thread.  The grid is ctas x 3 CTAs: CTA (c, r) computes
//     rank r (0 uid and the spare uniforms, 1 tag, 2 mention) of its
//     records, so a record's three data-dependent powf run on three
//     threads at once, each thread's the same code with no branch on
//     data.  The tag's rank is then selected against the hot tag; the
//     mention's rank takes selected operands, the copied record's
//     uniform with the user's constants or u5 with the mention's (both
//     ranks are over n_users).  The selection changes which operands
//     enter, never the arithmetic.
//   * Block constants once.  top and inv depend only on the block's
//     parameters.  Warp 0 loads the parameters, once a CTA; three of its
//     lanes compute the user's, the tag's and the mention's constants
//     with the plain version's operations and put them in shared memory
//     with the other parameters; one barrier.  (Every thread computing
//     its rank's and the user's constants side by side, with no barrier,
//     tied up to 8,192 records and lost above: PERF.md §6.)
//   * A thread's four counter hashes (its rank's two streams, u4 and the
//     copied record's u0 or u7) come before the barrier, while warp 0
//     waits for the parameters.
//   * The grid comes from the host (kernels/sampler.py::launch_plan):
//     CTA (c, r)'s thread t takes records c T R + k T + t, k < R, for T
//     threads and R records a thread.
//
// Bit-equality with the plain PyTorch version: every float32 operation
// of the plain version is one rounded PyTorch op, so the kernel writes
// each one with an _rn intrinsic, which nvcc never contracts into a
// fused multiply-add; `pow` is the library powf, which PyTorch's
// float32 pow(tensor, tensor) also calls on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxRecords = 4;
constexpr uint32_t kStreams = 8;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// key = fmix32(seed), computed once on the host
__device__ __forceinline__ float uniform(uint32_t key, uint32_t ctr) {
  const uint32_t bits = fmix32(fmix32(ctr + key) ^ key);
  return __fmul_rn(__uint2float_rn(bits >> 8), 1.0f / 16777216.0f);
}

// A Zipf rank's block constants, op for op the plain version's zipf_rank.
__device__ __forceinline__ void zipf_constants(int n, float a, float& top, float& inv) {
  const float one_m_a = __fsub_rn(1.0f, a);
  top = __fsub_rn(powf(__fadd_rn(__int2float_rn(n), 1.0f), one_m_a), 1.0f);
  inv = __fdiv_rn(1.0f, one_m_a);
}

__device__ __forceinline__ int zipf_rank(float u, float top, float inv, int n) {
  const float x = powf(__fadd_rn(1.0f, __fmul_rn(u, top)), inv);
  return min(max(static_cast<int>(x) - 1, 0), n - 1);
}

// The block's parameters and the three ranks' constants.
struct Block {
  float top[3], inv[3];
  int n_users, n_tags, burst_ntags, topic_base;
  float burst_frac, copy_frac;
};

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
traffic_ids_kernel(uint32_t key, uint32_t ctr0, int n, const int* __restrict__ iparams,
                   const float* __restrict__ fparams, int* __restrict__ uid,
                   int* __restrict__ tag, int* __restrict__ mention,
                   float* __restrict__ u_dup, float* __restrict__ u_dupi) {
  const int T = blockDim.x;
  const int rank = blockIdx.y;
  const int first = blockIdx.x * T * R + threadIdx.x;
  __shared__ Block blk;
  // warp 0 starts the parameter loads first: lane k < 4 holds iparams[k],
  // lane k < 5 fparams[k]; their round trip overlaps the hashing below
  const int lane = threadIdx.x;
  int ip = 0;
  float fp = 0.0f;
  if (threadIdx.x < 32) {
    ip = iparams[min(lane, 3)];
    fp = fparams[min(lane, 4)];
  }

  // The counter hashes, before the powf.  Streams: rank 0 takes u0 and
  // the spare u6, u7; rank 1 u1 and the hot-tag draw u2; rank 2 u5, the
  // cascade draw u3 and, through u4, the copied record's u0.
  const uint32_t s_a = rank == 0 ? 0 : rank == 1 ? 1 : 5;
  const uint32_t s_b = rank == 0 ? 6 : rank == 1 ? 2 : 3;
  float ua[R], ub[R], uc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = first + k * T;
    const uint32_t lanes = ctr0 + static_cast<uint32_t>(i) * kStreams;
    ua[k] = uniform(key, lanes + s_a);
    ub[k] = uniform(key, lanes + s_b);
    const int j = static_cast<int>(__fmul_rn(uniform(key, lanes + 4), __int2float_rn(i)));
    uc[k] = uniform(key, rank == 2 ? ctr0 + static_cast<uint32_t>(j) * kStreams : lanes + 7);
  }

  if (threadIdx.x < 32) {  // warp-uniform: every CTA has whole warps
    // rank k's n: n_tags for the tag (k = 1), n_users for the others
    const int n_k = __shfl_sync(kFullWarp, ip, lane == 1 ? 1 : 0);
    if (lane < 3) zipf_constants(n_k, fp, blk.top[lane], blk.inv[lane]);
    if (lane == 0) blk.n_users = ip;
    if (lane == 1) blk.n_tags = ip;
    if (lane == 2) blk.burst_ntags = ip;
    if (lane == 3) {
      blk.topic_base = ip;
      blk.burst_frac = fp;
    }
    if (lane == 4) blk.copy_frac = fp;
  }
  __syncthreads();
  const Block& b = blk;
  const float top_own = b.top[rank], inv_own = b.inv[rank];
  const float top_user = b.top[0], inv_user = b.inv[0];

  const int n_rank = rank == 1 ? b.n_tags : b.n_users;
  const float ntags_hot = __int2float_rn(b.burst_ntags);
  int* const out = rank == 0 ? uid : rank == 1 ? tag : mention;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = first + k * T;
    // the mention copies an earlier record's uid: that record's u0 with
    // the user's constants (both ranks are over n_users)
    const bool copy = (rank == 2) & (ub[k] < b.copy_frac) & (i > 0);
    const int r = zipf_rank(copy ? uc[k] : ua[k], copy ? top_user : top_own,
                            copy ? inv_user : inv_own, n_rank);
    // the hot tag: int32 add (wrapping) and a remainder with the
    // divisor's sign, as PyTorch's % on int32
    const int h = static_cast<int>(__fmul_rn(ua[k], ntags_hot));
    int hot = static_cast<int>(static_cast<uint32_t>(b.topic_base) + static_cast<uint32_t>(h)) %
              b.n_tags;
    hot += (hot != 0 && ((hot ^ b.n_tags) < 0)) ? b.n_tags : 0;
    if (i < n) {
      out[i] = (rank == 1) & (ub[k] < b.burst_frac) ? hot : r;
      if (rank == 0) {
        u_dup[i] = ub[k];
        u_dupi[i] = uc[k];
      }
    }
  }
}

using Kernel = void (*)(uint32_t, uint32_t, int, const int*, const float*, int*, int*, int*,
                       float*, float*);
const Kernel kKernels[kMaxRecords] = {traffic_ids_kernel<1>, traffic_ids_kernel<2>,
                                      traffic_ids_kernel<3>, traffic_ids_kernel<4>};

}  // namespace

// Launches one block of n records on `stream` as ctas x 3 CTAs (one a
// rank) of `threads` threads, `records` records a thread; allocates
// nothing.  Returns the cudaError_t of the launch (0 = success), and
// cudaErrorInvalidValue without launching for a plan the kernel does
// not run: n < 1, threads not a multiple of 32 in [32, 256], records
// outside [1, 4], fewer than n records in the grid, or a CTA that holds
// none of them (so every record index fits an int).
extern "C" int traffic_ids_launch(uint32_t seed, uint32_t ctr0, int n, const void* iparams,
                                  const void* fparams, void* uid, void* tag, void* mention,
                                  void* u_dup, void* u_dupi, int ctas, int threads,
                                  int records, void* stream) {
  if (n < 1 || ctas < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      records < 1 || records > kMaxRecords ||
      static_cast<int64_t>(ctas) * threads * records < n ||
      static_cast<int64_t>(ctas - 1) * threads * records >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t key = fmix32(seed);
  const Kernel kernel = kKernels[records - 1];
  kernel<<<dim3(ctas, 3), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      key, ctr0, n, static_cast<const int*>(iparams), static_cast<const float*>(fparams),
      static_cast<int*>(uid), static_cast<int*>(tag), static_cast<int*>(mention),
      static_cast<float*>(u_dup), static_cast<float*>(u_dupi));
  return static_cast<int>(cudaGetLastError());
}
