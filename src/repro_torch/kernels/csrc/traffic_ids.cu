// Counter-based traffic-id sampling for the workload generator,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sampler.py::traffic_ids (the
// pl.pallas_call at sampler.py:159, body traffic_body at :90).
//
// One thread per record.  Record i of a block draws its uniforms from
// the counters lanes[i] + s, s = 0..7, with lanes[i] = ctr0 + 8 i in
// uint32 (wrapping), through the lowbias32 counter PRNG keyed by the
// seed, and produces
//   uid     = zipf_rank(u0, n_users, a_user)
//   tag     = u2 < burst_frac ? (topic_base + int(u1 * burst_ntags)) % n_tags
//                             : zipf_rank(u1, n_tags, a_tag)
//   mention = (u3 < copy_frac && i > 0) ? uid[int(u4 * i)]
//                                       : zipf_rank(u5, n_users, a_mention)
//   u_dup = u6, u_dupi = u7.
// The cascade copy reads another record's uid.  Instead of a grid-wide
// barrier the thread recomputes that uid itself: a uid is a pure
// function of its record's counter.
//
// Bit-equality with the plain PyTorch version: every float32 operation
// of the plain version is one rounded PyTorch op, so the kernel writes
// each one with an _rn intrinsic, which nvcc never contracts into a
// fused multiply-add; `pow` is the library powf, which PyTorch's
// float32 pow(tensor, tensor) also calls on the card.
//
// What bounds it on this card: bytes.  It reads nothing but 36 bytes of
// parameters and writes 5 x 4 bytes per record: 40 KB for the path's
// 2,048-record block, about 12 ns at 3.35 TB/s.  The launch takes
// microseconds, which the design accepts: the workload source launches
// it once per tick.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kStreams = 8;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform(uint32_t key, uint32_t ctr) {
  const uint32_t bits = fmix32(fmix32(ctr + key) ^ key);
  return __fmul_rn(__uint2float_rn(bits >> 8), 1.0f / 16777216.0f);
}

// Zipf(a) rank in [0, n) by the bounded-Pareto inverse CDF; op for op
// the plain version's zipf_rank.
__device__ __forceinline__ int zipf_rank(float u, int n, float a) {
  const float one_m_a = __fsub_rn(1.0f, a);
  const float top = __fsub_rn(powf(__fadd_rn(static_cast<float>(n), 1.0f), one_m_a), 1.0f);
  const float x = powf(__fadd_rn(1.0f, __fmul_rn(u, top)), __fdiv_rn(1.0f, one_m_a));
  const int r = static_cast<int>(x) - 1;
  return min(max(r, 0), n - 1);
}

__global__ void __launch_bounds__(kThreads)
traffic_ids_kernel(uint32_t seed, uint32_t ctr0, int n, const int* __restrict__ iparams,
                   const float* __restrict__ fparams, int* __restrict__ uid,
                   int* __restrict__ tag, int* __restrict__ mention,
                   float* __restrict__ u_dup, float* __restrict__ u_dupi) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int n_users = iparams[0], n_tags = iparams[1];
  const int burst_ntags = iparams[2], topic_base = iparams[3];
  const float a_user = fparams[0], a_tag = fparams[1], a_mention = fparams[2];
  const float burst_frac = fparams[3], copy_frac = fparams[4];
  const uint32_t key = fmix32(seed);
  const uint32_t lane = ctr0 + static_cast<uint32_t>(i) * kStreams;

  const float u_tag = uniform(key, lane + 1), u_mix = uniform(key, lane + 2);
  const float u_cas = uniform(key, lane + 3), u_src = uniform(key, lane + 4);
  const float u_men = uniform(key, lane + 5);
  const int my_uid = zipf_rank(uniform(key, lane), n_users, a_user);

  int t;
  if (u_mix < burst_frac) {
    const int h = static_cast<int>(__fmul_rn(u_tag, static_cast<float>(burst_ntags)));
    t = (topic_base + h) % n_tags;
    if (t < 0) t += n_tags;  // the remainder takes the divisor's sign, as in PyTorch
  } else {
    t = zipf_rank(u_tag, n_tags, a_tag);
  }

  int m;
  if (u_cas < copy_frac && i > 0) {
    const int j = static_cast<int>(__fmul_rn(u_src, static_cast<float>(i)));
    m = zipf_rank(uniform(key, ctr0 + static_cast<uint32_t>(j) * kStreams), n_users, a_user);
  } else {
    m = zipf_rank(u_men, n_users, a_mention);
  }

  uid[i] = my_uid;
  tag[i] = t;
  mention[i] = m;
  u_dup[i] = uniform(key, lane + 6);
  u_dupi[i] = uniform(key, lane + 7);
}

}  // namespace

// Launches one block of n records on `stream`; allocates nothing.
// Returns the cudaError_t of the launch (0 = success).  n must be > 0.
extern "C" int traffic_ids_launch(uint32_t seed, uint32_t ctr0, int n, const void* iparams,
                                  const void* fparams, void* uid, void* tag, void* mention,
                                  void* u_dup, void* u_dupi, void* stream) {
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  traffic_ids_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, ctr0, n, static_cast<const int*>(iparams), static_cast<const float*>(fparams),
      static_cast<int*>(uid), static_cast<int*>(tag), static_cast<int*>(mention),
      static_cast<float*>(u_dup), static_cast<float*>(u_dupi));
  return static_cast<int>(cudaGetLastError());
}
