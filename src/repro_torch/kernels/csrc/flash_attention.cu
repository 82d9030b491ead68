// Blocked (flash) attention forward with grouped-query heads, causal and
// sliding-window masks, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (the pl.pallas_call at flash_attention.py:96, body _flash_kernel at :24).
//
// What it computes, as _flash_kernel does: for query row i of head j,
//   s_ik = (q_i . k_k) * (1/sqrt(d))   from q and k read as float32,
//   s_ik = -1e30 where the causal (i >= k) or window (i - k < window)
//          mask is false,
// an online softmax over the keys with running max m (from -1e30), sum l
// and accumulator acc in float32, and o_i = acc / max(l, 1e-30) written in
// q's dtype (float32 or bfloat16).  As there, a row whose first keys are
// all masked sums them with weight 1 until a real key arrives, whose
// rescale exp(-1e30 - m) = 0 wipes them.
//
// Layout.  q, o are (B, S, n, d) and k, v (B, S, m, d) read in place
// through their strides (batch, head, position; the head width is
// contiguous), so the model's (B, S, n, d) projections need no permute.
// Query head j reads kv head j / (n / m): grouped-query attention without
// a copy of k and v per query head.
//
// Design.  One CTA per (64-row query tile, query head, batch).  Each row
// is owned by TPR = d/32 threads (1 for d <= 32), each holding 32 (or d)
// of the row's columns of q and of the float32 accumulator in registers,
// in float4 groups; a score is their partial dot products summed with
// warp shuffles.  K and V tiles of 32 keys are staged in shared memory as
// float32 (32 KB at d = 128), and every row of a warp reads the same key,
// so the reads broadcast.  The online softmax steps over 16 keys at a
// time: 16 scores in registers, one rescale of acc per step.  Key tiles
// that the mask hides from every row of the query tile (above the causal
// diagonal, or before the first row's window) are skipped: in the
// reference they add exactly nothing (after a real key, p = exp(-1e30 -
// m) = 0) or are wiped exactly (before one).  No tensor cores yet.
//
// What bounds it on this card: operations.  A causal prefill at the
// serving path's shape (16 heads, 16,384 positions, d = 128) does 4·d
// flops per unmasked (query, key) pair, 1.1e12 a launch, against 0.27 GB
// of q, k, v and o; this kernel runs them on the float32 FMA units (67
// TFLOP/s) with two shared-memory reads per four FMAs.  wgmma on bf16
// tiles (989 TFLOP/s) is the later work that moves it toward its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;  // query rows per CTA
constexpr int kKeys = 32;  // keys per shared-memory tile
constexpr int kSub = 16;   // keys per online-softmax step
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D > 32 ? D / 32 : 1))
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int group, int seq,
                       long long qsb, long long qsh, long long qss, long long ksb,
                       long long ksh, long long kss, long long vsb, long long vsh,
                       long long vss, long long osb, long long osh, long long oss,
                       int causal, int window, float scale) {
  constexpr int CPT = D > 32 ? 32 : D;  // columns per thread
  constexpr int TPR = D / CPT;          // threads per row
  constexpr int kThreads = kRows * TPR;
  constexpr int C4 = CPT / 4;           // float4 groups per thread

  __shared__ __align__(16) float ks[kKeys][D];
  __shared__ __align__(16) float vs[kKeys][D];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int t = tid - row * TPR;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int qpos = q0 + row;
  const bool row_ok = qpos < seq;

  const T* qp = q + b * qsb + head * qsh + static_cast<long long>(row_ok ? qpos : 0) * qss;
  const T* kp = k + b * ksb + (head / group) * ksh;
  const T* vp = v + b * vsb + (head / group) * vsh;

  float qr[CPT], acc[CPT];
#pragma unroll
  for (int c4 = 0; c4 < C4; ++c4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[c4 * 4 + e] = load_f(qp + (c4 * TPR + t) * 4 + e);
      acc[c4 * 4 + e] = 0.f;
    }
  }
  float m = kMasked, l = 0.f;

  // key tiles some row of this query tile can see
  int kv_lo = 0, kv_hi = seq;
  if (causal) kv_hi = min(seq, q0 + kRows);
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / kKeys) * kKeys;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kKeys * D; e += kThreads) {
      const int j = e / D, c = e - (e / D) * D;
      const int pos = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (pos < seq) {
        kv = load_f(kp + pos * kss + c);
        vv = load_f(vp + pos * vss + c);
      }
      ks[j][c] = kv;
      vs[j][c] = vv;
    }
    __syncthreads();

#pragma unroll
    for (int j0 = 0; j0 < kKeys; j0 += kSub) {
      float s[kSub];
      float smax = -INFINITY;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const float4* kr = reinterpret_cast<const float4*>(&ks[j0 + u][0]);
        float dot = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < C4; ++c4) {
          const float4 kk = kr[c4 * TPR + t];
          dot += qr[c4 * 4] * kk.x;
          dot += qr[c4 * 4 + 1] * kk.y;
          dot += qr[c4 * 4 + 2] * kk.z;
          dot += qr[c4 * 4 + 3] * kk.w;
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off /= 2) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        const int pos = k0 + j0 + u;
        float sv = dot * scale;
        if ((causal && qpos < pos) || (window > 0 && qpos - pos >= window)) sv = kMasked;
        if (pos >= seq) sv = -INFINITY;  // past the sequence: weight exactly 0
        s[u] = sv;
        smax = fmaxf(smax, sv);
      }
      const float m_new = fmaxf(m, smax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] *= alpha;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const float p = expf(s[u] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(&vs[j0 + u][0]);
#pragma unroll
        for (int c4 = 0; c4 < C4; ++c4) {
          const float4 vv = vr[c4 * TPR + t];
          acc[c4 * 4] += p * vv.x;
          acc[c4 * 4 + 1] += p * vv.y;
          acc[c4 * 4 + 2] += p * vv.z;
          acc[c4 * 4 + 3] += p * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    T* op = o + b * osb + head * osh + static_cast<long long>(qpos) * oss;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c4 = 0; c4 < C4; ++c4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        store_f(op + (c4 * TPR + t) * 4 + e, acc[c4 * 4 + e] / den);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch,
                   int heads, int group, int seq, const long long* st, int causal,
                   int window, cudaStream_t stream) {
  constexpr int kThreads = kRows * (D > 32 ? D / 32 : 1);
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  flash_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), group, seq, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], causal, window,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* o, int batch,
                     int heads, int group, int seq, const long long* st, int causal,
                     int window, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, batch, heads, group, seq, st, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, batch, heads, group, seq, st, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, batch, heads, group, seq, st, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, batch, heads, group, seq, st, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the forward pass on `stream`; allocates nothing.  Strides are
// in elements, (batch, head, position) for each of q, k, v and o; window
// <= 0 means none; bf16 != 0 reads and writes bfloat16, else float32.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int heads,
    int kv_heads, int seq, int head_dim, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, int causal, int window, int bf16,
    void* stream) {
  if (batch <= 0 || seq <= 0 || kv_heads <= 0 || heads % kv_heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  const int group = heads / kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(head_dim, q, k, v, o, batch, heads, group, seq, st,
                                     causal, window, s)
           : dispatch<float>(head_dim, q, k, v, o, batch, heads, group, seq, st, causal,
                             window, s);
  return static_cast<int>(err);
}
