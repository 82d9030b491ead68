// Mamba2 SSD chunked scan forward (y and the final state), hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (the
// pl.pallas_call at ssd_scan.py:82, body _ssd_kernel at :25).
//
// What it computes, as _ssd_kernel does, for each (batch row, head), chunk
// by chunk of Q positions, from a zero state h (N x p, float32):
//   seg     = cumsum(dt * A)                  within the chunk
//   y_intra = ((C B^T) o L) x,  L[i,j] = exp(seg_i - seg_j) dt_j for j <= i,
//                               0 above the diagonal (masked before exp)
//   y_inter = exp(seg) o (C h)
//   h       = exp(total) h + B^T (w o x),  w = exp(total - seg) dt,
//             total = seg[Q-1]
// y = y_intra + y_inter in x's dtype (float32 or bfloat16); the last h is
// written out in float32.
//
// Precision.  seg runs to about -150 over a 256-step chunk at the serving
// path's step sizes, where one float32 ulp is 1.5e-5: a difference of two
// float32 prefix sums, seg_i - seg_j, keeps only the digits of its
// operands, and every implementation's rounding of the prefix sums (a
// running sum here, a triangular matmul in the TPU kernel, a scan in
// torch.cumsum) then shows in L and y at 1e-4 and more.  So the products
// dt*A are rounded to float32 as the reference rounds them, summed in
// float64, and each difference (seg_i - seg_j, total - seg_j) is taken in
// float64 before it is rounded to float32 for exp; the plain version does
// the same, so the two agree within 1e-4 at the path's shape.  Dot
// products run over four partial sums.
//
// Layout.  The Mamba2 block's own: x and y (B, S, nh, p), dt (B, S, nh),
// A per (batch, head) through two strides (0 where shared), and B/C
// (B, S, N) shared by every head (ngroups = 1), all read in place through
// strides, so nothing is copied per head.  The wrapper's (BH, S, *)
// signature is the case nh = 1.
//
// Design.  One CTA of 256 threads per (head, batch row), looping over
// the chunks in order: the carried state is the loop's dependency, as it
// was the TPU grid's sequential axis.  The state (32 KB at N = 128,
// p = 64) stays in shared memory for the whole scan.  A Q x Q block of
// C B^T or L would not fit (256 KB at Q = 256), so the intra-chunk product
// is tiled by 32 query rows against 32-key blocks: C and B row blocks
// (padded to N + 1 floats, so a warp's 32 different rows fall in 32
// banks), an x block, and the 32 x 32 block of (C B^T) o L in shared
// memory.  Each thread owns fixed (row, column) entries of y and of the
// state, so no two threads write one word.  About 82 KB of dynamic shared
// memory a block at the serving path's shape: two blocks an SM.
//
// What bounds it on this card: operations.  (N + p) Q (Q + 1) flops a
// chunk for the intra product's causal pairs (j <= i) and 4QNp for the
// state's two products, on float32 FMA units (67 TFLOP/s): 6.5e10 a launch
// at the path's shape (4 x 48 heads, 4,096 positions, N = 128, p = 64,
// Q = 256), against about 0.3 GB moved.  With one CTA per (head, batch row) the launch has
// 192 CTAs, under two per SM; splitting the state's columns over CTAs, or
// the chunks over a parallel pass and a short sequential one, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;  // devices whose shared-memory opt-in is tracked
constexpr int kThreads = 256;
constexpr int kRows = 32;    // query rows and keys per block of the intra product
constexpr int kMaxY = 16;    // y entries per thread: kRows * p / kThreads, p <= 128

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// a . b over n terms, in four partial sums
__device__ __forceinline__ float dot4(const float* a, int sa, const float* b, int sb, int n) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int k = 0;
  for (; k + 3 < n; k += 4) {
    s0 += a[k * sa] * b[k * sb];
    s1 += a[(k + 1) * sa] * b[(k + 1) * sb];
    s2 += a[(k + 2) * sa] * b[(k + 2) * sb];
    s3 += a[(k + 3) * sa] * b[(k + 3) * sb];
  }
  for (; k < n; ++k) s0 += a[k * sa] * b[k * sb];
  return (s0 + s1) + (s2 + s3);
}

struct Strides {
  long long xb, xs, xh, db, ds, dh, ab, ah, bb, bs, cb, cs, yb, ys, yh;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, T* __restrict__ y, float* __restrict__ state,
                int heads, int seq, int P, int N, int Q, Strides st) {
  extern __shared__ __align__(16) double smem_d[];
  const int NP = N + 1;  // padded row of a B or C block
  double* seg = smem_d;                // Q       prefix sums of dt*A, float64
  float* hs = reinterpret_cast<float*>(seg + Q);  // N x P   carried state
  float* cblk = hs + N * P;            // kRows x NP
  float* bblk = cblk + kRows * NP;     // kRows x NP
  float* xblk = bblk + kRows * NP;     // kRows x P
  float* gl = xblk + kRows * P;        // kRows x (kRows + 1)
  float* dts = gl + kRows * (kRows + 1);  // Q
  float* w = dts + Q;                  // Q

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a = A[b * st.ab + h * st.ah];
  const T* xp = x + b * st.xb + h * st.xh;
  const float* dtp = dt + b * st.db + h * st.dh;
  const float* bp = Bm + b * st.bb;
  const float* cp = Cm + b * st.cb;
  T* yp = y + b * st.yb + h * st.yh;

  for (int e = tid; e < N * P; e += kThreads) hs[e] = 0.f;

  for (int c0 = 0; c0 < seq; c0 += Q) {
    for (int i = tid; i < Q; i += kThreads) dts[i] = dtp[(c0 + i) * st.ds];
    __syncthreads();
    if (tid == 0) {
      double run = 0.0;
      for (int i = 0; i < Q; ++i) {
        run += static_cast<double>(__fmul_rn(dts[i], a));
        seg[i] = run;
      }
    }
    __syncthreads();
    const double total = seg[Q - 1];
    for (int i = tid; i < Q; i += kThreads) {
      w[i] = expf(static_cast<float>(total - seg[i])) * dts[i];
    }

    // ---- y for this chunk, 32 query rows at a time, from the old state ----
    for (int i0 = 0; i0 < Q; i0 += kRows) {
      const int rows = min(kRows, Q - i0);
      __syncthreads();  // previous users of cblk are done
      for (int e = tid; e < kRows * N; e += kThreads) {
        const int i = e / N, n = e - (e / N) * N;
        cblk[i * NP + n] = i < rows ? cp[(c0 + i0 + i) * st.cs + n] : 0.f;
      }
      __syncthreads();

      float yi[kMaxY], ye[kMaxY];
#pragma unroll
      for (int u = 0; u < kMaxY; ++u) {
        yi[u] = 0.f;
        ye[u] = 0.f;
        const int e = tid + u * kThreads;
        if (e < kRows * P) {
          const int i = e / P, c = e - (e / P) * P;
          const float dot = dot4(cblk + i * NP, 1, hs + c, P, N);
          ye[u] = i < rows ? expf(static_cast<float>(seg[i0 + i])) * dot : 0.f;
        }
      }

      for (int j0 = 0; j0 <= i0; j0 += kRows) {
        const int jrows = min(kRows, Q - j0);
        __syncthreads();  // previous users of bblk, xblk and gl are done
        for (int e = tid; e < kRows * N; e += kThreads) {
          const int j = e / N, n = e - (e / N) * N;
          bblk[j * NP + n] = j < jrows ? bp[(c0 + j0 + j) * st.bs + n] : 0.f;
        }
        for (int e = tid; e < kRows * P; e += kThreads) {
          const int j = e / P, c = e - (e / P) * P;
          xblk[e] = j < jrows ? load_f(xp + (c0 + j0 + j) * st.xs + c) : 0.f;
        }
        __syncthreads();
        for (int e = tid; e < kRows * kRows; e += kThreads) {
          const int i = e / kRows, j = e - (e / kRows) * kRows;
          const int gi = i0 + i, gj = j0 + j;
          float v = 0.f;
          if (i < rows && j < jrows && gj <= gi) {
            const float g = dot4(cblk + i * NP, 1, bblk + j * NP, 1, N);
            v = g * (expf(static_cast<float>(seg[gi] - seg[gj])) * dts[gj]);
          }
          gl[i * (kRows + 1) + j] = v;
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kMaxY; ++u) {
          const int e = tid + u * kThreads;
          if (e < kRows * P) {
            const int i = e / P, c = e - (e / P) * P;
            yi[u] += dot4(gl + i * (kRows + 1), 1, xblk + c, P, kRows);
          }
        }
      }

#pragma unroll
      for (int u = 0; u < kMaxY; ++u) {
        const int e = tid + u * kThreads;
        if (e < kRows * P) {
          const int i = e / P, c = e - (e / P) * P;
          if (i < rows) store_f(yp + (c0 + i0 + i) * st.ys + c, yi[u] + ye[u]);
        }
      }
    }

    // ---- state: h = exp(total) h + B^T (w o x) ----
    __syncthreads();  // every y of this chunk has read the old state
    const float decay = expf(static_cast<float>(total));
    for (int e = tid; e < N * P; e += kThreads) hs[e] *= decay;
    for (int j0 = 0; j0 < Q; j0 += kRows) {
      const int jrows = min(kRows, Q - j0);
      __syncthreads();
      for (int e = tid; e < kRows * N; e += kThreads) {
        const int j = e / N, n = e - (e / N) * N;
        bblk[j * NP + n] = j < jrows ? bp[(c0 + j0 + j) * st.bs + n] : 0.f;
      }
      for (int e = tid; e < kRows * P; e += kThreads) {
        const int j = e / P, c = e - (e / P) * P;
        xblk[e] = j < jrows ? w[j0 + j] * load_f(xp + (c0 + j0 + j) * st.xs + c) : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < N * P; e += kThreads) {
        const int n = e / P, c = e - (e / P) * P;
        hs[e] += dot4(bblk + n, NP, xblk + c, P, jrows);
      }
    }
    __syncthreads();
  }

  float* sp = state + (static_cast<long long>(b) * heads + h) * N * P;
  for (int e = tid; e < N * P; e += kThreads) sp[e] = hs[e];
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* state, int batch, int heads, int seq, int P,
                   int N, int Q, const Strides& st, cudaStream_t stream) {
  const size_t smem = sizeof(double) * Q +
                      sizeof(float) * (static_cast<size_t>(N) * P + 2 * kRows * (N + 1) +
                                       kRows * P + kRows * (kRows + 1) + 2 * Q);
  // The opt-in above 48 KB of dynamic shared memory is an attribute of
  // the kernel on each device: set it to the device's most on the first
  // launch there only.  A larger block's launch then fails with its error.
  static std::atomic<bool> smem_opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_opted_in[device].load(std::memory_order_acquire)) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err != cudaSuccess) return err;
    smem_opted_in[device].store(true, std::memory_order_release);
  }
  ssd_scan_kernel<T><<<dim3(heads, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), heads, seq, P, N, Q, st);
  return cudaGetLastError();
}

}  // namespace

// Launches the scan on `stream`; allocates nothing.  Strides are in
// elements: x, dt and y by (batch, position, head), A by (batch, head),
// B and C by (batch, position); the last dimension of x, y, B and C is
// contiguous.  seq must be a multiple of chunk, and head_dim at most 128.
// bf16 != 0 reads x and writes y as bfloat16, else float32.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, void* state, int batch, int heads,
                               int seq, int head_dim, int n_state, int chunk, long long xb,
                               long long xs, long long xh, long long db, long long ds,
                               long long dh, long long ab, long long ah, long long bb,
                               long long bs, long long cb, long long cs, long long yb,
                               long long ys, long long yh, int bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || chunk <= 0 || seq % chunk || head_dim <= 0 ||
      head_dim > kMaxY * kThreads / kRows || n_state <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{xb, xs, xh, db, ds, dh, ab, ah, bb, bs, cb, cs, yb, ys, yh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, batch, heads, seq, head_dim,
                                   n_state, chunk, st, s)
           : launch<float>(x, dt, A, Bm, Cm, y, state, batch, heads, seq, head_dim, n_state,
                           chunk, st, s);
  return static_cast<int>(err);
}
