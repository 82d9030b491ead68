// Mamba2 SSD chunked scan forward (y and the final state), hand-written
// for Hopper (sm_90a) in the SSD's chunk-parallel form.
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
// operands, and every implementation's rounding of the prefix sums then
// shows in L and y at 1e-4 and more (the TPU kernel's float32 sums miss
// the sequential definition by up to 2.9 times 1e-4 at Q = 256).  So the
// products dt*A are rounded to float32 as the reference rounds them,
// summed in float64, and each difference (seg_i - seg_j, total - seg_j)
// is taken in float64 before it is rounded to float32 for exp; the plain
// version does the same.  Every product is float32 FMA: no tensor core.
//
// Layout.  The Mamba2 block's own: x and y (B, S, nh, p), dt (B, S, nh),
// A per (batch, head) through two strides (0 where shared), and B/C
// (B, S, N) shared by every head (ngroups = 1), all read in place through
// strides, so nothing is copied per head.  The wrapper's (BH, S, *)
// signature is the case nh = 1.
//
// Design.  The carried state is the scan's only sequential dependency, so
// one call runs three kernels on the caller's stream:
//   1. ssd_scan_chunk_kernel, a CTA per (batch row, chunk, head): seg by a
//      block-wide float64 scan (kept in a float64 scratch for 2 and 3),
//      then the chunk's own state S_c = B^T (w o x), an (N x Q)(Q x p)
//      product, into a float32 scratch of (B, nc, nh, N, p).
//   2. ssd_scan_state_kernel, a thread per state element: the recurrence
//      h_c = exp(total_c) h_{c-1} + S_c over the nc chunks, leaving the
//      state before each chunk in place of S_c, and the final state.
//   3. ssd_scan_output_kernel, a CTA of two 256-thread halves per (64-row
//      query tile, chunk, batch row, group of heads): G = C B^T over the
//      tile's keys, once for the group (every head at the serving path's
//      shape, so once per batch row and chunk), kept in shared memory
//      (64 KB at Q = 256); then each half takes every other head of the
//      group: y = exp(seg) o (C h_prev) + (G o L) x, with (G o L)^T built
//      in shared memory 32 keys at a time.  On the diagonal tile a warp
//      stops at its last query row's key.
// Both products run as register tiles: each thread owns a 4 x 4 (or, for
// S_c, 8 x 4) block of outputs and reads one float4 of each operand from
// shared memory per step of the contraction, 16 (32) FMAs per two (three)
// 16-byte loads; a warp's threads are laid out 4 x 8 so that each load is
// one shared-memory wavefront.  Operand tiles are stored k-major with rows
// padded to 68 floats, so the transposed loads of C and B (eight state
// columns by four rows a warp) land in 32 banks.  Operands arrive by
// cp.async into a two-stage ring, the next step's while this one
// computes.  At the serving path's shape (4 x 4,096 positions, 48 heads,
// p 64, N 128, Q 256) the chunk pass runs 3,072 CTAs where the old kernel
// ran 192, the state pass 1.57 M threads, and the output pass 256 CTAs
// (4 query tiles x 16 chunks x 4 rows) of 16 warps, longest tiles first.
//
// What bounds it on this card: operations.  With C B^T counted once per
// (batch row, chunk), N Q (Q + 1) flops over the causal pairs, and the
// per-head products at p Q (Q + 1) + 4 Q N p, the path's call is 3.92e10
// flops, 0.586 ms at the float32 FMA peak (67 TFLOP/s), against 0.43 GB
// of inputs and outputs (0.13 ms at 3.35 TB/s) and 0.2 GB through the
// state scratch.  The design computes 2% more (G over whole 64-key
// tiles, (G o L) x over 16-row steps of the diagonal).  The FMA rate is
// not what holds it under that peak: the same passes with their products
// as 3xTF32 on the tensor cores (mma.sync, a fresh fragment per 8-deep
// step, without which a running sum loses 1e-4) ran no faster, and a
// third ring stage moved it little.  The output pass's staging, barriers
// and uneven query tiles are where the time goes next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kMaxDevices = 64;  // devices whose shared-memory opt-in is tracked
constexpr int kThreads = 256;    // 8 warps, a 16 x 16 grid: a CTA, or half an output CTA
constexpr int kT = 64;           // query rows, keys, state rows and columns of a tile
constexpr int kLd = kT + 4;      // padded row of a 64-wide tile, 16-byte aligned
constexpr int kMaxN = 128;       // state width N
constexpr int kMaxQ = 256;       // chunk Q (the output pass keeps kMaxQ rows of G)
constexpr int kKc = 32;          // positions a step of the chunk pass

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  long long xb, xs, xh, db, ds, dh, ab, ah, bb, bs, cb, cs, yb, ys, yh;
};

// The place of thread t (of 256) in a 16 x 16 grid: a warp covers 4 rows
// (ty) by 8 columns (tx), so its float4 operand loads read 64 and 128
// contiguous bytes of shared memory.
__device__ __forceinline__ int tile_x(int t) { return ((t >> 5) & 1) << 3 | (t & 7); }
__device__ __forceinline__ int tile_y(int t) { return (t >> 6) << 2 | ((t >> 3) & 3); }

// acc[r][c] += sum_{k < K} a[k * lda + r] * b[k * ldb + c], r < R, c < 4:
// a and b are k-major tiles in shared memory, a 16-byte aligned at this
// thread's first row and b at its first column.
template <int R>
__device__ __forceinline__ void mma_tile(float (&acc)[R][4], const float* a, int lda,
                                         const float* b, int ldb, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float ar[R];
#pragma unroll
    for (int q = 0; q < R; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(a + k * lda + q);
      ar[q] = v.x;
      ar[q + 1] = v.y;
      ar[q + 2] = v.z;
      ar[q + 3] = v.w;
    }
    const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb);
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
  }
}

// Inclusive prefix sum over the block of one float64 per thread.
__device__ __forceinline__ double block_scan(double v, double* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_sums[w];
  return v;
}

// Barrier of one half (256 threads) of a 512-thread CTA.
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(half + 1), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits for every group of asynchronous copies but the newest.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// *dst = valid ? *src : 0 in shared memory: an asynchronous 4-byte copy
// (zero-filled where not valid) for float, which lands by the matching
// cp_async_wait_prior; bf16 is converted on the spot.  Where not valid,
// src must still point into the operand.
__device__ __forceinline__ void stage(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src, bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}

// Rows [r0, r0 + kT) of a row-major matrix at `src` (row stride `ld`, N
// contiguous) staged into dst[n][r] (rows of kLd), zero outside rows
// [0, rows) and columns [0, N); n runs to N rounded up to 8; by thread t
// of `threads`.  A warp stores eight n by four r, which the 68-float rows
// spread over 32 banks.
__device__ __forceinline__ void stage_transposed(float* dst, const float* src, long long ld,
                                                 int r0, int rows, int N, int t, int threads) {
  const int n8 = (N + 7) & ~7;
  for (int e = t; e < kT * n8; e += threads) {
    const int r = (e >> 3) & (kT - 1), n = (e >> 9) * 8 + (e & 7);
    const bool ok = n < N && r0 + r < rows;
    stage(dst + n * kLd + r, ok ? src + (r0 + r) * ld + n : src, ok);
  }
}

// ---- 1. the chunk's own state, S_c = B^T (w o x), and seg ----
constexpr int kChunkStage = kKc * (kMaxN + kT);  // floats: B rows, then w o x rows

size_t chunk_smem() {
  return sizeof(float) * 2 * kChunkStage + (sizeof(double) + sizeof(float)) * kMaxQ;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ Bm,
                      float* __restrict__ states, double* __restrict__ segs, int heads,
                      int nc, int P, int N, int Q, Strides st) {
  // two stages of [kKc][kMaxN] B rows ([j][n]) and [kKc][kT] w_j x_j ([j][c])
  extern __shared__ __align__(16) float smem[];
  double* seg = reinterpret_cast<double*>(smem + 2 * kChunkStage);  // [kMaxQ]
  float* w = reinterpret_cast<float*>(seg + kMaxQ);                 // [kMaxQ]
  __shared__ double warp_sums[kThreads / 32];

  const int tid = threadIdx.x, tx = tile_x(tid), ty = tile_y(tid);
  int u = blockIdx.x;
  const int h = u % heads;
  u /= heads;
  const int c = u % nc, b = u / nc;
  const int c0 = blockIdx.y * kT;  // first head-width column of this CTA
  const long long pos0 = static_cast<long long>(c) * Q;
  const long long unit = (static_cast<long long>(b) * nc + c) * heads + h;
  const float a = A[b * st.ab + h * st.ah];
  const T* xp = x + b * st.xb + h * st.xh + pos0 * st.xs + c0;
  const float* bp = Bm + b * st.bb + pos0 * st.bs;

  auto stage_step = [&](int t) {
    float* bs = smem + (t & 1) * kChunkStage;
    float* xs = bs + kKc * kMaxN;
    const int j0 = t * kKc;
    for (int e = tid; e < kKc * kMaxN; e += kThreads) {
      const int j = e / kMaxN, n = e % kMaxN;
      const bool ok = n < N && j0 + j < Q;
      stage(bs + e, ok ? bp + (j0 + j) * st.bs + n : bp, ok);
    }
#pragma unroll
    for (int q = 0; q < kKc * kT / kThreads; ++q) {
      const int e = tid + q * kThreads, j = e / kT, cc = e % kT;
      const bool ok = c0 + cc < P && j0 + j < Q;
      stage(xs + e, ok ? xp + (j0 + j) * st.xs + cc : xp, ok);
    }
  };
  stage_step(0);
  cp_async_commit();

  float dti = 0.f;
  double v = 0.0;
  if (tid < Q) {
    dti = dt[b * st.db + (pos0 + tid) * st.ds + h * st.dh];
    v = static_cast<double>(__fmul_rn(dti, a));
  }
  v = block_scan(v, warp_sums);
  if (tid < Q) seg[tid] = v;
  __syncthreads();
  if (tid < Q) {
    w[tid] = expf(static_cast<float>(seg[Q - 1] - v)) * dti;
    if (blockIdx.y == 0) segs[unit * Q + tid] = v;
  }
  __syncthreads();

  float acc[8][4] = {};
  const int steps = (Q + kKc - 1) / kKc;
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) stage_step(t + 1);
    cp_async_commit();
    cp_async_wait_prior();
    float* bs = smem + (t & 1) * kChunkStage;
    float* xs = bs + kKc * kMaxN;
    const int j0 = t * kKc;
#pragma unroll
    for (int q = 0; q < kKc * kT / kThreads; ++q) {  // this thread's own copies
      const int e = tid + q * kThreads, j = e / kT;
      if (j0 + j < Q) xs[e] *= w[j0 + j];
    }
    __syncthreads();
    mma_tile<8>(acc, bs + ty * 8, kMaxN, xs + tx * 4, kT, min(kKc, Q - j0));
    __syncthreads();  // before step t + 2 is staged over this one
  }

  float* sp = states + unit * N * P;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = ty * 8 + r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = c0 + tx * 4 + cc;
      if (n < N && col < P) sp[n * P + col] = acc[r][cc];
    }
  }
}

// ---- 2. the recurrence over chunks: h_c = exp(total_c) h_{c-1} + S_c ----
constexpr int kStateBatch = 8;  // chunks whose loads are issued together

__global__ void __launch_bounds__(kThreads)
ssd_scan_state_kernel(float* __restrict__ states, const double* __restrict__ segs,
                      float* __restrict__ state, int heads, int nc, int NP, int Q) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= NP) return;
  const long long unit0 = static_cast<long long>(b) * nc * heads + h;  // chunk 0
  float hc = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kStateBatch) {
    float s[kStateBatch], decay[kStateBatch];
#pragma unroll
    for (int q = 0; q < kStateBatch; ++q) {
      if (c0 + q < nc) {
        const long long unit = unit0 + static_cast<long long>(c0 + q) * heads;
        s[q] = states[unit * NP + e];
        decay[q] = expf(static_cast<float>(segs[unit * Q + Q - 1]));
      }
    }
#pragma unroll
    for (int q = 0; q < kStateBatch; ++q) {
      if (c0 + q < nc) {
        states[(unit0 + static_cast<long long>(c0 + q) * heads) * NP + e] = hc;  // h_prev
        hc = __fadd_rn(__fmul_rn(hc, decay[q]), s[q]);
      }
    }
  }
  state[(static_cast<long long>(b) * heads + h) * NP + e] = hc;
}

// ---- 3. y = exp(seg) o (C h_prev) + ((C B^T) o L) x ----
constexpr int kOutThreads = 2 * kThreads;  // two halves, each on its own heads
constexpr int kKs = 32;  // keys or state rows a step of a half

size_t output_smem(int N, int Q) {
  const int n8 = (N + 7) & ~7, nt = (Q + kT - 1) / kT;
  return sizeof(float) * (static_cast<size_t>(n8 + nt * kT + 8 * kKs) * kLd) +
         4 * (sizeof(double) + sizeof(float)) * Q;
}

template <typename T>
__global__ void __launch_bounds__(kOutThreads, 1)
ssd_scan_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ Bm, const float* __restrict__ Cm,
                       const float* __restrict__ states, const double* __restrict__ segs,
                       T* __restrict__ y, int batch, int heads, int nc, int P, int N, int Q,
                       int group, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int n8 = (N + 7) & ~7;
  const int nt = (Q + kT - 1) / kT;
  const int half = threadIdx.x / kThreads, lt = threadIdx.x % kThreads;
  const int tx = tile_x(lt), ty = tile_y(lt);
  float* cs = smem;                // [n8][kLd]: C rows of the query tile, [n][i]
  float* gt = cs + n8 * kLd;       // [nt * kT][kLd]: G^T over the tile's keys, [j][i]
  // per half, two stages of [2 kKs][kLd]: see below
  float* ring = gt + nt * kT * kLd + half * 4 * kKs * kLd;
  double* sg = reinterpret_cast<double*>(gt + nt * kT * kLd + 8 * kKs * kLd) + half * 2 * Q;
  float* dts = reinterpret_cast<float*>(sg - half * 2 * Q + 4 * Q) + half * 2 * Q;

  const int ngroups = (heads + group - 1) / group;
  int u = blockIdx.x;
  const int b = u % batch;
  u /= batch;
  const int c = u % nc;
  u /= nc;
  const int g = u % ngroups;
  const int i0 = (nt - 1 - u / ngroups) * kT;  // the longest query tiles first
  const int kend = min(Q, i0 + kT);            // keys 0 .. kend-1 reach this tile
  const int c0 = blockIdx.y * kT;
  const long long pos0 = static_cast<long long>(c) * Q;
  const long long unit0 = (static_cast<long long>(b) * nc + c) * heads;  // head 0
  const int h0 = g * group, nh = min(heads, h0 + group) - h0;
  const float* bp = Bm + b * st.bb + pos0 * st.bs;

  // G^T[j][i] = B_j . C_i, by 64-key tiles: the halves take alternate
  // tiles, each staging B^T's tile over its own ring
  stage_transposed(cs, Cm + b * st.cb + (pos0 + i0) * st.cs, st.cs, 0, Q - i0, N,
                   threadIdx.x, kOutThreads);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int n_g = (kend + kT - 1) / kT;
  for (int kt = half; kt < n_g; kt += 2) {
    stage_transposed(ring, bp, st.bs, kt * kT, kend, N, lt, kThreads);
    cp_async_commit();
    cp_async_wait_all();
    half_sync(half);
    float gacc[4][4] = {};
    mma_tile<4>(gacc, ring + ty * 4, kLd, cs + tx * 4, kLd, N);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(gt + (kt * kT + ty * 4 + r) * kLd + tx * 4) =
          make_float4(gacc[r][0], gacc[r][1], gacc[r][2], gacc[r][3]);
    }
    half_sync(half);
  }
  __syncthreads();  // G^T is whole

  // Each half then walks its heads (h0 + half, h0 + half + 2, ...) in
  // steps of 32 operand rows over a two-stage ring: per head n_i steps of
  // C h_prev (state rows in the stage's second half), then n_j steps of
  // (G o L) x ((G o L)^T in the first half, x rows in the second).  Step
  // t + 1 is staged while step t computes.
  const int n_i = (N + kKs - 1) / kKs, n_j = (kend + kKs - 1) / kKs;
  const int per_head = n_i + n_j, steps = (nh - half + 1) / 2 * per_head;
  auto stage_step = [&](int t) {
    float* rows = ring + (t & 1) * 2 * kKs * kLd + kKs * kLd;
    const int h = h0 + half + 2 * (t / per_head), k = t % per_head;
    if (k < n_i) {
      const float* hp = states + (unit0 + h) * N * P + c0;
      const int n0 = k * kKs;
      for (int e = lt; e < kKs * kT; e += kThreads) {
        const int n = e >> 6, cc = e & (kT - 1);
        const bool ok = n0 + n < N && c0 + cc < P;
        stage(rows + n * kLd + cc, ok ? hp + (n0 + n) * P + cc : hp, ok);
      }
    } else {
      const T* xh = x + b * st.xb + h * st.xh + pos0 * st.xs + c0;
      const int j0 = (k - n_i) * kKs;
      for (int e = lt; e < kKs * kT; e += kThreads) {
        const int j = e >> 6, cc = e & (kT - 1);
        const bool ok = j0 + j < kend && c0 + cc < P;
        stage(rows + j * kLd + cc, ok ? xh + (j0 + j) * st.xs + cc : xh, ok);
      }
    }
  };
  if (steps > 0) stage_step(0);
  cp_async_commit();

  const int mi = lt & (kT - 1);  // the query row this thread fills in (G o L)^T
  const int mj = lt >> 6;        // and its first key row, then every fourth
  const int gi = i0 + mi;
  const int last_row = i0 + (ty & ~3) * 4 + 15;  // this warp's last query row
  float acc[4][4] = {};
  for (int t = 0; t < steps; ++t) {
    float* cur = ring + (t & 1) * 2 * kKs * kLd;
    if (t + 1 < steps) stage_step(t + 1);
    cp_async_commit();
    const int hn = t / per_head, k = t % per_head, h = h0 + half + 2 * hn;
    double* sgh = sg + (hn & 1) * Q;
    float* dth = dts + (hn & 1) * Q;
    if (k == 0) {  // a head's first step: its seg and dt, for its later steps
      for (int j = lt; j < kend; j += kThreads) {
        sgh[j] = segs[(unit0 + h) * Q + j];
        dth[j] = dt[b * st.db + (pos0 + j) * st.ds + h * st.dh];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
      }
    }
    const int j0 = (k - n_i) * kKs;
    if (k >= n_i) {  // (G o L)^T of the key rows, masked before exp
      const double seg_i = gi < Q ? sgh[gi] : 0.0;
#pragma unroll
      for (int q = 0; q < kKs / 4; ++q) {
        const int j = mj + 4 * q, gj = j0 + j;
        float m = 0.f;
        if (gj <= gi && gi < Q) {
          m = gt[gj * kLd + mi] * (expf(static_cast<float>(seg_i - sgh[gj])) * dth[gj]);
        }
        cur[j * kLd + mi] = m;
      }
    }
    cp_async_wait_prior();
    half_sync(half);
    if (k < n_i) {  // C h_prev over 32 state rows
      mma_tile<4>(acc, cs + k * kKs * kLd + ty * 4, kLd, cur + kKs * kLd + tx * 4, kLd,
                  min(kKs, N - k * kKs));
    } else {
      if (k == n_i) {  // y_inter = exp(seg_i) (C h_prev)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
          const float e = i < Q ? expf(static_cast<float>(sgh[i])) : 0.f;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] *= e;
        }
      }
      // keys past the warp's last query row weigh 0
      const int keys = min(min(kKs, kend - j0), last_row + 1 - j0);
      if (keys > 0) {
        mma_tile<4>(acc, cur + ty * 4, kLd, cur + kKs * kLd + tx * 4, kLd, keys);
      }
      if (k == per_head - 1) {
        T* yh = y + b * st.yb + h * st.yh + c0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int col = tx * 4 + cc;
            if (i < Q && c0 + col < P) store_f(yh + (pos0 + i) * st.ys + col, acc[r][cc]);
          }
        }
      }
    }
    half_sync(half);  // before step t + 2 is staged over this one
  }
}

// Lets `kernel` use the device's most dynamic shared memory beside its
// static shared memory: an attribute of the kernel on each device, set on
// the first launch there only.  A larger block's launch then fails with
// its error.
template <typename Kernel>
cudaError_t allow_large_smem(Kernel kernel, std::atomic<bool> (&opted_in)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (opted_in[device].load(std::memory_order_acquire)) return cudaSuccess;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most - static_cast<int>(attr.sharedSizeBytes));
  if (err != cudaSuccess) return err;
  opted_in[device].store(true, std::memory_order_release);
  return cudaSuccess;
}

// Heads of one output CTA, which share its C B^T tile: every head, unless
// the `ctas` CTAs of one group would leave SMs of the device idle; then the
// heads split into as few groups as fill them.
cudaError_t heads_per_cta(int heads, int ctas, int* group) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int groups = std::min(heads, (sms + ctas - 1) / ctas);
  *group = (heads + groups - 1) / groups;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* state, void* states, void* segs, int batch,
                   int heads, int seq, int P, int N, int Q, const Strides& st,
                   cudaStream_t stream) {
  static std::atomic<bool> chunk_opted_in[kMaxDevices], output_opted_in[kMaxDevices];
  const int nc = seq / Q, slabs = (P + kT - 1) / kT;
  cudaError_t err = allow_large_smem(ssd_scan_chunk_kernel<T>, chunk_opted_in);
  if (err != cudaSuccess) return err;
  ssd_scan_chunk_kernel<T><<<dim3(batch * nc * heads, slabs), kThreads, chunk_smem(), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<float*>(states), static_cast<double*>(segs),
      heads, nc, P, N, Q, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ssd_scan_state_kernel<<<dim3((N * P + kThreads - 1) / kThreads, heads, batch), kThreads, 0,
                          stream>>>(static_cast<float*>(states),
                                    static_cast<const double*>(segs),
                                    static_cast<float*>(state), heads, nc, N * P, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = allow_large_smem(ssd_scan_output_kernel<T>, output_opted_in);
  if (err != cudaSuccess) return err;
  const int nt = (Q + kT - 1) / kT;
  int group = 0;
  err = heads_per_cta(heads, nt * nc * batch * slabs, &group);
  if (err != cudaSuccess) return err;
  const int ngroups = (heads + group - 1) / group;
  ssd_scan_output_kernel<T><<<dim3(nt * ngroups * nc * batch, slabs), kOutThreads,
                              output_smem(N, Q), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(states),
      static_cast<const double*>(segs), static_cast<T*>(y), batch, heads, nc, P, N, Q, group,
      st);
  return cudaGetLastError();
}

}  // namespace

// Launches the scan's three kernels on `stream`; allocates nothing.
// `states` is float32 scratch of (batch, seq/chunk, heads, n_state,
// head_dim) and `segs` float64 scratch of (batch, seq/chunk, heads,
// chunk), both contiguous.  Strides are in elements: x, dt and y by
// (batch, position, head), A by (batch, head), B and C by (batch,
// position); the last dimension of x, y, B and C is contiguous.  seq must
// be a multiple of chunk; chunk at most 256, n_state at most 128.
// bf16 != 0 reads x and writes y as
// bfloat16, else float32.  Returns the cudaError_t of the launches
// (0 = success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, void* state, void* states, void* segs,
                               int batch, int heads, int seq, int head_dim, int n_state,
                               int chunk, long long xb, long long xs, long long xh,
                               long long db, long long ds, long long dh, long long ab,
                               long long ah, long long bb, long long bs, long long cb,
                               long long cs, long long yb, long long ys, long long yh, int bf16,
                               void* stream) {
  if (batch <= 0 || heads <= 0 || chunk <= 0 || chunk > kMaxQ || seq <= 0 || seq % chunk ||
      head_dim <= 0 || n_state <= 0 || n_state > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{xb, xs, xh, db, ds, dh, ab, ah, bb, bs, cb, cs, yb, ys, yh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, states, segs, batch, heads, seq,
                                   head_dim, n_state, chunk, st, s)
           : launch<float>(x, dt, A, Bm, Cm, y, state, states, segs, batch, heads, seq,
                           head_dim, n_state, chunk, st, s);
  return static_cast<int>(err);
}
