// Blocked (flash) attention forward with grouped-query heads, causal and
// sliding-window masks, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (the pl.pallas_call at flash_attention.py:96, body _flash_kernel at :24).
//
// What it computes, as _flash_kernel does: for query row i of head j,
//   s_ik = (q_i . k_k) * (1/sqrt(d))   in float32 from q and k,
//   s_ik = -1e30 where the causal (i >= k) or window (i - k < window)
//          mask is false,
// an online softmax over the keys with running max m (from -1e30), sum l
// and accumulator acc in float32, and o_i = acc / max(l, 1e-30) written in
// q's dtype (float32 or bfloat16).  As there, a row whose first keys are
// all masked sums them with weight 1 until a real key arrives, whose
// rescale exp(-1e30 - m) = 0 wipes them; keys past the sequence weigh 0.
//
// Layout.  q, o are (B, S, n, d) and k, v (B, S, m, d) read in place
// through their strides (batch, head, position; the head width is
// contiguous), so the model's (B, S, n, d) projections need no permute.
// Query head j reads kv head j / (n / m): grouped-query attention without
// a copy of k and v per query head.
//
// What bounds it on this card: operations.  A causal prefill at the
// serving path's shape (16 heads, 16,384 positions, d = 128) does 4·d
// flops per unmasked (query, key) pair, 1.10e12 a launch, against 0.27 GB
// of q, k, v and o: 1.11 ms at the bf16 tensor-core peak (989 TFLOP/s)
// against 0.08 ms at the memory's 3.35 TB/s.
//
// bfloat16: flash_attention_wgmma_kernel, on the tensor cores.  One CTA
// per (128-row query tile, query head, batch) of three warpgroups.  The
// first is the producer: it hands most of its registers to the others
// (setmaxnreg), and one of its threads loads the CTA's tile of q once and
// then K and V tiles of 128 keys by TMA (cp.async.bulk.tensor, one map per
// operand encoded on the host over the strides above) into a two-stage
// ring guarded by mbarriers: "full" when a tile's bytes have landed,
// "empty" when both consumers are done with its stage.  The other two
// warpgroups own 64 query rows each.  For every key tile a consumer
//   * issues S = Q·Kᵀ as wgmma m64n128k16 from shared memory (q and k
//     K-major, in the 128-, 64- or 32-byte swizzle that TMA writes and
//     the descriptor names), float32 in registers;
//   * masks only on a tile that straddles the diagonal, the window's edge
//     or the sequence's end, and runs the online softmax on the
//     accumulator (exp2 of scores scaled by log2(e)/sqrt(d));
//   * splits P in place into bf16 hi and lo = bf16(p - hi) (the
//     accumulator's fragment is the A fragment of the next product),
//     while l sums the float32 p;
//   * issues O += hi·V + lo·V as wgmma with A in registers and V read
//     MN-major through the descriptor's transpose bit: V is never
//     transposed.
// One bf16 P (FlashAttention's choice) errs by 2^-9 of each weight,
// which misses atol 1e-4 on outputs near 0 (tests/
// test_torch_flash_attention.py emulates both); the lo product brings
// the weights to 2^-17 for half again the tensor work.
// Key tiles that no row of the CTA sees are not loaded; a consumer skips
// the tiles that none of its 64 rows sees (in the reference they add
// exactly 0 after a real key, or are wiped before one).  Query tiles run
// longest first (the last ones under a causal mask), so the short ones
// fill the tail of the grid.  Still on the table: the lo product's third
// of the tensor work; a consumer's softmax does not overlap its own
// matrix products (no pipelining of the next S under this P·V, no
// ping-pong schedule between the two consumers, which overlap only as
// the warp schedulers interleave them); the output is stored from
// registers rather than by TMA; the grid is not persistent.
//
// float32: flash_attention_kernel, on the FMA units.  One CTA per (64-row
// query tile, query head, batch).  Each row is owned by TPR = d/32
// threads (1 for d <= 32), each holding 32 (or d) of the row's columns of
// q and of the float32 accumulator in registers, in float4 groups; a
// score is their partial dot products summed with warp shuffles.  K and V
// tiles of 32 keys are staged in shared memory, and every row of a warp
// reads the same key, so the reads broadcast.  The online softmax steps
// over 16 keys at a time.  Key tiles hidden from every row are skipped.
// No model serves in float32; tensor cores would need three TF32
// products to hold the float32 path's 2e-6.

#include <cuda.h>  // CUtensorMap; the encoder is found at run time, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kRows = 64;  // float32: query rows per CTA
constexpr int kKeys = 32;  // float32: keys per shared-memory tile
constexpr int kSub = 16;   // float32: keys per online-softmax step
constexpr float kMasked = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

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


// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores

constexpr int kBr = 128;            // query rows per CTA: two consumers of 64
constexpr int kBc = 128;            // keys per K/V tile
constexpr int kStages = 2;          // K/V tiles in flight
constexpr int kThreadsTC = 384;     // the producer warpgroup and two consumers
constexpr int kConsumerWarps = 8;   // arrivals that free a stage
constexpr uint64_t kHangNs = 4000000000ull;  // a barrier wait this long is a fault

// Shared memory of the bf16 kernel for head width D.  A tile of `rows`
// rows is stored as D / kBoxCols boxes of rows x kRowBytes, each written
// by one TMA load in the swizzle of its row width (128, 64 or 32 bytes).
template <int D>
struct Tiles {
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr uint32_t kMode = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr uint32_t kAtom = 8 * kRowBytes;  // 8 rows: one swizzle atom
  static constexpr uint32_t kQBytes = kBr * D * 2;
  static constexpr uint32_t kKVBytes = kBc * D * 2;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBar = kV + kStages * kKVBytes;
  static constexpr uint32_t kSmem = kBar + 8 * (1 + 3 * kStages) + 1024;  // + alignment
  // byte offset of k-step kk (columns 16kk..16kk+15) in a K-major tile
  static __device__ __forceinline__ uint32_t k_step(int kk, int rows) {
    return (kk * 16 / kBoxCols) * rows * kRowBytes + (kk * 16 % kBoxCols) * 2;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the phase of parity `parity` to complete.  A fault in the
// pipeline traps (a launch failure) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > kHangNs) __trap();
  }
}

// One TMA load of a box at (column, head, position, batch) into shared
// memory, counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(pos),
      "r"(batch)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (in 16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(mode) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (m64 x n128, float32) = a·bᵀ (+ d if accumulate), a and b bf16, K-major
// in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64 x n16, float32) += a·b, a bf16 in registers (the accumulator's
// layout), b bf16 MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64 x n32, float32) += a·b, a bf16 in registers (the accumulator's
// layout), b bf16 MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64 x n64, float32) += a·b, a bf16 in registers (the accumulator's
// layout), b bf16 MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (m64 x D) += P·V for one k-step of 16 keys: V's rows 16kk..16kk+15 of
// the tile at `tile`, MN-major, one wgmma per 64-column box.
template <int D>
__device__ __forceinline__ void pv_step(float* acc, const uint32_t* p, uint32_t tile, int kk) {
  using T = Tiles<D>;
  const uint32_t addr = tile + 16 * kk * T::kRowBytes;
  if constexpr (D == 128) {
    wgmma_rs_n64(acc, p, make_desc(addr, T::kAtom, T::kAtom, T::kMode));
    wgmma_rs_n64(acc + 32, p, make_desc(addr + kBc * T::kRowBytes, T::kAtom, T::kAtom, T::kMode));
  } else if constexpr (D == 64) {
    wgmma_rs_n64(acc, p, make_desc(addr, T::kAtom, T::kAtom, T::kMode));
  } else if constexpr (D == 32) {
    wgmma_rs_n32(acc, p, make_desc(addr, T::kAtom, T::kAtom, T::kMode));
  } else {
    wgmma_rs_n16(acc, p, make_desc(addr, T::kAtom, T::kAtom, T::kMode));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, long long osb, long long osh,
                             long long oss, int group, int seq, int causal, int window,
                             float scale_log2) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the 128 B swizzle's atom
  const uint32_t sq = base + T::kQ, sk = base + T::kK, sv = base + T::kV;
  const uint32_t bar_q = base + T::kBar;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };

  const int head = blockIdx.x;
  const int b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBr;  // the longest query tiles first
  // key tiles some row of this CTA sees
  int kv_lo = 0, kv_hi = seq;
  if (causal) kv_hi = min(seq, q0 + kBr);
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  const int t0 = kv_lo / kBc;
  const int ntiles = (kv_hi + kBc - 1) / kBc - t0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = head / group;
      mbar_expect_tx(bar_q, T::kQBytes);
      for (int bx = 0; bx < T::kBoxes; ++bx) {
        tma_load(sq + bx * kBr * T::kRowBytes, &tq, bar_q, bx * T::kBoxCols, head, q0, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);  // the first round passes
        const int k0 = (t0 + i) * kBc;
        mbar_expect_tx(full_k(s), T::kKVBytes);
        for (int bx = 0; bx < T::kBoxes; ++bx) {
          tma_load(sk + s * T::kKVBytes + bx * kBc * T::kRowBytes, &tk, full_k(s),
                   bx * T::kBoxCols, kvh, k0, b);
        }
        mbar_expect_tx(full_v(s), T::kKVBytes);
        for (int bx = 0; bx < T::kBoxes; ++bx) {
          tma_load(sv + s * T::kKVBytes + bx * kBc * T::kRowBytes, &tv, full_v(s),
                   bx * T::kBoxCols, kvh, k0, b);
        }
      }
    }
  } else {
    // a consumer warpgroup: 64 query rows
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int r_lo = q0 + 64 * cw;
    // this thread's accumulator entries: rows row and row + 8, columns
    // col and col + 1 of every 8-column group
    const int row = r_lo + 16 * warp + lane / 4;
    const int col = 2 * (lane % 4);

    float acc[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
    const uint64_t dq = make_desc(sq + 64 * cw * T::kRowBytes, 16, T::kAtom, T::kMode);
    mbar_wait(bar_q, 0);

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const int k0 = (t0 + i) * kBc;
      const bool hidden = r_lo >= seq || (causal && k0 > r_lo + 63) ||
                          (window > 0 && r_lo - (k0 + kBc - 1) >= window);
      mbar_wait(full_k(s), ph);
      if (!hidden) {
        float sc[kBc / 2];
#pragma unroll
        for (int r = 0; r < kBc / 2; ++r) sc[r] = 0.f;
        const uint64_t dk = make_desc(sk + s * T::kKVBytes, 16, T::kAtom, T::kMode);
        fence_regs<kBc / 2>(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss_n128(sc, dq + (T::k_step(kk, kBr) >> 4), dk + (T::k_step(kk, kBc) >> 4),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<kBc / 2>(sc);

        // scores in log2 units: sc * sl.  On a tile that straddles a mask
        // edge or the sequence's end, scale and mask here (sl = 1 after).
        float sl = scale_log2;
        if ((causal && k0 + kBc - 1 > r_lo) || (window > 0 && r_lo + 63 - k0 >= window) ||
            k0 + kBc > seq) {
#pragma unroll
          for (int r = 0; r < kBc / 2; ++r) {
            const int key = k0 + 8 * (r / 4) + col + (r & 1);
            const int qpos = row + 8 * ((r >> 1) & 1);
            float x = sc[r] * scale_log2;
            if ((causal && key > qpos) || (window > 0 && qpos - key >= window)) x = kMasked;
            if (key >= seq) x = -INFINITY;  // past the sequence: weight exactly 0
            sc[r] = x;
          }
          sl = 1.f;
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int r = 0; r < kBc / 2; ++r) mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[r]);
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h] * sl);
          alpha[h] = exp2_approx(m[h] - m_new);
          m[h] = m_new;
          l[h] *= alpha[h];
        }
        // P as bf16 hi + lo parts, in the A fragment of m64nNk16: k-step kk
        // takes the score registers 8kk..8kk+7 in pairs
        uint32_t p_hi[kBc / 16][4], p_lo[kBc / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBc / 16; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = 8 * kk + 2 * j;
            const float p0 = exp2_approx(fmaf(sc[r], sl, -m[j & 1]));
            const float p1 = exp2_approx(fmaf(sc[r + 1], sl, -m[j & 1]));
            l[j & 1] += p0 + p1;
            const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
            const float2 hf = __bfloat1622float2(hi);
            p_hi[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
            p_lo[kk][j] = pack_bf16(p0 - hf.x, p1 - hf.y);
          }
        }
#pragma unroll
        for (int r = 0; r < D / 2; ++r) acc[r] *= alpha[(r >> 1) & 1];

        mbar_wait(full_v(s), ph);
        fence_regs<D / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBc / 16; ++kk) {
          pv_step<D>(acc, p_hi[kk], sv + s * T::kKVBytes, kk);
          pv_step<D>(acc, p_lo[kk], sv + s * T::kKVBytes, kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<D / 2>(acc);
      } else {
        mbar_wait(full_v(s), ph);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int qpos = row + 8 * h;
      if (qpos < seq) {
        __nv_bfloat16* op = o + b * osb + head * osh + static_cast<long long>(qpos) * oss;
        const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const int r = 4 * c + 2 * h;  // group c's entries of row qpos
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * c + col) =
              __floats2bfloat162_rn(acc[r] / den, acc[r + 1] / den);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A TMA map over a bf16 (batch, seq, heads, D) tensor with element strides
// (sb, sh, ss), its dimensions ordered (column, head, position, batch),
// boxes of `rows` positions by one swizzle span of columns.  Positions
// past seq read as zeros.
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int batch, int heads, int seq, long long sb,
            long long sh, long long ss, int rows) {
  using T = Tiles<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  // a dimension of extent 1 is never stepped: give it a stride TMA takes
  const cuuint64_t bh = heads > 1 ? 2 * sh : 2 * D;
  const cuuint64_t bs = seq > 1 ? 2 * ss : bh * heads;
  const cuuint64_t bb = batch > 1 ? 2 * sb : bs * seq;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {bh, bs, bb};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kBoxCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int batch,
                         int heads, int kv_heads, int seq, const long long* st, int causal,
                         int window, cudaStream_t stream) {
  using T = Tiles<D>;
  const int qtiles = (seq + kBr - 1) / kBr;
  if (qtiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!encode<D>(&mq, q, batch, heads, seq, st[0], st[1], st[2], kBr) ||
      !encode<D>(&mk, k, batch, kv_heads, seq, st[3], st[4], st[5], kBc) ||
      !encode<D>(&mv, v, batch, kv_heads, seq, st[6], st[7], st[8], kBc)) {
    return cudaErrorInvalidValue;
  }
  // The opt-in above 48 KB of dynamic shared memory is an attribute of the
  // kernel on each device: set it on the first launch there only.
  static std::atomic<bool> smem_opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_opted_in[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
    smem_opted_in[device].store(true, std::memory_order_release);
  }
  const dim3 grid(heads, qtiles, batch);
  flash_attention_wgmma_kernel<D><<<grid, kThreadsTC, T::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], heads / kv_heads,
      seq, causal, window, static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

cudaError_t dispatch_wgmma(int d, const void* q, const void* k, const void* v, void* o,
                           int batch, int heads, int kv_heads, int seq, const long long* st,
                           int causal, int window, cudaStream_t s) {
  switch (d) {
    case 16: return launch_wgmma<16>(q, k, v, o, batch, heads, kv_heads, seq, st, causal, window, s);
    case 32: return launch_wgmma<32>(q, k, v, o, batch, heads, kv_heads, seq, st, causal, window, s);
    case 64: return launch_wgmma<64>(q, k, v, o, batch, heads, kv_heads, seq, st, causal, window, s);
    case 128: return launch_wgmma<128>(q, k, v, o, batch, heads, kv_heads, seq, st, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the forward pass on `stream`; allocates nothing.  Strides are
// in elements, (batch, head, position) for each of q, k, v and o; window
// <= 0 means none; bf16 != 0 reads and writes bfloat16 (the tensor-core
// kernel: q, k and v 16-byte aligned, their strides multiples of 8
// elements), else float32 (the FMA kernel).  Returns the cudaError_t of
// the launch (0 = success).
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_wgmma(head_dim, q, k, v, o, batch, heads, kv_heads, seq, st, causal,
                            window, s)
           : dispatch<float>(head_dim, q, k, v, o, batch, heads, heads / kv_heads, seq, st,
                             causal, window, s);
  return static_cast<int>(err);
}
