// Bitonic sort with run-head marking (Algorithm 1's INSERTEDGE dedup as
// a sorting network), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/edge_dedup.py::sort_dedup (the
// pl.pallas_call at edge_dedup.py:68, body _dedup_kernel at :44).
//
// Sorts n (a power of two) uint32 keys, carried in int64, together with
// their input positions, by the reference's bitonic network, compare for
// compare: for k = 2, 4, ..., n and j = k/2, ..., 1, lane i with bit j
// clear meets lane i + j; the pair ascends iff (i & k) == 0, i the global
// lane, and swaps iff ascending ? a > b : a < b on the key alone.  Equal
// keys never swap, so `order` is exactly the reference kernel's (not a
// stable sort's).  Then head[i] = (i == 0 || sorted[i] != sorted[i-1]).
// The exchanges of one stage are independent, so any schedule that runs
// each stage's exchanges after the previous stage's, on the lanes they
// touch, gives the same permutation; the design below is such a
// schedule.
//
// What bounds it on this card: not bytes (24 a lane, 25 MB at 2^20,
// under 8 us at 3.35 TB/s) but the network's log2(n)(log2(n)+1)/2
// dependent stages (136 at 65,536 keys, 210 at 2^20): each stage waits
// for the last, so what a stage costs in barriers and round trips, and
// how many SMs share the work, set the time.  Each level of the design
// answers one of those:
//   * one word a lane: (uint64)key << 32 | position, compared on the high
//     word only (comparing the whole word would be a stable sort); in
//     registers the key and the position sit in two arrays;
//   * every pair ascends: in phase k a lane with bit k set holds its key
//     complemented (phase_flip), which turns a descending pair's a < b
//     into an ascending pair's a > b and keeps ties tied, so a
//     compare-exchange is one compare and four selects, with no direction;
//   * registers: each thread holds kE = 16 consecutive lanes, so every
//     stage with j < 16 runs with no communication at all;
//   * warp: stages with 16 <= j < 512 pair the same register of two
//     threads of one warp, exchanged by __shfl_xor_sync, with no barrier
//     (two shuffles a lane, which set a warp stage's pace);
//   * shared memory: a CTA holds kTile = 4,096 lanes (34 KB, a pad word
//     after every 16 so that both the blocked and the strided accesses
//     are free of bank conflicts).  Stages with 512 <= j < kTile are one
//     fused group: the lanes b + u * 2^lo, u < 16, that differ in the four
//     bits lo .. log2(j) are closed under the stages j .. 2^lo, so a
//     thread loads such a set, runs up to four stages in registers and
//     stores it back: one barrier per group, not per stage;
//   * cluster: kMaxCluster = 16 CTAs of one thread-block cluster (the
//     non-portable size, opted in once per device) run the stages with
//     kTile <= j < 65,536 as fused groups the same way, over distributed
//     shared memory, one cluster barrier on each side of a group.  So
//     every n <= 65,536 is one launch, on n / 4,096 SMs;
//   * device memory: stages with j >= 65,536 run as fused groups of up
//     to four in a launch of their own (a thread per 16-lane set, in
//     place in the scratch), and one cluster launch per k then runs the
//     stages below.  Where the call's clusters would not all fit on the
//     card with one CTA to an SM (sort_dedup_resident_clusters: 7 on an
//     H100, so above 2^18 keys), the stages with j >= kTile run so too
//     and the other launches need no cluster: CTAs that share an SM, or
//     wait for a second wave, would pay the whole network again.
// The host computes which stages each launch fuses at which level
// (`_plan` in edge_dedup.py) and hands it over; the launcher allocates
// nothing.
//
// Run heads are marked in the last launch.  The one key read across CTAs
// is the key before a CTA's first lane: in a cluster, the previous CTA's
// last lane, read through distributed shared memory.  For a cluster's
// first CTA in a launch of several clusters it is the largest key of the
// previous cluster's lanes (its segment): after the k = n stages above
// the segment, every key of an earlier segment is at most every key of a
// later one, and the last launch permutes only within segments, so each
// CTA reduces its share of the previous segment in the scratch (which
// that launch only reads) and the first CTA takes the largest of the
// cluster's.  A launch without cluster steps runs its CTAs as clusters
// of one, each its own segment.

#include <atomic>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kLogE = 4;
constexpr int kE = 1 << kLogE;  // lanes a thread holds (REG_LANES)
constexpr int kLogWarpLanes = kLogE + 5;  // WARP_LANES = 512
constexpr int kLogTile = 12;
constexpr int kTile = 1 << kLogTile;  // lanes a CTA holds (CTA_LANES)
constexpr int kThreads = kTile / kE;
constexpr int kMaxCluster = 16;  // CTAs of a cluster (CLUSTER_CTAS)
constexpr int kLogClusterLanes = kLogTile + 4;
constexpr int kSmemWords = kTile + kTile / 16;
constexpr int kMaxSteps = 64;
constexpr int kMaxDevices = 64;
// with the static 34 KB, more than half an SM's 228 KB: one CTA an SM
constexpr int kSpreadSmem = 96 * 1024;
enum Level { kReg = 0, kSmem = 1, kCluster = 2, kGlobal = 3 };

// The steps of one launch, packed as edge_dedup._encoded_plan packs them.
struct Steps {
  int count;
  int step[kMaxSteps];
};

__device__ __forceinline__ unsigned pad(unsigned lane) { return lane + (lane >> 4); }

__device__ __forceinline__ u64 word(unsigned key, unsigned pos) {
  return (static_cast<u64>(key) << 32) | pos;
}

__device__ __forceinline__ unsigned key_of(u64 w) { return static_cast<unsigned>(w >> 32); }

// A thread's lanes: key[u] (in its phase's form, below) and pos[u].
struct Lanes {
  unsigned key[kE];
  unsigned pos[kE];
  __device__ __forceinline__ void set(int u, u64 w) {
    key[u] = key_of(w);
    pos[u] = static_cast<unsigned>(w);
  }
  __device__ __forceinline__ u64 get(int u) const { return word(key[u], pos[u]); }
};

// In phase k a lane i with (i & k) != 0 holds its key complemented
// (~key reverses the unsigned order and keeps ties tied), so every pair
// ascends: it swaps iff key(a) > key(b) on the stored keys, which is
// ascending ? a > b : a < b on the keys themselves.  This XOR takes lane
// i's key from phase k/2's form (the plain key before phase 2) to phase
// k's; the first step of each phase applies it to the lanes it loads.
// After the last phase (k = n) no lane below n is complemented.
__device__ __forceinline__ unsigned phase_flip(unsigned i, int logk) {
  const unsigned now = (i >> logk) & 1u, before = logk > 1 ? (i >> (logk - 1)) & 1u : 0u;
  return 0u - (now ^ before);
}

// One stage on a thread's lanes: u meets u + D for every u with bit D
// clear, the pair ascending (the phase's form): the smaller key to u.
template <int D>
__device__ __forceinline__ void reg_stage(Lanes& x) {
#pragma unroll
  for (int u = 0; u < kE; ++u) {
    if (u & D) continue;
    const unsigned ka = x.key[u], kb = x.key[u + D], pa = x.pos[u], pb = x.pos[u + D];
    const bool swap = kb < ka;
    x.key[u] = swap ? kb : ka;
    x.key[u + D] = swap ? ka : kb;
    x.pos[u] = swap ? pb : pa;
    x.pos[u + D] = swap ? pa : pb;
  }
}

// A stage with kE <= j < 32 kE on the blocked layout (thread t holds lanes
// 16 t .. 16 t + 15): the partner lane is the same register of thread
// t ^ d, d = j / kE.  The pair ascends, so the lower thread keeps the
// smaller key and the upper the larger, each taking its partner's
// position iff it took its partner's (strictly smaller or larger) key.
__device__ __forceinline__ void warp_stage(Lanes& x, unsigned d) {
  const bool upper = (threadIdx.x & d) != 0;
#pragma unroll
  for (int u = 0; u < kE; ++u) {
    const unsigned kp = __shfl_xor_sync(0xffffffffu, x.key[u], d);
    const unsigned pp = __shfl_xor_sync(0xffffffffu, x.pos[u], d);
    const unsigned kept = upper ? max(x.key[u], kp) : min(x.key[u], kp);
    x.pos[u] = kept != x.key[u] ? pp : x.pos[u];
    x.key[u] = kept;
  }
}

// Applies phase k's flip to lanes lane0 + u * stride where the step
// starts the phase (j = k / 2).
__device__ __forceinline__ void start_phase(Lanes& x, unsigned lane0, unsigned stride, int logk,
                                            int logj) {
  if (logj != logk - 1) return;
#pragma unroll
  for (int u = 0; u < kE; ++u) x.key[u] ^= phase_flip(lane0 + u * stride, logk);
}

// The stages j = 2^TOP, ..., 2, 1 of a REG step on the blocked layout,
// each of its distance at compile time.
template <int TOP>
__device__ __forceinline__ void reg_run(Lanes& x) {
  if constexpr (TOP >= kLogE) {
    warp_stage(x, 1u << (TOP - kLogE));
  } else {
    reg_stage<1 << TOP>(x);
  }
  if constexpr (TOP > 0) reg_run<TOP - 1>(x);
}

// A REG step from j = 2^logj down to j = 1, as one straight run of stages.
__device__ __forceinline__ void reg_step(Lanes& x, int logj) {
  switch (logj) {
    case 0: reg_run<0>(x); break;
    case 1: reg_run<1>(x); break;
    case 2: reg_run<2>(x); break;
    case 3: reg_run<3>(x); break;
    case 4: reg_run<4>(x); break;
    case 5: reg_run<5>(x); break;
    case 6: reg_run<6>(x); break;
    case 7: reg_run<7>(x); break;
    default: reg_run<8>(x); break;
  }
}

// The m stages of a fused group over the lanes b + u * 2^lo, u < kE,
// lo = logj - 3: the first pairs u with u + 8, the next u + 4, ...
__device__ __forceinline__ void group_stages(Lanes& x, int m) {
  switch (m) {
    case 1: reg_stage<8>(x); break;
    case 2: reg_stage<8>(x); reg_stage<4>(x); break;
    case 3: reg_stage<8>(x); reg_stage<4>(x); reg_stage<2>(x); break;
    default: reg_stage<8>(x); reg_stage<4>(x); reg_stage<2>(x); reg_stage<1>(x); break;
  }
}

// The first lane of thread g's set in a group whose window is the bits
// lo .. lo + 3: g with kLogE zero bits put in at bit lo.
__device__ __forceinline__ unsigned group_base(unsigned g, int lo) {
  return (g & ((1u << lo) - 1)) | ((g >> lo) << (lo + kLogE));
}

// Distributed shared memory by 32-bit shared::cluster addresses.
__device__ __forceinline__ unsigned cluster_addr(const u64* local, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(local))), "r"(rank));
  return out;
}
__device__ __forceinline__ u64 load_cluster(unsigned addr) {
  u64 v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];" : "=l"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void store_cluster(unsigned addr, u64 v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;" ::"r"(addr), "l"(v) : "memory");
}

// One launch's steps over a cluster of CTAs, each of `tile` lanes
// (kTile, or n below it).  Input: the int64 keys (first launch) or the
// scratch's words; output: the scratch, or the three outputs with run
// heads (last launch).
__global__ void __launch_bounds__(kThreads)
cluster_kernel(const long long* __restrict__ in_keys, u64* scratch,
               long long* __restrict__ out_sorted, int* __restrict__ out_order,
               int* __restrict__ out_head, int tile, Steps steps) {
  __shared__ u64 smem[kSmemWords];
  __shared__ unsigned warp_max[kThreads / 32];
  __shared__ unsigned share_max;  // this CTA's share of the previous segment's largest key
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned ctas = cluster.num_blocks();
  const unsigned t = threadIdx.x, nt = blockDim.x;
  const unsigned cta_base = blockIdx.x * static_cast<unsigned>(tile);
  const unsigned cluster_base = cta_base - rank * tile;
  const bool last = out_sorted != nullptr;
  const bool after_segment = last && cluster_base > 0;  // only when reading the scratch

  unsigned m_prev = 0;
#pragma unroll
  for (int v = 0; v < kE; ++v) {
    const unsigned l = t + v * nt;
    if (l < static_cast<unsigned>(tile)) {
      const unsigned i = cta_base + l;
      smem[pad(l)] = in_keys != nullptr ? word(static_cast<unsigned>(in_keys[i]), i) : scratch[i];
      if (after_segment) m_prev = max(m_prev, key_of(scratch[i - ctas * tile]));
    }
  }
  if (after_segment) {
    for (int off = 16; off > 0; off >>= 1) m_prev = max(m_prev, __shfl_xor_sync(~0u, m_prev, off));
    if ((t & 31) == 0) warp_max[t >> 5] = m_prev;
  }
  __syncthreads();
  if (after_segment && t == 0) {
    unsigned m = 0;
    for (unsigned w = 0; w < nt / 32; ++w) m = max(m, warp_max[w]);
    share_max = m;
  }

  Lanes x;
  bool in_regs = false;
  const unsigned lane0 = cta_base + t * kE;  // global lane of x's lane 0 in the blocked layout
  for (int s = 0; s < steps.count; ++s) {
    const int st = steps.step[s];
    const int level = st & 15, logk = (st >> 4) & 63, logj = (st >> 10) & 63, m = st >> 16;
    if (level == kReg) {
      if (!in_regs) {
        __syncthreads();  // after a group's stores
#pragma unroll
        for (int u = 0; u < kE; ++u) x.set(u, smem[pad(t * kE + u)]);
        in_regs = true;
      }
      start_phase(x, lane0, 1u, logk, logj);
      reg_step(x, logj);
      continue;
    }
    if (in_regs) {
#pragma unroll
      for (int u = 0; u < kE; ++u) smem[pad(t * kE + u)] = x.get(u);
      in_regs = false;
    }
    const int lo = logj - (kLogE - 1);
    if (level == kSmem) {
      __syncthreads();  // after the blocked stores or a group's
      const unsigned b = group_base(t, lo);
#pragma unroll
      for (int u = 0; u < kE; ++u) x.set(u, smem[pad(b + (u << lo))]);
      start_phase(x, cta_base + b, 1u << lo, logk, logj);
      group_stages(x, m);
#pragma unroll
      for (int u = 0; u < kE; ++u) smem[pad(b + (u << lo))] = x.get(u);
    } else {  // kCluster: lanes of the whole cluster, in distributed shared memory
      cluster.sync();
      const unsigned b = group_base(rank * nt + t, lo);
#pragma unroll
      for (int u = 0; u < kE; ++u) {
        const unsigned l = b + (u << lo);
        x.set(u, load_cluster(cluster_addr(smem + pad(l & (kTile - 1)), l >> kLogTile)));
      }
      start_phase(x, cluster_base + b, 1u << lo, logk, logj);
      group_stages(x, m);
#pragma unroll
      for (int u = 0; u < kE; ++u) {
        const unsigned l = b + (u << lo);
        store_cluster(cluster_addr(smem + pad(l & (kTile - 1)), l >> kLogTile), x.get(u));
      }
      cluster.sync();
    }
  }
  if (in_regs) {
#pragma unroll
    for (int u = 0; u < kE; ++u) smem[pad(t * kE + u)] = x.get(u);
  }

  if (!last) {
    __syncthreads();
#pragma unroll
    for (int v = 0; v < kE; ++v) {
      const unsigned l = t + v * nt;
      if (l < static_cast<unsigned>(tile)) scratch[cta_base + l] = smem[pad(l)];
    }
    return;
  }
  cluster.sync();  // every CTA's lanes are final, and share_max is set
  unsigned before = 0;
  bool has_before = false;
  if (t == 0 && rank > 0) {
    before = key_of(load_cluster(cluster_addr(smem + pad(tile - 1), rank - 1)));
    has_before = true;
  } else if (t == 0 && after_segment) {
    for (unsigned r = 0; r < ctas; ++r) {
      before = max(before, *cluster.map_shared_rank(&share_max, r));
    }
    has_before = true;
  }
#pragma unroll
  for (int v = 0; v < kE; ++v) {
    const unsigned l = t + v * nt;
    if (l < static_cast<unsigned>(tile)) {
      const u64 w = smem[pad(l)];
      const unsigned key = key_of(w);
      const unsigned i = cta_base + l;
      out_sorted[i] = static_cast<long long>(key);
      out_order[i] = static_cast<int>(static_cast<unsigned>(w));
      const bool first = l == 0 ? (!has_before || key != before) : key != key_of(smem[pad(l - 1)]);
      out_head[i] = first ? 1 : 0;
    }
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// One fused group of device-memory stages over the scratch's words, in
// place: a thread per 16-lane set.
__global__ void __launch_bounds__(kThreads) global_kernel(u64* __restrict__ words, int st) {
  const int logk = (st >> 4) & 63, logj = (st >> 10) & 63, m = st >> 16;
  const int lo = logj - (kLogE - 1);
  const unsigned b = group_base(blockIdx.x * kThreads + threadIdx.x, lo);
  Lanes x;
#pragma unroll
  for (int u = 0; u < kE; ++u) x.set(u, words[b + (static_cast<unsigned>(u) << lo)]);
  start_phase(x, b, 1u << lo, logk, logj);
  group_stages(x, m);
#pragma unroll
  for (int u = 0; u < kE; ++u) words[b + (static_cast<unsigned>(u) << lo)] = x.get(u);
}

// Whether a packed step is one this design runs at its level for n keys.
bool valid_step(int st, int log_n) {
  const int level = st & 15, logk = (st >> 4) & 63, logj = (st >> 10) & 63, m = st >> 16;
  if (logk < 1 || logk > log_n || logj >= logk || m < 1 || logj - m + 1 < 0) return false;
  switch (level) {
    case kReg: return logj < kLogWarpLanes && m == logj + 1;  // down to j = 1
    case kSmem: return logj >= kLogWarpLanes && logj < kLogTile && m <= kLogE;
    case kCluster: return logj >= kLogTile && logj < kLogClusterLanes && m <= kLogE;
    case kGlobal: return logj >= kLogTile && m <= kLogE;
    default: return false;
  }
}

// The opt-ins to clusters of 16 CTAs and to kSpreadSmem of dynamic shared
// memory (for the occupancy query only) are attributes of the kernel on
// each device: set them on the first call there only.
cudaError_t opt_in() {
  static std::atomic<bool> opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSpreadSmem);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

}  // namespace

// How many clusters of kMaxCluster CTAs of the kernel the current device
// runs at once with one CTA on each SM, into *clusters: the occupancy
// query for a launch whose shared memory (kSpreadSmem beside the static)
// leaves no room for a second CTA on an SM.  Launches take no dynamic
// shared memory; where the hardware is free to put two CTAs of a cluster
// on one SM, it does, and they share its instruction rate.  Returns the
// cudaError_t (0 = success).
extern "C" int sort_dedup_resident_clusters(int* clusters) {
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster_dim[1];
  cluster_dim[0].id = cudaLaunchAttributeClusterDimension;
  cluster_dim[0].val.clusterDim.x = kMaxCluster;
  cluster_dim[0].val.clusterDim.y = 1;
  cluster_dim[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kMaxCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSpreadSmem;
  config.attrs = cluster_dim;
  config.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, cluster_kernel, &config));
}

// Launches the sort on `stream` by the host's plan: per launch its step
// count, then its steps (a kGlobal step is a launch of its own); the
// first launch reads `keys`, the last writes the three outputs.
// Allocates nothing.  n must be a power of two up to 2^30; `scratch`
// must hold n int64 where the plan has more than one launch and may be
// null otherwise.  Returns the cudaError_t of the first launch that
// failed (0 = success), or cudaErrorInvalidValue for a plan it does not
// run.
extern "C" int sort_dedup_launch(const void* keys, void* sorted, void* order, void* head, int n,
                                 void* scratch, const int* plan, int plan_len, void* stream) {
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || (n & (n - 1)) != 0 || n > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int log_n = 31 - __builtin_clz(static_cast<unsigned>(n));

  // check the whole plan before the first launch
  int launches = 0;
  bool global_last = false;
  for (int p = 0; p < plan_len; ++launches) {
    const int count = plan[p++];
    if (count < 0 || count > kMaxSteps || p + count > plan_len) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    global_last = false;
    for (int s = 0; s < count; ++s) {
      const int st = plan[p + s];
      global_last = (st & 15) == kGlobal;
      if (!valid_step(st, log_n) || (global_last && (count != 1 || launches == 0))) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    p += count;
  }
  if (launches < 1 || global_last || (launches > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = n < kTile ? n : kTile;
  const int ctas = n / tile;
  const int threads = tile / kE < 32 ? 32 : tile / kE;
  cudaLaunchAttribute cluster_dim[1];
  cluster_dim[0].id = cudaLaunchAttributeClusterDimension;
  cluster_dim[0].val.clusterDim.y = 1;
  cluster_dim[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = 0;
  config.stream = s;
  config.attrs = cluster_dim;
  config.numAttrs = 1;

  u64* words = static_cast<u64*>(scratch);
  int p = 0;
  for (int launch = 0; launch < launches; ++launch) {
    const int count = plan[p++];
    if (count == 1 && (plan[p] & 15) == kGlobal) {
      global_kernel<<<n / kTile, kThreads, 0, s>>>(words, plan[p]);
    } else {
      // a launch without cluster steps needs no CTA beside its own
      Steps steps;
      steps.count = count;
      cluster_dim[0].val.clusterDim.x = 1;
      for (int i = 0; i < count; ++i) {
        steps.step[i] = plan[p + i];
        if ((steps.step[i] & 15) == kCluster) {
          cluster_dim[0].val.clusterDim.x = ctas < kMaxCluster ? ctas : kMaxCluster;
        }
      }
      const bool last = launch == launches - 1;
      err = cudaLaunchKernelEx(&config, cluster_kernel,
                               launch == 0 ? static_cast<const long long*>(keys) : nullptr, words,
                               last ? static_cast<long long*>(sorted) : nullptr,
                               last ? static_cast<int*>(order) : nullptr,
                               last ? static_cast<int*>(head) : nullptr, tile, steps);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    p += count;
  }
  return 0;
}
