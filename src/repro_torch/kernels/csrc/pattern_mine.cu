// Per-batch frequent-substructure mining for GraphZip compression,
// hand-written for Hopper (sm_90a) as hash counting in shared memory.
//
// Replaces the TPU kernel repro/kernels/pattern_mine.py::pattern_mine
// (the pl.pallas_call at pattern_mine.py:174, body mine_body at :75).
//
// Two instances, one for each key width of the reference: 64-bit keys
// (pattern_mine_launch) and 32-bit keys (pattern_mine32_launch).  The
// width sets mix_keys (the 64-bit packing-or-hash, or the 32-bit hash),
// the all-ones key, and the key word of the hash tables (8 or 4 bytes a
// slot in shared memory); the design below is the same for both.
//
// For each edge e of a dedup'd batch of n edges (n a power of two):
//   fan_out[e] = #{valid f : tag(src, etype, A1) equal}   (hub fan-out)
//   fan_in[e]  = #{valid f : tag(dst, etype, A2) equal}   (hub fan-in)
//   chain      = dst[e] is the src of some valid edge, and dst != src
//   hot        = count[e] >= hot_min
// flags is the FLAG_* mask of (fan_out >= star_min, fan_in >= star_min,
// chain, hot), psig the signature of the strongest pattern (0 where
// flags is 0), and both fans are 0 on invalid lanes.
//
// The reference sorts three key vectors and binary-searches them,
// because the TPU's vector unit has neither scatter nor atomics.  No
// output depends on an order: the fans are the sizes of groups of equal
// keys, and chain asks whether dst is in the multiset of tails.  So this
// kernel counts in hash tables, O(n) work in one pass, where the sort
// took 91 barrier-separated stages at the path's 8,192 edges.
//
// Design.  Two kernels a call, on the caller's stream.
//   1. pattern_mine_count_kernel: three thread-block clusters of C CTAs,
//      one for each vector: GS, the (src, etype, A1) tag keys; GD, the
//      (dst, etype, A2) tag keys; T, the tails (src).  A cluster holds one
//      open-addressing table of S = 2 max(n, 64) slots (an 8-byte key
//      and a 4-byte count each), spread over its CTAs' shared memory, at
//      most 16,384 slots (192 KB) a CTA.  The host plans C
//      (kernels/pattern_mine.py::cluster_plan): 1 below 2,048 edges, else
//      8 (the portable cluster size); a CTA of up to 1,024 threads takes a
//      lane a thread up to 8,192 edges a CTA, 8 at 65,536.  A cluster's
//      launch costs 2 to 4 us more than a lone CTA's, which rules below
//      2,048 edges; from there spreading the lanes pays although 7 in 8
//      slots are then in another CTA: at the path's 8,192 edges the call
//      took 0.0391 ms with C = 1 and 0.0220 ms with C = 8, at 2,048 edges
//      0.0182 and 0.0162 (tools/k5_plan.py, H100 80GB HBM3 at 700 W).
//      The load is at most 0.5, so every probe ends.
//        a. Each CTA clears its slots; a cluster barrier.
//        b. Each CTA inserts its n / C lanes' keys: slot = the splitmix64
//           finalizer of the key, masked to S, probed linearly across the
//           cluster's slots; a 64-bit atomicCAS claims an empty slot (or
//           finds the key or another one there: one round trip a probe),
//           and in GS and GD an atomicAdd adds to its count.  Equal keys of a
//           warp are merged first (__match_any_sync), so one leader adds
//           their number: a star hub may own thousands of a batch's edges,
//           and each add on its own would serialise on one word.  Slots in
//           another CTA are reached through distributed shared memory.  A
//           cluster barrier.
//        c. Each cluster answers its CTAs' lanes for its vector: GS writes
//           fan_out, GD fan_in (0 on invalid lanes), T a member byte for
//           each lane's dst into the caller's n-byte scratch.
//   2. pattern_mine_flags_kernel: a thread a lane, flags and psig from
//      the two fans, the member byte, count and the thresholds.
//
// Exactness: bit-equal to the plain version (torch.sort plus the
// reference's bisects).  Counts depend on neither the hash, the probe
// order nor the order of the atomics.  The traps:
//   * Empty slots hold the all-ones key, the reference's sentinel.  GS
//     and GD never hold it (mix_keys maps it away), and T never inserts
//     it.  The reference's sorted tails hold the sentinel for every
//     invalid lane, so a dst of all-ones is a member exactly where some
//     lane is invalid or some valid src is all-ones: T's cluster ORs
//     that over its lanes, and such a dst reads the OR.
//   * Key 0 is an ordinary key; no marker uses it.
//   * Past the end.  The reference's upper-bound search runs n's bit
//     length halvings with its probe clipped to [0, n), so for a query at
//     or above the vector's largest key it ends at n + 1, not n (n >= 2).
//     Where some lane is invalid the largest key is the sentinel and no
//     query reaches it; where none is, the lanes holding the largest key
//     get a fan one above their number.  GS and GD reduce "some lane is
//     invalid" and their largest key over the cluster, and add that one.
//
// What bounds it on this card: bytes in principle (src, dst 8 B, etype,
// count 4 B and valid 1 B read, fans and flags 4 B and psig 8 B written:
// 45 B an edge, 0.11 us at the path's 8,192 edges at 3.35 TB/s), in
// practice the latency of two launches, three cluster barriers and the
// round trips of each lane's probes and atomics to (mostly) another SM's
// shared memory, on 24 SMs from 8,192 edges up.  So the 32-bit instance
// (4-byte keys: 33 B an edge) is about as fast as the 64-bit one: 0.0167
// ms against 0.0177 on the 32-bit ingest path's largest batch (8,192
// edges), 0.0122 against 0.0130 at 512 (chip_smoke.py phase 28, the same
// keys zero-extended for the 64-bit instance).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLanes = 1 << 16;
constexpr int kMinLanes = 64;  // the table's floor: S = 2 max(n, 64)
constexpr int kSlotsPerCta = 1 << 14;  // 16,384 x (8 + 4) B = 192 KB
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxTrips = kSlotsPerCta / 2 / kThreads;  // 8 lanes a thread at most
constexpr int kFlagThreads = 256;
constexpr int kMaxDevices = 64;  // devices whose shared-memory opt-in is tracked
constexpr uint64_t kC1 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kC2 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kC3 = 0x94D049BB133111EBull;
constexpr uint32_t kC1_32 = 0x9E3779B9u;
constexpr uint32_t kC2_32 = 0x85EBCA6Bu;
constexpr int kTagStarOut = 0xA1, kTagStarIn = 0xA2, kTagChain = 0xA3, kTagHot = 0xA4;
enum Vector { kGS = 0, kGD = 1, kTails = 2 };

// The empty slot, and the reference's sentinel: the all-ones key.
template <typename K>
constexpr K kEmpty = ~K(0);

// A CTA's reductions, after its slots' keys and counts.
struct Reduced {
  unsigned long long top;  // largest key this CTA inserted (GS, GD)
  unsigned long long all_top;  // ... over the cluster
  unsigned flag;  // some lane is invalid (T: or some valid src is all-ones)
  unsigned all_flag;  // ... over the cluster
};

// Slots of each CTA of a vector's cluster: the table's 2 max(n, 64) over
// its `ctas` CTAs.
__host__ __device__ constexpr int slots_per_cta(int n, int ctas) {
  return 2 * (n > kMinLanes ? n : kMinLanes) / ctas;
}

template <typename K>
constexpr size_t smem_bytes(int slots) {
  return static_cast<size_t>(slots) * (sizeof(K) + sizeof(unsigned)) + sizeof(Reduced);
}

// core/compression.py::mix_keys at 64 bits: exact 27/27/8-bit packing
// when the ids fit, else the splitmix hash with bit 63 set; the sentinel
// and 0 are remapped away.  `dst` is the int64 value as uint64 bits.
__device__ __forceinline__ uint64_t mix_keys(uint64_t src, uint64_t dst, int etype) {
  const uint64_t et = static_cast<uint64_t>(static_cast<int64_t>(etype));
  uint64_t x = src * kC1 + dst;
  x = (x ^ (x >> 30)) * kC2;
  x = x ^ (x >> 27);
  x = x + et;
  const bool fits = src < (1ull << 27) && dst < (1ull << 27) && etype >= 0 && et < (1ull << 8);
  x = fits ? ((1ull << 62) | (src << 35) | (dst << 8) | et) : (x | (1ull << 63));
  if (x == kEmpty<uint64_t>) x = kEmpty<uint64_t> - 1;
  return x == 0 ? 2 : x;
}

// mix_keys at 32 bits: the 32-bit splitmix-style hash alone, in uint32
// arithmetic; the sentinel and 0 are remapped away.
__device__ __forceinline__ uint32_t mix_keys(uint32_t src, uint32_t dst, int etype) {
  uint32_t x = src * kC1_32 + dst;
  x = (x ^ (x >> 30)) * kC2_32;
  x = x ^ (x >> 27);
  x = x + static_cast<uint32_t>(etype);
  if (x == kEmpty<uint32_t>) x = kEmpty<uint32_t> - 1;
  return x == 0 ? 2 : x;
}

// Pattern signature: id x etype x pattern-class tag (etype, converted to
// the key width as the reference's astype does, in the "dst" place).
template <typename K>
__device__ __forceinline__ K tag_key(K id, int etype, int tag) {
  return mix_keys(id, static_cast<K>(static_cast<int64_t>(etype)), tag);
}

// A key's first slot: the splitmix64 finalizer of the key (a 32-bit key
// zero-extended), to be masked to S.
__device__ __forceinline__ unsigned slot_of(uint64_t k) {
  k = (k ^ (k >> 30)) * kC2;
  k = (k ^ (k >> 27)) * kC3;
  return static_cast<unsigned>(k ^ (k >> 31));
}

// Slot s of the cluster's table: in CTA s / spc of the cluster, at s mod
// spc of `base` (this CTA's array of that name).
template <bool kCluster, typename T>
__device__ __forceinline__ T* at(T* base, unsigned s, int log_spc) {
  if constexpr (kCluster) {
    return cg::this_cluster().map_shared_rank(base + (s & ((1u << log_spc) - 1)), s >> log_spc);
  } else {
    return base + s;
  }
}

template <bool kCluster>
__device__ __forceinline__ void sync() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// atomicCAS on a table word of either width.
__device__ __forceinline__ uint64_t cas(uint64_t* p, uint64_t expected, uint64_t key) {
  return atomicCAS(reinterpret_cast<unsigned long long*>(p), expected, key);
}

__device__ __forceinline__ uint32_t cas(uint32_t* p, uint32_t expected, uint32_t key) {
  return atomicCAS(reinterpret_cast<unsigned*>(p), expected, key);
}

// Adds `add` lanes of `key` to the table (to the count where `counted`).
template <typename K, bool kCluster>
__device__ __forceinline__ void insert(K* keys, unsigned* counts, unsigned mask, int log_spc,
                                       K key, unsigned add, bool counted) {
  unsigned s = slot_of(key) & mask;
  for (unsigned probe = 0; probe <= mask; ++probe, s = (s + 1) & mask) {
    const K cur = cas(at<kCluster>(keys, s, log_spc), kEmpty<K>, key);
    if (cur == kEmpty<K> || cur == key) {
      if (counted) atomicAdd(at<kCluster>(counts, s, log_spc), add);
      return;
    }
  }
}

// The slot holding `key`, or -1 where it is not in the table.
template <typename K, bool kCluster>
__device__ __forceinline__ int find(K* keys, unsigned mask, int log_spc, K key) {
  unsigned s = slot_of(key) & mask;
  for (unsigned probe = 0; probe <= mask; ++probe, s = (s + 1) & mask) {
    const K cur = *at<kCluster>(keys, s, log_spc);
    if (cur == key) return static_cast<int>(s);
    if (cur == kEmpty<K>) return -1;
  }
  return -1;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

template <typename K, bool kCluster>
__global__ void __launch_bounds__(kThreads)
pattern_mine_count_kernel(const K* __restrict__ src, const K* __restrict__ dst,
                          const int* __restrict__ etype, const bool* __restrict__ valid, int n,
                          int* __restrict__ fan_out, int* __restrict__ fan_in,
                          uint8_t* __restrict__ member) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr K kNone = kEmpty<K>;
  const int ctas = gridDim.x / 3;  // a 1-D cluster's ranks are consecutive blocks
  const int spc = slots_per_cta(n, ctas);
  K* keys = reinterpret_cast<K*>(smem);
  unsigned* counts = reinterpret_cast<unsigned*>(smem + spc * sizeof(K));
  Reduced* red = reinterpret_cast<Reduced*>(smem + spc * (sizeof(K) + sizeof(unsigned)));
  const int rank = blockIdx.x % ctas;
  const int vec = blockIdx.x / ctas;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int log_spc = __ffs(spc) - 1;
  const unsigned mask = static_cast<unsigned>(spc) * ctas - 1;
  const int lanes = n / ctas, first = rank * lanes;
  const int trips = (lanes + nt - 1) / nt;

  // a. clear this CTA's slots
  for (int s = tid; s < spc; s += nt) {
    keys[s] = kNone;
    counts[s] = 0;
  }
  if (tid == 0) {
    red->top = 0;
    red->flag = 0;
  }
  sync<kCluster>();

  // b. this CTA's lanes' keys, then their inserts
  K mine[kMaxTrips];
  bool flag = false;
  unsigned long long top = 0;
#pragma unroll
  for (int t = 0; t < kMaxTrips; ++t) {
    mine[t] = kNone;
    const int l = t * nt + tid;
    if (t < trips && l < lanes) {
      const int i = first + l;
      const bool v = valid[i];
      if (vec == kTails) {
        const K s = src[i];
        flag |= !v || s == kNone;
        mine[t] = v ? s : kNone;  // the all-ones tail is never inserted
      } else {
        flag |= !v;
        if (v) {
          mine[t] = vec == kGS ? tag_key<K>(src[i], etype[i], kTagStarOut)
                               : tag_key<K>(dst[i], etype[i], kTagStarIn);
          top = max(top, static_cast<unsigned long long>(mine[t]));
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxTrips; ++t) {
    if (t < trips) {  // uniform over the block: every thread of a warp takes part
      const K key = mine[t];
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      if (key != kNone && (tid & 31) == __ffs(peers) - 1) {
        insert<K, kCluster>(keys, counts, mask, log_spc, key, __popc(peers), vec != kTails);
      }
    }
  }
  top = warp_max(top);
  if ((tid & 31) == 0 && top != 0) atomicMax(&red->top, top);
  if (flag) red->flag = 1;
  sync<kCluster>();
  if (tid < 32) {  // thread r reads CTA r's reductions, all at once
    unsigned long long t = 0;
    unsigned f = 0;
    if (tid < ctas) {
      const Reduced* r = red;
      if constexpr (kCluster) r = cg::this_cluster().map_shared_rank(red, tid);
      t = r->top;
      f = r->flag;
    }
    t = warp_max(t);
    f = __any_sync(0xffffffffu, f != 0);
    if (tid == 0) {
      red->all_top = t;
      red->all_flag = f;
    }
  }
  __syncthreads();

  // c. answer this CTA's lanes
  const unsigned long long all_top = red->all_top;
  const bool any_flag = red->all_flag != 0;
  const bool past_end = n >= 2 && !any_flag;  // GS, GD: no lane is invalid
#pragma unroll
  for (int t = 0; t < kMaxTrips; ++t) {
    const int l = t * nt + tid;
    if (t < trips && l < lanes) {
      const int i = first + l;
      if (vec == kTails) {
        const K d = dst[i];
        member[i] = d == kNone ? any_flag : find<K, kCluster>(keys, mask, log_spc, d) >= 0;
      } else {
        const K key = mine[t];
        int fan = 0;
        if (key != kNone) {
          const int s = find<K, kCluster>(keys, mask, log_spc, key);
          fan = s < 0 ? 0 : static_cast<int>(*at<kCluster>(counts, s, log_spc));
          fan += past_end && key == all_top;
        }
        (vec == kGS ? fan_out : fan_in)[i] = fan;
      }
    }
  }
  // no CTA leaves while another may still read its slots
  if constexpr (kCluster) cg::this_cluster().sync();
}

template <typename K>
__global__ void __launch_bounds__(kFlagThreads)
pattern_mine_flags_kernel(const K* __restrict__ src, const K* __restrict__ dst,
                          const int* __restrict__ etype, const int* __restrict__ count,
                          const bool* __restrict__ valid, int n, int star_min, int hot_min,
                          const int* __restrict__ fan_out, const int* __restrict__ fan_in,
                          const uint8_t* __restrict__ member, int* __restrict__ flags,
                          K* __restrict__ psig) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  if (!valid[e]) {
    flags[e] = 0;
    psig[e] = 0;
    return;
  }
  const K s = src[e], d = dst[e];
  const int et = etype[e];
  const bool chain = member[e] != 0 && d != s;
  const bool staro = fan_out[e] >= star_min, stari = fan_in[e] >= star_min;
  const bool hot = count[e] >= hot_min;
  K sig = 0;
  if (staro) {
    sig = tag_key<K>(s, et, kTagStarOut);
  } else if (stari) {
    sig = tag_key<K>(d, et, kTagStarIn);
  } else if (chain) {
    sig = tag_key<K>(d, et, kTagChain);
  } else if (hot) {
    sig = tag_key<K>(s, et, kTagHot);
  }
  flags[e] = (staro ? 1 : 0) + (stari ? 2 : 0) + (chain ? 4 : 0) + (hot ? 8 : 0);
  psig[e] = sig;
}

// The opt-in above 48 KB of dynamic shared memory is an attribute of
// each kernel on each device: set it on the first call there only.  The
// count kernel declares no static shared memory (F17).  Each key width
// keeps its own record.
template <typename K>
cudaError_t opt_in() {
  static std::atomic<bool> opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device].load(std::memory_order_acquire)) {
    const int bytes = static_cast<int>(smem_bytes<K>(kSlotsPerCta));
    err = cudaFuncSetAttribute(pattern_mine_count_kernel<K, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(pattern_mine_count_kernel<K, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// Launches the miner of K keys on `stream` with `ctas` CTAs in each
// vector's cluster (kernels/pattern_mine.py::cluster_plan); allocates
// nothing.  n must be a power of two up to 65,536 and `ctas` a power of
// two up to 8 that divides n and leaves each CTA at most 16,384 slots and
// 8 lanes a thread; `member` is an n-byte scratch.  Returns the
// cudaError_t of the first launch that failed (0 = success), or
// cudaErrorInvalidValue for a shape or plan it does not run.
template <typename K>
int launch_miner(const void* src, const void* dst, const void* etype, const void* count,
                 const void* valid, int n, int star_min, int hot_min, int ctas, void* fan_out,
                 void* fan_in, void* flags, void* psig, void* member, void* stream) {
  if (n < 1 || (n & (n - 1)) != 0 || n > kMaxLanes || ctas < 1 || ctas > kMaxCluster ||
      (ctas & (ctas - 1)) != 0 || n % ctas != 0 || slots_per_cta(n, ctas) > kSlotsPerCta ||
      n / ctas > kMaxTrips * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = opt_in<K>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes = n / ctas;
  const int threads = lanes < 32 ? 32 : (lanes < kThreads ? lanes : kThreads);
  const size_t smem = smem_bytes<K>(slots_per_cta(n, ctas));
  const K* sk = static_cast<const K*>(src);
  const K* dk = static_cast<const K*>(dst);
  const int* et = static_cast<const int*>(etype);
  const bool* v = static_cast<const bool*>(valid);
  int* fo = static_cast<int*>(fan_out);
  int* fi = static_cast<int*>(fan_in);
  uint8_t* mem = static_cast<uint8_t*>(member);
  if (ctas == 1) {
    pattern_mine_count_kernel<K, false><<<3, threads, smem, s>>>(sk, dk, et, v, n, fo, fi, mem);
  } else {
    cudaLaunchAttribute cluster_dim[1];
    cluster_dim[0].id = cudaLaunchAttributeClusterDimension;
    cluster_dim[0].val.clusterDim.x = ctas;
    cluster_dim[0].val.clusterDim.y = 1;
    cluster_dim[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(3 * ctas);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.stream = s;
    config.attrs = cluster_dim;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, pattern_mine_count_kernel<K, true>, sk, dk, et, v, n, fo,
                             fi, mem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pattern_mine_flags_kernel<K><<<(n + kFlagThreads - 1) / kFlagThreads, kFlagThreads, 0, s>>>(
      sk, dk, et, static_cast<const int*>(count), v, n, star_min, hot_min, fo, fi, mem,
      static_cast<int*>(flags), static_cast<K*>(psig));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The miner of 64-bit keys: see launch_miner.
extern "C" int pattern_mine_launch(const void* src, const void* dst, const void* etype,
                                   const void* count, const void* valid, int n, int star_min,
                                   int hot_min, int ctas, void* fan_out, void* fan_in,
                                   void* flags, void* psig, void* member, void* stream) {
  return launch_miner<uint64_t>(src, dst, etype, count, valid, n, star_min, hot_min, ctas,
                                fan_out, fan_in, flags, psig, member, stream);
}

// The miner of 32-bit keys (4-byte keys in the hash tables): see
// launch_miner.
extern "C" int pattern_mine32_launch(const void* src, const void* dst, const void* etype,
                                     const void* count, const void* valid, int n, int star_min,
                                     int hot_min, int ctas, void* fan_out, void* fan_in,
                                     void* flags, void* psig, void* member, void* stream) {
  return launch_miner<uint32_t>(src, dst, etype, count, valid, n, star_min, hot_min, ctas,
                                fan_out, fan_in, flags, psig, member, stream);
}

