// Fused lookup-or-insert for an open-addressing hash table (Algorithm 3
// GRAPHPUSH commit hot path), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/upsert.py::fused_upsert (the
// pl.pallas_call at upsert.py:104, body upsert_sweep at :42).
//
// Two instances, one for each key width of the reference: 64-bit keys
// (fused_upsert_launch) and 32-bit keys (fused_upsert32_launch).  The
// width sets the table word, the key a CTA holds in shared memory (8 or
// 4 bytes) and the probe's golden-ratio multiplier (0x9E3779B97F4A7C15
// in uint64, 0x9E3779B9 in uint32, as the reference's probe_hash); the
// schedule below is the same for both.
//
// Semantics are the reference's round-synchronous sweep, bit for bit.
// In probe round i every live lane reads table[probe(key, i)] as it
// stood BEFORE the round; a lane that finds its key is placed, a lane
// that finds the slot empty (0) claims it with an unsigned max
// and checks back (the lane whose key is in the slot won it, new), and
// every other lane probes on.  Key 0 reads an empty slot as its own
// key: it is placed there even where a larger key won the claim (not
// new).  Duplicate keys of a batch both win one slot, both new.  A lane
// still live after the budget is dropped (slot -1).
//
// What bounded the first design (one CTA of 1,024 threads striding over
// all n lanes, their state in device memory, three block barriers a
// round): the round, not bytes.  A sweep moves about 14 bytes a lane
// plus 8 a probe, well under a microsecond at 3.35 TB/s, but every round
// touched all n lanes whether live or not.  At 16,384 lanes (NVIDIA H100
// 80GB HBM3, 700 W) it took 0.052 ms at load 0, 0.27 ms at load 0.5 and
// 1.33 ms at load 0.85 with 128 probes: 3.6 to 8.7 us a round even where
// almost no lane was live, about half that at 8,192 lanes.
//
// Design.
//   * Round 0 runs from registers: a thread owns lanes tid, tid + T, ...
//     and keeps kChunk of them in flight (key, validity, candidate, table
//     word), so their L2 reads overlap; a CTA with no more lanes than
//     threads runs a one-lane body.  Placed and invalid lanes write slot
//     and is_new at once: every lane's outputs are written once, when it
//     is resolved.
//   * Live lanes go to a worklist in shared memory: a 16-bit code a lane
//     (the index of its key, which the CTA keeps in shared memory; bit 15
//     set where its claim is pending), compacted by warp ballots and one
//     shared atomicAdd a warp.  Later rounds touch only the worklist; a
//     warp past its end leaves the phase at once, and a worklist of at
//     most an entry a thread runs the one-entry body.
//   * Two barriers a round.  Round i's check-back and round i+1's read
//     see the same table: every claim of round i has landed (barrier 2)
//     and no claim of round i+1 has been issued (they wait for barrier
//     1).  So one phase (A) checks back round i's claimants and reads
//     round i+1's slot for the losers and the misses, and the claims
//     make the other phase (B):
//        A(0) | barrier 1 | B(0) | barrier 2 | A(1) | barrier 1 | B(1) ...
//     Every read of round i+1 thus sees the table after all of round
//     i's claims and before any of round i+1's: the reference's
//     pre-round read.  After barrier 1 the worklists' counts say whether
//     any lane is live, and the loop ends there.  The round that
//     exhausts the budget checks back and drops the rest.  Table reads
//     are strong gpu-scope loads (ld.relaxed.gpu, past L1 as __ldcg) and
//     claims atomicMax, so every table access resolves in L2 and the
//     barriers' ordering holds within the memory model.
//   * One CTA or a cluster, by a host plan (kernels/upsert.py::
//     cluster_plan; n is a tensor shape, so no sync): one CTA below
//     4,096 lanes, else 8 (16 above 131,072).  A CTA takes at most
//     16,384 lanes (16 a thread).  A cluster splits the lanes over its
//     CTAs, its barriers are barrier.cluster (arrive.release /
//     wait.acquire: a claim of one CTA is seen by another's read after
//     it), and lane r of each warp reads CTA r's count through
//     distributed shared memory.  Once at most 2,048 lanes are live, the
//     CTAs copy their worklists and keys into CTA 0's shared memory and
//     leave, and CTA 0 runs the tail rounds alone on block barriers: a
//     cluster barrier costs several times a block barrier, and the tail
//     of a loaded table runs for up to the whole budget.
//
// What the card measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// phase 1 and tools/k1_plan.py).  At the main path's node sweep (16,384
// lanes, load 0, budget 32) 0.0173 ms under the plan (8 CTAs), 0.040
// with one CTA; at load 0.5 0.060, at 0.85 with budget 128 0.285; the
// edge sweep (8,192 lanes, load 0) 0.0138.  One thread's dependent load
// through an 8 MB table takes about 330 cycles (170 ns), so a sweep of
// R rounds cannot take less than R of them; a tail round (budget 64 to
// 128 at loads 0.7 and 0.85) costs 0.9 to 1.4 us, 5 to 8 of them, where
// the first design paid 3.6 to 8.7.  Below 4,096 lanes one CTA beats
// every cluster, whose launch costs 2 to 4 us more.  The 32-bit instance
// (chip_smoke.py phase 28, against the 64-bit one on the same keys
// zero-extended) took 0.0169 ms at the node sweep (0.0161), 0.111 at
// load 0.7 with budget 64 (0.117) and 0.0069 at 512 lanes (0.0078):
// half the key bytes buy little where rounds' round trips bound the
// sweep.  PERF.md (section 6) has the rest.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxLanesPerThread = 16;
constexpr int kMaxCtaLanes = kMaxThreads * kMaxLanesPerThread;  // 16,384
constexpr int kMaxCluster = 16;  // a non-portable size, opted in below
constexpr int kChunk = 4;  // lanes (or worklist entries) a thread has in flight
constexpr int kHandOver = 2048;  // live lanes at which a cluster hands them to CTA 0
constexpr int kHeader = 16;  // two int counts, padded for the keys
constexpr unsigned short kClaim = 0x8000;  // a pending claim (keys held < 2^15)
constexpr unsigned short kLane = 0x7FFF;
constexpr unsigned short kNone = 0xFFFF;  // not on the worklist
constexpr int kMaxDevices = 64;  // devices whose attributes are tracked

// The probe's golden-ratio multiplier at each key width.
template <typename K>
struct Golden;
template <>
struct Golden<unsigned long long> {
  static constexpr unsigned long long kMul = 0x9E3779B97F4A7C15ull;
};
template <>
struct Golden<unsigned> {
  static constexpr unsigned kMul = 0x9E3779B9u;
};

template <typename K>
constexpr size_t smem_bytes(int cta_lanes, int extra) {
  // keys (8 or 4 B) and two worklists (2 B each) a lane held, and the
  // global lane (4 B) of each lane taken over
  return kHeader + static_cast<size_t>(cta_lanes + extra) * (sizeof(K) + 4) +
         static_cast<size_t>(extra) * sizeof(int);
}

// Low 32 bits of h ^ (h >> 16) with h = key * golden at the key's width
// (logical shift): the probe start, before the round number is added in
// uint32.
template <typename K>
__device__ __forceinline__ unsigned probe_base(K key) {
  const K h = key * Golden<K>::kMul;
  return static_cast<unsigned>(h ^ (h >> 16));
}

__device__ __forceinline__ unsigned probe_at(unsigned base, int i, unsigned cap, bool pow2) {
  const unsigned x = base + static_cast<unsigned>(i);
  return pow2 ? (x & (cap - 1)) : x % cap;
}

// A table word as L2 holds it: a strong (relaxed, gpu-scope) load, which
// bypasses L1, so the barriers order it after every CTA's claims.
__device__ __forceinline__ unsigned long long load_l2(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned load_l2(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Appends the codes of a thread's kC entries (kNone: not on the
// worklist) to worklist q of count *count with one shared atomicAdd a
// warp.  Every thread of the warp calls it.
template <int kC>
__device__ __forceinline__ void enqueue(unsigned short* q, int* count,
                                        const unsigned short (&code)[kC]) {
  unsigned ballot[kC];
  int total = 0;
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    ballot[j] = __ballot_sync(0xffffffffu, code[j] != kNone);
    total += __popc(ballot[j]);
  }
  if (total == 0) return;
  const unsigned r = threadIdx.x & 31, below = (1u << r) - 1;
  int at = 0;
  if (r == 0) at = atomicAdd(count, total);
  at = __shfl_sync(0xffffffffu, at, 0);
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    if (code[j] != kNone) q[at + __popc(ballot[j] & below)] = code[j];
    at += __popc(ballot[j]);
  }
}

// What every phase of a CTA uses: the table, the outputs, and the keys
// the CTA holds (its own lanes', then those taken over from the cluster).
template <typename K>
struct Sweep {
  K* table;
  unsigned cap;
  bool pow2;
  int* slot;
  bool* is_new;
  K* key;
  const int* taken;
  int cta_lanes, first;

  __device__ __forceinline__ unsigned at(unsigned base, int i) const {
    return probe_at(base, i, cap, pow2);
  }
  // the global lane of the key held at `held`
  __device__ __forceinline__ int lane_of(int held) const {
    return held < cta_lanes ? first + held : taken[held - cta_lanes];
  }
  __device__ __forceinline__ void finish(int g, int s, bool nw) const {
    slot[g] = s;
    is_new[g] = nw;
  }
};

// A(i + 1) over worklist q of m entries: round i's claimants check back,
// and losers and misses read round i+1's slot; the lanes still live go to
// worklist nq.  A thread keeps kC entries in flight.
template <typename K, int kC>
__device__ __forceinline__ void check_back_and_read(const Sweep<K>& s, const unsigned short* q,
                                                    int m, int i, bool last,
                                                    unsigned short* nq, int* ncount) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e0 = 0; e0 < m; e0 += nt * kC) {
    // a warp whose first entry is past the worklist has none here or
    // later: in a tail round all but a few warps leave at once
    if (e0 + (tid & ~31) >= m) break;
    K key[kC], got[kC];
    unsigned short code[kC], next[kC];
    unsigned base[kC];
    bool reads[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int e = e0 + j * nt + tid;
      code[j] = e < m ? q[e] : kNone;
      key[j] = code[j] != kNone ? s.key[code[j] & kLane] : K(0);
      base[j] = code[j] != kNone ? probe_base(key[j]) : 0u;
    }
    // one read each: a claimant's check-back, or a miss's next slot
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const bool claim = code[j] != kNone && (code[j] & kClaim);
      reads[j] = code[j] != kNone && !claim && !last;
      got[j] = 0;
      if (claim || reads[j]) got[j] = load_l2(s.table + s.at(base[j], claim ? i : i + 1));
    }
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      if (code[j] == kNone) continue;
      const int g = s.lane_of(code[j] & kLane);
      if (code[j] & kClaim) {
        const int c = static_cast<int>(s.at(base[j], i));
        if (got[j] == key[j]) {
          s.finish(g, c, true);
        } else if (key[j] == 0) {  // read the empty slot as its own key
          s.finish(g, c, false);
        } else if (last) {
          s.finish(g, -1, false);
        } else {
          reads[j] = true;  // lost: reads round i+1's slot below
          got[j] = load_l2(s.table + s.at(base[j], i + 1));
        }
      } else if (last) {
        s.finish(g, -1, false);
      }
    }
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      next[j] = kNone;
      if (reads[j]) {
        const unsigned short l = code[j] & kLane;
        if (got[j] == 0) {
          next[j] = l | kClaim;
        } else if (got[j] == key[j]) {
          s.finish(s.lane_of(l), static_cast<int>(s.at(base[j], i + 1)), false);
        } else {
          next[j] = l;
        }
      }
    }
    enqueue<kC>(nq, ncount, next);
  }
}

// A(0): round 0's read of the CTA's lanes, from registers: a thread owns
// lanes tid, tid + T, ... and keeps kC of them in flight.  Placed and
// invalid lanes are finished; the others go to worklist q with their keys.
template <typename K, int kC>
__device__ __forceinline__ void read_round0(const Sweep<K>& s, const K* __restrict__ keys,
                                            const bool* __restrict__ valid, int lanes,
                                            unsigned short* q, int* count) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int l0 = 0; l0 < lanes; l0 += nt * kC) {
    K key[kC], cur[kC];
    unsigned cand[kC];
    unsigned short code[kC];
    bool live[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int l = l0 + j * nt + tid;
      key[j] = l < lanes ? keys[s.first + l] : K(0);  // side by side with valid
      live[j] = l < lanes && valid[s.first + l];
      cand[j] = s.at(probe_base(key[j]), 0);
    }
#pragma unroll
    for (int j = 0; j < kC; ++j) cur[j] = live[j] ? load_l2(s.table + cand[j]) : K(0);
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int l = l0 + j * nt + tid;
      code[j] = kNone;
      if (l < lanes) {
        if (!live[j]) {
          s.finish(s.first + l, -1, false);
        } else if (cur[j] == 0) {
          code[j] = static_cast<unsigned short>(l) | kClaim;
        } else if (cur[j] == key[j]) {
          s.finish(s.first + l, static_cast<int>(cand[j]), false);
        } else {
          code[j] = static_cast<unsigned short>(l);
        }
        if (code[j] != kNone) s.key[l] = key[j];
      }
    }
    enqueue<kC>(q, count, code);
  }
}

template <typename K, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
fused_upsert_kernel(K* __restrict__ table, unsigned cap, const K* __restrict__ keys,
                    const bool* __restrict__ valid, int n, int cta_lanes, int extra,
                    const int* __restrict__ n_probes, int* __restrict__ slot,
                    bool* __restrict__ is_new) {
  // shared memory: two counts; a key for each of the CTA's lanes and for
  // `extra` lanes taken over from the cluster; two worklists of codes;
  // the global index of each lane taken over
  extern __shared__ __align__(16) unsigned char smem[];
  const int keys_held = cta_lanes + extra;
  int* count = reinterpret_cast<int*>(smem);
  K* skey = reinterpret_cast<K*>(smem + kHeader);
  unsigned short* q0 = reinterpret_cast<unsigned short*>(skey + keys_held);
  unsigned short* q1 = q0 + keys_held;
  int* taken = reinterpret_cast<int*>(q1 + keys_held);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int first = blockIdx.x * cta_lanes;  // a 1-D cluster's ranks are its blocks
  const int lanes = max(0, min(cta_lanes, n - first));
  const int budget = *n_probes;
  const Sweep<K> s{table, cap, (cap & (cap - 1)) == 0, slot, is_new, skey, taken, cta_lanes,
                   first};

  if (tid == 0) count[0] = count[1] = 0;
  __syncthreads();
  if (budget <= 0) {  // uniform: no round, every lane dropped
    for (int l = tid; l < lanes; l += nt) s.finish(first + l, -1, false);
    return;
  }
  // A(0): a lane a thread where the CTA has no more lanes than threads
  if (lanes > nt) {
    read_round0<K, kChunk>(s, keys, valid, lanes, q0, count);
  } else {
    read_round0<K, 1>(s, keys, valid, lanes, q0, count);
  }

  int p = 0;
  bool clustered = kCluster;  // until the cluster hands its lanes to CTA 0
  for (int i = 0;; ++i) {
    // barrier 1: round i's reads are done, worklist p is whole
    if (kCluster && clustered) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
    int m = count[p];
    unsigned short* q = p ? q1 : q0;
    if (kCluster && clustered) {
      // lane r of each warp reads CTA r's count
      cg::cluster_group cluster = cg::this_cluster();
      const unsigned r = threadIdx.x & 31, rank = cluster.block_rank();
      const int c = r < cluster.num_blocks() ? *cluster.map_shared_rank(count + p, r) : 0;
      const int total = __reduce_add_sync(0xffffffffu, c);
      if (total == 0) {
        cluster.sync();  // no CTA leaves while another may still read its count
        return;
      }
      if (total <= kHandOver) {
        // hand the worklists to CTA 0: rank k's entries follow those of
        // the ranks below it, their keys and lanes after CTA 0's own
        const int at = __reduce_add_sync(0xffffffffu, r < rank ? c : 0);
        const int own = __shfl_sync(0xffffffffu, c, 0);
        if (rank != 0) {
          K* key0 = cluster.map_shared_rank(skey, 0);
          unsigned short* q_0 = cluster.map_shared_rank(q, 0);
          int* taken0 = cluster.map_shared_rank(taken, 0);
          for (int e = tid; e < m; e += nt) {
            const unsigned short code = q[e];
            const int l = code & kLane;
            const int held = cta_lanes + at - own + e;
            key0[held] = skey[l];
            taken0[held - cta_lanes] = first + l;
            q_0[at + e] = static_cast<unsigned short>(held) | (code & kClaim);
          }
        }
        cluster.sync();  // CTA 0 holds every live lane; no CTA reads another's memory
        if (rank != 0) return;
        clustered = false;
        m = total;
      }
    } else if (m == 0) {
      return;
    }
    unsigned short* nq = p ? q0 : q1;

    // B(i): the claims, largest key wins
    for (int e = tid; e < m; e += nt) {
      const unsigned short code = q[e];
      if (code & kClaim) {
        const K key = skey[code & kLane];
        atomicMax(table + s.at(probe_base(key), i), key);
      }
    }
    if (tid == 0) count[p ^ 1] = 0;
    // barrier 2: every claim of round i has landed
    if (kCluster && clustered) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }

    // A(i + 1): round i's check-back and round i+1's read; a tail round
    // (an entry a thread at most) runs the one-entry body
    const bool last = i + 1 >= budget;
    if (m > nt) {
      check_back_and_read<K, kChunk>(s, q, m, i, last, nq, count + (p ^ 1));
    } else {
      check_back_and_read<K, 1>(s, q, m, i, last, nq, count + (p ^ 1));
    }
    if (last) return;  // no CTA reads another's memory after barrier 2
    p ^= 1;
  }
}

// The opt-ins are attributes of each kernel on each device: set them on
// the first call there only (each key width keeps its own record).
template <typename K>
cudaError_t opt_in() {
  static std::atomic<bool> opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device].load(std::memory_order_acquire)) {
    const int bytes = static_cast<int>(smem_bytes<K>(kMaxCtaLanes, kHandOver));
    err = cudaFuncSetAttribute(fused_upsert_kernel<K, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fused_upsert_kernel<K, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fused_upsert_kernel<K, true>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// Launches the sweep of K keys on `stream` as one cluster of `ctas` CTAs
// (1: a lone CTA), each taking ceil(n / ctas) lanes, at most 16,384;
// allocates nothing.  Returns the cudaError_t of the launch (0 =
// success), or cudaErrorInvalidValue for a plan it does not run.
template <typename K>
int launch_sweep(void* table, int cap, const void* keys, const void* valid, int n,
                 const void* n_probes, int ctas, void* slot, void* is_new, void* stream) {
  if (n < 0 || cap < 1 || ctas < 1 || ctas > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cta_lanes = (n + ctas - 1) / ctas;
  if (cta_lanes > kMaxCtaLanes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in<K>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = cta_lanes >= kMaxThreads ? kMaxThreads : ((cta_lanes + 31) / 32) * 32;
  const int block = threads < 32 ? 32 : threads;
  const int extra = ctas > 1 ? kHandOver : 0;
  const size_t smem = smem_bytes<K>(cta_lanes, extra);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  K* t = static_cast<K*>(table);
  const unsigned c = static_cast<unsigned>(cap);
  const K* k = static_cast<const K*>(keys);
  const bool* v = static_cast<const bool*>(valid);
  const int* probes = static_cast<const int*>(n_probes);
  int* sl = static_cast<int*>(slot);
  bool* nw = static_cast<bool*>(is_new);
  if (ctas == 1) {
    fused_upsert_kernel<K, false><<<1, block, smem, s>>>(t, c, k, v, n, cta_lanes, extra, probes,
                                                          sl, nw);
  } else {
    cudaLaunchAttribute cluster_dim[1];
    cluster_dim[0].id = cudaLaunchAttributeClusterDimension;
    cluster_dim[0].val.clusterDim.x = ctas;
    cluster_dim[0].val.clusterDim.y = 1;
    cluster_dim[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(ctas);
    config.blockDim = dim3(block);
    config.dynamicSmemBytes = smem;
    config.stream = s;
    config.attrs = cluster_dim;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, fused_upsert_kernel<K, true>, t, c, k, v, n, cta_lanes,
                             extra, probes, sl, nw);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The sweep of 64-bit keys (uint64 table words): see launch_sweep.
extern "C" int fused_upsert_launch(void* table, int cap, const void* keys, const void* valid,
                                   int n, const void* n_probes, int ctas, void* slot,
                                   void* is_new, void* stream) {
  return launch_sweep<unsigned long long>(table, cap, keys, valid, n, n_probes, ctas, slot,
                                          is_new, stream);
}

// The sweep of 32-bit keys (uint32 table words, 4-byte keys in shared
// memory): see launch_sweep.
extern "C" int fused_upsert32_launch(void* table, int cap, const void* keys, const void* valid,
                                     int n, const void* n_probes, int ctas, void* slot,
                                     void* is_new, void* stream) {
  return launch_sweep<unsigned>(table, cap, keys, valid, n, n_probes, ctas, slot, is_new,
                                stream);
}
