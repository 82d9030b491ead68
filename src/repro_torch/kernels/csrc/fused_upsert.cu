// Fused lookup-or-insert for an open-addressing hash table (Algorithm 3
// GRAPHPUSH commit hot path), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/upsert.py::fused_upsert (the
// pl.pallas_call at upsert.py:104, body upsert_sweep at :42).
//
// Semantics are the reference's round-synchronous sweep, bit for bit.
// In probe round i every live lane
//   1. reads table[cand] as it stood BEFORE the round,
//   2. if the slot was empty (0), claims it with an unsigned scatter-max,
//   3. checks back: the lane whose key is in the slot won it.
// A lane that hit its own key or won a claim is placed; the others probe
// on.  A grid of many blocks that read and claim in one pass would let a
// lane see another lane's claim from the same round and skip a slot the
// larger key should have won, so the phases are separated by block-wide
// barriers over ALL lanes: the kernel runs as ONE block of 1,024 threads
// that strides over the lanes.
//
// What bounds it on this card: neither bytes nor operations.  A sweep
// moves about 13 bytes per lane plus one 8-byte table slot per probe,
// a few hundred KB at the main path's 16,384 lanes, which the card's
// 3.35 TB/s would move in well under a microsecond.  The kernel instead
// waits on latency: up to n_probes rounds, each with three barriers and
// a dependent L2 round trip (read, atomic, read back), on one of the 132
// SMs.  The design accepts that for now (it is correct, and the commit
// path launches it twice per batch); it keeps every table access in L2
// (__ldcg, atomics resolve in L2) so a read-back never sees a stale L1
// line, leaves the loop as soon as no lane is live (__syncthreads_or),
// and reads the probe budget from device memory so the host never waits
// for it.  A faster design is later work.
//
// Per-lane state lives in the output arrays themselves (global memory,
// touched only by the thread that owns the lane): at 16,384 lanes it
// fits neither in 227 KB of shared memory nor in the 64 registers a
// thread of a 1,024-thread block may hold.  slot[lane] encodes it:
//   >= 0   placed at that slot
//   == -1  still probing (or an invalid lane, which never probes)
//   <= -2  claim pending on slot (-2 - value) in the current round

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned long long kProbeMul = 0x9E3779B97F4A7C15ull;

// Low 32 bits of h ^ (h >> 16) with h = key * golden (logical shift):
// the probe start, before the round number is added in uint32.
__device__ __forceinline__ unsigned int probe_base(unsigned long long key) {
  const unsigned long long h = key * kProbeMul;
  return static_cast<unsigned int>(h ^ (h >> 16));
}

__global__ void __launch_bounds__(kThreads)
fused_upsert_kernel(unsigned long long* __restrict__ table, unsigned int cap,
                    const unsigned long long* __restrict__ keys,
                    const bool* __restrict__ valid, int n,
                    const int* __restrict__ n_probes,
                    int* __restrict__ slot, bool* __restrict__ is_new) {
  const int budget = *n_probes;
  bool live = false;
  for (int lane = threadIdx.x; lane < n; lane += kThreads) {
    slot[lane] = -1;
    is_new[lane] = false;
    live |= valid[lane];
  }
  if (!__syncthreads_or(live)) return;

  for (int i = 0; i < budget; ++i) {
    // phase 1: read the pre-round table; hits are placed at once
    for (int lane = threadIdx.x; lane < n; lane += kThreads) {
      if (!valid[lane] || slot[lane] != -1) continue;
      const unsigned long long key = keys[lane];
      const unsigned int cand = (probe_base(key) + static_cast<unsigned int>(i)) % cap;
      const unsigned long long cur = __ldcg(table + cand);
      if (cur == 0) {
        slot[lane] = -2 - static_cast<int>(cand);  // claim pending
      } else if (cur == key) {
        slot[lane] = static_cast<int>(cand);  // hit
      }
    }
    __syncthreads();
    // phase 2: empties claim by unsigned max (the largest key wins)
    for (int lane = threadIdx.x; lane < n; lane += kThreads) {
      const int s = slot[lane];
      if (s <= -2) atomicMax(table + (-2 - s), keys[lane]);
    }
    __syncthreads();
    // phase 3: claimers check back
    live = false;
    for (int lane = threadIdx.x; lane < n; lane += kThreads) {
      if (!valid[lane]) continue;
      const int s = slot[lane];
      if (s <= -2) {
        const int cand = -2 - s;
        const unsigned long long key = keys[lane];
        if (__ldcg(table + cand) == key) {
          slot[lane] = cand;
          is_new[lane] = true;
        } else if (key == 0) {
          // key 0 read the empty slot as its own key: the reference
          // counts that as a hit even when a larger key won the claim
          slot[lane] = cand;
        } else {
          slot[lane] = -1;
          live = true;
        }
      } else if (s == -1) {
        live = true;
      }
    }
    if (!__syncthreads_or(live)) break;
  }
}

}  // namespace

// Launches the sweep on `stream`; allocates nothing.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int fused_upsert_launch(void* table, int cap, const void* keys,
                                   const void* valid, int n, const void* n_probes,
                                   void* slot, void* is_new, void* stream) {
  fused_upsert_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(table), static_cast<unsigned int>(cap),
      static_cast<const unsigned long long*>(keys), static_cast<const bool*>(valid), n,
      static_cast<const int*>(n_probes), static_cast<int*>(slot),
      static_cast<bool*>(is_new));
  return static_cast<int>(cudaGetLastError());
}
