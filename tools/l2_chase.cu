// One thread's dependent loads through a table in device memory: the
// round trip that bounds a round of the fused upsert (K1).  Built and
// run by tools/k1_plan.py.
//
// chase_launch walks `hops` loads from slot 0 of `next`, each load's
// value the next slot, with the load K1 uses for its table
// (ld.relaxed.gpu: strong, gpu scope, past L1; flavour 0), __ldcg's
// ld.global.cg (1) or a plain load (2), and writes the clock64 cycles
// of the walk and its last slot to out[0] and out[1].

#include <cuda_runtime.h>

namespace {

__global__ void chase_kernel(const unsigned long long* next, int hops, int flavour,
                             long long* out) {
  unsigned long long i = 0;
  const long long t0 = clock64();
  for (int h = 0; h < hops; ++h) {
    const unsigned long long* p = next + i;
    if (flavour == 0) {
      asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(i) : "l"(p));
    } else if (flavour == 1) {
      asm volatile("ld.global.cg.u64 %0, [%1];" : "=l"(i) : "l"(p));
    } else {
      asm volatile("ld.global.u64 %0, [%1];" : "=l"(i) : "l"(p));
    }
  }
  out[0] = clock64() - t0;
  out[1] = static_cast<long long>(i);
}

}  // namespace

extern "C" int chase_launch(const void* next, int hops, int flavour, void* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(next), hops, flavour, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
