// Shared pieces of the kernels: the coder's 16-bit mask, and the helpers
// of the probes that keep the first codec design, one warp per chain (P2
// in probe_model.cu, P4 in probe_layouts.cu).  The coder's arithmetic and
// model, one packet per thread, are in packet_model.cuh.
#pragma once

#include <cstdint>

namespace gpuar {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr uint32_t kU16 = 0xFFFFu;

// Hides x from the compiler's folding at no cost in instructions: a
// probe's chain of primitives is computed as written, not collapsed, and
// equal chains are not merged.
__device__ __forceinline__ void opaque(int& x) { asm volatile("" : "+r"(x)); }

// c[i] for a warp-uniform runtime i in [0, 8), by selects: a dynamic index
// into a register array would put the array in local memory.
__device__ __forceinline__ int pick(const int (&c)[8], int i) {
  int v = c[0];
#pragma unroll
  for (int r = 1; r < 8; ++r) v = (i == r) ? c[r] : v;
  return v;
}

}  // namespace gpuar
