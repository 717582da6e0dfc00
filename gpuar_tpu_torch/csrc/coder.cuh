// Shared pieces of the kernels: the coder's 16-bit mask, and opaque(), which
// keeps a probe's chain of primitives from being folded.  Every kernel runs
// one chain a thread; the coder's arithmetic and model, one packet per
// thread, are in packet_model.cuh.
#pragma once

#include <cstdint>

namespace gpuar {

constexpr uint32_t kU16 = 0xFFFFu;

// Hides x from the compiler's folding at no cost in instructions: a
// probe's chain of primitives is computed as written, not collapsed, and
// equal chains are not merged.
__device__ __forceinline__ void opaque(int& x) { asm volatile("" : "+r"(x)); }

}  // namespace gpuar
