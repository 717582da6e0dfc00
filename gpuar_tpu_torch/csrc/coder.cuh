// Shared pieces of the per-packet adaptive arithmetic coder kernels.
//
// The coder's arithmetic (narrow, renorm, the constants) serves every
// kernel.  The warp helpers below serve the probes P1-P4 alone
// (probe_model.cu, profile_encode.cu, probe_layouts.cu), which keep the
// first codec design: one warp codes one packet.  The adaptive model's
// cumulative counts C[0..256] live in registers: lane j holds C[8j+1 ..
// 8j+8], and C[0] = 0 is implicit.  Coder state (bounds, code, bit
// cursor) is uniform across the warp: every lane computes it redundantly,
// so the per-symbol chain has no broadcast beyond the two table reads
// below.  The codec kernels K1-K3 code one packet per thread instead
// (packet_model.cuh).
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

// Leading zeros of a 16-bit value (clz16(0) = 16).
__device__ __forceinline__ uint32_t clz16(uint32_t x) { return __clz(x) - 16; }

// c[i] for a warp-uniform runtime i in [0, 8), by selects: a dynamic index
// into a register array would put the array in local memory.
__device__ __forceinline__ int pick(const int (&c)[8], int i) {
  int v = c[0];
#pragma unroll
  for (int r = 1; r < 8; ++r) v = (i == r) ? c[r] : v;
  return v;
}

// C[s] for a warp-uniform s in [0, 256].  Every lane must call it.
__device__ __forceinline__ int cum_at(const int (&c)[8], int s) {
  const int v = __shfl_sync(kFull, pick(c, (s - 1) & 7), ((s - 1) >> 3) & 31);
  return s == 0 ? 0 : v;
}

// Model reset: every symbol count 1, so C[i] = i.
__device__ __forceinline__ void model_reset(int (&c)[8], int lane) {
#pragma unroll
  for (int r = 0; r < 8; ++r) c[r] = 8 * lane + 1 + r;
}

// Count one occurrence of sym: C[i] += 1 for every i > sym.
__device__ __forceinline__ void model_bump(int (&c)[8], int lane, int sym) {
#pragma unroll
  for (int r = 0; r < 8; ++r) c[r] += (8 * lane + 1 + r > sym) ? 1 : 0;
}

// Narrow [lo, hi] to [low, high) of cum (applySymbolRange): the new upper
// bound uses the old lower one; products stay below 2^31.
__device__ __forceinline__ void narrow(uint32_t& lo, uint32_t& hi, uint32_t span,
                                       uint32_t low, uint32_t high,
                                       uint32_t cum) {
  hi = (lo + high * span / cum - 1) & kU16;
  lo = (lo + low * span / cum) & kU16;
}

// Closed-form renormalisation (gpuar_tpu/ops/xla_codec.py docstring): m
// settled MSBs, then k straddle removals; bounds updated in place.
__device__ __forceinline__ void renorm(uint32_t& lo, uint32_t& hi, uint32_t& m,
                                       uint32_t& k) {
  m = clz16(lo ^ hi);
  const uint32_t la = (lo << m) & kU16;
  const uint32_t ua = ((hi << m) | ((1u << m) - 1)) & kU16;
  const uint32_t a = (la << 1) & kU16;
  const uint32_t b = ((ua << 1) | 1u) & kU16;
  k = clz16(~(a & ~b) & kU16);
  lo = (la << k) & 0x7FFFu;
  hi = ((ua << k) | ((1u << k) - 1) | 0x8000u) & kU16;
}

}  // namespace gpuar
