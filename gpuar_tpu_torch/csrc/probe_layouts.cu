// P4: costs of the inner-loop primitives, on the H100.
//
// Replaces the TPU probes benchmarks/probe_layouts.py::k_base .. k_onehot
// (pallas_call at :43 in `call`), computing their outputs.
//
// The scalar probes take the [8, 128] seed, one thread per element, and
// run STEPS steps of one primitive chain each: the loop alone (base), 60
// adds, 4 variable shifts natively or by the float32 exponent trick, 4
// leading-zero counts natively (__clz) or from a float32 exponent.  The
// TPU's pltpu.bitcast becomes __int_as_float / __float_as_int, and every
// float step is an IEEE round-to-nearest operation (__int2float_rn,
// __fmul_rn) with a truncating conversion back (__float2int_rz): the
// tricks are exact for these operands, so this file is built without
// fast math and the results equal the native shifts bit for bit.
//
// The table probes keep one 256-entry model per row b of B tables and
// count symbol c_b(t) = (7b + t) & 0xFF at every step t: the update alone
// (k_update), a read of C[c_b] then the update (k_gather), and the
// one-hot form of the read (k_onehot).  Layout: one warp per table, lane
// j holding C[8j .. 8j+7] in registers, as K1 holds its model
// (csrc/coder.cuh).  Registers and not shared memory, because that is the
// layout whose cost K1 pays every symbol: the update is 8 predicated adds
// per lane, k_gather's read is the owner lane's register by __shfl_sync,
// and k_onehot's read is the probe's masked sum, every lane offering its
// entry or 0 to __reduce_add_sync.  (The TPU's [B, 256] and [256, B]
// layouts are two orientations of one VMEM table; a warp's registers have
// one.)  k_update stores every final table, so no table's work is dead;
// k_gather and k_onehot store each table's 16-bit running sum.
//
// Each primitive's result passes through opaque(), so the compiler
// cannot fold a chain of them (the 20 rounds of k_adds would otherwise
// collapse into a few operations) and every probe does the work it names.
//
// What bounds them: the serial chain of each thread or warp (latency);
// the bytes are the seed and the outputs.
#include <cuda_runtime.h>

#include <cstdint>

#include "coder.cuh"

namespace {

using gpuar::kFull;
using gpuar::kWarpsPerBlock;

enum Scalar { BASE, ADDS, VARSHIFT, F32SHIFT, CLZ, CLZF, N_SCALAR };
enum Table { UPDATE, GATHER, ONEHOT, N_TABLE };

// 2^e as a float32, by building its bits (probe_layouts.pow2f / shr).
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ int f32_scale(int x, float p) {
  return __float2int_rz(__fmul_rn(__int2float_rn(x), p));
}

// (x << m) & 0xFFFF for x < 2^16, m in [0, 16], without a variable shift.
__device__ __forceinline__ int shl16(int x, int m) {
  const float p = pow2f(m);
  return (f32_scale(x & 0xFF, p) + (f32_scale(x >> 8, p) << 8)) & 0xFFFF;
}

// x >> m for x < 2^24, m in [0, 30].
__device__ __forceinline__ int shr(int x, int m) {
  return f32_scale(x, pow2f(-m));
}

// clz16 from the float32 exponent: 15 - floor(log2 x) for x > 0, else 16.
__device__ __forceinline__ int clz16f(int x) {
  const int e = (__float_as_int(__int2float_rn(x)) >> 23) & 0xFF;
  return x > 0 ? 142 - e : 16;
}

template <int P>
__global__ void scalar_kernel(const int* __restrict__ seed, int n, int steps,
                              int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int x = seed[i];
  for (int t = 0; t < steps; ++t) {
    if (P == BASE) {
      x = (x + t) & 0xFFFF;
    } else if (P == ADDS) {
#pragma unroll
      for (int j = 0; j < 20; ++j) {
        x = (x + 1) & 0xFFFF;
        x = x | 1;
        x = x ^ 3;
        gpuar::opaque(x);
      }
    } else if (P == VARSHIFT || P == F32SHIFT) {
      const int m = x & 15;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x = P == VARSHIFT ? ((x << m) | (x >> (16 - m))) & 0xFFFF
                          : (shl16(x, m) | shr(x & 0xFFFF, 16 - m)) & 0xFFFF;
        gpuar::opaque(x);
      }
      x |= 1;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x = (x + (P == CLZ ? __clz(x | 1) : clz16f(x | 1))) & 0xFFFF;
        gpuar::opaque(x);
      }
      x |= 1;
    }
  }
  out[i] = x;
}

template <int P>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
table_kernel(int n_tables, int steps, int* __restrict__ tables,
             int* __restrict__ acc_out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_tables) return;  // whole warp leaves together
  int c[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) c[r] = 8 * lane + r;
  int acc = 0;
  for (int t = 0; t < steps; ++t) {
    const int s = (b * 7 + t) & 0xFF;
    if (P == GATHER) {
      acc = (acc + __shfl_sync(kFull, gpuar::pick(c, s & 7), s >> 3)) & 0xFFFF;
    } else if (P == ONEHOT) {
      int v = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) v = 8 * lane + r == s ? c[r] : v;
      acc = (acc + __reduce_add_sync(kFull, v)) & 0xFFFF;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) c[r] += 8 * lane + r > s ? 1 : 0;
  }
  if (P == UPDATE) {
    int* row = tables + static_cast<size_t>(b) * 256 + 8 * lane;
#pragma unroll
    for (int r = 0; r < 8; ++r) row[r] = c[r];
  } else if (lane == 0) {
    acc_out[b] = acc;
  }
}

template <int P>
cudaError_t launch_scalar(const int* seed, int n, int steps, int* out,
                          cudaStream_t stream) {
  scalar_kernel<P><<<(n + 127) / 128, 128, 0, stream>>>(seed, n, steps, out);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_table(int n, int steps, int* tables, int* acc,
                         cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  table_kernel<P><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(n, steps,
                                                              tables, acc);
  return cudaGetLastError();
}

}  // namespace

// Scalar probes: seed int32 [n] -> out int32 [n].
extern "C" int gpuar_probe_scalar(const void* seed, int n, int steps,
                                  int probe, void* out, void* stream) {
  if (n <= 0) return 0;
  const int* s = static_cast<const int*>(seed);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (probe) {
    case BASE: return static_cast<int>(launch_scalar<BASE>(s, n, steps, o, st));
    case ADDS: return static_cast<int>(launch_scalar<ADDS>(s, n, steps, o, st));
    case VARSHIFT: return static_cast<int>(launch_scalar<VARSHIFT>(s, n, steps, o, st));
    case F32SHIFT: return static_cast<int>(launch_scalar<F32SHIFT>(s, n, steps, o, st));
    case CLZ: return static_cast<int>(launch_scalar<CLZ>(s, n, steps, o, st));
    case CLZF: return static_cast<int>(launch_scalar<CLZF>(s, n, steps, o, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Table probes over n tables: tables int32 [n, 256] (k_update's final
// tables), acc int32 [n] (k_gather's and k_onehot's sums).
extern "C" int gpuar_probe_table(int n, int steps, int probe, void* tables,
                                 void* acc, void* stream) {
  if (n <= 0) return 0;
  int* tb = static_cast<int*>(tables);
  int* a = static_cast<int*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (probe) {
    case UPDATE: return static_cast<int>(launch_table<UPDATE>(n, steps, tb, a, st));
    case GATHER: return static_cast<int>(launch_table<GATHER>(n, steps, tb, a, st));
    case ONEHOT: return static_cast<int>(launch_table<ONEHOT>(n, steps, tb, a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
