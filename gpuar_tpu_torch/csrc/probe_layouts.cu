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
// one-hot form of the read (k_onehot).  They ask it of the codec kernels'
// own model: one thread holds one table as a PacketModel (QuadModel<64>,
// packet_model.cuh), in blocks of 64 with 81,920 B of dynamic shared
// memory, as K1, K2 and K3 hold one packet's.  The update is
// QuadModel::bump.  k_gather's read is QuadModel::prefix's low, the
// codec's own read: selects over the registers of the top two levels and
// two 16-byte shared loads.  k_onehot's read is the same read in one-hot
// form (onehot_prefix below): each of prefix's selects becomes the reduce
// of the node's entries, every entry ANDed with a mask that is all ones at
// the digit's entry and 0 elsewhere, then summed.  So P4 still asks what
// an indexed read costs against a one-hot reduce of the model, now of
// K1's read.  (The TPU's [B, 256] and [256, B] layouts are two
// orientations of one VMEM table; a thread's tree has one.)  k_update
// stores every final table (model_table.cuh, shared with P1), so no
// table's work is dead; k_gather and k_onehot store each table's 16-bit
// running sum.  No warp collective is on a step's path.
//
// Each primitive's result passes through opaque(), so the compiler
// cannot fold a chain of them (the 20 rounds of k_adds would otherwise
// collapse into a few operations) and every probe does the work it names.
//
// What bounds them: the serial chain of each thread (latency); the bytes
// are the seed and the outputs.
#include <cuda_runtime.h>

#include <cstdint>

#include "coder.cuh"
#include "model_table.cuh"
#include "packet_model.cuh"

namespace {

using gpuar::kU16;
using gpuar::SharedAllowance;
using Model = gpuar::PacketModel;

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

// An all-ones mask where j == k, else 0.
__device__ __forceinline__ uint32_t hot(int j, int k) {
  return 0u - static_cast<uint32_t>(j == k);
}

// x_j for j in [0, 3] as a one-hot reduce: every entry ANDed with its
// mask, then summed.
__device__ __forceinline__ uint32_t onehot(int j, uint32_t x0, uint32_t x1,
                                           uint32_t x2, uint32_t x3) {
  return (x0 & hot(j, 0)) + (x1 & hot(j, 1)) + (x2 & hot(j, 2)) +
         (x3 & hot(j, 3));
}

// C[s], the low of QuadModel::prefix(s), with each of its selects (sel and
// pick) a one-hot reduce over the same entries: on each level, the S before
// s's child (0 for child 0) of the node over s; level 1's S1, S2 and S3 of
// node 1 + j0 are each a reduce over the 4 level-1 nodes.
__device__ __forceinline__ uint32_t onehot_prefix(const Model& m, int s) {
  const uint4 n2 = m.node(5 + (s >> 4));
  const uint4 n3 = m.node(21 + (s >> 2));
  const int j0 = s >> 6, j1 = (s >> 4) & 3, j2 = (s >> 2) & 3, j3 = s & 3;
  const uint32_t s1 = onehot(j0, m.a[0], m.a[1], m.a[2], m.a[3]);
  const uint32_t s2 = onehot(j0, m.b[0], m.b[1], m.b[2], m.b[3]);
  const uint32_t s3 = onehot(j0, m.c[0], m.c[1], m.c[2], m.c[3]);
  return onehot(j0, 0u, m.r[0], m.r[1], m.r[2]) + onehot(j1, 0u, s1, s2, s3) +
         onehot(j2, 0u, n2.x, n2.y, n2.z) + onehot(j3, 0u, n3.x, n3.y, n3.z);
}

// One table a thread: table b counts (7b + t) & 0xFF at step t.
template <int P>
__global__ void __launch_bounds__(Model::kBlock)
table_kernel(int n_tables, int steps, int* __restrict__ tables,
             int* __restrict__ acc_out) {
  extern __shared__ uint4 smem[];  // 16-byte aligned
  const int b = blockIdx.x * Model::kBlock + threadIdx.x;
  if (b >= n_tables) return;
  Model model{reinterpret_cast<char*>(smem) + threadIdx.x * Model::kWidth};
  model.reset();
  uint32_t acc = 0;
  for (int t = 0; t < steps; ++t) {
    const int s = (b * 7 + t) & 0xFF;
    if (P == GATHER) {
      uint32_t low, high;
      model.prefix(s, low, high);
      acc = (acc + low) & kU16;
    } else if (P == ONEHOT) {
      acc = (acc + onehot_prefix(model, s)) & kU16;
    }
    model.bump(s);
  }
  if (P == UPDATE) {
    gpuar::write_table(model, tables + static_cast<size_t>(b) * 256,
                       [](uint32_t c) { return static_cast<int>(c); });
  } else {
    acc_out[b] = static_cast<int>(acc);
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
  const auto kernel = table_kernel<P>;
  static SharedAllowance allowance;
  const cudaError_t e =
      allowance.allow(reinterpret_cast<const void*>(kernel), Model::kBytes);
  if (e != cudaSuccess) return e;
  kernel<<<(n + Model::kBlock - 1) / Model::kBlock, Model::kBlock,
           Model::kBytes, stream>>>(n, steps, tables, acc);
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

// Threads and dynamic shared memory bytes per block of gpuar_probe_table
// (the same for every table probe: PacketModel's).
extern "C" int gpuar_probe_table_shape(int* threads, int* smem_bytes) {
  *threads = Model::kBlock;
  *smem_bytes = Model::kBytes;
  return 0;
}
