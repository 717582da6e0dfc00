// P1 / P2: the model-update and loop-carry probes, one warp per chain.
//
// Replaces the TPU probes benchmarks/probe_model.py::make (P1, the kernels
// of `run`, pallas_call at :187) and the kernel of `run_carry` (P2,
// pallas_call at :236).  Each computes the TPU probe's output: a
// checksum `chk` per chain (lane of the TPU tile), a deterministic
// function of the input words.
//
// The question P1 asks is what one step of the adaptive model costs in
// each form (reads only, update only, both, 16-bit pairs, 16-bit counts,
// unrolled).  On the H100 the model lives as K1 keeps it
// (csrc/coder.cuh): in the registers of one warp, lane j holding R
// consecutive rows (R = 8 of 256, or 4 of the paired form's 128).  The
// probe's table has a row 0 that the paired update writes and no row 256,
// so lane j holds rows R*j .. R*j+R-1 (K1 holds C[8j+1..8j+8] with C[0]
// implicit).  A read of row s is the probe's one-hot sum: every lane
// offers its row s or 0 and __reduce_add_sync adds them, so a row past
// the table reads 0 as on the TPU.  The update is R predicated register
// adds per lane.  The checksum is uniform across the warp; lane 0 stores
// it.
//
// P2 asks what loop-carried state costs: 1, 4 or 8 separate carries, or
// one packed [8] carry, with the step unrolled 1 or 4 times.  Here every
// carry is a register of every lane of the chain's warp; a packed carry
// is 8 registers too (there is no packing), and every row of it is
// stored, as the TPU computed every row.  Each carry passes through
// opaque() every step, so 8 carries that hold equal values are not
// merged.
//
// What bounds both on the H100: the serial chain of each step (a
// reduction across the warp, integer adds, a data-dependent select), so
// latency; a few MB of input words are read once per repeat.  Integer
// adds wrap (two's complement), as XLA's do: they are done on unsigned
// values.  v14_clz_div keeps the TPU's float32 reciprocal division: an
// IEEE reciprocal (__frcp_rn), an IEEE multiply (__fmul_rn, never fused)
// and a truncating conversion, so this file is built without fast math.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "coder.cuh"

namespace {

using gpuar::kFull;
using gpuar::kWarpsPerBlock;

// Variant ids, in the order of probe_model.make's branches (the Python
// side, gpuar_tpu_torch/probes/probe_model.py::VARIANTS, names them).
enum Variant {
  V0_3PASS_256, V1_LOW_ONLY, V2_UPDATE_ONLY, V3_LOWHIGH_ONLY, V4_PAIRED,
  V5_PAIRED_1HOT, V6_SINGLE_REDUCE_256, V7_SINGLE_REDUCE_128,
  V8_RAW_SUM_256, V10_NOLOAD, V11_UNROLL4, V12_20ADDS_ROW,
  V13_20ADDS_8X128, V14_CLZ_DIV, V15_VARSHIFT, V16_UNROLL4_3PASS,
  V17_UNROLL4_STALE, V30_I16_REDUCE, V31_I16_3PASS, V32_I16_MIXED, V9_NOOP,
  N_VARIANTS
};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// Row s of a table of 32*R rows held R per lane (0 outside the table);
// every lane must call it.
template <int R, typename T>
__device__ __forceinline__ int row_at(const T (&c)[R], int lane, int s) {
  int v = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) v = (R * lane + r == s) ? static_cast<int>(c[r]) : v;
  return __reduce_add_sync(kFull, v);
}

// Sum of every row of the table (v8_raw_sum_256).
template <int R, typename T>
__device__ __forceinline__ int table_sum(const T (&c)[R]) {
  int v = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) v = wadd(v, static_cast<int>(c[r]));
  return __reduce_add_sync(kFull, v);
}

// C[i] += 1 for every row i > s, in the table's type (16-bit counts wrap).
template <int R, typename T>
__device__ __forceinline__ void bump(T (&c)[R], int lane, int s) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    c[r] = static_cast<T>(wadd(static_cast<int>(c[r]), R * lane + r > s ? 1 : 0));
}

// probe_model._exact_div_probe: a float32 quotient estimate, corrected.
__device__ __forceinline__ int exact_div(int x, int d) {
  const float inv = __frcp_rn(__int2float_rn(d));
  const int q0 = __float2int_rz(__fmul_rn(__int2float_rn(x), inv));
  const int r = x - q0 * d;
  return q0 + (r >= d ? 1 : 0) - (r < 0 ? 1 : 0);
}

// The input words of one chain, 32 at a time: at every 32nd word lane l
// loads word i + l, and a step takes word i by shuffle.  rows_in bounds
// the input.
struct WordCache {
  const int* col;   // words[0, chain]
  int tile, rows_in, lane;
  int mine;

  // `fresh`: this is the first use of word i (the caller knows).
  __device__ __forceinline__ int get(int i, bool fresh) {
    if (fresh && (i & 31) == 0) {
      const int row = i + lane;
      mine = row < rows_in ? col[static_cast<size_t>(row) * tile] : 0;
    }
    return __shfl_sync(kFull, mine, i & 31);
  }
};

template <int V>
struct Traits {
  static constexpr bool kI16 = V == V30_I16_REDUCE || V == V31_I16_3PASS ||
                               V == V32_I16_MIXED;
  static constexpr int kRows =
      (V == V4_PAIRED || V == V5_PAIRED_1HOT || V == V7_SINGLE_REDUCE_128 ||
       V == V13_20ADDS_8X128) ? 128 : 256;
  static constexpr int R = kRows / 32;
  // v11, v16 and v17 read one whole word per step (input [STEPS, TILE]).
  static constexpr bool kWordPerStep =
      V == V11_UNROLL4 || V == V16_UNROLL4_3PASS || V == V17_UNROLL4_STALE;
  using T = typename std::conditional<kI16, int16_t, int>::type;
};

template <int V>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
model_kernel(const int* __restrict__ words, int rows_in, int tile, int steps,
             int repeat, int* __restrict__ out,
             typename Traits<V>::T* __restrict__ table) {
  using Tr = Traits<V>;
  using T = typename Tr::T;
  constexpr int R = Tr::R;
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chain >= tile) return;  // whole warp leaves together

  T c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) c[r] = static_cast<T>(R * lane + r);
  WordCache wc{words + chain, tile, rows_in, lane, 0};
  int chk = 0;

  for (int rep = 0; rep < repeat; ++rep) {
    for (int t = 0; t < steps; ++t) {
      int sym = 0, w = 0;
      if (Tr::kWordPerStep) {
        w = wc.get(t, true);
      } else if (V != V10_NOLOAD) {
        sym = (wc.get(t >> 2, (t & 3) == 0) >> ((t & 3) * 8)) & 0xFF;
      }
      switch (V) {
        case V0_3PASS_256:
        case V31_I16_3PASS:
        case V32_I16_MIXED: {
          const int low = row_at(c, lane, sym), high = row_at(c, lane, sym + 1);
          bump(c, lane, sym);
          chk = wadd(wadd(chk, low), high);
          break;
        }
        case V1_LOW_ONLY: {
          const int low = row_at(c, lane, sym);
          bump(c, lane, sym);
          chk = wadd(chk, low);
          break;
        }
        case V2_UPDATE_ONLY:
          bump(c, lane, sym);
          chk = wadd(chk, sym);
          break;
        case V3_LOWHIGH_ONLY:
          chk = wadd(wadd(chk, row_at(c, lane, sym)), row_at(c, lane, sym + 1));
          break;
        case V4_PAIRED: {
          const int mrow = sym >> 1, par = sym & 1;
          const int pk0 = row_at(c, lane, mrow), pk1 = row_at(c, lane, mrow + 1);
          const int low = par == 0 ? (pk0 & 0xFFFF) : (pk0 >> 16);
          const int high = par == 0 ? (pk0 >> 16) : (pk1 & 0xFFFF);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int row = R * lane + r;
            const int add = (row > mrow ? 0x10001 : 0) +
                            ((par == 0 && row == mrow) ? (1 << 16) : 0);
            c[r] = wadd(c[r], add);
          }
          chk = wadd(wadd(chk, low), high);
          break;
        }
        case V5_PAIRED_1HOT: {
          const int mrow = sym >> 1;
          chk = wadd(wadd(chk, row_at(c, lane, mrow)), row_at(c, lane, mrow + 1));
          break;
        }
        case V6_SINGLE_REDUCE_256:
        case V30_I16_REDUCE:
          chk = wadd(chk, row_at(c, lane, sym));
          break;
        case V7_SINGLE_REDUCE_128:
          chk = wadd(chk, row_at(c, lane, sym >> 1));
          break;
        case V8_RAW_SUM_256:
          chk = wadd(wadd(chk, table_sum(c)), sym);
          break;
        case V10_NOLOAD:
          chk = wadd(chk, t & 255);
          break;
        case V11_UNROLL4:
#pragma unroll
          for (int j = 0; j < 4; ++j) chk = wadd(chk, (w >> (j * 8)) & 0xFF);
          break;
        case V12_20ADDS_ROW:
        case V13_20ADDS_8X128: {
          int s2 = sym;
#pragma unroll
          for (int j = 0; j < 20; ++j) s2 = wadd(s2, s2 >> 1);
          chk = wadd(chk, s2);
          break;
        }
        case V14_CLZ_DIV: {
          const int q = exact_div(sym * 12345 + 7, sym + 3);
          chk = wadd(wadd(chk, q), __clz(q | 1));
          break;
        }
        case V15_VARSHIFT: {
          const int m = sym & 15;
          chk = wadd(wadd(chk, (sym << m) & 0xFFFF), ((1 << m) - 1) & 0xFFFF);
          break;
        }
        case V16_UNROLL4_3PASS:
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sj = (w >> (j * 8)) & 0xFF;
            const int low = row_at(c, lane, sj), high = row_at(c, lane, sj + 1);
            bump(c, lane, sj);
            chk = wadd(wadd(chk, low), high);
          }
          break;
        case V17_UNROLL4_STALE: {
          // Four reads of the table as it was, then one update by all four.
          int add[R] = {};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sj = (w >> (j * 8)) & 0xFF;
            chk = wadd(wadd(chk, row_at(c, lane, sj)), row_at(c, lane, sj + 1));
#pragma unroll
            for (int r = 0; r < R; ++r) add[r] += R * lane + r > sj ? 1 : 0;
          }
#pragma unroll
          for (int r = 0; r < R; ++r) c[r] = wadd(c[r], add[r]);
          break;
        }
        case V9_NOOP:
          chk = wadd(chk, sym);
          break;
        default:
          break;
      }
    }
  }
  if (lane == 0) out[chain] = chk;
  // The final table goes to `table`, as the TPU's stays in its VMEM
  // scratch: an update that no read follows (v2) is then not dropped.
  T* row = table + static_cast<size_t>(chain) * Tr::kRows + R * lane;
#pragma unroll
  for (int r = 0; r < R; ++r) row[r] = c[r];
}

// P2: `ncarry` carries (packed: one [8] carry) updated c + (c >> 1) + t,
// `unroll` times per iteration; the chain's result is the sum of its
// carries (packed: every row, out [ncarry, tile], of which row 0 is the
// TPU probe's output).
template <int NCARRY, bool PACKED, int UNROLL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
carry_kernel(int tile, int iters, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chain >= tile) return;
  int c[NCARRY];
#pragma unroll
  for (int i = 0; i < NCARRY; ++i) c[i] = 0;
  for (int t = 0; t < iters; ++t) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int i = 0; i < NCARRY; ++i) {
        c[i] = wadd(wadd(c[i], c[i] >> 1), t);
        gpuar::opaque(c[i]);
      }
    }
  }
  if (lane != 0) return;
  if (PACKED) {
#pragma unroll
    for (int i = 0; i < NCARRY; ++i) out[static_cast<size_t>(i) * tile + chain] = c[i];
  } else {
    int acc = c[0];
#pragma unroll
    for (int i = 1; i < NCARRY; ++i) acc = wadd(acc, c[i]);
    out[chain] = acc;
  }
}

template <int V>
cudaError_t launch_model(const int* words, int rows_in, int tile, int steps,
                         int repeat, int* out, void* table,
                         cudaStream_t stream) {
  const int blocks = (tile + kWarpsPerBlock - 1) / kWarpsPerBlock;
  model_kernel<V><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      words, rows_in, tile, steps, repeat, out,
      static_cast<typename Traits<V>::T*>(table));
  return cudaGetLastError();
}

template <int NCARRY, bool PACKED, int UNROLL>
cudaError_t launch_carry(int tile, int iters, int* out, cudaStream_t stream) {
  const int blocks = (tile + kWarpsPerBlock - 1) / kWarpsPerBlock;
  carry_kernel<NCARRY, PACKED, UNROLL>
      <<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(tile, iters, out);
  return cudaGetLastError();
}

}  // namespace

// P1: words int32 [rows_in, tile] -> out int32 [tile] and the final
// tables [tile, rows] (int32, or int16 for the i16 variants; rows 128 for
// the paired and 128-row variants, else 256).  Returns a CUDA error code
// (cudaErrorInvalidValue for an unknown variant).
extern "C" int gpuar_probe_model(const void* words, int rows_in, int tile,
                                 int steps, int repeat, int variant, void* out,
                                 void* table, void* stream) {
  if (tile <= 0) return 0;
  const int* w = static_cast<const int*>(words);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
#define CASE(V) \
  case V: return static_cast<int>(launch_model<V>(w, rows_in, tile, steps, repeat, o, table, s));
    CASE(V0_3PASS_256) CASE(V1_LOW_ONLY) CASE(V2_UPDATE_ONLY)
    CASE(V3_LOWHIGH_ONLY) CASE(V4_PAIRED) CASE(V5_PAIRED_1HOT)
    CASE(V6_SINGLE_REDUCE_256) CASE(V7_SINGLE_REDUCE_128)
    CASE(V8_RAW_SUM_256) CASE(V10_NOLOAD) CASE(V11_UNROLL4)
    CASE(V12_20ADDS_ROW) CASE(V13_20ADDS_8X128) CASE(V14_CLZ_DIV)
    CASE(V15_VARSHIFT) CASE(V16_UNROLL4_3PASS) CASE(V17_UNROLL4_STALE)
    CASE(V30_I16_REDUCE) CASE(V31_I16_3PASS) CASE(V32_I16_MIXED)
    CASE(V9_NOOP)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// P2: out int32 [tile] (packed: [ncarry, tile]); the configurations of
// probe_model.py:255-260.
extern "C" int gpuar_probe_carry(int tile, int iters, int ncarry, int packed,
                                 int unroll, void* out, void* stream) {
  if (tile <= 0) return 0;
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!packed && unroll == 1 && ncarry == 1) return launch_carry<1, false, 1>(tile, iters, o, s);
  if (!packed && unroll == 1 && ncarry == 4) return launch_carry<4, false, 1>(tile, iters, o, s);
  if (!packed && unroll == 1 && ncarry == 8) return launch_carry<8, false, 1>(tile, iters, o, s);
  if (packed && unroll == 1 && ncarry == 8) return launch_carry<8, true, 1>(tile, iters, o, s);
  if (!packed && unroll == 4 && ncarry == 8) return launch_carry<8, false, 4>(tile, iters, o, s);
  if (packed && unroll == 4 && ncarry == 8) return launch_carry<8, true, 4>(tile, iters, o, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
