// P1 / P2: the model-update and loop-carry probes.
//
// Replaces the TPU probes benchmarks/probe_model.py::make (P1, the kernels
// of `run`, pallas_call at :187) and the kernel of `run_carry` (P2,
// pallas_call at :236).  Each computes the TPU probe's output: a
// checksum `chk` per chain (lane of the TPU tile), a deterministic
// function of the input words.
//
// The question P1 asks is what one step of the adaptive model costs in
// each form (reads only, update only, both, 16-bit pairs, 16-bit counts,
// unrolled).  On the H100 it asks it of the codec kernels' own model
// step: one thread runs one chain, in blocks of 64, as K1, K2 and K3 code
// one packet a thread (csrc/packet_model.cuh).  The probe's table row s
// holds C[s], the count of the symbols below s plus s; a read past the
// table gives 0.  By variant:
//   * updated 256-row tables (v0, v1, v2, v16, v17, and the int16 v31 and
//     v32) are a PacketModel: row s is C[s] from QuadModel::prefix (row
//     256, high for s = 255, reads 0 by a select), the update is bump.
//     The int16 variants read each row as its low 16 bits, sign-extended,
//     which is the probe's wrap of int16 counts; the nodes stay 32-bit.
//     v17 makes its four reads first, then its four bumps;
//   * v4_paired reads the same tree: with every count starting at 1,
//     paired row m is m + (C[2m] - 2m) + ((C[2m+1] - 2m - 1) << 16) in
//     wrapping 32-bit arithmetic, and row 128 reads 0;
//   * the read-only variants (v3, v5, v6, v7, v30) and v8 never update:
//     the table is the thread's own column of the block's shared memory,
//     entry e of thread t at (e * 64 + t) * width as packet_model.cuh lays
//     out its nodes (so no two lanes of a warp share a bank), with one
//     entry past the table that holds 0;
//   * v8_raw_sum_256 sums every row of the column at every step: in one
//     chain a thread, that is what a full-table sum costs, 256 loads and
//     adds, bound by the SM's shared-memory bandwidth.  The column's base
//     is chk & zero, zero a mask that is 0 at run time (rows_in >> 31)
//     but not to the compiler, so no step's sum can be hoisted or reused
//     and every step loads all 256 rows; it adds into 8 partial sums;
//   * the table-free variants (v9 to v15) run in registers.
// Each chain reads its column of the input words in chunks
// (chain_input.cuh, shared with P3).
// The final table [tile, rows] is written out at the end from the tree
// (model_table.cuh, shared with P4) or the column (the table-free
// variants write the initial one), as the
// TPU's stays in its VMEM scratch: an update that no read follows (v2) is
// then not dropped.  No warp collective is on a step's path.
//
// P2 asks what loop-carried state costs: 1, 4 or 8 separate carries, or
// one packed [8] carry, with the step unrolled 1 or 4 times.  It asks it
// of K1's own registers: one thread runs one chain, in blocks of 64, its
// carries in that thread's registers, as K1 holds its coder state.  A
// packed carry is 8 registers too (there is no packing), and every row of
// it is stored, as the TPU computed every row.  Each carry passes through
// opaque() every step, so 8 carries that hold equal values are not merged.
// A 1-carry step is a shift and an add in dependence, so at any width one
// chain's latency sets P2's time; more carries a thread add independent
// chains that the scheduler interleaves.
//
// What bounds both on the H100: the serial chain of each step (the
// model's shared-memory reads and update, integer adds, a data-dependent
// select), so latency; a few MB of input words are read once per repeat.
// Integer adds wrap (two's complement), as XLA's do: they are done on
// unsigned values.  v14_clz_div keeps the TPU's float32 reciprocal
// division: an IEEE reciprocal (__frcp_rn), an IEEE multiply (__fmul_rn,
// never fused) and a truncating conversion, so this file is built without
// fast math.
//
// On the card: python -m gpuar_tpu_torch.probes model (P1) or carry (P2)
// times every variant; tests/test_torch_probes.py's GPU-marked tests hold
// each to its plain version (probes/probe_model.py).
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "chain_input.cuh"
#include "coder.cuh"
#include "model_table.cuh"
#include "packet_model.cuh"

namespace {

using gpuar::kChunk;
using gpuar::PacketModel;
using gpuar::SharedAllowance;

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

// probe_model._exact_div_probe: a float32 quotient estimate, corrected.
__device__ __forceinline__ int exact_div(int x, int d) {
  const float inv = __frcp_rn(__int2float_rn(d));
  const int q0 = __float2int_rz(__fmul_rn(__int2float_rn(x), inv));
  const int r = x - q0 * d;
  return q0 + (r >= d ? 1 : 0) - (r < 0 ? 1 : 0);
}

enum Form { kTree, kColumn, kRegisters };

template <int V>
struct Traits {
  static constexpr bool kI16 = V == V30_I16_REDUCE || V == V31_I16_3PASS ||
                               V == V32_I16_MIXED;
  static constexpr int kRows =
      (V == V4_PAIRED || V == V5_PAIRED_1HOT || V == V7_SINGLE_REDUCE_128 ||
       V == V13_20ADDS_8X128) ? 128 : 256;
  // v11, v16 and v17 read one whole word per step (input [STEPS, TILE]).
  static constexpr bool kWordPerStep =
      V == V11_UNROLL4 || V == V16_UNROLL4_3PASS || V == V17_UNROLL4_STALE;
  static constexpr Form kForm =
      (V == V0_3PASS_256 || V == V1_LOW_ONLY || V == V2_UPDATE_ONLY ||
       V == V4_PAIRED || V == V16_UNROLL4_3PASS || V == V17_UNROLL4_STALE ||
       V == V31_I16_3PASS || V == V32_I16_MIXED) ? kTree
      : (V == V3_LOWHIGH_ONLY || V == V5_PAIRED_1HOT ||
         V == V6_SINGLE_REDUCE_256 || V == V7_SINGLE_REDUCE_128 ||
         V == V8_RAW_SUM_256 || V == V30_I16_REDUCE) ? kColumn
      : kRegisters;
  using T = typename std::conditional<kI16, int16_t, int>::type;
  static constexpr int kBlock = PacketModel::kBlock;
  // Dynamic shared memory a block: the tree's nodes, or each thread's
  // column of kRows entries and the 0 past them.
  static constexpr int kShared =
      kForm == kTree ? PacketModel::kBytes
      : kForm == kColumn ? (kRows + 1) * kBlock * static_cast<int>(sizeof(T))
      : 0;
};

// One chain's table and step, in the variant's form.
template <int V>
struct Chain {
  using Tr = Traits<V>;
  using T = typename Tr::T;
  PacketModel model;  // kTree
  T* col;             // kColumn: this thread's entry 0
  int zero;           // 0, unknown to the compiler (v8's base mask)

  __device__ __forceinline__ void reset() {
    if constexpr (Tr::kForm == kTree) {
      model.reset();
    } else if constexpr (Tr::kForm == kColumn) {
      for (int e = 0; e < Tr::kRows; ++e) col[e * Tr::kBlock] = static_cast<T>(e);
      col[Tr::kRows * Tr::kBlock] = 0;
    }
  }

  // A row as the probe reads it: an int16 count is its low 16 bits,
  // sign-extended.
  __device__ __forceinline__ static int as_row(uint32_t c) {
    return Tr::kI16 ? static_cast<int>(static_cast<int16_t>(c))
                    : static_cast<int>(c);
  }

  // Rows s and s + 1 of the tree's table: C[s] and C[s + 1], row 256 0.
  __device__ __forceinline__ void rows(int s, int& low, int& high) const {
    uint32_t l, h;
    model.prefix(s, l, h);
    low = as_row(l);
    high = s == 255 ? 0 : as_row(h);
  }

  // Paired row m (m <= 128) of the tree's table.
  __device__ __forceinline__ int paired(int m) const {
    uint32_t c0, c1;
    model.prefix((2 * m) & 255, c0, c1);
    const uint32_t v = (c0 - m) + ((c1 - 2 * m - 1) << 16);
    return m < 128 ? static_cast<int>(v) : 0;
  }

  // Row s (s <= kRows) of the column.
  __device__ __forceinline__ int at(int s) const {
    return static_cast<int>(col[s * Tr::kBlock]);
  }

  // One step on symbol sym.
  __device__ __forceinline__ void step(int sym, int t, int& chk) {
    if constexpr (V == V0_3PASS_256 || V == V31_I16_3PASS ||
                  V == V32_I16_MIXED) {
      int low, high;
      rows(sym, low, high);
      model.bump(sym);
      chk = wadd(wadd(chk, low), high);
    } else if constexpr (V == V1_LOW_ONLY) {
      int low, high;
      rows(sym, low, high);
      model.bump(sym);
      chk = wadd(chk, low);
    } else if constexpr (V == V2_UPDATE_ONLY) {
      model.bump(sym);
      chk = wadd(chk, sym);
    } else if constexpr (V == V3_LOWHIGH_ONLY) {
      chk = wadd(wadd(chk, at(sym)), at(sym + 1));
    } else if constexpr (V == V4_PAIRED) {
      const int mrow = sym >> 1;
      const int pk0 = paired(mrow), pk1 = paired(mrow + 1);
      const bool even = (sym & 1) == 0;
      const int low = even ? (pk0 & 0xFFFF) : (pk0 >> 16);
      const int high = even ? (pk0 >> 16) : (pk1 & 0xFFFF);
      model.bump(sym);
      chk = wadd(wadd(chk, low), high);
    } else if constexpr (V == V5_PAIRED_1HOT) {
      const int mrow = sym >> 1;
      chk = wadd(wadd(chk, at(mrow)), at(mrow + 1));
    } else if constexpr (V == V6_SINGLE_REDUCE_256 || V == V30_I16_REDUCE) {
      chk = wadd(chk, at(sym));
    } else if constexpr (V == V7_SINGLE_REDUCE_128) {
      chk = wadd(chk, at(sym >> 1));
    } else if constexpr (V == V8_RAW_SUM_256) {
      const T* c = col + (chk & zero);
      int part[8] = {};  // 8 sums, so the adds are not one serial chain
#pragma unroll
      for (int e = 0; e < Tr::kRows; ++e)
        part[e & 7] = wadd(part[e & 7], static_cast<int>(c[e * Tr::kBlock]));
      int sum = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) sum = wadd(sum, part[r]);
      chk = wadd(wadd(chk, sum), sym);
    } else if constexpr (V == V10_NOLOAD) {
      chk = wadd(chk, t & 255);
    } else if constexpr (V == V12_20ADDS_ROW || V == V13_20ADDS_8X128) {
      int s2 = sym;
#pragma unroll
      for (int j = 0; j < 20; ++j) s2 = wadd(s2, s2 >> 1);
      chk = wadd(chk, s2);
    } else if constexpr (V == V14_CLZ_DIV) {
      const int q = exact_div(sym * 12345 + 7, sym + 3);
      chk = wadd(wadd(chk, q), __clz(q | 1));
    } else if constexpr (V == V15_VARSHIFT) {
      const int m = sym & 15;
      chk = wadd(wadd(chk, (sym << m) & 0xFFFF), ((1 << m) - 1) & 0xFFFF);
    } else if constexpr (V == V9_NOOP) {
      chk = wadd(chk, sym);
    }
  }

  // One step of the variants that take a whole word a step.
  __device__ __forceinline__ void word_step(uint32_t w, int& chk) {
    if constexpr (V == V11_UNROLL4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) chk = wadd(chk, (w >> (j * 8)) & 0xFF);
    } else if constexpr (V == V16_UNROLL4_3PASS) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sj = (w >> (j * 8)) & 0xFF;
        int low, high;
        rows(sj, low, high);
        model.bump(sj);
        chk = wadd(wadd(chk, low), high);
      }
    } else if constexpr (V == V17_UNROLL4_STALE) {
      // Four reads of the table as it was, then the four updates.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int low, high;
        rows((w >> (j * 8)) & 0xFF, low, high);
        chk = wadd(wadd(chk, low), high);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) model.bump((w >> (j * 8)) & 0xFF);
    }
  }

  // The final table, row s at row[s].
  __device__ __forceinline__ void write(T* row) const {
    if constexpr (Tr::kForm == kTree && V != V4_PAIRED) {
      gpuar::write_table(model, row, [](uint32_t c) { return as_row(c); });
    } else {
      for (int s = 0; s < Tr::kRows; ++s) {
        int v = s;
        if constexpr (V == V4_PAIRED) {
          v = paired(s);
        } else if constexpr (Tr::kForm == kColumn) {
          v = at(s);
        }
        row[s] = static_cast<T>(v);
      }
    }
  }
};

template <int V>
__global__ void __launch_bounds__(Traits<V>::kBlock)
model_kernel(const int* __restrict__ words, int rows_in, int tile, int steps,
             int repeat, int* __restrict__ out,
             typename Traits<V>::T* __restrict__ table) {
  using Tr = Traits<V>;
  using T = typename Tr::T;
  extern __shared__ uint4 smem[];  // 16-byte aligned
  const int chain = blockIdx.x * Tr::kBlock + threadIdx.x;
  if (chain >= tile) return;
  Chain<V> c{{reinterpret_cast<char*>(smem) +
              threadIdx.x * PacketModel::kWidth},
             reinterpret_cast<T*>(smem) + threadIdx.x, rows_in >> 31};
  c.reset();

  // The chain's input words (one a step for v11, v16 and v17, else one
  // per 4 steps), in chunks: a chunk loads while the one before it is
  // used, as K1 loads its input a chunk ahead.
  const int* in = words + chain;
  constexpr int kPer = Tr::kWordPerStep ? 1 : 4;  // steps a word
  const auto use = [&](uint32_t w, int t, int& chk) {
    if constexpr (Tr::kWordPerStep) {
      c.word_step(w, chk);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) c.step((w >> (8 * j)) & 0xFF, t + j, chk);
    }
  };
  int chk = 0;
  if constexpr (V == V10_NOLOAD) {
    for (int rep = 0; rep < repeat; ++rep)
      for (int t = 0; t < steps; ++t) c.step(0, t, chk);
  } else {
    const int whole = (steps / kPer) & ~(kChunk - 1);  // words in chunks
    uint32_t next[kChunk];
    if (whole > 0) gpuar::load_chunk(in, 0, tile, next);
    for (int rep = 0; rep < repeat; ++rep) {
      int i = 0;
      for (; i < whole; i += kChunk) {
        uint32_t cur[kChunk];
#pragma unroll
        for (int r = 0; r < kChunk; ++r) cur[r] = next[r];
        // The next chunk of this pass, or the first of the next.
        gpuar::load_chunk(in, i + kChunk < whole ? i + kChunk : 0, tile,
                          next);
        gpuar::each_word(cur, [&](uint32_t w, int j) {
          use(w, (i + j) * kPer, chk);
        });
      }
      // The steps past the last whole chunk, each word loaded as used (0
      // past the input).
      for (int t = i * kPer; t < steps; ++t) {
        const int r = t / kPer;
        const uint32_t w = static_cast<uint32_t>(
            r < rows_in ? __ldg(in + static_cast<size_t>(r) * tile) : 0);
        if constexpr (Tr::kWordPerStep)
          c.word_step(w, chk);
        else
          c.step((w >> (8 * (t & 3))) & 0xFF, t, chk);
      }
    }
  }
  out[chain] = chk;
  c.write(table + static_cast<size_t>(chain) * Tr::kRows);
}

// P2's launch: one chain a thread, in blocks of 64 as the codec kernels'.
constexpr int kCarryBlock = 64;

// P2: `ncarry` carries (packed: one [8] carry) updated c + (c >> 1) + t,
// `unroll` times per iteration, in the chain's thread's registers; the
// chain's result is the sum of its carries (packed: every row, out
// [ncarry, tile], of which row 0 is the TPU probe's output).
template <int NCARRY, bool PACKED, int UNROLL>
__global__ void __launch_bounds__(kCarryBlock)
carry_kernel(int tile, int iters, int* __restrict__ out) {
  const int chain = blockIdx.x * kCarryBlock + threadIdx.x;
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
  using Tr = Traits<V>;
  const auto kernel = model_kernel<V>;
  if constexpr (Tr::kShared > 0) {
    static SharedAllowance allowance;
    const cudaError_t e = allowance.allow(
        reinterpret_cast<const void*>(kernel), Tr::kShared);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(tile + Tr::kBlock - 1) / Tr::kBlock, Tr::kBlock, Tr::kShared,
           stream>>>(words, rows_in, tile, steps, repeat, out,
                     static_cast<typename Tr::T*>(table));
  return cudaGetLastError();
}

template <int NCARRY, bool PACKED, int UNROLL>
cudaError_t launch_carry(int tile, int iters, int* out, cudaStream_t stream) {
  carry_kernel<NCARRY, PACKED, UNROLL>
      <<<(tile + kCarryBlock - 1) / kCarryBlock, kCarryBlock, 0, stream>>>(
          tile, iters, out);
  return cudaGetLastError();
}

template <int V>
int model_shape(int* threads, int* smem_bytes) {
  *threads = Traits<V>::kBlock;
  *smem_bytes = Traits<V>::kShared;
  return 0;
}

}  // namespace

#define GPUAR_EACH_VARIANT(CASE)                                            \
  CASE(V0_3PASS_256) CASE(V1_LOW_ONLY) CASE(V2_UPDATE_ONLY)                 \
  CASE(V3_LOWHIGH_ONLY) CASE(V4_PAIRED) CASE(V5_PAIRED_1HOT)                \
  CASE(V6_SINGLE_REDUCE_256) CASE(V7_SINGLE_REDUCE_128)                     \
  CASE(V8_RAW_SUM_256) CASE(V10_NOLOAD) CASE(V11_UNROLL4)                   \
  CASE(V12_20ADDS_ROW) CASE(V13_20ADDS_8X128) CASE(V14_CLZ_DIV)             \
  CASE(V15_VARSHIFT) CASE(V16_UNROLL4_3PASS) CASE(V17_UNROLL4_STALE)        \
  CASE(V30_I16_REDUCE) CASE(V31_I16_3PASS) CASE(V32_I16_MIXED)              \
  CASE(V9_NOOP)

// P1: words int32 [rows_in, tile] -> out int32 [tile] and the final
// tables [tile, rows] (int32, or int16 for the i16 variants; rows 128 for
// the paired and 128-row variants, else 256).  Returns a CUDA error code
// (cudaErrorInvalidValue for an unknown variant).
extern "C" int gpuar_probe_model(const void* words, int rows_in, int tile,
                                 int steps, int repeat, int variant, void* out,
                                 void* table, void* stream) {
  if (rows_in < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tile <= 0) return 0;
  const int* w = static_cast<const int*>(words);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
#define CASE(V) \
  case V: return static_cast<int>(launch_model<V>(w, rows_in, tile, steps, repeat, o, table, s));
    GPUAR_EACH_VARIANT(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Threads and dynamic shared memory bytes per block of gpuar_probe_model
// for one variant.
extern "C" int gpuar_probe_model_shape(int variant, int* threads,
                                       int* smem_bytes) {
  switch (variant) {
#define CASE(V) \
  case V: return model_shape<V>(threads, smem_bytes);
    GPUAR_EACH_VARIANT(CASE)
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

// Threads and dynamic shared memory bytes per block of gpuar_probe_carry
// (the same for every configuration).
extern "C" int gpuar_probe_carry_shape(int* threads, int* smem_bytes) {
  *threads = kCarryBlock;
  *smem_bytes = 0;
  return 0;
}
