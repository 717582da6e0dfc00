// P3: the encoder's phase ablation, K1's step cut off at each level.
//
// Replaces the TPU probe benchmarks/profile_encode.py::make_kernel
// (pallas_call at :191 in `call`).  Level L runs phases 1..L of an
// encoder step and computes the probe's per-packet outputs:
//
//   L1 the model: QuadModel::prefix, then bump      chk += low + high
//   L2 + narrow_by and renorm_s                     chk += b0+pat+drain
//   L3 + the bit appends into the accumulator       chk += words, flags
//   L4 + the word stores
//   L5 + the stores of the whole fill words of an underflow run
//
// and len = chk + wcur (profile_encode.py:165), wcur the count of words
// the stream has reached (1 at the start, for the packet header).  From
// L4 on, chk stays 0 and the words are stored.
//
// The design is K1's (csrc/encode.cu), so that the levels split K1's own
// chain: one thread codes one packet, in blocks of 64, its model a
// PacketModel in 81,920 B of the block's dynamic shared memory; the
// reciprocal of cum = 256 + t is read from the constant table ahead of
// the chain; packet b reads column b of words [steps/4, B], so a warp's
// threads read neighbouring 4-byte words, in chunks of 4 words (16
// symbols), each loaded one chunk ahead of its use as K1 loads its
// 16-byte chunks (chain_input.cuh, shared with P1).  The probe's high = cum for symbol 255 is C[256] of the
// model, 256 + t, since the active steps are a prefix of the steps.  The
// inactive steps after a packet's end change nothing from L2 on, and at
// L1 each adds C[1]: they are added at the end in one product.
//
// L3 is K1's BitWriter: a 64-bit accumulator and, for the m settled bits
// and the pending run together, one put when they fit in 32 bits.  That
// put completes at most one word, the same word and flag as the probe's
// four appends (a1 the first bit, a2 the run up to a word boundary, a3
// the run's rest after its whole words, a4 the other settled bits).  A
// longer run takes a branch, as in K1, where the four appends are four
// puts and the run's whole fill words are skipped: the probe's checksum
// leaves them out, and L5 stores them.  Against K1's settle, a step of L3
// adds the checksum's select and add (2 instructions) and counts words
// rather than bytes; its long-run branch differs from K1's run loop.
// L4's store is predicated, as K1's: the threads of a warp settle bits
// at different symbols.
//
// What K1 does and P3 does not, so that L5 against K1 on the same bytes
// is a like-for-like split: K1 also writes the packet's 4-byte header,
// loads its input in 16-byte chunks (4-byte words here), stores words
// big-endian by __byte_perm (here as they are) and closes the stream
// (writeRemaining and close()).  What bounds both on the H100: one
// packet's serial chain per symbol (latency, not bytes).  All values are
// uint32 with wrapping adds, as the TPU's int32 arithmetic.
//
// On the card: python -m gpuar_tpu_torch.probes encode times each level
// and then K1 on the same bytes; chip_smoke.py phase 8 prints the levels
// as shares of K1's time.
#include <cuda_runtime.h>

#include <cstdint>

#include "chain_input.cuh"
#include "coder.cuh"
#include "packet_model.cuh"

namespace {

using namespace gpuar;
using Model = PacketModel;

// Symbols below this index have cum = 256 + t in the reciprocal table
// with room for whole chunks: the chunk loop reads it unchecked.
constexpr int kTableSymbols = (kInvEntries - 1) & ~(4 * kChunk - 1);

// One packet's encoder, cut off after phase LEVEL.
template <int LEVEL>
struct Probe {
  Model model;
  uint32_t* row;     // the packet's row of out
  uint32_t cap;      // words of the row
  uint32_t lo = 0, hi = kU16, under = 0;
  uint64_t acc = 0;  // pending bits, right-aligned; n < 32 between calls
  uint32_t n = 0;
  uint32_t wcur = 1, chk = 0;

  // K1's BitWriter::put(v, k <= 32), its word counted (L3) or stored at
  // index wcur of the row (L4 on, predicated).
  __device__ __forceinline__ void put(uint32_t v, uint32_t k) {
    acc = (acc << k) | v;
    n += k;
    const bool full = n >= 32;
    n = full ? n - 32 : n;
    const uint32_t w = static_cast<uint32_t>(acc >> n);
    if constexpr (LEVEL == 3) chk += full ? w + 1u : 0u;
    if constexpr (LEVEL >= 4) {
      if (full && wcur < cap) row[wcur] = w;
    }
    wcur += full;
  }

  // The m settled bits `top`: the first of them, `under` pending bits of
  // its complement, then the rest.
  __device__ __forceinline__ void settle(uint32_t top, uint32_t m) {
    const uint32_t len = m ? m + under : 0u;
    if (__builtin_expect(len <= 32, 1)) {
      const uint32_t r = m ? under : 0u, sh = m ? m - 1 : 0u;
      put(top + (((1u << r) - 1u) << sh), len);
      return;
    }
    const uint32_t b0 = top >> (m - 1);
    const uint32_t fill = b0 ? 0u : 0xFFFFFFFFu;
    put(b0, 1);                                   // a1
    const uint32_t r1 = min(under, (32u - n) & 31u);
    put(fill & ((1u << r1) - 1u), r1);            // a2
    const uint32_t rest = under - r1;
    const uint32_t runw = rest >> 5;              // n is 0 here if runw
    if constexpr (LEVEL >= 5) {
      for (uint32_t i = 0; i < runw; ++i)
        if (wcur + i < cap) row[wcur + i] = fill;
    }
    wcur += runw;
    const uint32_t left = rest & 31u;
    put(fill & ((1u << left) - 1u), left);        // a3
    put(top & ((1u << (m - 1)) - 1u), m - 1);     // a4
  }

  // Symbol sym, the packet's t-th, with inv = reciprocal(256 + t).
  __device__ __forceinline__ void step(int sym, int t, uint32_t inv) {
    uint32_t low, high;
    model.prefix(sym, low, high);
    if constexpr (LEVEL == 1) {
      model.bump(sym);
      chk += low + high;
      return;
    }
    uint32_t lo2 = lo, hi2 = hi;
    narrow_by(lo2, hi2, hi - lo + 1, low, high, 256 + t, inv);
    model.bump(sym);
    const uint32_t settled = hi2;  // its m top bits are settled
    uint32_t s, k;
    renorm_s(lo2, hi2, s, k);
    const uint32_t m = s - k;
    const uint32_t top = settled >> (16 - m);
    if constexpr (LEVEL == 2) {
      const uint32_t sh = m ? m - 1 : 0u;
      chk += (top >> sh) + (top & ((1u << sh) - 1u)) + (m ? under : 0u);
    } else {
      settle(top, m);
    }
    under = m ? k : under + k;
    lo = lo2;
    hi = hi2;
  }
};

template <int LEVEL>
__global__ void __launch_bounds__(Model::kBlock)
profile_kernel(const int* __restrict__ sizes, const int* __restrict__ words,
               int n_packets, int steps, uint32_t* __restrict__ out,
               int out_words, int* __restrict__ len) {
  extern __shared__ uint4 smem[];  // 16-byte aligned
  const int b = blockIdx.x * Model::kBlock + threadIdx.x;
  if (b >= n_packets) return;
  Probe<LEVEL> p{{reinterpret_cast<char*>(smem) + threadIdx.x * Model::kWidth},
                 out + static_cast<size_t>(b) * out_words,
                 static_cast<uint32_t>(out_words)};
  p.model.reset();

  int size = sizes[b];
  size = size < 0 ? 0 : (size > steps ? steps : size);
  const int rows_in = steps >> 2;
  const int* col = words + b;

  // Whole chunks: the next chunk loads while this one is coded, a word (4
  // symbols, unrolled) at a time.
  const int whole = min(size, kTableSymbols) & ~(4 * kChunk - 1);
  uint32_t next[kChunk];
  if (whole > 0) load_chunk(col, 0, n_packets, next);
  int t = 0;
  for (; t < whole; t += 4 * kChunk) {
    uint32_t cur[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) cur[i] = next[i];
    // The chunk after this one (the last whole chunk once past the end:
    // loaded, never used).
    load_chunk(col, min((t >> 2) + kChunk, (whole >> 2) - kChunk), n_packets,
               next);
    each_word(cur, [&](uint32_t word, int i) {
      const int u = t + 4 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p.step((word >> (8 * j)) & 0xFF, u + j, kInv.v[u + j]);
    });
  }
  // The last partial chunk (and any symbols past the table): one symbol
  // at a time.
  for (; t < size; ++t) {
    const int r = t >> 2;
    const uint32_t word = static_cast<uint32_t>(
        r < rows_in ? __ldg(col + static_cast<size_t>(r) * n_packets) : 0);
    p.step((word >> (8 * (t & 3))) & 0xFF, t, reciprocal(256 + t));
  }
  if constexpr (LEVEL == 1) {
    // Each inactive step reads symbol 0: low = 0, high = C[1].
    uint32_t low, c1;
    p.model.prefix(0, low, c1);
    p.chk += static_cast<uint32_t>(steps - size) * c1;
  }
  len[b] = static_cast<int>(p.chk + p.wcur);
}

template <int LEVEL>
cudaError_t launch(const int* sizes, const int* words, int n, int steps,
                   uint32_t* out, int out_words, int* len,
                   cudaStream_t stream) {
  const auto kernel = profile_kernel<LEVEL>;
  static SharedAllowance allowance;
  const cudaError_t e = allowance.allow(reinterpret_cast<const void*>(kernel),
                                        Model::kBytes);
  if (e != cudaSuccess) return e;
  kernel<<<(n + Model::kBlock - 1) / Model::kBlock, Model::kBlock,
           Model::kBytes, stream>>>(sizes, words, n, steps, out, out_words,
                                    len);
  return cudaGetLastError();
}

}  // namespace

// sizes int32 [n], words int32 [steps/4, n] -> out int32 [n, out_words]
// (stored from level 4 on), len int32 [n].
extern "C" int gpuar_profile_encode(const void* sizes, const void* words,
                                    int n, int steps, int level, void* out,
                                    int out_words, void* len, void* stream) {
  if (n <= 0) return 0;
  const int* s = static_cast<const int*>(sizes);
  const int* w = static_cast<const int*>(words);
  uint32_t* o = static_cast<uint32_t*>(out);
  int* l = static_cast<int*>(len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (level) {
    case 1: return static_cast<int>(launch<1>(s, w, n, steps, o, out_words, l, st));
    case 2: return static_cast<int>(launch<2>(s, w, n, steps, o, out_words, l, st));
    case 3: return static_cast<int>(launch<3>(s, w, n, steps, o, out_words, l, st));
    case 4: return static_cast<int>(launch<4>(s, w, n, steps, o, out_words, l, st));
    case 5: return static_cast<int>(launch<5>(s, w, n, steps, o, out_words, l, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Threads and dynamic shared memory bytes per block of gpuar_profile_encode
// (every level launches the same blocks).
extern "C" int gpuar_profile_encode_shape(int* threads, int* smem_bytes) {
  *threads = Model::kBlock;
  *smem_bytes = Model::kBytes;
  return 0;
}
