// K1: per-packet adaptive order-0 arithmetic encode, one thread per packet.
//
// Replaces the TPU kernel gpuar_tpu/ops/pallas_encode.py::_encode_kernel
// (launched by _encode_big2d under _encode_call).  The contract is the
// bytes: for every packet, the first lengths[i] bytes equal the golden
// codec's native.encode_packet(data[i, :sizes[i]]).
//
// What bounds it on the H100: each packet's symbols form one serial chain
// (the model's two reads, the narrowing with its two divisions by cum, the
// renormalisation, the bits it settles), so no launch is shorter than one
// packet's chain.  The bytes (about 134 MB in and out for a 64 MiB batch)
// are under 1% of what HBM moves in that time.  The first design, one
// warp per packet with every lane computing the same coder state, spent
// one warp instruction per packet and so was bound by issue: its time grew
// 6.6 times from 1 packet to 8192 (NVIDIA H100 80GB HBM3, 700.00 W,
// chip_smoke.py phase 5).  This design puts every packet's chain in flight
// at once and keeps each chain short, as K2 does (decode.cu):
//   * one thread codes one packet (blocks of 64, PacketModel): a warp
//     instruction serves 32 packets;
//   * QuadModel::prefix gives C[s] and C[s + 1] from registers and two
//     16-byte shared loads whose addresses follow from the symbol alone,
//     so both go out at once, before the coder state is known;
//   * the divisions by cum multiply by a reciprocal from a constant table
//     (cum = 256 + t, the same for every thread, read ahead of the chain
//     and unchecked below the table's end), and the renormalisation
//     shifts both bounds at once (narrow_by and renorm_s, equal to the
//     plain coder's ops/torch_codec.py::_apply_symbol_range and _renorm);
//   * the bits a symbol settles, the pending underflow run between the
//     first of them and the rest, leave as one put of a 64-bit
//     accumulator whenever they fit in 32 bits (a loop only for longer
//     runs), and a full word's 32-bit big-endian store into the thread's
//     own row is predicated: the threads of a warp settle bits at
//     different symbols, and a branch there would diverge and cut the
//     step into blocks the compiler schedules one by one;
//   * the input comes in 16-byte loads (4-byte ones where the packet size
//     is no multiple of 16), each loaded one chunk ahead of its use, and
//     the loop codes a word of it, 4 symbols unrolled, per iteration: the
//     16 symbols of a chunk unrolled were slower, likely as the loop body
//     then outgrew the instruction cache.
// No warp collective is left on the per-symbol path.
//
// None of the TPU kernel's mechanism is carried over: no lane-major
// tables, no _exact_div, no pair stepping, no _bswap32 interleave and no
// MAX_RUN_BITS error flag.  The pending-underflow run is unbounded (the
// greedy adversary reaches about 133 bits) and no host re-encode path
// exists.
#include <cuda_runtime.h>

#include <cstdint>

#include "coder.cuh"
#include "packet_model.cuh"

namespace {

using namespace gpuar;
using Model = PacketModel;

// MSB-first bit writer of one thread's row.  Words go out big-endian from
// byte 4 (after the header), whole 32 bits at a time; close() drains the
// last bytes with writeClose's left-aligned pad.
struct BitWriter {
  uint8_t* row;
  int cap;       // bytes of the output row
  uint64_t acc;  // pending bits, right-aligned; < 32 between calls
  uint32_t n;
  int pos;       // next byte of the row

  // Straight-line but for the store, which is predicated: the threads of
  // a warp fill their words at different symbols.
  __device__ __forceinline__ void put(uint32_t v, uint32_t k) {  // k <= 32
    acc = (acc << k) | v;
    n += k;
    const bool full = n >= 32;
    n = full ? n - 32 : n;
    const uint32_t w = static_cast<uint32_t>(acc >> n);
    if (full && pos + 4 <= cap)
      *reinterpret_cast<uint32_t*>(row + pos) = __byte_perm(w, 0, 0x0123);
    pos = full ? pos + 4 : pos;
  }

  __device__ __forceinline__ void run(uint32_t bit, uint32_t len) {
    while (len) {
      const uint32_t c = len > 32 ? 32 : len;
      put(bit ? static_cast<uint32_t>((1ull << c) - 1) : 0u, c);
      len -= c;
    }
  }

  // The m settled bits `top` (m in [0, 16]) of one symbol: the first of
  // them, then `under` pending bits of its complement, then the rest.  As
  // one value: b0 then under copies of !b0 is (2^under - 1 + b0), so the
  // whole is top + ((2^under - 1) << (m - 1)), m + under bits.
  __device__ __forceinline__ void settle(uint32_t top, uint32_t m,
                                         uint32_t under) {
    const uint32_t len = m ? m + under : 0u;
    if (__builtin_expect(len <= 32, 1)) {
      const uint32_t r = m ? under : 0u, sh = m ? m - 1 : 0u;
      put(top + (((1u << r) - 1u) << sh), len);
      return;
    }
    const uint32_t b0 = top >> (m - 1);
    put(b0, 1);
    run(b0 ^ 1u, under);
    put(top & ((1u << (m - 1)) - 1u), m - 1);
  }

  __device__ __forceinline__ void close() {
    while (n >= 8) {
      n -= 8;
      if (pos < cap) row[pos] = static_cast<uint8_t>(acc >> n);
      ++pos;
    }
    if (n) {
      if (pos < cap) row[pos] = static_cast<uint8_t>(acc << (8 - n));
      ++pos;
      n = 0;
    }
  }
};

// kChunk bytes of input from p (16- or 4-byte aligned) as little-endian
// words.
template <int kChunk>
__device__ __forceinline__ void load_chunk(const uint8_t* p,
                                           uint32_t (&w)[kChunk / 4]) {
  if constexpr (kChunk == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
}

// The coder's state in one packet's thread.
struct Coder {
  uint32_t lo = 0, hi = kU16, under = 0;

  // Code symbol sym, the packet's t-th, with inv = reciprocal(256 + t).
  __device__ __forceinline__ void step(Model& model, BitWriter& bw, int sym,
                                       int t, uint32_t inv) {
    uint32_t low, high;
    model.prefix(sym, low, high);
    uint32_t lo2 = lo, hi2 = hi;
    narrow_by(lo2, hi2, hi - lo + 1, low, high, 256 + t, inv);
    model.bump(sym);
    const uint32_t settled = hi2;  // its m top bits are settled
    uint32_t s, k;
    renorm_s(lo2, hi2, s, k);
    const uint32_t m = s - k;
    bw.settle(settled >> (16 - m), m, under);
    under = m ? k : under + k;
    lo = lo2;
    hi = hi2;
  }
};

// Symbols below this index have cum = 256 + t in the reciprocal table
// with room for whole chunks: the main loop reads it unchecked.
constexpr int kTableSymbols = (kInvEntries - 1) & ~15;

template <int kChunk>
__global__ void __launch_bounds__(Model::kBlock)
encode_kernel(const uint8_t* __restrict__ data, const int* __restrict__ sizes,
              int n_packets, int packet_size, uint8_t* __restrict__ out,
              int stride, int* __restrict__ lengths) {
  extern __shared__ uint4 smem[];  // 16-byte aligned
  const int pkt = blockIdx.x * Model::kBlock + threadIdx.x;
  if (pkt >= n_packets) return;
  Model model{reinterpret_cast<char*>(smem) + threadIdx.x * Model::kWidth};
  model.reset();

  const uint8_t* in = data + static_cast<size_t>(pkt) * packet_size;
  uint8_t* row = out + static_cast<size_t>(pkt) * stride;
  int size = sizes[pkt];
  size = size < 0 ? 0 : (size > packet_size ? packet_size : size);

  Coder coder;
  BitWriter bw{row, stride, 0, 0, 4};

  // Whole chunks: the next chunk loads while this one is coded, a word
  // (4 symbols, unrolled) at a time.
  constexpr int kWords = kChunk / 4;
  const int whole = min(size, kTableSymbols) & ~(kChunk - 1);
  uint32_t next[kWords];
  if (whole > 0) load_chunk<kChunk>(in, next);
  int t = 0;
  for (; t < whole; t += kChunk) {
    uint32_t cur[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) cur[i] = next[i];
    // The chunk after this one (the last whole chunk once past the end:
    // loaded, never used).
    load_chunk<kChunk>(in + min(t + kChunk, packet_size - kChunk), next);
#pragma unroll 1
    for (int i = 0; i < kWords; ++i) {
      const uint32_t word = cur[0];
#pragma unroll
      for (int r = 0; r + 1 < kWords; ++r) cur[r] = cur[r + 1];
      const int u = t + 4 * i;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        coder.step(model, bw, (word >> (8 * b)) & 0xFF, u + b,
                   kInv.v[u + b]);
    }
  }
  // The last partial chunk (and any symbols past the table): one byte at
  // a time.
  for (; t < size; ++t)
    coder.step(model, bw, __ldg(in + t), t, reciprocal(256 + t));

  // writeRemaining: lower's second bit, then underflow+1 complements.
  const uint32_t tb = (coder.lo >> 14) & 1u;
  bw.put(tb, 1);
  bw.run(tb ^ 1u, coder.under + 1);
  bw.close();
  // Header [u16 LE total][u16 LE raw] as one little-endian word.
  *reinterpret_cast<uint32_t*>(row) =
      (static_cast<uint32_t>(bw.pos) & 0xFFFFu) |
      (static_cast<uint32_t>(size) << 16);
  lengths[pkt] = bw.pos;
}

template <int kChunk>
int launch(const uint8_t* data, const int* sizes, int n, int packet_size,
           uint8_t* out, int stride, int* lengths, cudaStream_t s) {
  const auto kernel = encode_kernel<kChunk>;
  static SharedAllowance allowance;
  const cudaError_t e = allowance.allow(reinterpret_cast<const void*>(kernel),
                                        Model::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(n + Model::kBlock - 1) / Model::kBlock, Model::kBlock,
           Model::kBytes, s>>>(data, sizes, n, packet_size, out, stride,
                               lengths);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data starts 16-byte aligned (ops/encode.py sees to it) and its rows are
// whole 32-bit words; rows of a multiple of 16 bytes are read 16 bytes at
// a time, others 4.
extern "C" int gpuar_encode(const void* data, const void* sizes, int n,
                            int packet_size, void* out, int stride,
                            void* lengths, void* stream) {
  if (n <= 0) return 0;
  if (packet_size % 4 || reinterpret_cast<uintptr_t>(data) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto go = packet_size % 16 == 0 ? launch<16> : launch<4>;
  return go(static_cast<const uint8_t*>(data), static_cast<const int*>(sizes),
            n, packet_size, static_cast<uint8_t*>(out), stride,
            static_cast<int*>(lengths), static_cast<cudaStream_t>(stream));
}
