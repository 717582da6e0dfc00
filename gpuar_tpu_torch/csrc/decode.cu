// K2 / K3: per-packet adaptive arithmetic decode, one thread per packet;
// K3 is the kDebug = true instantiation.
//
// Replaces the TPU kernel gpuar_tpu/ops/pallas_decode.py::_decode_kernel
// (launched by _decode_big2d under _decode_call; debug=True is K3).  The
// contract is the bytes: each packet decodes exactly its raw_size bytes
// (the rest of its output row is zeroed), and K3 flags the packets the
// TPU kernel's debug variant flags: row 0 of `flags` is nonzero where an
// active step saw unscaled outside [0, cum) or a range inversion, row 1 is
// the final bit cursor counted from the packet start, header included
// (48 after priming), so pallas_decode.check_debug_flags keeps its rule.
//
// What bounds it on the H100: each packet's symbols form one serial chain
// (the symbol search, the narrowing with its two divisions by cum, the
// renormalisation, the next code), so no launch is shorter than one
// packet's chain, whatever the card's rates.  The bytes (about 140 MB for
// a 64 MiB batch) are under 1% of what HBM moves in that time.  The design
// puts every packet's chain in flight at once and keeps each chain short:
//   * one thread codes one packet: a warp instruction serves 32 packets,
//     and 8192 packets fill the card's 132 SMs at one or two warps each;
//   * the model is the thread's own 4-ary prefix tree (QuadModel in
//     packet_model.cuh): its top two levels in registers, the two below
//     in shared memory, so the search waits on two 16-byte loads; it asks
//     S * span <= num instead of dividing by the span; and a symbol's
//     count touches two shared nodes whose addresses follow from it alone;
//   * the divisions by cum multiply by a reciprocal read from a constant
//     table a symbol ahead, and the renormalisation shifts both bounds at
//     once (narrow_by and renorm_s, equal to the plain coder's
//     ops/torch_codec.py::_apply_symbol_range and _renorm);
//   * the bit reader loads the next 4 bytes one refill ahead of use, and
//     one funnel shift moves the code and brings in its new bits;
//   * decoded bytes leave four at a time as one 32-bit store; the loop is
//     unrolled by 4.
// No warp collective is left on the per-symbol path.
//
// Input is the compacted blob as it comes off the file: packet i starts at
// byte_offsets[i], and the kernel reads it in place (no expand gather).
// A packet's readable window is `region` bytes from its start, clipped to
// the blob; bytes past either read as zero.  Lookahead past a packet's own
// stream picks up its neighbour's bytes, which is sound: the final flush
// pins every symbol regardless of the bits that follow.  Corrupt streams
// can consume up to 16 bits per symbol, far past the packet, which the
// clamp keeps inside the blob.
#include <cuda_runtime.h>

#include "coder.cuh"
#include "packet_model.cuh"

namespace {

using namespace gpuar;

// Readable in place of a packet window of no bytes.
__device__ const uint8_t kNoBytes[4] = {0, 0, 0, 0};

// MSB-first bit reader over one packet's window, one per thread.  The 4
// bytes after those in `buf` are loaded at the refill before the one that
// takes them, and nothing reads them until then: their addresses are
// clamped into the window instead of the loads being skipped, and the
// bytes past the window are masked off when they are taken.  So a load
// has at least two symbols' time to arrive.
struct BitReader {
  const uint8_t* base;  // packet start (kNoBytes for an empty window)
  int limit;            // readable bytes from base
  uint64_t buf;         // next bits, left-aligned
  int nb;               // valid bits in buf
  int q;                // first byte after next[], from the packet start
  uint32_t next[4];     // bytes q - 4 .. q - 1, unmasked
  uint32_t keep;        // the mask of those inside the window

  __device__ __forceinline__ void load_next() {
    const int last = limit > 0 ? limit - 1 : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) next[j] = base[min(q + j, last)];
    const int in = min(max(limit - q, 0), 4);  // bytes inside
    keep = in == 4 ? 0xFFFFFFFFu : ~(0xFFFFFFFFu >> (8 * in));
    q += 4;
  }

  // Past the 4-byte header: buf holds bytes 4..7, next bytes 8..11.
  __device__ __forceinline__ void start() {
    q = 4;
    load_next();
    refill();
  }

  __device__ __forceinline__ void refill() {  // call with nb < 32
    const uint32_t w =
        ((next[0] << 24) | (next[1] << 16) | (next[2] << 8) | next[3]) & keep;
    buf |= static_cast<uint64_t>(w) << (32 - nb);
    nb += 32;
    load_next();
  }

  // The next s <= 16 <= nb bits as the low bits of `code << s`, 16 bits.
  __device__ __forceinline__ uint32_t shift_in(uint32_t code, uint32_t s) {
    const uint32_t top = static_cast<uint32_t>(buf >> 32);
    buf <<= s;
    nb -= static_cast<int>(s);
    return __funnelshift_l(top, code, s) & kU16;
  }
};

// Bytes [i, i + 4) of a row from the little-endian word w, cut at the
// row's end `size`; whole 32-bit stores when rows are 4-byte aligned.
__device__ __forceinline__ void put4(uint8_t* row, int i, uint32_t w,
                                     int size, bool aligned) {
  if (aligned) {
    *reinterpret_cast<uint32_t*>(row + i) = w;
    return;
  }
  for (int j = 0; j < 4 && i + j < size; ++j)
    row[i + j] = static_cast<uint8_t>(w >> (8 * j));
}

using Model = PacketModel;

template <bool kDebug>
__global__ void __launch_bounds__(Model::kBlock)
decode_kernel(const uint8_t* __restrict__ blob, int64_t blob_len,
              const int64_t* __restrict__ offsets, int region,
              const int* __restrict__ raw_sizes, int n_packets,
              int packet_size, uint8_t* __restrict__ out,
              int* __restrict__ flags) {
  extern __shared__ uint4 smem[];  // 16-byte aligned
  const int pkt = blockIdx.x * Model::kBlock + threadIdx.x;
  if (pkt >= n_packets) return;
  Model model{reinterpret_cast<char*>(smem) + threadIdx.x * Model::kWidth};
  model.reset();

  int raw = raw_sizes[pkt];
  raw = raw < 0 ? 0 : (raw > packet_size ? packet_size : raw);
  uint8_t* dst = out + static_cast<size_t>(pkt) * packet_size;
  const bool aligned = (packet_size & 3) == 0;
  int64_t off = offsets[pkt];
  off = off < 0 ? 0 : (off > blob_len ? blob_len : off);
  const int64_t room = blob_len - off;
  const int limit = static_cast<int>(room < region ? room : region);

  BitReader br{limit > 0 ? blob + off : kNoBytes, limit, 0, 0, 0, {}, 0};
  br.start();
  uint32_t code = br.shift_in(0, 16);  // initializeDecoder: 16 bits
  int cursor = 48;                     // bits from the packet start

  int cum = 256;
  uint32_t inv = reciprocal(256);  // of cum, read a symbol ahead
  uint32_t lo = 0, hi = kU16;
  int flag = 0;
  uint32_t word = 0;  // the last 4 decoded bytes, the newest on top

#pragma unroll 4
  for (int t = 0; t < raw; ++t) {
    if (br.nb < 32) br.refill();
    int span = static_cast<int>(hi) - static_cast<int>(lo) + 1;
    span = span < 1 ? 1 : span;
    const int num =
        (static_cast<int>(code) - static_cast<int>(lo) + 1) * cum - 1;
    // unscaled = num / span (or -1) is outside [0, cum)
    if (kDebug) flag |= (num < 0) | (num >= cum * span);

    uint32_t low, high;
    const int sym = model.search(num, span, low, high);
    uint32_t lo2 = lo, hi2 = hi;
    narrow_by(lo2, hi2, static_cast<uint32_t>(span), low, high,
              static_cast<uint32_t>(cum), inv);
    if (kDebug) flag |= lo2 > hi2;
    model.bump(sym);
    ++cum;
    inv = reciprocal(static_cast<uint32_t>(cum));

    uint32_t s, k;
    renorm_s(lo2, hi2, s, k);
    code = br.shift_in(code, s) ^ (k ? 0x8000u : 0u);
    cursor += static_cast<int>(s);
    lo = lo2;
    hi = hi2;

    word = __byte_perm(word, static_cast<uint32_t>(sym), 0x4321);
    if ((t & 3) == 3) put4(dst, t - 3, word, packet_size, aligned);
  }
  // The last partial word (its high bytes zero), then zeros to the end.
  int i = raw & ~3;
  if (raw & 3) {
    put4(dst, i, word >> (8 * (4 - (raw & 3))), packet_size, aligned);
    i += 4;
  }
  for (; i < packet_size; i += 4) put4(dst, i, 0u, packet_size, aligned);
  if (kDebug) {
    flags[pkt] = flag;
    flags[n_packets + pkt] = cursor;
  }
}

template <bool kDebug>
int launch(const uint8_t* b, int64_t blob_len, const int64_t* o, int region,
           const int* r, int n, int packet_size, uint8_t* d, int* f,
           cudaStream_t s) {
  const auto kernel = decode_kernel<kDebug>;
  static SharedAllowance allowance;
  const cudaError_t e = allowance.allow(reinterpret_cast<const void*>(kernel),
                                        Model::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(n + Model::kBlock - 1) / Model::kBlock, Model::kBlock,
           Model::kBytes, s>>>(b, blob_len, o, region, r, n, packet_size, d,
                               f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gpuar_decode(const void* blob, int64_t blob_len,
                            const void* offsets, int region,
                            const void* raw_sizes, int n, int packet_size,
                            void* out, void* flags, int debug, void* stream) {
  if (n <= 0) return 0;
  const auto go = debug ? launch<true> : launch<false>;
  return go(static_cast<const uint8_t*>(blob), blob_len,
            static_cast<const int64_t*>(offsets), region,
            static_cast<const int*>(raw_sizes), n, packet_size,
            static_cast<uint8_t*>(out), static_cast<int*>(flags),
            static_cast<cudaStream_t>(stream));
}

// gpuar_decode's launch: threads and dynamic shared memory bytes per block
// (PacketModel's, so gpuar_encode's too).
extern "C" int gpuar_decode_shape(int* threads, int* smem_bytes) {
  *threads = Model::kBlock;
  *smem_bytes = Model::kBytes;
  return 0;
}
