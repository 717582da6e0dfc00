// K2 / K3: per-packet adaptive arithmetic decode, one warp per packet;
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
// What bounds it on the H100: the serial per-symbol chain (division by the
// span, the symbol search, two table reads, two divisions by cum) --
// latency, not bytes: K2 takes 20.7 ms for a 64 MiB batch of mostly random
// bytes, under 1% of HBM bandwidth for what it moves (NVIDIA H100 80GB
// HBM3, 700.00 W, chip_smoke.py).  One warp per packet keeps 8192 chains
// in flight for a 64 MiB batch; the symbol search is one compare pass over
// each lane's 8 registers plus one __reduce_add_sync, and the model update
// is 8 predicated adds per lane.
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

namespace {

using namespace gpuar;

// MSB-first bit reader over one packet's window.  Every lane keeps the
// same state and issues the same (broadcast) loads.
struct BitReader {
  const uint8_t* base;  // packet start
  int64_t limit;        // readable bytes from base
  uint64_t buf;         // next bits, left-aligned
  int nb;               // valid bits in buf
  int q;                // next byte to load, from the packet start

  __device__ __forceinline__ uint32_t byte_at(int i) const {
    return i < limit ? base[i] : 0u;
  }

  __device__ __forceinline__ void refill() {  // call with nb < 32
    const uint32_t w = (byte_at(q) << 24) | (byte_at(q + 1) << 16) |
                       (byte_at(q + 2) << 8) | byte_at(q + 3);
    buf |= static_cast<uint64_t>(w) << (32 - nb);
    nb += 32;
    q += 4;
  }

  __device__ __forceinline__ uint32_t take(uint32_t s) {  // s <= 16 <= nb
    const uint32_t bits = s ? static_cast<uint32_t>(buf >> (64 - s)) : 0u;
    buf <<= s;
    nb -= static_cast<int>(s);
    return bits;
  }
};

template <bool kDebug>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
decode_kernel(const uint8_t* __restrict__ blob, int64_t blob_len,
              const int64_t* __restrict__ offsets, int region,
              const int* __restrict__ raw_sizes, int n_packets,
              int packet_size, uint8_t* __restrict__ out,
              int* __restrict__ flags) {
  const int lane = threadIdx.x & 31;
  const int pkt = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pkt >= n_packets) return;  // whole warp leaves together

  int raw = raw_sizes[pkt];
  raw = raw < 0 ? 0 : (raw > packet_size ? packet_size : raw);
  uint8_t* dst = out + static_cast<size_t>(pkt) * packet_size;
  int64_t off = offsets[pkt];
  off = off < 0 ? 0 : (off > blob_len ? blob_len : off);
  const int64_t room = blob_len - off;

  BitReader br{blob + off, room < region ? room : region, 0, 0, 4};
  br.refill();
  uint32_t code = br.take(16);  // initializeDecoder: the first 16 bits
  int cursor = 48;              // bits from the packet start

  int c[8];
  model_reset(c, lane);
  int cum = 256;
  uint32_t lo = 0, hi = kU16;
  int flag = 0;
  int mine = 0;  // this lane's byte of the current 32-symbol group

  for (int t = 0; t < raw; ++t) {
    if (br.nb < 32) br.refill();
    int span = static_cast<int>(hi) - static_cast<int>(lo) + 1;
    span = span < 1 ? 1 : span;
    const int num = (static_cast<int>(code) - static_cast<int>(lo) + 1) * cum - 1;
    const int unscaled = num >= 0 ? num / span : -1;
    if (kDebug) flag |= (unscaled >= cum) | (unscaled < 0);

    // sym = #{i in 1..256 : C[i] <= unscaled}, clipped to 255.
    int le = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) le += c[r] <= unscaled ? 1 : 0;
    int sym = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(le)));
    sym = sym > 255 ? 255 : sym;

    const uint32_t low = cum_at(c, sym), high = cum_at(c, sym + 1);
    uint32_t lo2 = lo, hi2 = hi;
    narrow(lo2, hi2, static_cast<uint32_t>(span), low, high,
           static_cast<uint32_t>(cum));
    if (kDebug) flag |= lo2 > hi2;
    model_bump(c, lane, sym);
    ++cum;

    uint32_t m, k;
    renorm(lo2, hi2, m, k);
    const uint32_t s = m + k;
    code = (((code << s) | br.take(s)) ^ (k ? 0x8000u : 0u)) & kU16;
    cursor += static_cast<int>(s);
    lo = lo2;
    hi = hi2;

    // Symbols leave in coalesced 32-byte groups.
    if (lane == (t & 31)) mine = sym;
    if ((t & 31) == 31 || t == raw - 1) {
      const int g = t & ~31;
      if (lane <= (t & 31)) dst[g + lane] = static_cast<uint8_t>(mine);
    }
  }
  for (int i = raw + lane; i < packet_size; i += 32) dst[i] = 0;
  if (kDebug && lane == 0) {
    flags[pkt] = flag;
    flags[n_packets + pkt] = cursor;
  }
}

}  // namespace

extern "C" int gpuar_decode(const void* blob, int64_t blob_len,
                            const void* offsets, int region,
                            const void* raw_sizes, int n, int packet_size,
                            void* out, void* flags, int debug, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint8_t*>(blob);
  const auto* o = static_cast<const int64_t*>(offsets);
  const auto* r = static_cast<const int*>(raw_sizes);
  auto* d = static_cast<uint8_t*>(out);
  auto* f = static_cast<int*>(flags);
  if (debug)
    decode_kernel<true><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
        b, blob_len, o, region, r, n, packet_size, d, f);
  else
    decode_kernel<false><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
        b, blob_len, o, region, r, n, packet_size, d, f);
  return static_cast<int>(cudaGetLastError());
}
