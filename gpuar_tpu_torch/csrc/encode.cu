// K1: per-packet adaptive order-0 arithmetic encode, one warp per packet.
//
// Replaces the TPU kernel gpuar_tpu/ops/pallas_encode.py::_encode_kernel
// (launched by _encode_big2d under _encode_call).  The contract is the
// bytes: for every packet, the first lengths[i] bytes equal the golden
// codec's native.encode_packet(data[i, :sizes[i]]).
//
// What bounds it on the H100: the serial per-symbol chain (two table reads
// by shuffle, two integer divisions, renormalisation) -- latency, not
// bytes.  A 64 MiB batch of mostly random bytes takes 17.0 ms here while
// moving about 134 MB in and out, under 1% of HBM bandwidth (NVIDIA H100
// 80GB HBM3, 700.00 W, chip_smoke.py).  The design answer is parallel
// slack: one warp per packet puts 8192 chains in flight for a 64 MiB
// batch (about one wave of the card's warp slots), and the warp's 32
// lanes share the 257-entry model so the suffix increment is 8 predicated
// register adds per lane instead of a 256-entry loop.
//
// None of the TPU kernel's mechanism is carried over: no lane-major
// tables, no f32-reciprocal division, no hull windows, no ring of output
// words and no MAX_RUN_BITS error flag.  The pending-underflow run is
// emitted in a loop, so it is unbounded (the greedy adversary reaches
// about 133 bits) and no host re-encode path exists.
#include <cuda_runtime.h>

#include "coder.cuh"

namespace {

using namespace gpuar;

// MSB-first bit writer.  Every lane keeps the same state; lane 0 stores.
// Words go out big-endian from byte 4 (after the header), whole 32 bits at
// a time; close() drains the last bytes with writeClose's left-aligned pad.
struct BitWriter {
  uint8_t* row;
  int cap;        // bytes of the output row
  bool store;     // this lane stores
  uint64_t acc;   // pending bits, right-aligned; < 32 between calls
  int n;
  int pos;        // next byte of the row

  __device__ __forceinline__ void put(uint32_t v, int k) {  // k <= 32
    acc = (acc << k) | v;
    n += k;
    if (n >= 32) {
      n -= 32;
      const uint32_t w = static_cast<uint32_t>(acc >> n);
      if (store && pos + 4 <= cap)
        *reinterpret_cast<uint32_t*>(row + pos) = __byte_perm(w, 0, 0x0123);
      pos += 4;
    }
  }

  __device__ __forceinline__ void run(uint32_t bit, uint32_t len) {
    while (len) {
      const int c = len > 32 ? 32 : static_cast<int>(len);
      put(bit ? (c == 32 ? 0xFFFFFFFFu : (1u << c) - 1) : 0u, c);
      len -= c;
    }
  }

  __device__ __forceinline__ void close() {
    while (n >= 8) {
      n -= 8;
      if (store && pos < cap) row[pos] = static_cast<uint8_t>(acc >> n);
      ++pos;
    }
    if (n) {
      if (store && pos < cap) row[pos] = static_cast<uint8_t>(acc << (8 - n));
      ++pos;
      n = 0;
    }
  }
};

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
encode_kernel(const uint8_t* __restrict__ data, const int* __restrict__ sizes,
              int n_packets, int packet_size, uint8_t* __restrict__ out,
              int stride, int* __restrict__ lengths) {
  const int lane = threadIdx.x & 31;
  const int pkt = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pkt >= n_packets) return;  // whole warp leaves together

  const uint8_t* in = data + static_cast<size_t>(pkt) * packet_size;
  uint8_t* row = out + static_cast<size_t>(pkt) * stride;
  int size = sizes[pkt];
  size = size < 0 ? 0 : (size > packet_size ? packet_size : size);

  int c[8];
  model_reset(c, lane);
  uint32_t cum = 256, lo = 0, hi = kU16, under = 0;
  BitWriter bw{row, stride, lane == 0, 0, 0, 4};

  for (int t0 = 0; t0 < size; t0 += 32) {
    // One coalesced byte per lane, handed out by shuffle below.
    const int mine = t0 + lane < size ? in[t0 + lane] : 0;
    const int steps = size - t0 < 32 ? size - t0 : 32;
    for (int j = 0; j < steps; ++j) {
      const int sym = __shfl_sync(kFull, mine, j);
      const uint32_t low = cum_at(c, sym), high = cum_at(c, sym + 1);
      uint32_t lo2 = lo, hi2 = hi;
      narrow(lo2, hi2, hi - lo + 1, low, high, cum);
      model_bump(c, lane, sym);
      ++cum;
      uint32_t m, k;
      const uint32_t settled = hi2;  // the m common MSBs come from here
      renorm(lo2, hi2, m, k);
      if (m) {
        const uint32_t topm = (settled >> (16 - m)) & ((1u << m) - 1);
        const uint32_t b0 = topm >> (m - 1);
        bw.put(b0, 1);
        bw.run(b0 ^ 1u, under);
        if (m > 1) bw.put(topm & ((1u << (m - 1)) - 1), m - 1);
        under = 0;
      }
      under += k;
      lo = lo2;
      hi = hi2;
    }
  }

  // writeRemaining: lower's second bit, then underflow+1 complements.
  const uint32_t tb = (lo >> 14) & 1u;
  bw.put(tb, 1);
  bw.run(tb ^ 1u, under + 1);
  bw.close();
  if (lane == 0) {
    // Header [u16 LE total][u16 LE raw] as one little-endian word.
    *reinterpret_cast<uint32_t*>(row) =
        (static_cast<uint32_t>(bw.pos) & 0xFFFFu) |
        (static_cast<uint32_t>(size) << 16);
    lengths[pkt] = bw.pos;
  }
}

}  // namespace

extern "C" int gpuar_encode(const void* data, const void* sizes, int n,
                            int packet_size, void* out, int stride,
                            void* lengths, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  encode_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(sizes), n,
      packet_size, static_cast<uint8_t*>(out), stride,
      static_cast<int*>(lengths));
  return static_cast<int>(cudaGetLastError());
}
