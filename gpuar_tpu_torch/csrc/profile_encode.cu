// P3: the encoder's phase ablation, K1's structure cut off at each level.
//
// Replaces the TPU probe benchmarks/profile_encode.py::make_kernel
// (pallas_call at :191 in `call`).  Level L runs phases 1..L of an
// encoder step and computes the probe's per-packet outputs:
//
//   L1 the model: two table reads, the suffix update   chk += low + high
//   L2 + the range narrowing and renormalisation       chk += b0+pat+drain
//   L3 + the bit appends into a 32-bit accumulator     chk += words, flags
//   L4 + the word stores
//   L5 + the stores of the whole fill words of an underflow run
//
// and len = chk + wcur (profile_encode.py:165), wcur the count of words
// the stream has reached (1 at the start, for the packet header).  From
// L4 on, chk stays 0 and the words are stored.
//
// What the TPU levels did with a VMEM ring of 16 words and a dump of it
// into the output tile (L4 and L5) has no counterpart here: on the H100
// the ring becomes the word stores K1 makes, lane 0 writing each word in
// place as it completes.  So L4 stores each completed word at its index
// wcur of the packet's row, and L5 adds what K1's run loop writes for a
// long pending-underflow run: its whole fill words, at their place in the
// stream (after the drained bits that fit the accumulator).  Indices past
// the row (out_words) are not stored.
//
// One warp per packet, as K1: the model in registers (lane j holds
// C[8j+1..8j+8]; csrc/coder.cuh), reads by shuffle, coder state uniform
// across the warp.  The probe's cumulative total is 256 + t at step t
// (it reads row 256 only as that total).  What bounds it on the H100:
// the serial chain per symbol, as K1 (latency, not bytes).  All values
// are uint32 with wrapping adds, as the TPU's int32 arithmetic.
#include <cuda_runtime.h>

#include <cstdint>

#include "coder.cuh"

namespace {

using namespace gpuar;

struct Append {   // profile_encode.make_kernel's `append`
  uint32_t acc, nbuf, word, flushing;
};

__device__ __forceinline__ Append append(uint32_t acc, uint32_t nbuf,
                                         uint32_t val, uint32_t n) {
  const uint32_t newn = nbuf + n;
  const uint32_t over = newn > 32 ? newn - 32 : 0;
  const bool flushing = newn >= 32;
  const uint32_t word = flushing ? (acc | (val >> over)) : 0u;
  const uint32_t rem = val & ((1u << over) - 1);
  const uint32_t lshift = newn >= 32 ? 0u : (32 - newn > 31 ? 31u : 32 - newn);
  const uint32_t acc2 = flushing ? (rem << ((32 - over) & 31))
                                 : (acc | (val << lshift));
  return {acc2, flushing ? over : newn, word, flushing ? 1u : 0u};
}

template <int LEVEL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
profile_kernel(const int* __restrict__ sizes, const int* __restrict__ words,
               int n_packets, int steps, uint32_t* __restrict__ out,
               int out_words, int* __restrict__ len) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_packets) return;  // whole warp leaves together

  const int size = sizes[b];
  const int rows_in = steps >> 2;
  uint32_t* row = out + static_cast<size_t>(b) * out_words;
  int c[8];
  model_reset(c, lane);
  uint32_t lower = 0, upper = kU16, under = 0, acc = 0, nbuf = 0, wcur = 1,
           chk = 0;
  int mine = 0;

  auto store = [&](uint32_t w, uint32_t at) {
    if (lane == 0 && at < static_cast<uint32_t>(out_words)) row[at] = w;
  };

  for (int tt = 0; tt < steps; ++tt) {
    // Words [steps/4, B]: at every 128th step lane l loads word tt/4 + l.
    if ((tt & 127) == 0) {
      const int r = (tt >> 2) + lane;
      mine = r < rows_in ? words[static_cast<size_t>(r) * n_packets + b] : 0;
    }
    const int w_in = __shfl_sync(kFull, mine, (tt >> 2) & 31);
    const bool active = tt < size;
    const int sym = active ? (w_in >> ((tt & 3) * 8)) & 0xFF : 0;
    const uint32_t cum = 256 + tt;

    // L1: the model.
    const uint32_t low = cum_at(c, sym);
    const uint32_t h = cum_at(c, sym + 1);
    const uint32_t high = sym == 255 ? cum : h;
    if (active) model_bump(c, lane, sym);
    if (LEVEL == 1) {
      chk += low + high;
      continue;
    }

    // L2: range narrowing and renormalisation.
    uint32_t lo2 = lower, up2 = upper;
    narrow(lo2, up2, upper - lower + 1, low, high, cum);
    const uint32_t settled = up2;
    uint32_t m, k;
    renorm(lo2, up2, m, k);   // lo2 / up2 become lo3 / up3
    const uint32_t topm = (settled >> (16 - m)) & ((1u << m) - 1);
    const bool has = m > 0 && active;
    const uint32_t m_e = has ? m : 0;
    const uint32_t b0 = has ? topm >> (m > 0 ? m - 1 : 0) : 0;
    const uint32_t u_drain = has ? under : 0;
    const uint32_t npat = m_e > 0 ? m_e - 1 : 0;
    const uint32_t pat = has ? topm & ((1u << npat) - 1) : 0;
    const uint32_t under2 = (has ? 0 : under) + (active ? k : 0);
    if (active) {
      lower = lo2;
      upper = up2;
    }
    if (LEVEL == 2) {
      chk += b0 + pat + u_drain;
      under = under2;
      continue;
    }

    // L3: the bit appends.
    const Append a1 = append(acc, nbuf, b0, has ? 1u : 0u);
    const uint32_t r1 = min(u_drain, (32 - a1.nbuf) & 31);
    const uint32_t fill_bits = b0 == 0 ? 1u : 0u;   // the run is ~b0
    const Append a2 = append(a1.acc, a1.nbuf, fill_bits ? (1u << r1) - 1 : 0u,
                             r1);
    uint32_t left = u_drain - r1;
    const uint32_t runw = left >> 5;
    left -= runw << 5;
    const Append a3 = append(a2.acc, a2.nbuf,
                             fill_bits ? (1u << left) - 1 : 0u, left);
    const Append a4 = append(a3.acc, a3.nbuf, pat, npat);
    acc = a4.acc;
    nbuf = a4.nbuf;
    under = under2;
    if (LEVEL == 3) {
      chk += a1.word + a2.word + a3.word + a4.word + a1.flushing +
             a2.flushing + a3.flushing + a4.flushing;
      wcur += a1.flushing + a2.flushing + a3.flushing + a4.flushing + runw;
      continue;
    }

    // L4: the word stores; L5: the run's whole fill words as well.
    if (a1.flushing) store(a1.word, wcur);
    wcur += a1.flushing;
    if (a2.flushing) store(a2.word, wcur);
    wcur += a2.flushing;
    if (LEVEL >= 5 && runw) {
      const uint32_t fill = fill_bits ? 0xFFFFFFFFu : 0u;
      for (uint32_t i = lane; i < runw; i += 32)
        if (wcur + i < static_cast<uint32_t>(out_words)) row[wcur + i] = fill;
    }
    wcur += runw;
    if (a3.flushing) store(a3.word, wcur);
    wcur += a3.flushing;
    if (a4.flushing) store(a4.word, wcur);
    wcur += a4.flushing;
  }
  if (lane == 0) len[b] = static_cast<int>(chk + wcur);
}

template <int LEVEL>
cudaError_t launch(const int* sizes, const int* words, int n, int steps,
                   uint32_t* out, int out_words, int* len,
                   cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  profile_kernel<LEVEL><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      sizes, words, n, steps, out, out_words, len);
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
