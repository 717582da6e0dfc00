// The input of the probes that run one chain a thread (P1 in
// probe_model.cu, P3 in profile_encode.cu): chain c reads column c of
// int32 words [rows, stride], so a warp's threads read neighbouring 4-byte
// words, in chunks of kChunk words, each chunk loaded while the one before
// it is used, as K1 loads its input a 16-byte chunk ahead (encode.cu).
//
// Both probes are tuned through this one file (NVIDIA H100 80GB HBM3,
// 700.00 W; python -m gpuar_tpu_torch.probes model encode).  One word
// ahead left every cheap P1 variant and P3's L1 waiting on the load
// (v9_noop 3.0187 ms at 512 chains, as long as v6 or v12; L1 1.4795 ms
// against K1's 1.5325).  Chunks of 8 words slowed the update variants (v0
// 5.9000 -> 6.2715 ms).  A ring of single loads, each 8 words ahead, put
// v9 back at 2.6516 ms: shifting a register whose load is still in flight
// waits for that load.
#pragma once

#include <cstdint>

namespace gpuar {

constexpr int kChunk = 4;  // words a chunk: 16 symbols, K1's chunk

// Words row .. row + kChunk - 1 of a column (stride: words from one row
// to the next).
__device__ __forceinline__ void load_chunk(const int* col, int row,
                                           int stride,
                                           uint32_t (&w)[kChunk]) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
    w[i] = static_cast<uint32_t>(
        __ldg(col + static_cast<size_t>(row + i) * stride));
}

// use(word, i) for each word i of chunk `cur`, in order, one word an
// iteration (the step's code appears once).  The words shift down a
// register each time, so no index into cur is dynamic: a dynamic index
// would put the chunk in local memory.  cur is consumed.
template <class Use>
__device__ __forceinline__ void each_word(uint32_t (&cur)[kChunk],
                                          Use&& use) {
#pragma unroll 1
  for (int i = 0; i < kChunk; ++i) {
    const uint32_t w = cur[0];
#pragma unroll
    for (int r = 0; r + 1 < kChunk; ++r) cur[r] = cur[r + 1];
    use(w, i);
  }
}

}  // namespace gpuar
