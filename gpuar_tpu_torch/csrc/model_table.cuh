// The table that a QuadModel holds, written out row by row: the final
// tables of the probes that run one chain a thread on the codec kernels'
// model (P1's tree variants in probe_model.cu, P4's k_update in
// probe_layouts.cu).  Like the TPU probes' tables, which stay in VMEM
// scratch, these are stored so that no update is dead.
#pragma once

#include <cstdint>

#include "packet_model.cuh"

namespace gpuar {

// row[s] = as_row(C[s]) for s in [0, 256), C[s] the low of
// QuadModel::prefix(s).
template <int kThreads, class T, class AsRow>
__device__ __forceinline__ void write_table(const QuadModel<kThreads>& model,
                                            T* row, AsRow as_row) {
  for (int s = 0; s < 256; ++s) {
    uint32_t low, high;
    model.prefix(s, low, high);
    row[s] = static_cast<T>(as_row(low));
  }
}

}  // namespace gpuar
