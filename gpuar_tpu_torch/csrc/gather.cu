// G1: a batch's .gip body gathered on the card from K1's packet rows.
//
// Replaces no TPU kernel: it is the port's own.  K1 (encode.cu) leaves
// packet i in row i of a fixed stride (8,736 bytes at 8192).  The JAX
// package gathers those rows into 96-byte rows with jitted XLA
// (gpuar_tpu/parallel/mesh.py::_compact_rows), because the TPU's vector
// unit cannot gather at byte granularity, and the host then strips the
// row padding (native.splice_at).  This kernel puts every packet at its
// byte offset in the body:
//
//   body[offsets[i] .. offsets[i] + lengths[i]) = packets[i, 0 .. lengths[i])
//
// so the batch's download is the body as it lies in the file, and the
// host splices nothing.  The kernel reads the inclusive prefix sum of the
// lengths, ends (one cumsum on the card, ops/encode.py::gather_body):
// packet i's offset is ends[i - 1] and its length ends[i] - ends[i - 1].
//
// What bounds it on the H100: bytes.  It reads and writes each body byte
// once, about 35 MB each way for a batch of 4224 random packets, some 21
// us at 3.35 TB/s, against K1's 1.5 ms.  The destination offsets are not
// aligned, and neighbouring packets share the words at their edges.  The
// design: one block a packet, so no two blocks write one byte; its
// threads stride over the packet's bytes a byte each, so a warp's loads
// and stores each cover 32 consecutive bytes whatever the destination's
// alignment; each thread keeps kUnroll loads in flight before its stores.
// Aligned 16-byte stores from funnel-shifted source words are untried.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
gather_body_kernel(const uint8_t* __restrict__ packets, int stride,
                   const int64_t* __restrict__ ends,
                   uint8_t* __restrict__ body) {
  const int pkt = blockIdx.x;
  const int64_t start = pkt ? ends[pkt - 1] : 0;
  const int64_t span = ends[pkt] - start;
  // K1's lengths lie in [0, stride]; anything else copies nothing rather
  // than read or write out of bounds.
  if (span < 0 || span > stride || start < 0 ||
      start + span > static_cast<int64_t>(gridDim.x) * stride)
    return;
  const int len = static_cast<int>(span);
  const uint8_t* src = packets + static_cast<size_t>(pkt) * stride;
  uint8_t* dst = body + start;
  for (int j = threadIdx.x; j < len; j += kUnroll * kThreads) {
    uint8_t v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int at = j + k * kThreads;
      v[k] = at < len ? __ldg(src + at) : 0;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int at = j + k * kThreads;
      if (at < len) dst[at] = v[k];
    }
  }
}

}  // namespace

// packets uint8 [n, stride], ends int64 [n] (the inclusive prefix sum of
// the packets' lengths, each in [0, stride]) -> body uint8 [n * stride],
// whose first ends[n - 1] bytes are the packets' bytes back to back; all
// on the device.
extern "C" int gpuar_gather_body(const void* packets, int stride,
                                 const void* ends, int n, void* body,
                                 void* stream) {
  if (n <= 0) return 0;
  gather_body_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packets), stride,
      static_cast<const int64_t*>(ends), static_cast<uint8_t*>(body));
  return static_cast<int>(cudaGetLastError());
}
