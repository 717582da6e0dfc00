// Per-thread pieces of the adaptive arithmetic coder, for kernels that
// code one packet per thread: the model of one packet, held by its thread
// in registers and shared memory, and the coder's divisions by cum and
// renormalisation in few dependent steps (narrow_by, renorm_s, equal to
// the plain coder's narrowing and renormalisation,
// ops/torch_codec.py::_apply_symbol_range and _renorm).
//
// The model is the coder's cumulative table C[0..256]: C[0] = 0 and C[i]
// is the sum of the counts of the symbols below i.  Every count starts at
// 1 (C[i] = i, cum = C[256] = 256) and there is no rescale: a packet has
// at most 8192 symbols, so cum stays at or below 8448.  QuadModel holds it
// as a 4-ary tree of prefix sums.  A node holds the running totals of its
// 4 children, so finding a symbol takes 4 levels of one compare each: the
// top two levels from registers, the two below one 16-byte load each.
// Counting a symbol touches one node a level.  1280 bytes of shared
// memory a thread.
//
// Layout: entry e of thread t at byte (e * kThreads + t) * width, width
// the entry's bytes and kThreads, the block's thread count, a power of
// two and a multiple of 32: whatever entry each lane reads, a warp's
// lanes read consecutive words, so no two share a bank.  The stride is a
// compile-time constant, so an entry's address is the thread's column
// plus a constant or a multiple of the entry's index.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "coder.cuh"

namespace gpuar {

// Division by cum without a divide on the symbol's chain.  inv(cum) =
// floor((2^32 - 1) / cum) comes from a table made at compile time (cum
// is 256 + the symbol's index, so a warp's threads read one entry), and
// x / cum for x < 2^31 is then one multiply-high and one correction:
// inv is less than 1 + 1/cum below 2^32 / cum, so x * inv / 2^32 falls
// short of x / cum by less than 1.
constexpr int kInvEntries = 8449;  // cum = 256 .. 8704

struct InvTable {
  uint32_t v[kInvEntries];
};

constexpr InvTable make_inv_table() {
  InvTable t{};
  for (int i = 0; i < kInvEntries; ++i)
    t.v[i] = 0xFFFFFFFFu / static_cast<uint32_t>(256 + i);
  return t;
}

__constant__ InvTable kInv = make_inv_table();

// inv(cum) for cum >= 256.
__device__ __forceinline__ uint32_t reciprocal(uint32_t cum) {
  const uint32_t i = cum - 256;
  if (__builtin_expect(i >= kInvEntries, 0)) return 0xFFFFFFFFu / cum;
  return kInv.v[i];
}

__device__ __forceinline__ uint32_t div_by(uint32_t x, uint32_t d,
                                           uint32_t inv) {
  const uint32_t q = __umulhi(x, inv);
  return x - q * d >= d ? q + 1 : q;
}

// The coder's narrowing of [lo, hi] to [low, high) of cum
// (applySymbolRange: the new upper bound uses the old lower one; the
// products stay below 2^31), its two divisions by cum taken by div_by.
__device__ __forceinline__ void narrow_by(uint32_t& lo, uint32_t& hi,
                                          uint32_t span, uint32_t low,
                                          uint32_t high, uint32_t cum,
                                          uint32_t inv) {
  hi = (lo + div_by(high * span, cum, inv) - 1) & kU16;
  lo = (lo + div_by(low * span, cum, inv)) & kU16;
}

// The closed-form renormalisation (ops/torch_codec.py::_renorm: m
// settled bits, then k straddle removals) in fewer dependent steps, equal
// to it for every (lo, hi) of 16 bits: its straddle count k is the run of
// ones that (lo & ~hi) starts right after the m settled bits, and both
// bounds then shift by s = m + k at once.  -> s and k.
__device__ __forceinline__ void renorm_s(uint32_t& lo, uint32_t& hi,
                                         uint32_t& s, uint32_t& k) {
  const uint32_t m = __clz(lo ^ hi) - 16;
  k = __clz(~(((lo & ~hi) << 16) << (m + 1)));
  s = m + k;
  lo = (lo << s) & 0x7FFFu;
  hi = ((hi << s) | ((1u << s) - 1) | 0x8000u) & kU16;
}

template <int kThreads>
struct QuadModel {
  // Node n: level 0 is node 0, level 1 nodes 1..4, level 2 nodes 5..20,
  // level 3 nodes 21..84; node n's children are 4n + 1 .. 4n + 4, and a
  // level-L node covers 4^(4 - L) symbols, child j of it the j-th quarter.
  // A node holds {S1, S2, S3, S4}: Sj is the total count of its first j
  // children.  So a leaf's Sj - S(j-1) is one symbol's count, and C[s] is
  // the sum, over the levels, of the S before s's child (0 for child 0).
  // Levels 0 and 1 (the S1..S3 of nodes 0..4) live in registers, where
  // every symbol updates them and the search starts; levels 2 and 3 in
  // shared memory.
  static_assert(kThreads % 32 == 0, "one bank per lane needs whole warps");
  static constexpr int kBlock = kThreads;
  static constexpr int kWidth = 16;  // bytes of a node
  static constexpr int kRow = kWidth * kThreads;  // from node to node
  static constexpr int kBytes = 80 * kRow;  // nodes 5..84, a block's
  char* col;  // this thread's node 5
  uint32_t r[3];        // node 0's S1..S3
  uint32_t a[4], b[4], c[4];  // node 1 + i's S1, S2, S3

  __device__ __forceinline__ uint4& node(int n) const {
    return *reinterpret_cast<uint4*>(col + (n - 5) * kRow);
  }

  // Every count 1: child j of a level-L node covers 4^(3 - L) symbols.
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int j = 0; j < 3; ++j) r[j] = 64 * (j + 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = 16;
      b[i] = 32;
      c[i] = 48;
    }
    for (int n = 5; n < 21; ++n) node(n) = make_uint4(4, 8, 12, 16);
    for (int n = 21; n < 85; ++n) node(n) = make_uint4(1, 2, 3, 4);
  }

  // Count one occurrence of s: on each level, the node over s adds 1 to
  // each Sj past s's child.  The 2 shared nodes' addresses follow from s
  // alone, so neither waits on the other: both are loaded before either
  // is stored (the compiler cannot tell that the two never alias, so a
  // store between them would hold the second load back).
  __device__ __forceinline__ void bump(int s) {
#pragma unroll
    for (int j = 0; j < 3; ++j) r[j] += s < 64 * (j + 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // s - 64i in [0, 16j): below child j
      const uint32_t d = static_cast<uint32_t>(s - 64 * i);
      a[i] += d < 16;
      b[i] += d < 32;
      c[i] += d < 48;
    }
    uint4& m = node(5 + (s >> 4));
    uint4& v = node(21 + (s >> 2));
    const uint4 om = m, ov = v;
    m = counted(om, (s >> 2) & 3);
    v = counted(ov, s & 3);
  }

  // Node n after counting a symbol under its child k.
  __device__ __forceinline__ static uint4 counted(uint4 n, int k) {
    return make_uint4(n.x + (k < 1), n.y + (k < 2), n.z + (k < 3),
                      n.w + 1u);
  }

  // low = C[s] and high = C[s + 1] for s in [0, 255]: on each level, the
  // S before s's child (0 for child 0) of the node over s; high takes the
  // leaf's S of s's own child instead.  The root and level 1 come from
  // registers by selects, and the two shared nodes' addresses follow from
  // s alone, so both loads go out together.
  __device__ __forceinline__ void prefix(int s, uint32_t& low,
                                         uint32_t& high) const {
    const uint4 m = node(5 + (s >> 4));
    const uint4 v = node(21 + (s >> 2));
    const int j0 = s >> 6, j1 = (s >> 4) & 3, j2 = (s >> 2) & 3, j3 = s & 3;
    const uint32_t base =
        sel(j0, 0u, r[0], r[1], r[2]) +
        sel(j1, 0u, pick(a, j0), pick(b, j0), pick(c, j0)) +
        sel(j2, 0u, m.x, m.y, m.z);
    low = base + sel(j3, 0u, v.x, v.y, v.z);
    high = base + sel(j3, v.x, v.y, v.z, v.w);
  }

  // The symbol whose range holds the code: sym = #{i in 1..256 : C[i] <=
  // unscaled} clipped to 255, low = C[sym] and high = C[sym + 1], where
  // unscaled = num / span for num >= 0 and -1 below (span >= 1).  No
  // division: C[i] <= unscaled is C[i] * span <= num for integers, and the
  // descent keeps rem = num - C[first symbol of the node] * span; the
  // products stay below 2^31 while cum * 65536 does.  A level compares
  // S1..S3 of one node (S4 never: so a code at or past cum gives 255, and
  // one below the range, num < 0, gives 0, as the full count does) and
  // goes to child #{j : Sj * span <= rem}.  Straight-line code: two levels
  // from registers, then a node load a level.
  __device__ __forceinline__ int search(int num, int span, uint32_t& low,
                                        uint32_t& high) const {
    int rem = num, lo = 0;
    const int j0 = step(r[0], r[1], r[2], span, rem, lo);
    const int j1 = step(pick(a, j0), pick(b, j0), pick(c, j0), span, rem, lo);
    const int n2 = 5 + 4 * j0 + j1;
    const uint4 m = node(n2);
    const int j2 = step(m.x, m.y, m.z, span, rem, lo);
    const int n3 = 21 + 4 * (n2 - 5) + j2;
    const uint4 v = node(n3);
    const bool t1 = static_cast<int>(v.x) * span <= rem;
    const bool t2 = static_cast<int>(v.y) * span <= rem;
    const bool t3 = static_cast<int>(v.z) * span <= rem;
    low = static_cast<uint32_t>(lo) + (t3 ? v.z : t2 ? v.y : t1 ? v.x : 0u);
    high = static_cast<uint32_t>(lo) + (t3 ? v.w : t2 ? v.z : t1 ? v.y : v.x);
    return 4 * (n3 - 21) + t1 + t2 + t3;
  }

  // x_j for j in [0, 3], by selects.
  __device__ __forceinline__ static uint32_t sel(int j, uint32_t x0,
                                                 uint32_t x1, uint32_t x2,
                                                 uint32_t x3) {
    return j & 2 ? (j & 1 ? x3 : x2) : (j & 1 ? x1 : x0);
  }

  // x[j] for j in [0, 3], by selects (a dynamic index into a register
  // array would put it in local memory).
  __device__ __forceinline__ static uint32_t pick(const uint32_t (&x)[4],
                                                  int j) {
    return sel(j, x[0], x[1], x[2], x[3]);
  }

  // One level of the search over a node's S1..S3: its child number, with
  // rem and lo moved past the children before it.
  __device__ __forceinline__ static int step(uint32_t s1, uint32_t s2,
                                             uint32_t s3, int span, int& rem,
                                             int& lo) {
    const int p1 = static_cast<int>(s1) * span;
    const int p2 = static_cast<int>(s2) * span;
    const int p3 = static_cast<int>(s3) * span;
    // S1 <= S2 <= S3, so t3 implies t2 implies t1.
    const bool t1 = p1 <= rem, t2 = p2 <= rem, t3 = p3 <= rem;
    rem -= t2 ? (t3 ? p3 : p2) : (t1 ? p1 : 0);
    lo += t2 ? (t3 ? s3 : s2) : (t1 ? s1 : 0u);
    return t1 + t2 + t3;
  }
};

// The codec kernels' model (K1, K2, K3): blocks of 64 packets, each
// thread's model in the block's dynamic shared memory.
using PacketModel = QuadModel<64>;

// Above 48 KB a block's dynamic shared memory must be allowed first, and
// the allowance is the current device's state: a launch site keeps one
// of these per kernel and calls allow() before each launch, which sets
// the allowance once per device.
class SharedAllowance {
 public:
  cudaError_t allow(const void* kernel, int bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices && done_[dev].load(std::memory_order_acquire))
      return cudaSuccess;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e == cudaSuccess && dev < kMaxDevices)
      done_[dev].store(true, std::memory_order_release);
    return e;
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::atomic<bool> done_[kMaxDevices] = {};
};

}  // namespace gpuar
