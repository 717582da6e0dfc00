// Serial host codec: the native verification oracle and `--host` backend.
//
// Re-implements the adaptive order-0 arithmetic coder that the reference
// (jiahansu/GPUAR) compiles __host__ __device__ in src/gpuar_kernel.cu
// (encode :487-531, decode :848-892).  Same algorithm, fresh structure:
// the model is an explicit cumulative-frequency row (the reference uses a
// Fenwick tree storing identical counts, :205-238), and the decode symbol
// search is a branch-free binary search over that row (:727-763 equivalent).
// Output bitstreams are bit-identical to the reference by construction.
//
// Exposed C ABI (loaded from Python via ctypes):
//   tg_encode_packet / tg_decode_packet      one packet
//   tg_encode_batch  / tg_decode_batch       fixed-stride packet batches
//   tg_encode_stream / tg_decode_stream      back-to-back .gip packet bodies
//   tg_walk_packets                          the decode reader's packet walk

#include <cstdint>
#include <cstring>

#if defined(__AVX512BW__) && !defined(TG_NO_MASKPOP)
#define TG_USE_MASKPOP 1
#include <immintrin.h>
#endif

namespace {

constexpr int kModelSize = 257;   // cumulative entries C[0..256]
constexpr uint32_t kInitCum = 256;
constexpr uint32_t kMsb = 0x8000u;
constexpr uint32_t kSecond = 0x4000u;
constexpr uint32_t kLowMask = 0xFFFFu;
constexpr int kHeader = 4;        // [u16 total][u16 raw]

struct Model {
  // C[i] = cumulative count of symbols < i.  u16 suffices: max 256+8192.
  uint16_t cum[kModelSize];
  uint32_t cumprob;
#ifndef TG_NO_HULL
  // Hull window (the host mirror of the Pallas kernels' symbol-hull
  // windowed model passes): rows 1..live are maintained; rows i > live
  // are never written, and because every coded symbol is < live their
  // TRUE value is always i + nsym (nsym = cumprob - 256) — recoverable
  // in closed form without reading them.  live only grows (sticky), in
  // 32-row (one AVX-512 u16 vector) steps.
  int live;
#endif

  void reset(int live0 = 256) {
    for (int i = 0; i < kModelSize; ++i) cum[i] = static_cast<uint16_t>(i);
    cumprob = kInitCum;
#ifndef TG_NO_HULL
    live = live0;
#else
    (void)live0;
#endif
  }

  // Account one occurrence of `sym`.  The suffix increment is phrased as
  // a FIXED-trip masked pass (i > sym <=> cum[i] > cum[sym], the row
  // being strictly increasing): the variable-start `for (i = sym+1)`
  // formulation defeated the vectoriser and cost ~70% of encode time
  // (ablation in benchmarks/PROBES_r3.md); this form is 8 AVX-512BW
  // iterations and doubled encode throughput.
  // The intrinsics form of the masked pass measured +4% random / +2.5%
  // text encode over the auto-vectorised loop (hostab.py interleaved
  // A/B) — g++'s codegen for the scalar form round-trips the compare
  // through a vector instead of a k-register.  -DTG_NO_MASKPOP_BUMP
  // opts out.
  // One bump pass over rows 1..NV*32.  NV is a template constant so the
  // full-width (NV=8) path keeps its fully-unrolled codegen; the hull
  // paths take the runtime-width variant (nvec<8 by construction there).
  template <int NV>
  inline void bump_rows(int sym, int nvec) {
#if defined(TG_USE_MASKPOP) && !defined(TG_NO_MASKPOP_BUMP)
    const __m512i t = _mm512_set1_epi16(static_cast<short>(cum[sym]));
    const __m512i one = _mm512_set1_epi16(1);
    for (int v = 0; v < (NV ? NV : nvec); ++v) {
      __m512i c = _mm512_loadu_si512(cum + 1 + v * 32);
      const __mmask32 k = _mm512_cmpgt_epu16_mask(c, t);
      _mm512_storeu_si512(cum + 1 + v * 32,
                          _mm512_mask_add_epi16(c, k, c, one));
    }
#else
    const uint16_t t = cum[sym];
    for (int i = 1; i < 1 + (NV ? NV : nvec) * 32; ++i)
      cum[i] = static_cast<uint16_t>(cum[i] + (cum[i] > t));
#endif
  }

  // NV is fixed per packet (encode's hull is exact — see Enc): the whole
  // symbol loop is instantiated per width class, so there is no per-call
  // width dispatch (a runtime-width bump measured NET-NEGATIVE, -1~3%).
  template <int NV>
  void bump(int sym) {
    bump_rows<NV>(sym, NV);
    ++cumprob;
  }

  // Fused symbol search + model update (decode hot path).  Because the
  // row is strictly increasing with sym = max{c : cum[c] <= unscaled},
  // the adaptive update cum[i] += (i > sym) is identical to
  // cum[i] += (cum[i] > unscaled) — one auto-vectorised compare pass
  // yields the symbol (a count) AND applies the update.  The same trick
  // as the Pallas decode kernel's fused compare-read.  Does NOT touch
  // cumprob; the caller increments it after using the pre-update bounds
  // (cum[sym] is unchanged; pre-update cum[sym+1] = new value - 1).
#ifdef TG_USE_MASKPOP
  // Mask-popcount formulation: the compare lands in a k-register whose
  // popcount is a short scalar chain (8 independent kmov+popcnt), instead
  // of a 32-lane vector accumulator whose horizontal reduce sits on the
  // symbol-to-symbol critical path.  256 entries = 8 x 32 u16 lanes.
  // Interleaved A/B (benchmarks/hostab.py, best-of-5): random decode
  // 27.3 -> 30.5 MB/s (+12%), text 26.5 -> 30.5 (+15%).  Opt out with
  // -DTG_NO_MASKPOP (non-AVX512BW builds use the portable loop below).
  template <int NV>
  inline int gt_pass(uint32_t unscaled, int nvec) {
    const __m512i u = _mm512_set1_epi16(static_cast<short>(unscaled));
    const __m512i one = _mm512_set1_epi16(1);
    uint32_t gt = 0;
    for (int v = 0; v < (NV ? NV : nvec); ++v) {
      __m512i c = _mm512_loadu_si512(cum + 1 + v * 32);
      const __mmask32 k = _mm512_cmpgt_epu16_mask(c, u);
      _mm512_storeu_si512(cum + 1 + v * 32,
                          _mm512_mask_add_epi16(c, k, c, one));
      gt += static_cast<uint32_t>(__builtin_popcount(
          static_cast<uint32_t>(k)));
    }
    return static_cast<int>(gt);
  }
#else
  template <int NV>
  inline int gt_pass(uint32_t unscaled, int nvec) {
    const uint16_t u = static_cast<uint16_t>(unscaled);  // < cumprob <= 8448
    uint16_t gt = 0;  // u16 keeps the reduction in 32-lane vector adds
    for (int i = 1; i < 1 + (NV ? NV : nvec) * 32; ++i) {
      const uint16_t g = cum[i] > u;
      cum[i] = static_cast<uint16_t>(cum[i] + g);
      gt = static_cast<uint16_t>(gt + g);
    }
    return gt;
  }
#endif

  // HULL=true: windowed pass + closed-form tail while live < 256 (the
  // caller switches to HULL=false once every lockstep decoder has gone
  // sticky-full, so full-width packets pay zero per-symbol dispatch).
  template <bool HULL>
  int find_bump(uint32_t unscaled) {
#ifndef TG_NO_HULL
    if (HULL && live != 256)
      return tail_fix(unscaled, gt_pass<0>(unscaled, live >> 5));
#endif
    return 256 - gt_pass<8>(unscaled, 8);
  }

#ifndef TG_NO_HULL
  // Closed-form tail for the windowed find: rows i in (live, 256] were
  // never written, and since every coded symbol so far is < live, their
  // true value is i + nsym — so their contribution to the > count is
  // 256 - clamp(unscaled - nsym, live, 256) without touching memory.
  // The in-window value-based update is correct even when the symbol
  // lands in the tail (then cum[live] <= unscaled, so no live row moves);
  // a tail hit materializes the tail at its true post-update values and
  // grows the window to cover the symbol (sticky — windows never shrink,
  // which is what keeps the tail invariant sound).
  int tail_fix(uint32_t unscaled, int gt_window) {
    const int nsym = static_cast<int>(cumprob) - 256;  // pre-increment
    int t = static_cast<int>(unscaled) - nsym;  // tail rows i > t count
    if (t < live) t = live;
    if (t > 256) t = 256;
    const int sym = 256 - (gt_window + (256 - t));
    if (sym + 1 > live) {  // miss: materialize true tail, grow window
      for (int i = live + 1; i < kModelSize; ++i)
        cum[i] = static_cast<uint16_t>(i + nsym + (i > sym));
      live = (sym + 2 + 31) & ~31;
      if (live > 256) live = 256;
    }
    return sym;
  }
#endif
};

// Exact magic-number division by cumprob: floor(x/d) = (x*M) >> s with
// s = 32 + floor(log2 d), M = floor(2^s/d) + 1, exact for all x < 2^31
// and d < 2^16 (the round-up error x*(M - 2^s/d)/2^s < 1/d can never
// carry floor(x/d) past the next integer).  cumprob walks 256..8448
// sequentially per packet, so the table reads stream through cache.
// (A double-reciprocal variant with branchy fixups measured SLOWER than
// the hardware divider; see benchmarks/PROBES_r3.md, host-codec section.)
struct DivTab {
  uint64_t mul[kInitCum + 8192 + 1];
  uint8_t sh[kInitCum + 8192 + 1];
  DivTab() {
    for (uint32_t d = 1; d <= kInitCum + 8192; ++d) {
      const int s = 63 - __builtin_clz(d);  // 32 + floor(log2 d)
      sh[d] = static_cast<uint8_t>(s);
      mul[d] = (static_cast<uint64_t>(1) << s) / d + 1;
    }
  }
};
const DivTab kDiv;

inline uint32_t div_cum(uint32_t x, uint32_t d) {
  return static_cast<uint32_t>((x * kDiv.mul[d]) >> kDiv.sh[d]);
}

// Magic division by the decode span (d <= 65536; exact at d = 2^16 too —
// shown by direct expansion).  The table is 512 KiB and span access is
// data-dependent, trading the ~26-cycle divider for a possible L2 miss;
// interleaved A/B (hostab.py, best-of-5): +2.6% random / +1.9% text
// decode — renormalisation keeps hot spans in (2^14, 2^16], so the
// working set is the table's top ~384 KiB and mostly hits.  Opt out with
// -DTG_NO_SPAN_MAGIC.
#ifndef TG_NO_SPAN_MAGIC
struct SpanTab {
  uint64_t mul[65537];
  SpanTab() {
    for (uint32_t d = 1; d <= 65536; ++d)
      mul[d] = (static_cast<uint64_t>(1) << (63 - __builtin_clz(d))) / d + 1;
  }
};
const SpanTab kSpan;
inline uint32_t div_span(uint32_t x, uint32_t d) {
  return static_cast<uint32_t>((x * kSpan.mul[d]) >> (63 - __builtin_clz(d)));
}
#else
inline uint32_t div_span(uint32_t x, uint32_t d) { return x / d; }
#endif

// Narrow [lo, hi] to sym's cumulative share, then adapt the model.
// Mirrors applySymbolRange (src/gpuar_kernel.cu:256-299): new hi uses old lo,
// products are < 2^31, results wrap to 16 bits.  NV: see Model::bump.
template <int NV>
inline void apply_range(Model& m, int sym, uint32_t& lo, uint32_t& hi) {
  const uint32_t span = hi - lo + 1;
  hi = (lo + div_cum(m.cum[sym + 1] * span, m.cumprob) - 1) & kLowMask;
  lo = (lo + div_cum(m.cum[sym] * span, m.cumprob)) & kLowMask;
  m.bump<NV>(sym);
}

struct BitOut {
  uint8_t* p;
  uint64_t acc = 0;
  int n = 0;  // bits pending in acc (right-aligned); < 32 between calls

  // Append k bits (v's low k bits, MSB-first), k <= 32.
  // Flushes 32 bits in one big-endian store once enough accumulate (the
  // write mirror of BitIn's bswap refill; a byte-at-a-time drain loop
  // measured 7-11% slower encode).  n stays < 32 between calls, so acc
  // (64-bit) never overflows at k <= 32.
  inline void append(uint32_t v, int k) {
    acc = (acc << k) | v;
    n += k;
    if (n >= 32) {
      n -= 32;
      const uint32_t w =
          __builtin_bswap32(static_cast<uint32_t>(acc >> n));
      std::memcpy(p, &w, 4);
      p += 4;
    }
  }
  // Append `len` copies of `bit` (underflow runs can exceed 32).
  inline void run(uint32_t bit, uint32_t len) {
    while (len) {
      const int c = len > 32 ? 32 : static_cast<int>(len);
      append(bit ? (c == 32 ? 0xFFFFFFFFu : (1u << c) - 1) : 0u, c);
      len -= c;
    }
  }
  void close() {  // left-align final partial byte (writeClose :430-439)
    while (n >= 8) {  // drain whole bytes still buffered (< 32 bits)
      n -= 8;
      *p++ = static_cast<uint8_t>(acc >> n);
    }
    if (n) { *p++ = static_cast<uint8_t>(acc << (8 - n)); acc = 0; n = 0; }
  }
};

struct BitIn {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t win = 0;
  int n = 0;  // bits available in win (right-aligned)

  // Take k bits MSB-first, k <= 32.  Reads past the stream return 0
  // (the values never matter: decode stops at the framed raw length).
  inline uint32_t take(int k) {
    if (n < 32) {  // refill 32 bits in one unaligned big-endian load
      uint32_t w;
      if (p + 4 <= end) {
        std::memcpy(&w, p, 4);
        w = __builtin_bswap32(w);
      } else {  // tail: reads past the stream return 0 (values unused)
        w = 0;
        for (int i = 0; i < 4; ++i)
          w = (w << 8) | (p + i < end ? p[i] : 0u);
      }
      win = (win << 32) | w;
      p += 4;
      n += 32;
    }
    n -= k;
    return static_cast<uint32_t>(win >> n) & (k == 32 ? 0xFFFFFFFFu
                                                      : (1u << k) - 1);
  }
};

// Leading common MSBs of the 16-bit bounds: how many settled bits this
// symbol emits (the serial loop's equal-MSB iterations, :325-336).
inline int settled_count(uint32_t lo, uint32_t hi) {
  const uint32_t x = (lo ^ hi) & kLowMask;
  return x ? __builtin_clz(x) - 16 : 16;
}

// Straddle (underflow) count once MSBs differ: the serial loop removes
// the second bit while lo = 01..., hi = 10... (:337-352).  That holds for
// exactly min(leading 1s of lo after its 0, leading 0s of hi after its 1)
// iterations, and no settled emission can follow (MSBs still differ).
inline int straddle_count(uint32_t lo, uint32_t hi) {
  if (!(lo & kSecond) || (hi & kSecond)) return 0;
  const uint32_t lw = ~static_cast<uint32_t>(lo << 17);  // 1-run of lo
  const uint32_t hw = static_cast<uint32_t>(hi << 17);   // 0-run of hi
  const int p = __builtin_clz(lw);
  const int q = hw ? __builtin_clz(hw) : 15;
  return p < q ? p : q;
}

// --- K-way interleaved packet coding -------------------------------------
//
// One packet's symbol chain is LATENCY-bound: unscaled -> fused table pass
// -> horizontal reduce -> sym -> bounds -> divides -> next unscaled is a
// ~150-cycle serial dependency, and the vector units sit mostly idle (a
// narrower blocked table pass measured SLOWER — the reduce latency is
// width-independent; benchmarks/PROBES_r3.md).  Packets are independent
// coders, so stepping K of them in lockstep gives the out-of-order window
// K overlapping chains — the host mirror of the Pallas decode kernel's
// interleaved lane-streams.  K is capped by register/ROB pressure; the
// adopted value is measured in PROBES_r3.md.

struct Enc {
  Model m;
  BitOut bo;
  uint32_t lo, hi, under;
  uint8_t* out;

  void start(uint8_t* pkt) {
    out = pkt;
    m.reset();
    bo = BitOut{pkt + kHeader};
    lo = 0;
    hi = kLowMask;
    under = 0;
  }

  // Encode one symbol: range narrowing + closed-form renormalisation
  // (equivalent to writeEncodedBits :321-367: the serial loop is always
  // m settled emissions then k straddles).
  template <int NV>
  inline void step(uint8_t sym) {
    apply_range<NV>(m, sym, lo, hi);
    const int ms = settled_count(lo, hi);
    if (ms) {
      const uint32_t bits = lo >> (16 - ms);  // the m common MSBs
      if (under) {  // pending underflow flushes after the first bit
        bo.append(bits >> (ms - 1), 1);
        bo.run((bits >> (ms - 1)) ^ 1u, under);
        under = 0;
        if (ms > 1) bo.append(bits & ((1u << (ms - 1)) - 1), ms - 1);
      } else {
        bo.append(bits, ms);
      }
      lo = (lo << ms) & kLowMask;
      hi = ((hi << ms) | ((1u << ms) - 1)) & kLowMask;
    }
    const int ks = straddle_count(lo, hi);
    if (ks) {  // drop k second bits, shift up, fill 0s (lo) / 1s (hi)
      under += static_cast<uint32_t>(ks);
      lo = (lo & (0x7FFFu >> ks)) << ks;
      hi = kMsb | ((hi & (0x7FFFu >> ks)) << ks) | ((1u << ks) - 1);
    }
  }

  // Tail flush (writeRemaining :379-388) + header. Returns packet length.
  int finish(int n) {
    const uint32_t tb = (lo >> 14) & 1u;
    bo.append(tb, 1);
    bo.run(tb ^ 1u, under + 1);
    bo.close();
    const int len = static_cast<int>(bo.p - out);
    out[0] = static_cast<uint8_t>(len);
    out[1] = static_cast<uint8_t>(len >> 8);
    out[2] = static_cast<uint8_t>(n);
    out[3] = static_cast<uint8_t>(n >> 8);
    return len;
  }
};

struct Dec {
  Model m;
  BitIn bi;
  uint32_t code, lo, hi;
  uint8_t* out;

  void start(const uint8_t* pkt, uint8_t* o) {
    const int total = pkt[0] | (pkt[1] << 8);
    out = o;
    m.reset(32);  // decode hull starts minimal and grows on tail hits
    bi = BitIn{pkt + kHeader, pkt + total};
    code = bi.take(16);
    lo = 0;
    hi = kLowMask;
  }

  // Decode one symbol; find_bump applies the model update, so the bound
  // reads use: cum[sym] unchanged, pre-update cum[sym+1] = new value - 1.
  // Mirror renormalisation in closed form (readEncodedBits :787-836); the
  // straddle op (code ^= kSecond then shift in a bit) removes code's
  // second bit exactly like lo/hi: 01x -> 0x b, 10x -> 1x b.
  template <bool HULL>
  inline void step(int i) {
    const uint32_t span = hi - lo + 1;
    const uint32_t unscaled = div_span((code - lo + 1) * m.cumprob - 1, span);
    const int sym = m.find_bump<HULL>(unscaled);
    out[i] = static_cast<uint8_t>(sym);
    const uint32_t c_hi = static_cast<uint32_t>(m.cum[sym + 1]) - 1;
    hi = (lo + div_cum(c_hi * span, m.cumprob) - 1) & kLowMask;
    lo = (lo + div_cum(m.cum[sym] * span, m.cumprob)) & kLowMask;
    ++m.cumprob;
    const int ms = settled_count(lo, hi);
    if (ms) {
      code = ((code << ms) | bi.take(ms)) & kLowMask;
      lo = (lo << ms) & kLowMask;
      hi = ((hi << ms) | ((1u << ms) - 1)) & kLowMask;
    }
    const int ks = straddle_count(lo, hi);
    if (ks) {
      code = (code & kMsb) | ((code & (0x7FFFu >> ks)) << ks) | bi.take(ks);
      lo = (lo & (0x7FFFu >> ks)) << ks;
      hi = kMsb | ((hi & (0x7FFFu >> ks)) << ks) | ((1u << ks) - 1);
    }
  }
};

// DECODE interleave width: how many packet decoders run in lockstep.
// Swept in benchmarks/PROBES_r3.md: 2 wins (+10%), wider is flat-to-worse
// (two chains already saturate the vector ports with table passes), and
// ENCODE lockstep at any width LOSES ~20% — the encoder's chain is
// shorter (no horizontal reduce feeding the next step through `sym`), so
// forcing its state through memory costs more than the overlap buys.
// Encode therefore stays one-packet-serial.
#ifndef TG_WAY
#define TG_WAY 2
#endif
constexpr int kWay = TG_WAY;

// Lockstep over K started decoders (equal symbol count).  The inner loop
// unrolls; the hardware overlaps the K independent chains.
// Hull phase first: windowed model passes while any decoder's window is
// still narrow (text-class packets stay here the whole packet, +5-6%);
// once every decoder is sticky-full — a few symbols in, for random-class
// packets — the remainder runs the exact full-width path with zero
// per-symbol dispatch.
template <int K>
void dec_lockstep(Dec* d, int raw) {
  int i = 0;
#ifndef TG_NO_HULL
  while (i < raw) {  // check the switch once per 32 symbols, not per step
    const int stop = raw - i < 32 ? raw : i + 32;
    for (; i < stop; ++i)
      for (int k = 0; k < K; ++k) d[k].step<true>(i);
    bool full = true;
    for (int k = 0; k < K; ++k) full &= d[k].m.live == 256;
    if (full) break;
  }
#endif
  for (; i < raw; ++i)
    for (int k = 0; k < K; ++k) d[k].step<false>(i);
}

}  // namespace

extern "C" {

// Encode n raw bytes into out (capacity >= n + 512 + 4). Returns total
// packet length including the 4-byte header.
int tg_encode_packet(const uint8_t* in, int n, uint8_t* out) {
  Enc e;
  e.start(out);
#ifndef TG_NO_HULL
  // Exact per-packet hull: the encoder never reads model rows above
  // max(in)+1, so the whole symbol loop dispatches ONCE to a bump width
  // class (ASCII/text packets take the half pass; the max scan is ~0.5%
  // of packet time).  Per-call width dispatch measured -1~3%; this
  // per-packet template dispatch leaves the full-width loop untouched.
  uint8_t mx = 0;
  for (int i = 0; i < n; ++i) mx = in[i] > mx ? in[i] : mx;
  if (mx < 128) {
    for (int i = 0; i < n; ++i) e.step<4>(in[i]);
  } else {
    for (int i = 0; i < n; ++i) e.step<8>(in[i]);
  }
#else
  for (int i = 0; i < n; ++i) e.step<8>(in[i]);
#endif
  return e.finish(n);
}

// Decode one packet (header + bitstream) into out (capacity >= raw size).
// Returns the number of decoded bytes.
int tg_decode_packet(const uint8_t* in, uint8_t* out) {
  const int raw = in[2] | (in[3] << 8);
  Dec d;
  d.start(in, out);
  dec_lockstep<1>(&d, raw);
  return raw;
}

// Decode one packet and report its bit-consumption delta: bits taken by
// the coder minus the framed body length in bits.  The decoder
// legitimately reads up to 16 lookahead bits past the written stream
// (the primed 16-bit code window; clean slack measured 7..13 bits, same
// math as the TPU kernel's overrun flag, pallas_decode.check_debug_flags)
// — a delta beyond +16 is the detectable signature of a corrupt
// well-framed packet.  Used by the CLI `v --deep` verifier.
long tg_decode_packet_delta(const uint8_t* in, uint8_t* out) {
  const int total = in[0] | (in[1] << 8);
  const int raw = in[2] | (in[3] << 8);
  Dec d;
  d.start(in, out);
  dec_lockstep<1>(&d, raw);
  const long loaded =
      static_cast<long>(d.bi.p - (in + kHeader)) * 8;  // bits fetched
  const long taken = loaded - d.bi.n;                  // minus buffered
  return taken - static_cast<long>(total - kHeader) * 8;
}

// Encode `total` raw bytes as ceil(total/packet_size) packets written at
// fixed `out_stride` offsets. lengths[i] receives each packet's total size.
// Returns the packet count.
long tg_encode_batch(const uint8_t* in, long total, int packet_size,
                     uint8_t* out, long out_stride, int* lengths) {
  long count = 0;
  for (long off = 0; off < total; off += packet_size, ++count) {
    const int n = static_cast<int>(total - off < packet_size ? total - off
                                                             : packet_size);
    lengths[count] = tg_encode_packet(in + off, n, out + count * out_stride);
  }
  return count;
}

// Decode `npackets` packets at fixed `in_stride` offsets into out at fixed
// `out_stride` offsets. raw_lengths[i] receives each decoded size.  Runs
// of TG_WAY consecutive equal-raw packets decode interleaved (all but the
// archive's final packet have raw = packet_size, so this is the whole
// batch in practice).
void tg_decode_batch(const uint8_t* in, long in_stride, long npackets,
                     uint8_t* out, long out_stride, int* raw_lengths) {
  long i = 0;
  while (i < npackets) {
    const int raw0 = in[i * in_stride + 2] | (in[i * in_stride + 3] << 8);
    int g = 1;
    while (g < kWay && i + g < npackets) {
      const uint8_t* h = in + (i + g) * in_stride;
      if ((h[2] | (h[3] << 8)) != raw0) break;
      ++g;
    }
    if (g == kWay) {
      Dec d[kWay];
      for (int k = 0; k < kWay; ++k)
        d[k].start(in + (i + k) * in_stride, out + (i + k) * out_stride);
      dec_lockstep<kWay>(d, raw0);
      for (int k = 0; k < kWay; ++k) raw_lengths[i + k] = raw0;
      i += kWay;
    } else {
      raw_lengths[i] = tg_decode_packet(in + i * in_stride,
                                        out + i * out_stride);
      ++i;
    }
  }
}

// Encode `total` raw bytes into a back-to-back .gip packet body.
// Returns the compressed body length, or -1 if out_cap is too small.
long tg_encode_stream(const uint8_t* in, long total, int packet_size,
                      uint8_t* out, long out_cap) {
  long w = 0;
  for (long off = 0; off < total; off += packet_size) {
    const int n = static_cast<int>(total - off < packet_size ? total - off
                                                             : packet_size);
    if (w + n + 512 + kHeader > out_cap) return -1;
    w += tg_encode_packet(in + off, n, out + w);
  }
  return w;
}

// Splice variable-length rows out of a fixed-stride batch into one
// contiguous buffer (the .gip body assembly).  numpy's small-array
// concatenate costs ~0.5 s per 8192-packet batch; this is a memcpy loop.
// Returns bytes written, or -1 on overflow / bad length.
long tg_splice(const uint8_t* rows, long stride, const int* lengths,
               long n, uint8_t* out, long out_cap) {
  long w = 0;
  for (long i = 0; i < n; ++i) {
    const long len = lengths[i];
    if (len < 0 || len > stride || w + len > out_cap) return -1;
    std::memcpy(out + w, rows + i * stride, static_cast<size_t>(len));
    w += len;
  }
  return w;
}

// Splice from a compacted blob: packet i's bytes live at byte offset
// offsets[i] (device-side row compaction leaves packets at aligned
// starts with a little inter-packet padding; this strips it).  out may
// overlap the blob (the in-place splice of a row-aligned blob): then
// each packet's output must start at or before its source, so no write
// reaches bytes a later packet has yet to read, and memmove takes the
// overlap within a packet.
long tg_splice_at(const uint8_t* blob, long blob_len, const long* offsets,
                  const int* lengths, long n, uint8_t* out, long out_cap) {
  const uintptr_t b0 = reinterpret_cast<uintptr_t>(blob);
  const uintptr_t o0 = reinterpret_cast<uintptr_t>(out);
  const bool overlap = o0 < b0 + blob_len && b0 < o0 + out_cap;
  long w = 0;
  for (long i = 0; i < n; ++i) {
    const long len = lengths[i];
    if (len < 0 || offsets[i] < 0 || offsets[i] + len > blob_len ||
        w + len > out_cap)
      return -1;
    if (overlap && o0 + w > b0 + offsets[i]) return -1;
    std::memmove(out + w, blob + offsets[i], static_cast<size_t>(len));
    w += len;
  }
  return w;
}

// Scatter packets from a back-to-back body into aligned blob offsets
// (the multi-host stride loader's batch, in one pass).  The offsets
// ascend without overlap, and every byte of blob[0, blob_cap) that no
// packet covers (the gap after each packet and the tail) is zeroed, so
// the blob is the same whatever the buffer held: each byte is written
// once.
long tg_expand_at(const uint8_t* body, long body_len, const long* offsets,
                  const int* lengths, long n, uint8_t* blob,
                  long blob_cap) {
  long r = 0, end = 0;
  for (long i = 0; i < n; ++i) {
    const long len = lengths[i];
    if (len < 0 || r + len > body_len || offsets[i] < end ||
        offsets[i] + len > blob_cap)
      return -1;
    std::memset(blob + end, 0, static_cast<size_t>(offsets[i] - end));
    std::memcpy(blob + offsets[i], body + r, static_cast<size_t>(len));
    r += len;
    end = offsets[i] + len;
  }
  std::memset(blob + end, 0, static_cast<size_t>(blob_cap - end));
  return r;
}

// Walk the framed packets at the head of buf[0, len) (the decode
// reader's inner loop).  Each complete packet whose header passes the
// reader's check (kHeader <= total <= max_total, raw <= max_raw) has its
// length and raw size written to comp_len and raw_sizes.  With a dst it
// is also copied to row `rows` of dst (row_bytes a row, rows counted from
// rows0), the rest of its last row is zeroed, and its row offset goes to
// roff (which may be null).  With a null dst it is the header walk: no
// byte is copied, and the packet's byte offset, counted from buf[0] plus
// rows0, goes to boff.  The walk stops after max_packets packets (returns
// 0), at the first packet not complete in buf (1), at the first header
// that fails the check (2), or where dst would overflow (3).  res =
// {packets, bytes consumed, rows used (0 in the header walk)}.
int tg_walk_packets(const uint8_t* buf, long len, long max_packets,
                    int max_total, int max_raw, uint8_t* dst, long dst_cap,
                    long row_bytes, long rows0, int* roff, long* boff,
                    int* comp_len, int* raw_sizes, long* res) {
  long n = 0, r = 0, rows = rows0;
  int stop = 0;
  while (n < max_packets) {
    if (len - r < kHeader) { stop = 1; break; }
    const int total = buf[r] | (buf[r + 1] << 8);
    const int raw = buf[r + 2] | (buf[r + 3] << 8);
    if (total < kHeader || total > max_total || raw > max_raw) {
      stop = 2;
      break;
    }
    if (len - r < total) { stop = 1; break; }
    if (dst) {
      const long span = (total + row_bytes - 1) / row_bytes * row_bytes;
      uint8_t* to = dst + rows * row_bytes;
      if (rows * row_bytes + span > dst_cap) { stop = 3; break; }
      std::memcpy(to, buf + r, static_cast<size_t>(total));
      std::memset(to + total, 0, static_cast<size_t>(span - total));
      if (roff) roff[n] = static_cast<int>(rows);
      rows += span / row_bytes;
    } else {
      boff[n] = rows0 + r;
    }
    comp_len[n] = total;
    raw_sizes[n] = raw;
    r += total;
    ++n;
  }
  res[0] = n;
  res[1] = r;
  res[2] = dst ? rows - rows0 : 0;
  return stop;
}

// Decode a back-to-back .gip packet body of `total` bytes.  Runs of
// TG_WAY consecutive equal-raw packets (validated first) decode
// interleaved; ragged tails fall back to the single-packet path.
// Returns decoded length, or -1 on malformed framing / -2 on overflow.
long tg_decode_stream(const uint8_t* in, long total, uint8_t* out,
                      long out_cap) {
  long r = 0, w = 0;
  while (r < total) {
    // Validate and frame up to kWay packets ahead.
    long starts[kWay];
    int raws[kWay], g = 0;
    long r2 = r, w2 = w;
    while (g < kWay && r2 < total) {
      if (r2 + kHeader > total) return -1;
      const int psize = in[r2] | (in[r2 + 1] << 8);
      const int raw = in[r2 + 2] | (in[r2 + 3] << 8);
      if (psize < kHeader || r2 + psize > total) return -1;
      if (w2 + raw > out_cap) return -2;
      if (g && raw != raws[0]) break;  // lockstep needs equal symbol counts
      starts[g] = r2;
      raws[g] = raw;
      ++g;
      r2 += psize;
      w2 += raw;
    }
    if (g == kWay) {
      Dec d[kWay];
      for (int k = 0; k < kWay; ++k)
        d[k].start(in + starts[k], out + w + static_cast<long>(k) * raws[0]);
      dec_lockstep<kWay>(d, raws[0]);
      r = r2;
      w = w2;
    } else {
      tg_decode_packet(in + starts[0], out + w);
      r = starts[0] + (in[starts[0]] | (in[starts[0] + 1] << 8));
      w += raws[0];
    }
  }
  return w;
}

}  // extern "C"
