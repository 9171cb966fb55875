// Native wire engine: whole-frame encode/decode for the TCP comm backend.
//
// codec.cpp provides the element-wise primitives (f32<->bf16, int8
// quantization, byte-at-a-time crc32); this module is the frame layer on
// top of them — it encodes and decodes WHOLE frames in one call, operating
// directly on the TreeSpec ravel buffer:
//
//   * fused sparse frames (one `indices|values` section per dtype bucket,
//     u32 flat positions into the ravel): the u32 gather/scatter is FUSED
//     with the bf16/int8 wire conversion, so a frame is two linear passes
//     (measure, then write) instead of the per-bucket numpy pipeline of
//     comm/tensor_codec.py — and the frame's trailing crc32 is computed
//     over the assembled bytes with a slicing-by-8 table in the same call;
//   * dense tensor frames (header + converted payload written into one
//     preallocated output buffer).
//
// Decode is validate-then-scatter: every section header is bounds-checked
// against the frame length and the ravel size, and the trailing crc is
// verified, BEFORE the first scatter write — a corrupt length/offset or a
// flipped bit becomes a negative status (comm/tensor_codec.py raises
// CodecError), never an out-of-bounds write.  Wire layout parity is with
// the pure-Python codec in comm/tensor_codec.py, which stays the
// byte-for-byte authoritative oracle (and the DLT_NO_NATIVE=1 fallback).
//
// Exposed with C linkage for ctypes; built by native/__init__.py with g++
// -O3 at first use into the package's _build/ directory, under a name that
// hashes the sources (ABI-checked, see dlt_abi.h).  A copy of the JAX
// package's native/wire.cpp: the two must produce the same bytes.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__SSE2__) || defined(__AVX__)
#include <immintrin.h>
#endif

#if defined(__linux__)
#include <sys/mman.h>
#include <unistd.h>
#endif

#include "dlt_abi.h"

namespace {

// ---- status codes (negative returns; mirrored in native/wire.py) ---- //
constexpr long long kErrTrunc = -1;        // frame shorter than its headers
constexpr long long kErrMagic = -2;        // not a fused sparse frame
constexpr long long kErrVersion = -3;      // unknown fused frame version
constexpr long long kErrCrc = -4;          // checksum mismatch
constexpr long long kErrBounds = -5;       // section length/offset corrupt
constexpr long long kErrRange = -6;        // scatter index outside the ravel
constexpr long long kErrTotal = -7;        // header total != caller's buffer
constexpr long long kErrUnsupported = -8;  // valid frame, dtype the native
                                           // path does not handle (caller
                                           // falls back to Python)
constexpr long long kErrNonFinite = -9;    // int8 wire over NaN/Inf values
constexpr long long kErrInternal = -10;    // output capacity / pass-1 vs
                                           // pass-2 disagreement (a bug)

// Transport constants shared with comm/framing.py / comm/protocol.py.
// Mirror-only (the native engine codes payload sections, not transport
// frames) but kept equal to the Python constants: v2
// adds the TraceContext trailer (u8 present | u32 run_id | i64 seq |
// f64 t_wall | u16-len origin) to the value-bearing message bodies.
constexpr uint8_t kWireVersion = 2;
constexpr uint8_t kTraceCtxVersion = 1;

// Wire constants shared with comm/tensor_codec.py.
constexpr uint8_t kFusedMagic = 0xFE;
constexpr uint8_t kFusedVersion = 1;
constexpr uint8_t kDtypeF32 = 0;   // _DTYPE_CODES[np.float32]
constexpr uint8_t kDtypeBf16 = 5;  // _DTYPE_CODES[np.uint16] (bf16 bits)
constexpr uint8_t kDtypeI8 = 7;    // _DTYPE_CODES[np.int8]
constexpr uint8_t kFlagBf16 = 0x01;
constexpr uint8_t kFlagI8 = 0x02;
// Per-bucket / dense encode modes (native/wire.py _MODE_*).
constexpr uint8_t kModeF32 = 0;
constexpr uint8_t kModeBf16 = 1;
constexpr uint8_t kModeI8 = 2;

// ---- little-endian scalar IO --------------------------------------- //
// On little-endian hosts (every deployment target) a 4-byte memcpy is a
// single unaligned mov the compiler can vectorize across loop
// iterations; the byte-wise form is kept for exotic hosts.
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
inline void put_u32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }
inline uint32_t get_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline void put_u16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }
inline uint16_t get_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}
#else
inline void put_u32(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
  p[2] = static_cast<uint8_t>(v >> 16);
  p[3] = static_cast<uint8_t>(v >> 24);
}

inline uint32_t get_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

inline void put_u16(uint8_t* p, uint16_t v) {
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
}

inline uint16_t get_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}
#endif

inline void put_f32(uint8_t* p, float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  put_u32(p, bits);
}

inline float get_f32(const uint8_t* p) {
  uint32_t bits = get_u32(p);
  float v;
  std::memcpy(&v, &bits, 4);
  return v;
}

// ---- element conversions (bit-identical to codec.cpp's kernels) ----- //
inline uint16_t f32_to_bf16_one(float v) {
  uint32_t x;
  std::memcpy(&x, &v, 4);
  // NaN stays NaN: round-up could flow a signalling mantissa to zero
  // (infinity); force a quiet-NaN payload instead.  Branchless (select,
  // not branch) so the bulk encode loops vectorize.
  const bool is_nan = (x & 0x7fffffffu) > 0x7f800000u;
  const uint16_t nan_bits = static_cast<uint16_t>((x >> 16) | 0x0040u);
  const uint32_t lsb = (x >> 16) & 1u;
  const uint16_t rne_bits = static_cast<uint16_t>((x + 0x7fffu + lsb) >> 16);
  return is_nan ? nan_bits : rne_bits;
}

inline float bf16_to_f32_one(uint16_t bits) {
  uint32_t x = static_cast<uint32_t>(bits) << 16;
  float v;
  std::memcpy(&v, &x, 4);
  return v;
}

inline int8_t f32_to_i8_one(float v, float inv) {
  // Match np.rint (ties to even): nearbyint under FE_TONEAREST — the
  // same contract as codec.cpp's dlt_f32_to_i8.
  float r = __builtin_nearbyintf(v * inv);
  if (r > 127.0f) r = 127.0f;
  if (r < -127.0f) r = -127.0f;
  return static_cast<int8_t>(r);
}

// Rounding barrier: -O3 contracts ``a += s * v`` into an FMA (one
// rounding), but the Python oracle (np.add.at of ``s * vals``) rounds
// the multiply and the add separately.  Forcing the product through an
// opaque register keeps the apply path bit-identical to the oracle.
inline float fp_barrier(float x) {
#if defined(__SSE2__)
  __asm__("" : "+x"(x));
#else
  volatile float y = x;
  x = y;
#endif
  return x;
}

// Python-parity int8 scale plumbing (tensor_codec.encode_tensor):
//   scale = float(np.max(np.abs(x)) / 127.0)   # f32 max, f64 divide
//   wire stores struct.pack('<f', scale); the kernel receives
//   c_float(1.0 / scale).
struct I8Scale {
  float wire;  // f32 scale written ahead of the int8 payload
  float inv;   // f32 inverse handed to the quantizer
};

inline I8Scale i8_scale_of(float maxabs, uint64_t k) {
  if (k == 0 || maxabs == 0.0f) return {0.0f, 0.0f};
  double scale_d = static_cast<double>(maxabs) / 127.0;
  return {static_cast<float>(scale_d), static_cast<float>(1.0 / scale_d)};
}

// Value-section byte length for k elements under a mode (encode_tensor of
// a 1-D f32 vector: 4-byte header + u32 dim, int8 adds the f32 scale).
inline uint64_t vlen_of(uint8_t mode, uint64_t k) {
  switch (mode) {
    case kModeBf16:
      return 8 + 2 * k;
    case kModeI8:
      return 12 + k;
    default:
      return 8 + 4 * k;
  }
}

// Pre-fault a freshly-allocated buffer in one batched kernel call
// instead of ~one page fault per 4 KiB during the scatter/write loops —
// on a full-width ravel (146 MB) the per-fault overhead, not the
// zeroing, is the decode bottleneck.  Best-effort: any failure (old
// kernel, non-anon mapping) just leaves the lazy-fault behavior.
inline void prefault_writable(void* ptr, uint64_t nbytes) {
#if defined(__linux__) && defined(MADV_POPULATE_WRITE)
  if (nbytes < (1u << 22)) return;  // not worth a syscall below 4 MB
  const uint64_t page = static_cast<uint64_t>(sysconf(_SC_PAGESIZE));
  uint64_t lo = reinterpret_cast<uint64_t>(ptr);
  uint64_t hi = lo + nbytes;
  lo = (lo + page - 1) & ~(page - 1);
  hi &= ~(page - 1);
  if (hi > lo) {
    (void)madvise(reinterpret_cast<void*>(lo), hi - lo,
                  MADV_POPULATE_WRITE);
  }
#else
  (void)ptr;
  (void)nbytes;
#endif
}

// ---- slicing-by-8 crc32 (zlib polynomial, zlib-identical results) --- //
uint32_t kCrcTab[8][256];
bool kCrcTabInit = false;

void crc_tab_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) {
      c = (c & 1u) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    }
    kCrcTab[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    for (int t = 1; t < 8; ++t) {
      kCrcTab[t][i] =
          (kCrcTab[t - 1][i] >> 8) ^ kCrcTab[0][kCrcTab[t - 1][i] & 0xFFu];
    }
  }
  kCrcTabInit = true;
}

uint32_t crc32_sliced(const uint8_t* p, size_t n, uint32_t seed) {
  if (!kCrcTabInit) crc_tab_init();
  uint32_t c = seed ^ 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo = get_u32(p) ^ c;
    uint32_t hi = get_u32(p + 4);
    c = kCrcTab[7][lo & 0xFFu] ^ kCrcTab[6][(lo >> 8) & 0xFFu] ^
        kCrcTab[5][(lo >> 16) & 0xFFu] ^ kCrcTab[4][lo >> 24] ^
        kCrcTab[3][hi & 0xFFu] ^ kCrcTab[2][(hi >> 8) & 0xFFu] ^
        kCrcTab[1][(hi >> 16) & 0xFFu] ^ kCrcTab[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) {
    c = kCrcTab[0][(c ^ *p++) & 0xFFu] ^ (c >> 8);
  }
  return c ^ 0xFFFFFFFFu;
}

// ---- crc32 combine (zlib's GF(2) matrix method) --------------------- //
// crc(A||B) from crc(A), crc(B), len(B): lets two halves of a frame run
// as INDEPENDENT slicing chains in one interleaved loop — the chain's
// load-use latency, not bandwidth, bounds a single stream.
uint32_t gf2_matrix_times(const uint32_t* mat, uint32_t vec) {
  uint32_t sum = 0;
  while (vec) {
    if (vec & 1u) sum ^= *mat;
    vec >>= 1;
    ++mat;
  }
  return sum;
}

void gf2_matrix_square(uint32_t* square, const uint32_t* mat) {
  for (int i = 0; i < 32; ++i) square[i] = gf2_matrix_times(mat, mat[i]);
}

uint32_t crc32_combine(uint32_t crc1, uint32_t crc2, uint64_t len2) {
  if (len2 == 0) return crc1;
  uint32_t even[32], odd[32];
  odd[0] = 0xEDB88320u;  // the reflected polynomial: "times x" operator
  uint32_t row = 1;
  for (int i = 1; i < 32; ++i) {
    odd[i] = row;
    row <<= 1;
  }
  gf2_matrix_square(even, odd);  // times x^2
  gf2_matrix_square(odd, even);  // times x^4
  do {
    gf2_matrix_square(even, odd);
    if (len2 & 1u) crc1 = gf2_matrix_times(even, crc1);
    len2 >>= 1;
    if (len2 == 0) break;
    gf2_matrix_square(odd, even);
    if (len2 & 1u) crc1 = gf2_matrix_times(odd, crc1);
    len2 >>= 1;
  } while (len2);
  return crc1 ^ crc2;
}

// Dual-stream crc: two interleaved slicing-by-8 chains over the two
// halves (ILP hides the per-chain latency), merged with crc32_combine.
uint32_t crc32_fast(const uint8_t* p, size_t n, uint32_t seed) {
  if (n < (1u << 14)) return crc32_sliced(p, n, seed);
  if (!kCrcTabInit) crc_tab_init();
  const size_t half = (n / 2) & ~size_t(7);
  const uint8_t* p1 = p;
  const uint8_t* p2 = p + half;
  uint32_t c1 = seed ^ 0xFFFFFFFFu;
  uint32_t c2 = 0xFFFFFFFFu;  // seed 0 for the second stream
  for (size_t i = 0; i + 8 <= half; i += 8) {
    const uint32_t lo1 = get_u32(p1 + i) ^ c1;
    const uint32_t hi1 = get_u32(p1 + i + 4);
    const uint32_t lo2 = get_u32(p2 + i) ^ c2;
    const uint32_t hi2 = get_u32(p2 + i + 4);
    c1 = kCrcTab[7][lo1 & 0xFFu] ^ kCrcTab[6][(lo1 >> 8) & 0xFFu] ^
         kCrcTab[5][(lo1 >> 16) & 0xFFu] ^ kCrcTab[4][lo1 >> 24] ^
         kCrcTab[3][hi1 & 0xFFu] ^ kCrcTab[2][(hi1 >> 8) & 0xFFu] ^
         kCrcTab[1][(hi1 >> 16) & 0xFFu] ^ kCrcTab[0][hi1 >> 24];
    c2 = kCrcTab[7][lo2 & 0xFFu] ^ kCrcTab[6][(lo2 >> 8) & 0xFFu] ^
         kCrcTab[5][(lo2 >> 16) & 0xFFu] ^ kCrcTab[4][lo2 >> 24] ^
         kCrcTab[3][hi2 & 0xFFu] ^ kCrcTab[2][(hi2 >> 8) & 0xFFu] ^
         kCrcTab[1][(hi2 >> 16) & 0xFFu] ^ kCrcTab[0][hi2 >> 24];
  }
  c1 ^= 0xFFFFFFFFu;  // finalize stream 1 = crc of [0, half)
  // Stream 2 continues byte-wise through the tail [2*half, n).
  size_t rest = n - 2 * half;
  const uint8_t* pt = p + 2 * half;
  while (rest--) {
    c2 = kCrcTab[0][(c2 ^ *pt++) & 0xFFu] ^ (c2 >> 8);
  }
  c2 ^= 0xFFFFFFFFu;  // crc of [half, n)
  return crc32_combine(c1, c2, n - half);
}

// Sparse compaction driver for the encode write pass.  A gossip
// correction ravel is ~90% zeros, so per-element branches are all
// mispredictions and per-element branchless stores waste bandwidth;
// instead a SIMD nonzero mask (CMPNEQ, unordered — NaN counts nonzero,
// like np.flatnonzero) is reduced to a bitmask per block, all-zero
// blocks are skipped in a few ops, and only actual nonzeros reach the
// scalar emit (iterated via count-trailing-zeros).  Output order is
// strictly ascending positions — identical bytes to the Python oracle.
template <typename Emit>
inline uint64_t compact_span(const float* p, uint64_t n, uint64_t base,
                             uint64_t w, Emit emit) {
  uint64_t i = 0;
#if defined(__AVX__)
  const __m256 zero8 = _mm256_setzero_ps();
  for (; i + 8 <= n; i += 8) {
    const __m256 v = _mm256_loadu_ps(p + i);
    int m = _mm256_movemask_ps(_mm256_cmp_ps(v, zero8, _CMP_NEQ_UQ));
    while (m) {
      const int j = __builtin_ctz(m);
      m &= m - 1;
      emit(w, base + i + j, p[i + j]);
      ++w;
    }
  }
#elif defined(__SSE2__)
  const __m128 zero4 = _mm_setzero_ps();
  for (; i + 4 <= n; i += 4) {
    const __m128 v = _mm_loadu_ps(p + i);
    int m = _mm_movemask_ps(_mm_cmpneq_ps(v, zero4));
    while (m) {
      const int j = __builtin_ctz(m);
      m &= m - 1;
      emit(w, base + i + j, p[i + j]);
      ++w;
    }
  }
#endif
  for (; i < n; ++i) {
    const float v = p[i];
    if (v != 0.0f) {
      emit(w, base + i, v);
      ++w;
    }
  }
  return w;
}

#if defined(__AVX512F__)
// AVX-512 compaction: vcompressps / vpcompressd ARE the sparse-wire
// primitive — one masked compress-store packs a block's nonzero lanes
// (and their flat positions) straight into the frame's sections, no
// per-nonzero branches at all.  Blocks that could overrun the k-sized
// sections (only possible if the ravel changed between the size and
// write passes) fall to the guarded scalar tail, so the compress-stores
// can never write past their sections.
inline uint64_t compact_span_f32_avx512(const float* p, uint64_t n,
                                        uint64_t base, uint64_t w,
                                        uint64_t k, uint8_t* idx_p,
                                        uint8_t* val_p) {
  const __m512 zero16 = _mm512_setzero_ps();
  const __m512i lane_iota = _mm512_set_epi32(
      15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
  uint64_t i = 0;
  for (; i + 16 <= n && w + 16 <= k; i += 16) {
    const __m512 v = _mm512_loadu_ps(p + i);
    const __mmask16 m = _mm512_cmp_ps_mask(v, zero16, _CMP_NEQ_UQ);
    if (!m) continue;
    const __m512i pos = _mm512_add_epi32(
        _mm512_set1_epi32(static_cast<int>(base + i)), lane_iota);
    _mm512_mask_compressstoreu_epi32(idx_p + 4 * w, m, pos);
    _mm512_mask_compressstoreu_ps(val_p + 4 * w, m, v);
    w += __builtin_popcount(static_cast<unsigned>(m));
  }
  for (; i < n; ++i) {
    const float v = p[i];
    if (v != 0.0f) {
      if (w < k) {
        put_u32(idx_p + 4 * w, static_cast<uint32_t>(base + i));
        put_f32(val_p + 4 * w, v);
      }
      ++w;
    }
  }
  return w;
}

// bf16: positions compress-store into the final idx section; the RNE
// conversion runs 16-wide in integer vectors (bit-identical to
// f32_to_bf16_one, NaN quieting and denormals included — the hardware
// vcvtneps2bf16 flushes denormals and so cannot serve), and the 2-byte
// values compress via vpmovdw of the compressed 32-bit lanes.
inline uint64_t compact_span_bf16_avx512(const float* p, uint64_t n,
                                         uint64_t base, uint64_t w,
                                         uint64_t k, uint8_t* idx_p,
                                         uint8_t* val_p) {
  const __m512 zero16 = _mm512_setzero_ps();
  const __m512i lane_iota = _mm512_set_epi32(
      15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
  const __m512i abs_mask = _mm512_set1_epi32(0x7fffffff);
  const __m512i inf_bits = _mm512_set1_epi32(0x7f800000);
  const __m512i round_c = _mm512_set1_epi32(0x7fff);
  const __m512i one = _mm512_set1_epi32(1);
  const __m512i quiet = _mm512_set1_epi32(0x0040);
  uint64_t i = 0;
  for (; i + 16 <= n && w + 16 <= k; i += 16) {
    const __m512 v = _mm512_loadu_ps(p + i);
    const __mmask16 m = _mm512_cmp_ps_mask(v, zero16, _CMP_NEQ_UQ);
    if (!m) continue;
    const __m512i pos = _mm512_add_epi32(
        _mm512_set1_epi32(static_cast<int>(base + i)), lane_iota);
    _mm512_mask_compressstoreu_epi32(idx_p + 4 * w, m, pos);
    const __m512i x = _mm512_castps_si512(v);
    const __m512i hi16 = _mm512_srli_epi32(x, 16);
    const __mmask16 is_nan = _mm512_cmpgt_epi32_mask(
        _mm512_and_si512(x, abs_mask), inf_bits);
    const __m512i rne = _mm512_srli_epi32(
        _mm512_add_epi32(
            _mm512_add_epi32(x, round_c), _mm512_and_si512(hi16, one)),
        16);
    const __m512i bits = _mm512_mask_or_epi32(rne, is_nan, hi16, quiet);
    const __m512i packed = _mm512_maskz_compress_epi32(m, bits);
    const int c = __builtin_popcount(static_cast<unsigned>(m));
    // Narrow the c compressed 32-bit lanes to u16 and store them; the
    // store may cover up to 32 bytes, all inside the val section
    // thanks to the w + 16 <= k loop guard.
    _mm256_storeu_si256(
        reinterpret_cast<__m256i*>(val_p + 2 * w),
        _mm512_cvtepi32_epi16(packed));
    w += c;
  }
  for (; i < n; ++i) {
    const float v = p[i];
    if (v != 0.0f) {
      if (w < k) {
        put_u32(idx_p + 4 * w, static_cast<uint32_t>(base + i));
        put_u16(val_p + 2 * w, f32_to_bf16_one(v));
      }
      ++w;
    }
  }
  return w;
}
#endif  // __AVX512F__

// Nonzero count of one span via the same mask reduction (popcount per
// block instead of per-element adds).
inline uint64_t count_nonzero(const float* p, uint64_t n) {
  uint64_t k = 0;
  uint64_t i = 0;
#if defined(__AVX512F__)
  const __m512 zero16 = _mm512_setzero_ps();
  for (; i + 16 <= n; i += 16) {
    const __m512 v = _mm512_loadu_ps(p + i);
    k += __builtin_popcount(static_cast<unsigned>(
        _mm512_cmp_ps_mask(v, zero16, _CMP_NEQ_UQ)));
  }
#elif defined(__AVX__)
  const __m256 zero8 = _mm256_setzero_ps();
  for (; i + 8 <= n; i += 8) {
    const __m256 v = _mm256_loadu_ps(p + i);
    k += __builtin_popcount(
        _mm256_movemask_ps(_mm256_cmp_ps(v, zero8, _CMP_NEQ_UQ)));
  }
#elif defined(__SSE2__)
  const __m128 zero4 = _mm_setzero_ps();
  for (; i + 4 <= n; i += 4) {
    const __m128 v = _mm_loadu_ps(p + i);
    k += __builtin_popcount(
        _mm_movemask_ps(_mm_cmpneq_ps(v, zero4)));
  }
#endif
  for (; i < n; ++i) k += (p[i] != 0.0f);
  return k;
}

// Shared validation walk for the fused-frame read paths (decode and
// apply): crc, then every section header bounds-checked against the
// frame length and the ravel size — BEFORE the first write to the
// caller's memory.  Returns 0 or a negative status.
long long fused_validate(const uint8_t* buf, uint64_t len, uint64_t total) {
  if (len < 12) return kErrTrunc;
  if (buf[0] != kFusedMagic) return kErrMagic;
  if (buf[1] != kFusedVersion) return kErrVersion;
  const uint32_t nbuckets = buf[2];
  if (get_u32(buf + 4) != total) return kErrTotal;
  const uint64_t body_end = len - 4;
  if (crc32_fast(buf, body_end, 0) != get_u32(buf + body_end)) {
    return kErrCrc;
  }
  uint64_t off = 8;
  for (uint32_t b = 0; b < nbuckets; ++b) {
    if (off + 4 > body_end) return kErrTrunc;
    const uint64_t k = get_u32(buf + off);
    if (k > total) return kErrBounds;
    off += 4;
    if (off + 4 * k + 4 > body_end) return kErrTrunc;
    const uint8_t* idx_p = buf + off;
    off += 4 * k;
    const uint64_t vlen = get_u32(buf + off);
    off += 4;
    if (off + vlen > body_end || vlen < 8) return kErrTrunc;
    const uint8_t* vhdr = buf + off;
    const uint8_t code = vhdr[0], flags = vhdr[1], ndim = vhdr[2];
    if (ndim != 1 || get_u32(vhdr + 4) != k) return kErrBounds;
    uint8_t mode;
    if (code == kDtypeF32 && flags == 0) {
      mode = kModeF32;
    } else if (code == kDtypeBf16 && flags == kFlagBf16) {
      mode = kModeBf16;
    } else if (code == kDtypeI8 && flags == kFlagI8) {
      mode = kModeI8;
    } else {
      return kErrUnsupported;  // caller re-decodes via the Python oracle
    }
    if (vlen != vlen_of(mode, k)) return kErrBounds;
    // Branchless max over the index section (vectorizes), one compare.
    uint32_t mx = 0;
    for (uint64_t i = 0; i < k; ++i) {
      const uint32_t u = get_u32(idx_p + 4 * i);
      mx = u > mx ? u : mx;
    }
    if (k && mx >= total) return kErrRange;
    off += vlen;
  }
  if (off != body_end) return kErrBounds;  // trailing slack between
                                           // sections and crc
  return 0;
}

}  // namespace

extern "C" {

uint32_t dlt_abi_version() { return DLT_ABI_VERSION; }

// Exposed so the Python side can cross-check the sliced table against
// zlib (and reuse it for large buffers).
uint32_t dlt_wire_crc32(const uint8_t* data, size_t n, uint32_t seed) {
  return crc32_fast(data, n, seed);
}

// --------------------------------------------------------------------- //
// Fused sparse frames                                                   //
//                                                                       //
//   u8 0xFE | u8 version=1 | u8 nbuckets | u8 0 | u32 total |           //
//   per bucket: u32 k | u32 idx[k] | u32 vlen | value section |         //
//   u32 crc32(all preceding bytes)                                      //
//                                                                       //
// Buckets arrive as a CSR over (offset, size) spans of the ravel:       //
// bucket b owns spans [bucket_ptr[b], bucket_ptr[b+1]).  The caller     //
// (comm/tensor_codec.py) has already validated that spans tile the      //
// ravel exactly.                                                        //
// --------------------------------------------------------------------- //

// Pass 1: per-bucket nonzero counts (and, for int8 buckets, max|v| with a
// NaN/Inf check) + the exact frame size.  Writes out_k[nbuckets] and
// out_maxabs[nbuckets]; returns the frame byte size or a negative status.
long long dlt_wire_fused_size(
    const float* flat, uint64_t total, const uint64_t* span_off,
    const uint64_t* span_size, const uint64_t* bucket_ptr,
    const uint8_t* bucket_mode, uint32_t nbuckets, uint64_t* out_k,
    float* out_maxabs) {
  (void)total;
  uint64_t size = 8;  // frame header
  for (uint32_t b = 0; b < nbuckets; ++b) {
    uint64_t k = 0;
    float maxabs = 0.0f;
    bool any_nan = false;
    const bool want_scale = bucket_mode[b] == kModeI8;
    for (uint64_t s = bucket_ptr[b]; s < bucket_ptr[b + 1]; ++s) {
      const float* p = flat + span_off[s];
      const uint64_t n = span_size[s];
      if (!want_scale) {
        k += count_nonzero(p, n);
      } else {
        for (uint64_t i = 0; i < n; ++i) {
          const float v = p[i];
          k += (v != 0.0f);
          any_nan |= (v != v);
          const float a = std::fabs(v);
          maxabs = a > maxabs ? a : maxabs;
        }
      }
    }
    if (want_scale && (any_nan || std::isinf(maxabs))) return kErrNonFinite;
    out_k[b] = k;
    out_maxabs[b] = maxabs;
    size += 4 + 4 * k + 4 + vlen_of(bucket_mode[b], k);
  }
  return static_cast<long long>(size + 4);  // + trailing crc
}


// Pass 2: assemble the frame into out (capacity cap, which must be the
// pass-1 size) — gather + convert + section headers + trailing crc, one
// linear scan of the ravel.  Returns bytes written or a negative status.
long long dlt_wire_fused_encode(
    const float* flat, uint64_t total, const uint64_t* span_off,
    const uint64_t* span_size, const uint64_t* bucket_ptr,
    const uint8_t* bucket_mode, uint32_t nbuckets, const uint64_t* ks,
    const float* maxabs, uint8_t* out, uint64_t cap) {
  if (cap < 12 || total > 0xFFFFFFFFull) return kErrInternal;
  prefault_writable(out, cap);
  out[0] = kFusedMagic;
  out[1] = kFusedVersion;
  out[2] = static_cast<uint8_t>(nbuckets);
  out[3] = 0;
  put_u32(out + 4, static_cast<uint32_t>(total));
  uint64_t cur = 8;
  for (uint32_t b = 0; b < nbuckets; ++b) {
    const uint64_t k = ks[b];
    const uint8_t mode = bucket_mode[b];
    const uint64_t vlen = vlen_of(mode, k);
    if (cur + 4 + 4 * k + 4 + vlen + 4 > cap) return kErrInternal;
    uint8_t* idx_p = out + cur + 4;
    uint8_t* vhdr = idx_p + 4 * k + 4;
    uint8_t* val_p = vhdr + (mode == kModeI8 ? 12 : 8);
    I8Scale sc{0.0f, 0.0f};
    if (mode == kModeI8) sc = i8_scale_of(maxabs[b], k);
    const float inv = sc.inv;
    uint64_t w = 0;
    for (uint64_t s = bucket_ptr[b]; s < bucket_ptr[b + 1]; ++s) {
      const float* p = flat + span_off[s];
      const uint64_t base = span_off[s];
      uint64_t n = span_size[s];
      // Defense against the ravel changing between the size and write
      // passes (a caller bug): never emit past this bucket's k section.
      if (n > 0 && w >= k + 1) return kErrInternal;
      if (mode == kModeBf16) {
#if defined(__AVX512F__)
        w = compact_span_bf16_avx512(p, n, base, w, k, idx_p, val_p);
#else
        w = compact_span(p, n, base, w,
                         [&](uint64_t c, uint64_t pos, float v) {
                           if (c < k) {
                             put_u32(idx_p + 4 * c,
                                     static_cast<uint32_t>(pos));
                             put_u16(val_p + 2 * c, f32_to_bf16_one(v));
                           }
                         });
#endif
      } else if (mode == kModeI8) {
        w = compact_span(p, n, base, w,
                         [&](uint64_t c, uint64_t pos, float v) {
                           if (c < k) {
                             put_u32(idx_p + 4 * c,
                                     static_cast<uint32_t>(pos));
                             val_p[c] = static_cast<uint8_t>(
                                 f32_to_i8_one(v, inv));
                           }
                         });
      } else {
#if defined(__AVX512F__)
        w = compact_span_f32_avx512(p, n, base, w, k, idx_p, val_p);
#else
        w = compact_span(p, n, base, w,
                         [&](uint64_t c, uint64_t pos, float v) {
                           if (c < k) {
                             put_u32(idx_p + 4 * c,
                                     static_cast<uint32_t>(pos));
                             put_f32(val_p + 4 * c, v);
                           }
                         });
#endif
      }
    }
    if (w != k) return kErrInternal;  // ravel changed between passes
    put_u32(out + cur, static_cast<uint32_t>(k));
    put_u32(vhdr - 4, static_cast<uint32_t>(vlen));
    // encode_tensor header of the 1-D f32 value vector.
    vhdr[0] = mode == kModeBf16 ? kDtypeBf16
              : mode == kModeI8 ? kDtypeI8
                                : kDtypeF32;
    vhdr[1] = mode == kModeBf16 ? kFlagBf16 : mode == kModeI8 ? kFlagI8 : 0;
    vhdr[2] = 1;  // ndim
    vhdr[3] = 0;
    put_u32(vhdr + 4, static_cast<uint32_t>(k));
    if (mode == kModeI8) put_f32(vhdr + 8, sc.wire);
    cur += 4 + 4 * k + 4 + vlen;
  }
  if (cur + 4 > cap) return kErrInternal;
  put_u32(out + cur, crc32_fast(out, cur, 0));
  return static_cast<long long>(cur + 4);
}

// Decode: crc first, then a full bounds-checking validation walk over
// every section header, and only then the scatter pass into the ravel —
// a corrupt frame can never write out, let alone out of bounds.
// ``out`` is the caller's f32 ravel of ``total`` elements; its prior
// contents are IGNORED (the decode zero-fills between validation and
// scatter), so per-edge scratch buffers can be handed back dirty.
long long dlt_wire_fused_decode(const uint8_t* buf, uint64_t len, float* out,
                                uint64_t total) {
  const long long st = fused_validate(buf, len, total);
  if (st != 0) return st;
  const uint32_t nbuckets = buf[2];
  prefault_writable(out, total * 4);
  std::memset(out, 0, total * 4);
  // Scatter walk: fused gather-position + wire->f32 conversion.
  uint64_t off = 8;
  for (uint32_t b = 0; b < nbuckets; ++b) {
    const uint64_t k = get_u32(buf + off);
    const uint8_t* idx_p = buf + off + 4;
    const uint8_t* vhdr = buf + off + 4 + 4 * k + 4;
    const uint8_t code = vhdr[0], flags = vhdr[1];
    const uint8_t* val_p = vhdr + 8;
    if (code == kDtypeF32 && flags == 0) {
      uint64_t i = 0;
#if defined(__AVX512F__)
      // vscatterdps: same last-lane-wins overlap semantics as the
      // sequential loop (and numpy's out[idx] = vals).
      for (; i + 16 <= k; i += 16) {
        _mm512_i32scatter_ps(
            out,
            _mm512_loadu_si512(
                reinterpret_cast<const void*>(idx_p + 4 * i)),
            _mm512_loadu_ps(
                reinterpret_cast<const void*>(val_p + 4 * i)),
            4);
      }
#endif
      for (; i < k; ++i) {
        out[get_u32(idx_p + 4 * i)] = get_f32(val_p + 4 * i);
      }
      off += 4 + 4 * k + 4 + 8 + 4 * k;
    } else if (code == kDtypeBf16 && flags == kFlagBf16) {
      uint64_t i = 0;
#if defined(__AVX512F__)
      for (; i + 16 <= k; i += 16) {
        const __m256i raw = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(val_p + 2 * i));
        const __m512 vals = _mm512_castsi512_ps(
            _mm512_slli_epi32(_mm512_cvtepu16_epi32(raw), 16));
        _mm512_i32scatter_ps(
            out,
            _mm512_loadu_si512(
                reinterpret_cast<const void*>(idx_p + 4 * i)),
            vals, 4);
      }
#endif
      for (; i < k; ++i) {
        const uint16_t bits = static_cast<uint16_t>(val_p[2 * i]) |
                              (static_cast<uint16_t>(val_p[2 * i + 1]) << 8);
        out[get_u32(idx_p + 4 * i)] = bf16_to_f32_one(bits);
      }
      off += 4 + 4 * k + 4 + 8 + 2 * k;
    } else {  // int8
      const float scale = get_f32(val_p);
      const int8_t* q = reinterpret_cast<const int8_t*>(val_p + 4);
      for (uint64_t i = 0; i < k; ++i) {
        out[get_u32(idx_p + 4 * i)] = static_cast<float>(q[i]) * scale;
      }
      off += 4 + 4 * k + 4 + 12 + k;
    }
  }
  return 0;
}

// Validate-only entry: the full decode-side walk (crc + section
// geometry + dtype support + index range) with no output buffer at all
// — the lazy-payload path (comm/tensor_codec.py FusedFrame) rejects
// corrupt frames at unpack time while deferring the densify/apply to
// the consumer that owns the scratch.
long long dlt_wire_fused_validate(const uint8_t* buf, uint64_t len,
                                  uint64_t total) {
  return fused_validate(buf, len, total);
}

// Apply: scatter-ADD the frame's sections straight into a live f32
// ravel (``target[idx] += scale * val``) with no dense intermediate —
// the CHOCO hat update consumes a correction frame without ever
// materializing it.  Same validate-then-write discipline as decode: a
// corrupt frame returns a negative status before the first add.
// Accumulation is np.add.at semantics (duplicate indices add once per
// occurrence, sequentially); honestly-encoded frames carry strictly
// ascending positions, for which this is ulp-identical to
// decode-then-``target += scale * dense``.  Deliberately scalar: a
// SIMD gather-add-scatter would lose one addition per duplicate lane.
long long dlt_wire_fused_apply(const uint8_t* buf, uint64_t len,
                               float* target, uint64_t total, float scale) {
  const long long st = fused_validate(buf, len, total);
  if (st != 0) return st;
  const uint32_t nbuckets = buf[2];
  uint64_t off = 8;
  for (uint32_t b = 0; b < nbuckets; ++b) {
    const uint64_t k = get_u32(buf + off);
    const uint8_t* idx_p = buf + off + 4;
    const uint8_t* vhdr = buf + off + 4 + 4 * k + 4;
    const uint8_t code = vhdr[0], flags = vhdr[1];
    const uint8_t* val_p = vhdr + 8;
    if (code == kDtypeF32 && flags == 0) {
      for (uint64_t i = 0; i < k; ++i) {
        target[get_u32(idx_p + 4 * i)] +=
            fp_barrier(scale * get_f32(val_p + 4 * i));
      }
      off += 4 + 4 * k + 4 + 8 + 4 * k;
    } else if (code == kDtypeBf16 && flags == kFlagBf16) {
      for (uint64_t i = 0; i < k; ++i) {
        const uint16_t bits = static_cast<uint16_t>(val_p[2 * i]) |
                              (static_cast<uint16_t>(val_p[2 * i + 1]) << 8);
        target[get_u32(idx_p + 4 * i)] +=
            fp_barrier(scale * bf16_to_f32_one(bits));
      }
      off += 4 + 4 * k + 4 + 8 + 2 * k;
    } else {  // int8
      const float q_scale = get_f32(val_p);
      const int8_t* q = reinterpret_cast<const int8_t*>(val_p + 4);
      for (uint64_t i = 0; i < k; ++i) {
        target[get_u32(idx_p + 4 * i)] +=
            fp_barrier(scale * (static_cast<float>(q[i]) * q_scale));
      }
      off += 4 + 4 * k + 4 + 12 + k;
    }
  }
  return 0;
}

// --------------------------------------------------------------------- //
// Dense tensor frames (encode_tensor/decode_tensor parity):             //
//   u8 dtype_code | u8 flags | u8 ndim | u8 0 | u32 dim[ndim] |         //
//   [f32 scale if int8] | payload                                       //
// --------------------------------------------------------------------- //

// Whole-frame dense encode of an f32 source under a wire mode.  ``n``
// must be prod(dims); returns bytes written or a negative status.
long long dlt_wire_dense_encode(const float* src, uint64_t n,
                                const uint32_t* dims, uint32_t ndim,
                                uint32_t mode, uint8_t* out, uint64_t cap) {
  const uint64_t hdr = 4 + 4ull * ndim;
  const uint64_t need =
      hdr + (mode == kModeI8 ? 4 + n : mode == kModeBf16 ? 2 * n : 4 * n);
  if (cap < need) return kErrInternal;
  out[0] = mode == kModeBf16 ? kDtypeBf16 : mode == kModeI8 ? kDtypeI8
                                                            : kDtypeF32;
  out[1] = mode == kModeBf16 ? kFlagBf16 : mode == kModeI8 ? kFlagI8 : 0;
  out[2] = static_cast<uint8_t>(ndim);
  out[3] = 0;
  for (uint32_t d = 0; d < ndim; ++d) put_u32(out + 4 + 4 * d, dims[d]);
  uint8_t* p = out + hdr;
  if (mode == kModeBf16) {
    for (uint64_t i = 0; i < n; ++i) {
      const uint16_t bits = f32_to_bf16_one(src[i]);
      p[2 * i] = static_cast<uint8_t>(bits);
      p[2 * i + 1] = static_cast<uint8_t>(bits >> 8);
    }
  } else if (mode == kModeI8) {
    float maxabs = 0.0f;
    bool any_nan = false;
    for (uint64_t i = 0; i < n; ++i) {
      const float v = src[i];
      if (v != v) any_nan = true;
      const float a = std::fabs(v);
      if (a > maxabs) maxabs = a;
    }
    if (any_nan || std::isinf(maxabs)) return kErrNonFinite;
    const I8Scale sc = i8_scale_of(maxabs, n);
    put_f32(p, sc.wire);
    p += 4;
    for (uint64_t i = 0; i < n; ++i) {
      p[i] = static_cast<uint8_t>(f32_to_i8_one(src[i], sc.inv));
    }
  } else {
    for (uint64_t i = 0; i < n; ++i) put_f32(p + 4 * i, src[i]);
  }
  return static_cast<long long>(need);
}

// Whole-frame dense decode into an f32 buffer of ``n`` elements.  The
// caller (native/wire.py) sized ``out`` from the already-parsed header;
// this call re-validates the frame end to end.  Returns 0, or a negative
// status (kErrUnsupported: a dtype/flags combo the caller must route to
// the Python decoder).
long long dlt_wire_dense_decode(const uint8_t* buf, uint64_t len, float* out,
                                uint64_t n) {
  if (len < 4) return kErrTrunc;
  const uint8_t code = buf[0], flags = buf[1], ndim = buf[2];
  if (ndim > 16) return kErrBounds;
  const uint64_t hdr = 4 + 4ull * ndim;
  if (len < hdr) return kErrTrunc;
  uint64_t count = 1;
  for (uint32_t d = 0; d < ndim; ++d) {
    const uint64_t dim = get_u32(buf + 4 + 4 * d);
    if (dim != 0 && count > (1ull << 40) / (dim ? dim : 1)) return kErrBounds;
    count *= dim;
  }
  if (count != n) return kErrTotal;
  const uint8_t* p = buf + hdr;
  if (code == kDtypeBf16 && flags == kFlagBf16) {
    if (len != hdr + 2 * n) return kErrTrunc;
    for (uint64_t i = 0; i < n; ++i) {
      const uint16_t bits = static_cast<uint16_t>(p[2 * i]) |
                            (static_cast<uint16_t>(p[2 * i + 1]) << 8);
      out[i] = bf16_to_f32_one(bits);
    }
  } else if (code == kDtypeI8 && flags == kFlagI8) {
    if (len != hdr + 4 + n) return kErrTrunc;
    const float scale = get_f32(p);
    const int8_t* q = reinterpret_cast<const int8_t*>(p + 4);
    for (uint64_t i = 0; i < n; ++i) {
      out[i] = static_cast<float>(q[i]) * scale;
    }
  } else if (code == kDtypeF32 && flags == 0) {
    if (len != hdr + 4 * n) return kErrTrunc;
    for (uint64_t i = 0; i < n; ++i) out[i] = get_f32(p + 4 * i);
  } else {
    return kErrUnsupported;
  }
  return 0;
}

}  // extern "C"
