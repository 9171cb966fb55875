// Native tensor wire codec for the TCP comm backend.
//
// The reference's transport pickles raw float64 numpy arrays over TCP
// (utils/consensus_tcp/pickled_socket.py:11-23) — unsafe (pickle) and 4-8x
// larger on the wire than needed for gossip values.  This codec provides
// the two hot operations of the replacement binary protocol:
//
//   * float32 <-> bfloat16 conversion (round-to-nearest-even, the TPU
//     wire/storage format) — halves gossip bandwidth with the same
//     exponent range as f32;
//   * crc32 (reflected polynomial 0xEDB88320) integrity checksums for
//     frames, so a torn TCP stream is detected instead of deserialized;
//   * symmetric int8 quantization (scale = max|x|/127, round-to-nearest
//     ties-to-even, matching np.rint) — quarter-size gossip payloads
//     whose quantization error CHOCO's error feedback absorbs.
//
// Exposed with C linkage for ctypes; built by native/__init__.py with g++
// -O3 at first use into the package's _build/ directory.  A copy of the
// JAX package's native/codec.cpp: the two must produce the same bytes.

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "dlt_abi.h"

extern "C" {

// Checked by native/__init__.py right after dlopen: a cached .so built
// from an older source (missing symbols or changed signatures) must
// trigger a rebuild, never an AttributeError at first use.
uint32_t dlt_abi_version() { return DLT_ABI_VERSION; }

// f32 -> bf16 with round-to-nearest-even (ties to even), matching the
// hardware semantics XLA uses when it narrows f32 to bf16.
void dlt_f32_to_bf16(const float* src, uint16_t* dst, size_t n) {
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(src);
  for (size_t i = 0; i < n; ++i) {
    uint32_t x = bits[i];
    // NaN must stay NaN: round-up could flow a signalling NaN mantissa to
    // zero (infinity); force a quiet-NaN payload instead.
    if ((x & 0x7fffffffu) > 0x7f800000u) {
      dst[i] = static_cast<uint16_t>((x >> 16) | 0x0040u);
      continue;
    }
    uint32_t lsb = (x >> 16) & 1u;
    uint32_t rounded = x + 0x7fffu + lsb;
    dst[i] = static_cast<uint16_t>(rounded >> 16);
  }
}

void dlt_bf16_to_f32(const uint16_t* src, float* dst, size_t n) {
  uint32_t* out = reinterpret_cast<uint32_t*>(dst);
  for (size_t i = 0; i < n; ++i) {
    out[i] = static_cast<uint32_t>(src[i]) << 16;
  }
}

// f32 -> int8 with a caller-supplied inverse scale:
// q = clamp(rint(x/scale), -127, 127).  nearbyintf under the default
// FE_TONEAREST mode rounds ties to even — bit-identical to the Python
// fallback's np.rint.
void dlt_f32_to_i8(const float* src, int8_t* dst, size_t n, float inv_scale) {
  for (size_t i = 0; i < n; ++i) {
    float v = src[i] * inv_scale;
    // Match np.rint (ties to even): use __builtin_nearbyint under the
    // default FE_TONEAREST mode.
    float r = __builtin_nearbyintf(v);
    if (r > 127.0f) r = 127.0f;
    if (r < -127.0f) r = -127.0f;
    dst[i] = static_cast<int8_t>(r);
  }
}

void dlt_i8_to_f32(const int8_t* src, float* dst, size_t n, float scale) {
  for (size_t i = 0; i < n; ++i) {
    dst[i] = static_cast<float>(src[i]) * scale;
  }
}

static uint32_t kCrcTable[8][256];
static bool kCrcInit = false;

static void crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) {
      c = (c & 1u) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    }
    kCrcTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    for (int t = 1; t < 8; ++t) {
      kCrcTable[t][i] =
          (kCrcTable[t - 1][i] >> 8) ^ kCrcTable[0][kCrcTable[t - 1][i] & 0xFFu];
    }
  }
  kCrcInit = true;
}

// Same polynomial/reflection as zlib.crc32, so the Python fallback and the
// native path produce identical checksums.  Slicing-by-8: a
// byte-at-a-time loop bottlenecked framing.py's per-frame checksum
// behind one serial table lookup per byte; eight parallel tables process
// 8 bytes per iteration at ~4-5x the throughput.
uint32_t dlt_crc32(const uint8_t* data, size_t n, uint32_t seed) {
  if (!kCrcInit) crc_init();
  uint32_t c = seed ^ 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
    lo = __builtin_bswap32(lo);
    hi = __builtin_bswap32(hi);
#endif
    lo ^= c;
    c = kCrcTable[7][lo & 0xFFu] ^ kCrcTable[6][(lo >> 8) & 0xFFu] ^
        kCrcTable[5][(lo >> 16) & 0xFFu] ^ kCrcTable[4][lo >> 24] ^
        kCrcTable[3][hi & 0xFFu] ^ kCrcTable[2][(hi >> 8) & 0xFFu] ^
        kCrcTable[1][(hi >> 16) & 0xFFu] ^ kCrcTable[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  for (size_t i = 0; i < n; ++i) {
    c = kCrcTable[0][(c ^ data[i]) & 0xFFu] ^ (c >> 8);
  }
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
