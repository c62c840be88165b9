// capruntime — native batch JOSE preparation for cap_tpu.
//
// The framework's native runtime component (the reference has none —
// SURVEY.md §2: its hot loops live in Go stdlib crypto; ours live here
// and on the TPU). One call prepares a whole batch of compact JWS
// tokens for device dispatch:
//   - strict structural parse (3 segments, unpadded base64url)
//   - header JSON scan: top-level "alg" and "kid" strings
//     (full minimal JSON parser; duplicate keys: last one wins,
//     matching Python's json.loads)
//   - base64url decode of payload + signature
//   - SHA-256/384/512 of the signing input, chosen by alg family
// Multithreaded over tokens; exposed via a C ABI for ctypes.
//
// Build: make native   (g++ -O3 -shared -fPIC -pthread)

#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>  // SHA-NI path (sha2 namespace below)
#include <cpuid.h>      // feature probe fallback for gcc < 11
#endif

// ---------------------------------------------------------------------------
// SHA-2 (FIPS 180-4), implemented from the spec.
// ---------------------------------------------------------------------------

namespace sha2 {

static const uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void sha256_compress_scalar(uint32_t h[8], const uint8_t* p) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
           (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
           g = h[6], hh = h[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = hh + S1 + ch + K256[i] + w[i];
    uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    hh = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

#if defined(__x86_64__) || defined(__i386__)
// SHA-NI block: the canonical x86 SHA extension flow (two rounds per
// sha256rnds2, message schedule via sha256msg1/msg2 with a 4-register
// rotation). Bit-identical to the scalar compress — sha_batch parity
// tests diff it against hashlib on every build.
__attribute__((target("sha,sse4.1,ssse3")))
static void sha256_compress_ni(uint32_t h[8], const uint8_t* p) {
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i TMP = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&h[0]));
  __m128i STATE1 =
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(&h[4]));
  TMP = _mm_shuffle_epi32(TMP, 0xB1);           // CDAB
  STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);     // EFGH
  __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);     // ABEF
  STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);          // CDGH
  const __m128i ABEF_SAVE = STATE0;
  const __m128i CDGH_SAVE = STATE1;

  __m128i m[4];
  for (int g = 0; g < 4; ++g)
    m[g] = _mm_shuffle_epi8(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 16 * g)),
        MASK);
  for (int g = 0; g < 16; ++g) {
    __m128i msg = _mm_add_epi32(
        m[g & 3],
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(&K256[4 * g])));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, msg);
    msg = _mm_shuffle_epi32(msg, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, msg);
    if (g < 12) {
      // W[g+4] = msg2(msg1(W[g], W[g+1]) + alignr(W[g+3], W[g+2], 4),
      //               W[g+3]) — overwrites the slot just consumed.
      __m128i x = _mm_sha256msg1_epu32(m[g & 3], m[(g + 1) & 3]);
      x = _mm_add_epi32(
          x, _mm_alignr_epi8(m[(g + 3) & 3], m[(g + 2) & 3], 4));
      m[g & 3] = _mm_sha256msg2_epu32(x, m[(g + 3) & 3]);
    }
  }

  STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
  STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
  TMP = _mm_shuffle_epi32(STATE0, 0x1B);        // FEBA
  STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);     // DCHG
  STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);  // DCBA
  STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);     // HGFE
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&h[0]), STATE0);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&h[4]), STATE1);
}
#endif  // x86

// Runtime dispatch: SHA-NI where the CPU has it (one compress is
// ~10× the scalar rate; the digest is the prep hot loop's biggest
// single term), scalar elsewhere. x86 SHA extensions cover SHA-1/256
// only — SHA-384/512 stays scalar.
static void (*sha256_compress)(uint32_t[8], const uint8_t*) =
    sha256_compress_scalar;

__attribute__((constructor)) static void sha256_pick_impl() {
#if defined(__x86_64__) || defined(__i386__)
#if defined(__clang__) || (defined(__GNUC__) && __GNUC__ >= 11)
  if (__builtin_cpu_supports("sha") &&
      __builtin_cpu_supports("sse4.1") &&
      __builtin_cpu_supports("ssse3"))
    sha256_compress = sha256_compress_ni;
#else
  // gcc < 11 rejects "sha" as a __builtin_cpu_supports feature name
  // (the whole translation unit failed to compile, silently killing
  // the native runtime on those toolchains): probe CPUID leaf 7
  // directly — EBX bit 29 is the SHA-extensions flag.
  unsigned eax = 0, ebx = 0, ecx = 0, edx = 0;
  if (__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx) &&
      (ebx & (1u << 29)) &&
      __builtin_cpu_supports("sse4.1") &&
      __builtin_cpu_supports("ssse3"))
    sha256_compress = sha256_compress_ni;
#endif
#endif
}

void sha256(const uint8_t* data, size_t len, uint8_t out[32]) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  size_t i = 0;
  for (; i + 64 <= len; i += 64) sha256_compress(h, data + i);
  uint8_t block[128] = {0};
  size_t rem = len - i;
  memcpy(block, data + i, rem);
  block[rem] = 0x80;
  size_t blocks = (rem + 9 <= 64) ? 1 : 2;
  uint64_t bits = uint64_t(len) * 8;
  for (int j = 0; j < 8; j++)
    block[blocks * 64 - 1 - j] = uint8_t(bits >> (8 * j));
  sha256_compress(h, block);
  if (blocks == 2) sha256_compress(h, block + 64);
  for (int j = 0; j < 8; j++) {
    out[4 * j] = uint8_t(h[j] >> 24);
    out[4 * j + 1] = uint8_t(h[j] >> 16);
    out[4 * j + 2] = uint8_t(h[j] >> 8);
    out[4 * j + 3] = uint8_t(h[j]);
  }
}

static const uint64_t K512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

static inline uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

static void sha512_compress(uint64_t h[8], const uint8_t* p) {
  uint64_t w[80];
  for (int i = 0; i < 16; i++) {
    uint64_t v = 0;
    for (int j = 0; j < 8; j++) v = (v << 8) | p[8 * i + j];
    w[i] = v;
  }
  for (int i = 16; i < 80; i++) {
    uint64_t s0 = rotr64(w[i - 15], 1) ^ rotr64(w[i - 15], 8) ^ (w[i - 15] >> 7);
    uint64_t s1 = rotr64(w[i - 2], 19) ^ rotr64(w[i - 2], 61) ^ (w[i - 2] >> 6);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint64_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
           g = h[6], hh = h[7];
  for (int i = 0; i < 80; i++) {
    uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    uint64_t ch = (e & f) ^ (~e & g);
    uint64_t t1 = hh + S1 + ch + K512[i] + w[i];
    uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint64_t t2 = S0 + maj;
    hh = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

static void sha512_generic(const uint64_t iv[8], const uint8_t* data,
                           size_t len, uint8_t* out, int out_words) {
  uint64_t h[8];
  memcpy(h, iv, sizeof(h));
  size_t i = 0;
  for (; i + 128 <= len; i += 128) sha512_compress(h, data + i);
  uint8_t block[256] = {0};
  size_t rem = len - i;
  memcpy(block, data + i, rem);
  block[rem] = 0x80;
  size_t blocks = (rem + 17 <= 128) ? 1 : 2;
  // message length in bits as 128-bit big-endian (top 64 bits are zero
  // for any realistic input)
  uint64_t bits = uint64_t(len) * 8;
  for (int j = 0; j < 8; j++)
    block[blocks * 128 - 1 - j] = uint8_t(bits >> (8 * j));
  sha512_compress(h, block);
  if (blocks == 2) sha512_compress(h, block + 128);
  for (int j = 0; j < out_words; j++)
    for (int k = 0; k < 8; k++)
      out[8 * j + k] = uint8_t(h[j] >> (56 - 8 * k));
}

void sha512(const uint8_t* data, size_t len, uint8_t out[64]) {
  static const uint64_t iv[8] = {
      0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
      0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
      0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  sha512_generic(iv, data, len, out, 8);
}

void sha384(const uint8_t* data, size_t len, uint8_t out[48]) {
  static const uint64_t iv[8] = {
      0xcbbb9d5dc1059ed8ULL, 0x629a292a367cd507ULL, 0x9159015a3070dd17ULL,
      0x152fecd8f70e5939ULL, 0x67332667ffc00b31ULL, 0x8eb44a8768581511ULL,
      0xdb0c2e0d64f98fa7ULL, 0x47b5481dbefa4fa4ULL};
  sha512_generic(iv, data, len, out, 6);
}

}  // namespace sha2

// ---------------------------------------------------------------------------
// base64url (RFC 7515: unpadded, strict charset)
// ---------------------------------------------------------------------------

static int8_t B64_TABLE[256];
static bool b64_table_init = [] {
  for (int i = 0; i < 256; i++) B64_TABLE[i] = -1;
  const char* cs =
      "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_";
  for (int i = 0; i < 64; i++) B64_TABLE[uint8_t(cs[i])] = int8_t(i);
  return true;
}();

// Decode unpadded base64url. Returns decoded length or -1 on error.
static int64_t b64url_decode(const char* in, int64_t n, uint8_t* out) {
  if (n % 4 == 1) return -1;
  int64_t o = 0;
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    int8_t a = B64_TABLE[uint8_t(in[i])], b = B64_TABLE[uint8_t(in[i + 1])],
           c = B64_TABLE[uint8_t(in[i + 2])], d = B64_TABLE[uint8_t(in[i + 3])];
    if ((a | b | c | d) < 0) return -1;
    uint32_t v = (uint32_t(a) << 18) | (uint32_t(b) << 12) |
                 (uint32_t(c) << 6) | uint32_t(d);
    out[o++] = uint8_t(v >> 16);
    out[o++] = uint8_t(v >> 8);
    out[o++] = uint8_t(v);
  }
  int64_t rem = n - i;
  if (rem == 2) {
    int8_t a = B64_TABLE[uint8_t(in[i])], b = B64_TABLE[uint8_t(in[i + 1])];
    if ((a | b) < 0) return -1;
    uint32_t v = (uint32_t(a) << 18) | (uint32_t(b) << 12);
    out[o++] = uint8_t(v >> 16);
    // python's base64 ignores trailing bits in the final quantum; JWS
    // parity: accept (the CPU path accepts as well via urlsafe_b64decode)
  } else if (rem == 3) {
    int8_t a = B64_TABLE[uint8_t(in[i])], b = B64_TABLE[uint8_t(in[i + 1])],
           c = B64_TABLE[uint8_t(in[i + 2])];
    if ((a | b | c) < 0) return -1;
    uint32_t v = (uint32_t(a) << 18) | (uint32_t(b) << 12) | (uint32_t(c) << 6);
    out[o++] = uint8_t(v >> 16);
    out[o++] = uint8_t(v >> 8);
  }
  return o;
}

// Strict UTF-8 validation matching CPython's decoder (rejects overlong
// encodings, surrogates, and > U+10FFFF) — Python's json.loads decodes
// the buffer as UTF-8 before parsing, so the native path must too.
static bool valid_utf8(const uint8_t* p, int64_t n) {
  int64_t i = 0;
  while (i < n) {
    uint8_t c = p[i];
    if (c < 0x80) { i++; continue; }
    if (c < 0xC2) return false;  // continuation byte or overlong C0/C1
    if (c < 0xE0) {              // 2-byte
      if (i + 1 >= n || (p[i + 1] & 0xC0) != 0x80) return false;
      i += 2;
    } else if (c < 0xF0) {       // 3-byte
      if (i + 2 >= n) return false;
      uint8_t c1 = p[i + 1], c2 = p[i + 2];
      if ((c1 & 0xC0) != 0x80 || (c2 & 0xC0) != 0x80) return false;
      if (c == 0xE0 && c1 < 0xA0) return false;         // overlong
      if (c == 0xED && c1 >= 0xA0) return false;        // surrogate
      i += 3;
    } else if (c < 0xF5) {       // 4-byte
      if (i + 3 >= n) return false;
      uint8_t c1 = p[i + 1], c2 = p[i + 2], c3 = p[i + 3];
      if ((c1 & 0xC0) != 0x80 || (c2 & 0xC0) != 0x80 ||
          (c3 & 0xC0) != 0x80) return false;
      if (c == 0xF0 && c1 < 0x90) return false;         // overlong
      if (c == 0xF4 && c1 >= 0x90) return false;        // > U+10FFFF
      i += 4;
    } else {
      return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Minimal JSON parser — just enough to validate an object and extract
// top-level "alg"/"kid" string values (last duplicate wins, like
// Python's json.loads). Returns false on malformed JSON.
// ---------------------------------------------------------------------------

struct JsonScanner {
  const char* p;
  const char* end;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      p++;
  }

  bool parse_string(std::string* out) {
    if (p >= end || *p != '"') return false;
    p++;
    std::string s;
    while (p < end) {
      unsigned char c = *p;
      if (c == '"') {
        p++;
        if (out) *out = s;
        return true;
      }
      if (c == '\\') {
        p++;
        if (p >= end) return false;
        char e = *p++;
        switch (e) {
          case '"': s += '"'; break;
          case '\\': s += '\\'; break;
          case '/': s += '/'; break;
          case 'b': s += '\b'; break;
          case 'f': s += '\f'; break;
          case 'n': s += '\n'; break;
          case 'r': s += '\r'; break;
          case 't': s += '\t'; break;
          case 'u': {
            if (end - p < 4) return false;
            unsigned v = 0;
            for (int i = 0; i < 4; i++) {
              char h = p[i];
              v <<= 4;
              if (h >= '0' && h <= '9') v |= h - '0';
              else if (h >= 'a' && h <= 'f') v |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') v |= h - 'A' + 10;
              else return false;
            }
            p += 4;
            // encode as UTF-8 (surrogate pairs: handle the common case)
            if (v >= 0xD800 && v <= 0xDBFF && end - p >= 6 && p[0] == '\\' &&
                p[1] == 'u') {
              unsigned lo = 0;
              bool ok = true;
              for (int i = 0; i < 4; i++) {
                char h = p[2 + i];
                lo <<= 4;
                if (h >= '0' && h <= '9') lo |= h - '0';
                else if (h >= 'a' && h <= 'f') lo |= h - 'a' + 10;
                else if (h >= 'A' && h <= 'F') lo |= h - 'A' + 10;
                else { ok = false; break; }
              }
              if (ok && lo >= 0xDC00 && lo <= 0xDFFF) {
                p += 6;
                unsigned cp = 0x10000 + ((v - 0xD800) << 10) + (lo - 0xDC00);
                s += char(0xF0 | (cp >> 18));
                s += char(0x80 | ((cp >> 12) & 0x3F));
                s += char(0x80 | ((cp >> 6) & 0x3F));
                s += char(0x80 | (cp & 0x3F));
                break;
              }
            }
            if (v < 0x80) s += char(v);
            else if (v < 0x800) {
              s += char(0xC0 | (v >> 6));
              s += char(0x80 | (v & 0x3F));
            } else {
              s += char(0xE0 | (v >> 12));
              s += char(0x80 | ((v >> 6) & 0x3F));
              s += char(0x80 | (v & 0x3F));
            }
            break;
          }
          default: return false;
        }
        continue;
      }
      if (c < 0x20) return false;
      s += char(c);
      p++;
    }
    return false;
  }

  bool skip_number() {
    if (p < end && *p == '-') p++;
    if (p >= end) return false;
    if (*p == '0') p++;
    else if (*p >= '1' && *p <= '9') { while (p < end && *p >= '0' && *p <= '9') p++; }
    else return false;
    if (p < end && *p == '.') {
      p++;
      if (p >= end || *p < '0' || *p > '9') return false;
      while (p < end && *p >= '0' && *p <= '9') p++;
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
      p++;
      if (p < end && (*p == '+' || *p == '-')) p++;
      if (p >= end || *p < '0' || *p > '9') return false;
      while (p < end && *p >= '0' && *p <= '9') p++;
    }
    return true;
  }

  bool skip_literal(const char* lit) {
    size_t n = strlen(lit);
    if (size_t(end - p) < n || strncmp(p, lit, n) != 0) return false;
    p += n;
    return true;
  }

  bool skip_value(int depth) {
    if (depth > 64) return false;
    ws();
    if (p >= end) return false;
    switch (*p) {
      case '"': return parse_string(nullptr);
      case '{': return skip_object_with_kidflag(depth + 1, nullptr, nullptr,
                                                nullptr, nullptr);
      case '[': {
        p++;
        ws();
        if (p < end && *p == ']') { p++; return true; }
        while (true) {
          if (!skip_value(depth + 1)) return false;
          ws();
          if (p < end && *p == ',') { p++; continue; }
          if (p < end && *p == ']') { p++; return true; }
          return false;
        }
      }
      case 't': return skip_literal("true");
      case 'f': return skip_literal("false");
      case 'n': return skip_literal("null");
      default: return skip_number();
    }
  }

  // Parses an object. When alg/kid are non-null, captures those
  // top-level string members (top level only when depth == 1);
  // kid_found reports whether a top-level string "kid" member existed
  // (distinguishing an absent kid from an empty-string kid).
  // crit_found flags a top-level "crit" member of ANY value type —
  // go-jose rejects every JWS bearing one, and the Python parser
  // (jwt/jose.py) matches, so the native prep must too.
  bool skip_object_with_kidflag(int depth, std::string* alg,
                                std::string* kid, bool* kid_found,
                                bool* crit_found) {
    if (depth > 64) return false;
    ws();
    if (p >= end || *p != '{') return false;
    p++;
    ws();
    if (p < end && *p == '}') { p++; return true; }
    while (true) {
      ws();
      std::string key;
      if (!parse_string(&key)) return false;
      ws();
      if (p >= end || *p != ':') return false;
      p++;
      ws();
      if (depth == 1 && crit_found && key == "crit") *crit_found = true;
      bool captured = false;
      if (depth == 1 && p < end && *p == '"' && (alg || kid)) {
        if (alg && key == "alg") {
          if (!parse_string(alg)) return false;
          captured = true;
        } else if (kid && key == "kid") {
          if (!parse_string(kid)) return false;
          if (kid_found) *kid_found = true;
          captured = true;
        }
      }
      if (!captured && !skip_value(depth)) return false;
      ws();
      if (p < end && *p == ',') { p++; continue; }
      if (p < end && *p == '}') { p++; return true; }
      return false;
    }
  }
};

// ---------------------------------------------------------------------------
// Batch prepare
// ---------------------------------------------------------------------------

// Status codes (mirrored in cap_tpu/runtime/native_binding.py)
enum Status : int32_t {
  OK = 0,
  ERR_SEGMENTS = 1,     // not exactly 3 dot-separated segments
  ERR_B64 = 2,          // bad base64url in any segment
  ERR_HEADER_JSON = 3,  // header not a JSON object
  ERR_NO_ALG = 4,       // missing/empty alg
  ERR_UNSIGNED = 5,     // empty signature segment
  ERR_CRIT = 6,         // crit protected header present (go-jose parity)
};

// Alg ids (order matches ALG_NAMES in the binding)
static const char* ALG_NAMES[10] = {"RS256", "RS384", "RS512", "ES256",
                                    "ES384", "ES512", "PS256", "PS384",
                                    "PS512", "EdDSA"};

struct TokOut {
  int32_t status;
  int32_t alg_id;          // 0..9, or -1 for unknown alg strings
  int64_t sig_off, sig_len;
  int64_t payload_off, payload_len;
  int64_t signing_input_len;  // prefix length of token (header.payload)
  char kid[160];           // raw kid bytes (may contain NULs)
  char alg_raw[32];        // raw alg bytes for unknown algs
  uint8_t digest[64];      // sha256/384/512 of signing input (by family)
  int32_t digest_len;
  int32_t kid_len;         // -1 = kid absent; -2 = kid longer than 160
  int32_t alg_len;
  int32_t pad;
};

static int alg_id_of(const std::string& a) {
  for (int i = 0; i < 10; i++)
    if (a == ALG_NAMES[i]) return i;
  return -1;
}

static void prepare_one(const char* tok, int64_t len, TokOut* out,
                        uint8_t* scratch, int64_t scratch_cap) {
  memset(out, 0, sizeof(TokOut));
  out->kid_len = -1;
  // split on dots
  int64_t d1 = -1, d2 = -1;
  int dots = 0;
  for (int64_t i = 0; i < len; i++) {
    if (tok[i] == '.') {
      dots++;
      if (dots == 1) d1 = i;
      else if (dots == 2) d2 = i;
    }
  }
  if (dots != 2 || len == 0) {
    out->status = ERR_SEGMENTS;
    return;
  }
  const char* hseg = tok;
  int64_t hlen = d1;
  const char* pseg = tok + d1 + 1;
  int64_t plen = d2 - d1 - 1;
  const char* sseg = tok + d2 + 1;
  int64_t slen = len - d2 - 1;

  // header decode (into scratch)
  std::vector<uint8_t> hbuf((hlen * 3) / 4 + 4);
  int64_t hdec = b64url_decode(hseg, hlen, hbuf.data());
  if (hdec < 0) {
    out->status = ERR_B64;
    return;
  }
  if (!valid_utf8(hbuf.data(), hdec)) {
    out->status = ERR_HEADER_JSON;
    return;
  }
  JsonScanner js{reinterpret_cast<const char*>(hbuf.data()),
                 reinterpret_cast<const char*>(hbuf.data()) + hdec};
  std::string alg;
  std::string kid;
  bool kid_present = false;
  bool crit_present = false;
  if (!js.skip_object_with_kidflag(1, &alg, &kid, &kid_present,
                                   &crit_present)) {
    out->status = ERR_HEADER_JSON;
    return;
  }
  js.ws();
  if (js.p != js.end) {  // trailing garbage after the object
    out->status = ERR_HEADER_JSON;
    return;
  }
  if (alg.empty()) {
    out->status = ERR_NO_ALG;
    return;
  }
  if (crit_present) {  // same check order as jose.py: alg, then crit
    out->status = ERR_CRIT;
    return;
  }
  // payload + signature decode into the caller's scratch region
  if ((plen * 3) / 4 + 4 + (slen * 3) / 4 + 4 > scratch_cap) {
    out->status = ERR_B64;  // scratch sized from token len; cannot happen
    return;
  }
  int64_t pdec = b64url_decode(pseg, plen, scratch);
  if (pdec < 0) {
    out->status = ERR_B64;
    return;
  }
  int64_t sdec = b64url_decode(sseg, slen, scratch + pdec);
  if (sdec < 0) {
    out->status = ERR_B64;
    return;
  }
  if (sdec == 0) {
    out->status = ERR_UNSIGNED;
    return;
  }
  out->payload_off = 0;  // relative; binding adds the token's base offset
  out->payload_len = pdec;
  out->sig_off = pdec;
  out->sig_len = sdec;
  out->signing_input_len = d2;
  // byte-exact kid/alg (embedded NULs preserved; overlong kid flagged so
  // the binding demotes to the exact slow path instead of mismatching)
  if (!kid_present) {
    out->kid_len = -1;
  } else if (kid.size() > sizeof(out->kid)) {
    out->kid_len = -2;
  } else {
    memcpy(out->kid, kid.data(), kid.size());
    out->kid_len = int32_t(kid.size());
  }
  size_t alen = alg.size() < sizeof(out->alg_raw) ? alg.size()
                                                  : sizeof(out->alg_raw);
  memcpy(out->alg_raw, alg.data(), alen);
  out->alg_len = int32_t(alen);
  out->alg_id = (alg.size() <= sizeof(out->alg_raw)) ? alg_id_of(alg) : -1;

  // digest of the signing input, by alg family suffix
  const uint8_t* si = reinterpret_cast<const uint8_t*>(tok);
  if (out->alg_id >= 0) {
    if (alg == "EdDSA") {
      out->digest_len = 0;  // Ed25519 signs the raw message
    } else if (alg.size() == 5 && alg.compare(2, 3, "256") == 0) {
      sha2::sha256(si, size_t(d2), out->digest);
      out->digest_len = 32;
    } else if (alg.compare(2, 3, "384") == 0) {
      sha2::sha384(si, size_t(d2), out->digest);
      out->digest_len = 48;
    } else {
      sha2::sha512(si, size_t(d2), out->digest);
      out->digest_len = 64;
    }
  }
  out->status = OK;
}

extern "C" {

// tokens: concatenated token bytes; offsets: n+1 entries delimiting each
// token; outs: n TokOut records; decode_buf: per-token scratch carved as
// decode_offsets[i] .. decode_offsets[i+1] (binding sizes it from token
// lengths). Multithreaded over tokens.
void cap_prepare_batch(const char* tokens, const int64_t* offsets, int64_t n,
                       TokOut* outs, uint8_t* decode_buf,
                       const int64_t* decode_offsets, int32_t n_threads) {
  if (n_threads <= 0) {
    n_threads = int32_t(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n) n_threads = int32_t(n > 0 ? n : 1);
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      prepare_one(tokens + offsets[i], offsets[i + 1] - offsets[i], &outs[i],
                  decode_buf + decode_offsets[i],
                  decode_offsets[i + 1] - decode_offsets[i]);
    }
  };
  if (n_threads <= 1) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

int64_t cap_tokout_size() { return sizeof(TokOut); }

// Standalone batched SHA-2 over byte ranges (used by the PSS host check
// and Ed25519 prehash paths).
void cap_sha_batch(const uint8_t* data, const int64_t* offsets, int64_t n,
                   int32_t bits, uint8_t* out, int32_t n_threads) {
  int32_t out_len = bits / 8;
  if (n_threads <= 0) {
    n_threads = int32_t(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n) n_threads = int32_t(n > 0 ? n : 1);
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      const uint8_t* p = data + offsets[i];
      size_t len = size_t(offsets[i + 1] - offsets[i]);
      if (bits == 256) sha2::sha256(p, len, out + i * out_len);
      else if (bits == 384) sha2::sha384(p, len, out + i * out_len);
      else sha2::sha512(p, len, out + i * out_len);
    }
  };
  if (n_threads <= 1) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}


// EMSA-PSS-VERIFY (RFC 8017 §9.1.2) for a batch of device-computed EMs,
// salt auto-recovered (parity with cap_tpu.tpu.rsa.pss_check_em and the
// CPU oracle's PSS.AUTO). em: [n, em_stride] right-aligned big-endian.
void cap_pss_check_batch(const uint8_t* em, int64_t n, int64_t em_stride,
                         const uint8_t* mhash, int64_t mhash_stride,
                         const int64_t* em_bits, int32_t bits,
                         const uint8_t* valid, uint8_t* out_ok,
                         int32_t n_threads) {
  const int64_t h_len = bits / 8;
  void (*hash_fn)(const uint8_t*, size_t, uint8_t*) =
      bits == 256 ? sha2::sha256 : bits == 384 ? sha2::sha384 : sha2::sha512;
  if (n_threads <= 0) {
    n_threads = int32_t(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n) n_threads = int32_t(n > 0 ? n : 1);
  auto worker = [&](int64_t lo, int64_t hi) {
    std::vector<uint8_t> db((size_t)em_stride);
    std::vector<uint8_t> mgf_in((size_t)h_len + 4);
    std::vector<uint8_t> mgf_out(64);
    std::vector<uint8_t> mprime(8 + 64 + (size_t)em_stride);
    std::vector<uint8_t> hprime(64);
    for (int64_t i = lo; i < hi; i++) {
      out_ok[i] = 0;
      if (!valid[i]) continue;
      const uint8_t* row = em + i * em_stride;
      int64_t elen = (em_bits[i] + 7) / 8;
      if (elen > em_stride) continue;
      // dropped high bytes must be zero (EM < 2^emBits)
      bool lead_zero = true;
      for (int64_t j = 0; j < em_stride - elen; j++)
        if (row[j]) { lead_zero = false; break; }
      if (!lead_zero) continue;
      const uint8_t* e = row + (em_stride - elen);
      if (elen < h_len + 2) continue;
      if (e[elen - 1] != 0xBC) continue;
      int64_t db_len = elen - h_len - 1;
      const uint8_t* masked_db = e;
      const uint8_t* h = e + db_len;
      int unused = int(8 * elen - em_bits[i]);
      if (unused && (masked_db[0] >> (8 - unused))) continue;
      // DB = maskedDB XOR MGF1(H, db_len)
      std::memcpy(mgf_in.data(), h, size_t(h_len));
      for (int64_t off = 0, c = 0; off < db_len; off += h_len, c++) {
        mgf_in[size_t(h_len) + 0] = uint8_t(c >> 24);
        mgf_in[size_t(h_len) + 1] = uint8_t(c >> 16);
        mgf_in[size_t(h_len) + 2] = uint8_t(c >> 8);
        mgf_in[size_t(h_len) + 3] = uint8_t(c);
        hash_fn(mgf_in.data(), size_t(h_len) + 4, mgf_out.data());
        int64_t take = db_len - off < h_len ? db_len - off : h_len;
        for (int64_t j = 0; j < take; j++)
          db[size_t(off + j)] = masked_db[off + j] ^ mgf_out[size_t(j)];
      }
      if (unused) db[0] &= uint8_t(0xFF >> unused);
      // DB = 0x00.. ‖ 0x01 ‖ salt
      int64_t sep = -1;
      for (int64_t j = 0; j < db_len; j++) {
        if (db[size_t(j)] == 0x01) { sep = j; break; }
        if (db[size_t(j)] != 0x00) { sep = -2; break; }
      }
      if (sep < 0) continue;
      const uint8_t* salt = db.data() + sep + 1;
      int64_t salt_len = db_len - sep - 1;
      // H' = Hash(0x00*8 ‖ mHash ‖ salt)
      std::memset(mprime.data(), 0, 8);
      std::memcpy(mprime.data() + 8, mhash + i * mhash_stride,
                  size_t(h_len));
      std::memcpy(mprime.data() + 8 + h_len, salt, size_t(salt_len));
      hash_fn(mprime.data(), size_t(8 + h_len + salt_len), hprime.data());
      out_ok[i] = std::memcmp(hprime.data(), h, size_t(h_len)) == 0;
    }
  };
  if (n_threads <= 1) { worker(0, n); return; }
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}


// Pack one verify chunk's device records in a single multithreaded
// pass: out row r = [right-aligned sig bytes (width) ‖ digest (h_len)
// ‖ valid flag ‖ key row]. Replaces the numpy gather → align → where →
// assemble chain (several full-matrix passes, GIL-held) on the batch
// hot path. Rows whose signature length differs from their key's
// expected size, or whose `extra_valid` is 0, pack as zeros with
// flag 0 (the verdict is decided host-side, matching the CPU oracle).
// Rows in [m, pad) are padding: all-zero. idx selects tokens from the
// batch-wide arrays; sig_off is absolute into scratch.
void cap_pack_sig_records(
    const uint8_t* scratch, int64_t scratch_len,
    const int64_t* sig_off, const int64_t* sig_len,
    const uint8_t* digest, int64_t digest_stride,
    const int64_t* idx, const int64_t* expect_size,
    const uint8_t* extra_valid, const uint8_t* key_rows,
    int64_t m, int64_t pad, int64_t width, int64_t h_len,
    uint8_t* out, int32_t n_threads) {
  const int64_t rec_w = width + h_len + 2;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; r++) {
      uint8_t* row = out + r * rec_w;
      if (r >= m) {
        std::memset(row, 0, size_t(rec_w));
        continue;
      }
      int64_t i = idx[r];
      int64_t len = sig_len[i];
      bool valid = extra_valid[r] != 0 && len == expect_size[r] &&
                   len <= width && sig_off[i] >= 0 &&
                   sig_off[i] + len <= scratch_len;
      if (valid) {
        std::memset(row, 0, size_t(width - len));
        std::memcpy(row + width - len, scratch + sig_off[i],
                    size_t(len));
      } else {
        std::memset(row, 0, size_t(width));
      }
      std::memcpy(row + width, digest + i * digest_stride,
                  size_t(h_len));
      row[width + h_len] = valid ? 1 : 0;
      row[width + h_len + 1] = key_rows[r];
    }
  };
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = int32_t(hw ? hw : 4);
  }
  if (n_threads <= 1 || pad < 2048) { worker(0, pad); return; }
  std::vector<std::thread> threads;
  int64_t chunk = (pad + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk, hi = lo + chunk < pad ? lo + chunk : pad;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
