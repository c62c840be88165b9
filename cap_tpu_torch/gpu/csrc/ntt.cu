// The 256-point NTT and inverse NTT over Z_q, q = 8380417 (ML-DSA).
//
// Replaces: cap_tpu/tpu/pallas_ntt.py, _ntt_kernel (forward, 8
// Cooley-Tukey stages) and _intt_kernel (inverse, 8 Gentleman-Sande
// stages and the folded 256^-1 scale), via _call and ntt_fused /
// intt_fused. Rows are [rows, 256] canonical values in [0, q), read as
// uint32; every product is a Montgomery product with R = 2^32 against
// a twiddle in Montgomery form, so the outputs are the plain-domain
// transform, canonical, and equal value for value to the JAX package's
// uint32 limb arithmetic (a Montgomery result in [0, q) is unique).
//
// What bounds it on the card: integer operations, narrowly. A row
// reads and writes 1 KB each (2 KB) and runs 8 x 128 butterflies of
// ~12 integer instructions (a Montgomery product is two wide
// multiply-adds, one multiply and a conditional subtract; add_q and
// sub_q an add and a select each); at 64 integer instructions per SM
// per clock that takes a little longer than moving the bytes. At the
// ML-DSA path's 1,024 to 6,144 rows a launch, a launch's fixed cost
// and latency weigh as much as the work.
//
// Both kernels: one warp a row, kWarps rows a block, the 8 stages in
// registers. Each thread holds 8 coefficients and runs every butterfly
// whose two ends it holds; the row is re-laid out twice through a
// per-warp shared tile between __syncwarp()s, so each stage's pairs
// are in one thread. The three register layouts:
// - t + 32j in register j (bits 7..5 of the index in the register):
//   stages 128, 64, 32, whose twiddles are the same for the whole warp
//   (__constant__); moved 4 bytes a thread, coalesced;
// - (t & 3) + 4j + 32(t >> 2): stages 16, 8, 4;
// - 8t + j: stages 2, 1; moved as two 16-byte words a thread.
// The tile pads each 32 coefficients with 4 words, so every re-layout's
// reads and writes hit 32 distinct banks (the 16-byte accesses each
// bank quad once a quarter warp) and every register's word is at a
// constant offset from the thread's base. A thread's 13 twiddles of
// the five stages of the other two layouts are loaded once, from
// g_zetas or g_neg_zetas. A warp past the last row reads the last row
// and skips the store; no __syncthreads. One stage template runs both,
// given the butterfly:
// - forward (ntt_fwd_kernel, CT): layouts in the order above, the
//   stages 128 down to 1, 16-byte row stores;
// - inverse (intt_kernel, GS): the same layouts and tiles in reverse,
//   16-byte row loads, the stages 1 up to 128, coalesced 4-byte
//   stores. The 256^-1 scale is folded into the last stage (GSScale):
//   its sum is scaled by 256^-1 and its difference by NEG_ZETAS[1] *
//   256^-1 in one product, 128 products a row fewer than a separate
//   scale and the same words (a Montgomery result in [0, q) is
//   unique).
#include <cuda_runtime.h>
#include <stdint.h>

namespace capk {

constexpr uint32_t kQ = 8380417u;
constexpr uint32_t kNQInv = 4236238847u;  // -q^-1 mod 2^32
constexpr int kN = 256;
constexpr int kWarps = 4;                 // rows (warps) a block
constexpr int kTile = kN + kN / 8;        // 4 words of pad a 32

// ZETAS_MONT, NEG_ZETAS_MONT and INV256_MONT of ntt.py, set once by
// cap_ntt_set_tables.
__constant__ uint32_t c_zetas[kN];
__constant__ uint32_t c_neg_zetas[kN];
__constant__ uint32_t c_inv256;
// mont_mul(NEG_ZETAS_MONT[1], INV256_MONT): the last inverse stage's
// twiddle and the scale in one factor
__constant__ uint32_t c_neg1_inv256;
// ZETAS_MONT and NEG_ZETAS_MONT again, in global memory: the kernels'
// per-thread twiddles (32 different words a warp) as coalesced loads.
__device__ uint32_t g_zetas[kN];
__device__ uint32_t g_neg_zetas[kN];

__host__ __device__ __forceinline__ uint32_t mont_mul(uint32_t a,
                                                      uint32_t b) {
  const uint64_t t = uint64_t(a) * b;
  const uint32_t m = uint32_t(t) * kNQInv;
  // t + m*q = 0 mod 2^32; t < q^2 and m*q < 2^55, so the sum fits and
  // its high word is < 2q.
  const uint32_t u = uint32_t((t + uint64_t(m) * kQ) >> 32);
  return u >= kQ ? u - kQ : u;
}

__device__ __forceinline__ uint32_t add_q(uint32_t a, uint32_t b) {
  const uint32_t t = a + b;
  return t >= kQ ? t - kQ : t;
}

__device__ __forceinline__ uint32_t sub_q(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + kQ - b;
}

// The word of coefficient i in a row's shared tile.
__device__ __forceinline__ int pad(int i) { return i + ((i >> 5) << 2); }

// Cooley-Tukey: (a, b) -> (a + z b, a - z b).
struct CT {
  __device__ __forceinline__ void operator()(uint32_t& a, uint32_t& b,
                                             uint32_t z) const {
    const uint32_t t = mont_mul(z, b);
    b = sub_q(a, t);
    a = add_q(a, t);
  }
};

// Gentleman-Sande: (a, b) -> (a + b, z (a - b)).
struct GS {
  __device__ __forceinline__ void operator()(uint32_t& a, uint32_t& b,
                                             uint32_t z) const {
    const uint32_t d = sub_q(a, b);
    a = add_q(a, b);
    b = mont_mul(z, d);
  }
};

// The last inverse stage with the 256^-1 scale folded in:
// (a, b) -> (256^-1 (a + b), z (a - b)), z = NEG_ZETAS[1] 256^-1.
struct GSScale {
  __device__ __forceinline__ void operator()(uint32_t& a, uint32_t& b,
                                             uint32_t z) const {
    const uint32_t d = sub_q(a, b);
    a = mont_mul(c_inv256, add_q(a, b));
    b = mont_mul(z, d);
  }
};

// One stage on the pairs (v[j], v[j + kHalf]) of a thread's 8
// registers: bf(v[j], v[j + kHalf], z(j)). A forward stage s (ln = 128
// >> s) takes ZETAS[2^s + i / 2ln], an inverse one (ln = 2^s, nblk =
// 128 >> s) NEG_ZETAS[2 nblk - 1 - i / 2ln], i the index of v[j].
template <int kHalf, class B, class Z>
__device__ __forceinline__ void stage(uint32_t (&v)[8], B bf, Z z) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (!(j & kHalf)) bf(v[j], v[j + kHalf], z(j));
}

__global__ void __launch_bounds__(32 * kWarps)
    ntt_fwd_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   int rows) {
  __shared__ __align__(16) uint32_t tiles[kWarps][2][kTile];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int k = t >> 2;
  const long row = long(blockIdx.x) * kWarps + w;
  const bool live = row < rows;
  const uint32_t* src = in + (live ? row : rows - 1) * kN + t;
  uint32_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __ldg(src + 32 * j);
  // twiddles of stages 16, 8, 4 (z3, z4, z5) and 2, 1 (z6, z7)
  uint32_t z3, z4[2], z5[4], z6[2], z7[4];
  z3 = __ldg(g_zetas + 8 + k);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    z4[j] = __ldg(g_zetas + 16 + 2 * k + j);
    z6[j] = __ldg(g_zetas + 64 + 2 * t + j);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    z5[j] = __ldg(g_zetas + 32 + 4 * k + j);
    z7[j] = __ldg(g_zetas + 128 + 4 * t + j);
  }
  // i = t + 32j: stages 128, 64, 32 pair registers 4, 2, 1 apart
  stage<4>(v, CT(), [](int) { return c_zetas[1]; });
  stage<2>(v, CT(), [](int j) { return c_zetas[2 + (j >> 2)]; });
  stage<1>(v, CT(), [](int j) { return c_zetas[4 + (j >> 1)]; });
  uint32_t* ta = tiles[w][0];
  uint32_t* tb = tiles[w][1];
#pragma unroll
  for (int j = 0; j < 8; ++j) ta[pad(t + 32 * j)] = v[j];
  __syncwarp();
  const int mid = (t & 3) + 32 * k;          // i = mid + 4j
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = ta[pad(mid + 4 * j)];
  stage<4>(v, CT(), [&](int) { return z3; });
  stage<2>(v, CT(), [&](int j) { return z4[j >> 2]; });
  stage<1>(v, CT(), [&](int j) { return z5[j >> 1]; });
#pragma unroll
  for (int j = 0; j < 8; ++j) tb[pad(mid + 4 * j)] = v[j];
  __syncwarp();
  // i = 8t + j: two 16-byte words
  const uint4 lo = *reinterpret_cast<const uint4*>(tb + pad(8 * t));
  const uint4 hi = *reinterpret_cast<const uint4*>(tb + pad(8 * t + 4));
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  stage<2>(v, CT(), [&](int j) { return z6[j >> 2]; });
  stage<1>(v, CT(), [&](int j) { return z7[j >> 1]; });
  if (live) {
    uint4* dst = reinterpret_cast<uint4*>(out + row * kN + 8 * t);
    dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
    dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    intt_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int rows) {
  __shared__ __align__(16) uint32_t tiles[kWarps][2][kTile];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int k = t >> 2;
  const long row = long(blockIdx.x) * kWarps + w;
  const bool live = row < rows;
  // i = 8t + j: two 16-byte words
  const uint4* src = reinterpret_cast<const uint4*>(
      in + (live ? row : rows - 1) * kN + 8 * t);
  const uint4 lo = __ldg(src);
  const uint4 hi = __ldg(src + 1);
  uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  // twiddles of stages 1, 2 (z0, z1) and 4, 8, 16 (z2, z3, z4)
  uint32_t z0[4], z1[2], z2[4], z3[2], z4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    z0[j] = __ldg(g_neg_zetas + 255 - 4 * t - j);
    z2[j] = __ldg(g_neg_zetas + 63 - 4 * k - j);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    z1[j] = __ldg(g_neg_zetas + 127 - 2 * t - j);
    z3[j] = __ldg(g_neg_zetas + 31 - 2 * k - j);
  }
  z4 = __ldg(g_neg_zetas + 15 - k);
  // i = 8t + j: stages 1, 2 pair registers 1, 2 apart
  stage<1>(v, GS(), [&](int j) { return z0[j >> 1]; });
  stage<2>(v, GS(), [&](int j) { return z1[j >> 2]; });
  uint32_t* ta = tiles[w][0];
  uint32_t* tb = tiles[w][1];
  *reinterpret_cast<uint4*>(ta + pad(8 * t)) =
      make_uint4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<uint4*>(ta + pad(8 * t + 4)) =
      make_uint4(v[4], v[5], v[6], v[7]);
  __syncwarp();
  const int mid = (t & 3) + 32 * k;          // i = mid + 4j
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = ta[pad(mid + 4 * j)];
  stage<1>(v, GS(), [&](int j) { return z2[j >> 1]; });
  stage<2>(v, GS(), [&](int j) { return z3[j >> 2]; });
  stage<4>(v, GS(), [&](int) { return z4; });
#pragma unroll
  for (int j = 0; j < 8; ++j) tb[pad(mid + 4 * j)] = v[j];
  __syncwarp();
  // i = t + 32j: stages 32, 64, 128 pair registers 1, 2, 4 apart, the
  // last with the scale
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = tb[pad(t + 32 * j)];
  stage<1>(v, GS(), [](int j) { return c_neg_zetas[7 - (j >> 1)]; });
  stage<2>(v, GS(), [](int j) { return c_neg_zetas[3 - (j >> 2)]; });
  stage<4>(v, GSScale(), [](int) { return c_neg1_inv256; });
  if (live) {
    uint32_t* dst = out + row * kN + t;
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[32 * j] = v[j];
  }
}

#ifndef CAPK_NO_LAUNCH
int launch(bool inverse, const void* in, void* out, int rows, void* stream) {
  if (rows <= 0) return int(cudaErrorInvalidValue);
  // 16-byte row loads (inverse) or stores (forward)
  if (reinterpret_cast<uintptr_t>(inverse ? in : out) % 16)
    return int(cudaErrorMisalignedAddress);
  const int grid = (rows + kWarps - 1) / kWarps;
  const auto kernel = inverse ? intt_kernel : ntt_fwd_kernel;
  kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows);
  return int(cudaGetLastError());
}
#endif

}  // namespace capk

#ifndef CAPK_NO_LAUNCH
// The twiddle tables (256 + 256 words), 256^-1 R mod q and its product
// with NEG_ZETAS_MONT[1], copied to __constant__ (and both twiddle
// tables to g_zetas and g_neg_zetas) once per process before the first
// launch.
extern "C" int cap_ntt_set_tables(const void* zetas, const void* neg_zetas,
                                  unsigned inv256) {
  cudaError_t e = cudaMemcpyToSymbol(capk::c_zetas, zetas,
                                     sizeof(uint32_t) * capk::kN);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(capk::c_neg_zetas, neg_zetas,
                           sizeof(uint32_t) * capk::kN);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(capk::c_inv256, &inv256, sizeof(uint32_t));
  const uint32_t neg1_inv256 =
      capk::mont_mul(static_cast<const uint32_t*>(neg_zetas)[1], inv256);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(capk::c_neg1_inv256, &neg1_inv256,
                           sizeof(uint32_t));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(capk::g_zetas, zetas,
                           sizeof(uint32_t) * capk::kN);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(capk::g_neg_zetas, neg_zetas,
                           sizeof(uint32_t) * capk::kN);
  return int(e);
}

// in, out: [rows, 256] uint32 (int32 tensors), contiguous, the
// 16-byte-word side (out forward, in inverse) 16-byte aligned.
extern "C" int cap_ntt(const void* in, void* out, int rows, void* stream) {
  return capk::launch(false, in, out, rows, stream);
}

extern "C" int cap_intt(const void* in, void* out, int rows, void* stream) {
  return capk::launch(true, in, out, rows, stream);
}
#endif
