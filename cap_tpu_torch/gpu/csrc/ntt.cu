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
// Forward (ntt_fwd_kernel): one warp a row, the 8 stages in registers.
// Each thread holds 8 coefficients and runs every butterfly whose two
// ends it holds; the row is re-laid out twice through a per-warp
// shared tile between __syncwarp()s, so each stage's pairs are in one
// thread:
// - stages 128, 64, 32: coefficient t + 32j in register j (bits 7..5
//   of the index in the register), loaded 4 bytes a thread, coalesced;
//   their twiddles are the same for the whole warp (__constant__);
// - stages 16, 8, 4: (t & 3) + 4j + 32(t >> 2) in register j;
// - stages 2, 1: 8t + j in register j, read as two 16-byte words and
//   stored to device memory the same way.
// The tile pads each 32 coefficients with 4 words, so every re-layout's
// reads and writes hit 32 distinct banks and every register's word is
// at a constant offset from the thread's base. A thread's 13 twiddles
// of the last five stages are loaded once, from g_zetas. A warp past
// the last row reads the last row and skips the store; no
// __syncthreads.
//
// Inverse (intt_kernel): kRows rows per block, 128 threads per row; a
// row's 256 coefficients sit in shared memory and each thread does one
// butterfly per stage, __syncthreads() between stages, so device
// memory is touched once on the way in and once on the way out. The
// twiddles live in __constant__ and are staged into shared memory per
// block: from the sixth stage on, the threads of one warp index
// different twiddles, which the constant cache would serialize.
#include <cuda_runtime.h>
#include <stdint.h>

namespace capk {

constexpr uint32_t kQ = 8380417u;
constexpr uint32_t kNQInv = 4236238847u;  // -q^-1 mod 2^32
constexpr int kN = 256;
constexpr int kRows = 4;                  // rows per block, inverse

// ZETAS_MONT, NEG_ZETAS_MONT and INV256_MONT of ntt.py, set once by
// cap_ntt_set_tables.
__constant__ uint32_t c_zetas[kN];
__constant__ uint32_t c_neg_zetas[kN];
__constant__ uint32_t c_inv256;
// ZETAS_MONT again, in global memory: the forward kernel's per-thread
// twiddles (32 different words a warp) as coalesced loads.
__device__ uint32_t g_zetas[kN];

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
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

__global__ void __launch_bounds__(128 * kRows)
    intt_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int rows) {
  __shared__ uint32_t zs[kN];
  __shared__ uint32_t xs[kRows][kN];
  const int t = threadIdx.x;                     // 0..127: the butterfly
  const int r = threadIdx.y;
  const long row = long(blockIdx.x) * kRows + r;
  const bool live = row < rows;
  if (r == 0) {
    zs[t] = c_neg_zetas[t];
    zs[t + 128] = c_neg_zetas[t + 128];
  }
  uint32_t* x = xs[r];
  if (live) {
    x[t] = in[row * kN + t];
    x[t + 128] = in[row * kN + t + 128];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int ln = 1 << s;
    const int nblk = kN / (2 * ln);
    const int blk = t / ln;
    const int lo = blk * 2 * ln + t % ln;
    const uint32_t a = x[lo];
    const uint32_t b = x[lo + ln];
    // ntt.intt: z = NEG_ZETAS_MONT[nblk:2 nblk][::-1]
    const uint32_t z = zs[2 * nblk - 1 - blk];
    x[lo] = add_q(a, b);
    x[lo + ln] = mont_mul(z, sub_q(a, b));
    __syncthreads();
  }
  if (live) {
    out[row * kN + t] = mont_mul(c_inv256, x[t]);
    out[row * kN + t + 128] = mont_mul(c_inv256, x[t + 128]);
  }
}

constexpr int kFwdWarps = 4;              // rows a block, forward

constexpr int kTile = kN + kN / 8;       // 4 words of pad a 32

// The word of coefficient i in a row's shared tile.
__device__ __forceinline__ int pad(int i) { return i + ((i >> 5) << 2); }

__device__ __forceinline__ void butterfly(uint32_t& a, uint32_t& b,
                                          uint32_t z) {
  const uint32_t t = mont_mul(z, b);
  b = sub_q(a, t);
  a = add_q(a, t);
}

// Stage s (ln = 128 >> s, twiddle ZETAS[2^s + i / 2ln]) on the pairs
// (v[j], v[j + kHalf]) of a thread's 8 registers; z(j) gives the
// twiddle.
template <int kHalf, class Z>
__device__ __forceinline__ void stage(uint32_t (&v)[8], Z z) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (!(j & kHalf)) butterfly(v[j], v[j + kHalf], z(j));
}

__global__ void __launch_bounds__(32 * kFwdWarps)
    ntt_fwd_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   int rows) {
  __shared__ __align__(16) uint32_t tiles[kFwdWarps][2][kTile];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int k = t >> 2;
  const long row = long(blockIdx.x) * kFwdWarps + w;
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
  stage<4>(v, [](int) { return c_zetas[1]; });
  stage<2>(v, [](int j) { return c_zetas[2 + (j >> 2)]; });
  stage<1>(v, [](int j) { return c_zetas[4 + (j >> 1)]; });
  uint32_t* ta = tiles[w][0];
  uint32_t* tb = tiles[w][1];
#pragma unroll
  for (int j = 0; j < 8; ++j) ta[pad(t + 32 * j)] = v[j];
  __syncwarp();
  const int mid = (t & 3) + 32 * k;          // i = mid + 4j
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = ta[pad(mid + 4 * j)];
  stage<4>(v, [&](int) { return z3; });
  stage<2>(v, [&](int j) { return z4[j >> 2]; });
  stage<1>(v, [&](int j) { return z5[j >> 1]; });
#pragma unroll
  for (int j = 0; j < 8; ++j) tb[pad(mid + 4 * j)] = v[j];
  __syncwarp();
  // i = 8t + j: two 16-byte words
  const uint4 lo = *reinterpret_cast<const uint4*>(tb + pad(8 * t));
  const uint4 hi = *reinterpret_cast<const uint4*>(tb + pad(8 * t + 4));
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  stage<2>(v, [&](int j) { return z6[j >> 2]; });
  stage<1>(v, [&](int j) { return z7[j >> 1]; });
  if (live) {
    uint4* dst = reinterpret_cast<uint4*>(out + row * kN + 8 * t);
    dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
    dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
  }
}

#ifndef CAPK_NO_LAUNCH
int launch_intt(const void* in, void* out, int rows, void* stream) {
  if (rows <= 0) return int(cudaErrorInvalidValue);
  const dim3 block(128, kRows);
  const int grid = (rows + kRows - 1) / kRows;
  intt_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows);
  return int(cudaGetLastError());
}

int launch_fwd(const void* in, void* out, int rows, void* stream) {
  if (rows <= 0) return int(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % 16)    // 16-byte row stores
    return int(cudaErrorMisalignedAddress);
  const int grid = (rows + kFwdWarps - 1) / kFwdWarps;
  ntt_fwd_kernel<<<grid, 32 * kFwdWarps, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows);
  return int(cudaGetLastError());
}
#endif

}  // namespace capk

#ifndef CAPK_NO_LAUNCH
// The twiddle tables (256 + 256 words) and 256^-1 R mod q, copied to
// __constant__ (and the forward twiddles to g_zetas) once per process
// before the first launch.
extern "C" int cap_ntt_set_tables(const void* zetas, const void* neg_zetas,
                                  unsigned inv256) {
  cudaError_t e = cudaMemcpyToSymbol(capk::c_zetas, zetas,
                                     sizeof(uint32_t) * capk::kN);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(capk::c_neg_zetas, neg_zetas,
                           sizeof(uint32_t) * capk::kN);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(capk::c_inv256, &inv256, sizeof(uint32_t));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(capk::g_zetas, zetas,
                           sizeof(uint32_t) * capk::kN);
  return int(e);
}

// in, out: [rows, 256] uint32 (int32 tensors), contiguous.
extern "C" int cap_ntt(const void* in, void* out, int rows, void* stream) {
  return capk::launch_fwd(in, out, rows, stream);
}

extern "C" int cap_intt(const void* in, void* out, int rows, void* stream) {
  return capk::launch_intt(in, out, rows, stream);
}
#endif
