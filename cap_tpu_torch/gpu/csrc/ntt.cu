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
// per clock that takes a little longer than moving the bytes.
//
// Design: ROWS rows per block, one warp-multiple of 128 threads per
// row; a row's 256 coefficients sit in shared memory and each thread
// does one butterfly per stage, __syncthreads() between stages, so
// device memory is touched once on the way in and once on the way
// out. The twiddles live in __constant__ and are staged into shared
// memory per block: from the sixth stage on, the threads of one warp
// index different twiddles, which the constant cache would serialize.
#include <cuda_runtime.h>
#include <stdint.h>

namespace capk {

constexpr uint32_t kQ = 8380417u;
constexpr uint32_t kNQInv = 4236238847u;  // -q^-1 mod 2^32
constexpr int kN = 256;
constexpr int kRows = 4;                  // rows per block

// ZETAS_MONT, NEG_ZETAS_MONT and INV256_MONT of ntt.py, set once by
// cap_ntt_set_tables.
__constant__ uint32_t c_zetas[kN];
__constant__ uint32_t c_neg_zetas[kN];
__constant__ uint32_t c_inv256;

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

template <bool kInverse>
__global__ void __launch_bounds__(128 * kRows)
    ntt_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
               int rows) {
  __shared__ uint32_t zs[kN];
  __shared__ uint32_t xs[kRows][kN];
  const int t = threadIdx.x;                     // 0..127: the butterfly
  const int r = threadIdx.y;
  const long row = long(blockIdx.x) * kRows + r;
  const bool live = row < rows;
  if (r == 0) {
    zs[t] = kInverse ? c_neg_zetas[t] : c_zetas[t];
    zs[t + 128] = kInverse ? c_neg_zetas[t + 128] : c_zetas[t + 128];
  }
  uint32_t* x = xs[r];
  if (live) {
    x[t] = in[row * kN + t];
    x[t + 128] = in[row * kN + t + 128];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int ln = kInverse ? (1 << s) : (128 >> s);
    const int nblk = kN / (2 * ln);
    const int blk = t / ln;
    const int lo = blk * 2 * ln + t % ln;
    const uint32_t a = x[lo];
    const uint32_t b = x[lo + ln];
    if (kInverse) {
      // ntt.intt: z = NEG_ZETAS_MONT[nblk:2 nblk][::-1]
      const uint32_t z = zs[2 * nblk - 1 - blk];
      x[lo] = add_q(a, b);
      x[lo + ln] = mont_mul(z, sub_q(a, b));
    } else {
      const uint32_t tt = mont_mul(zs[nblk + blk], b);
      x[lo] = add_q(a, tt);
      x[lo + ln] = sub_q(a, tt);
    }
    __syncthreads();
  }
  if (live) {
    if (kInverse) {
      out[row * kN + t] = mont_mul(c_inv256, x[t]);
      out[row * kN + t + 128] = mont_mul(c_inv256, x[t + 128]);
    } else {
      out[row * kN + t] = x[t];
      out[row * kN + t + 128] = x[t + 128];
    }
  }
}

template <bool kInverse>
int launch(const void* in, void* out, int rows, void* stream) {
  if (rows <= 0) return int(cudaErrorInvalidValue);
  const dim3 block(128, kRows);
  const int grid = (rows + kRows - 1) / kRows;
  ntt_kernel<kInverse><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows);
  return int(cudaGetLastError());
}

}  // namespace capk

// The twiddle tables (256 + 256 words) and 256^-1 R mod q, copied to
// __constant__ once per process before the first launch.
extern "C" int cap_ntt_set_tables(const void* zetas, const void* neg_zetas,
                                  unsigned inv256) {
  cudaError_t e = cudaMemcpyToSymbol(capk::c_zetas, zetas,
                                     sizeof(uint32_t) * capk::kN);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(capk::c_neg_zetas, neg_zetas,
                           sizeof(uint32_t) * capk::kN);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(capk::c_inv256, &inv256, sizeof(uint32_t));
  return int(e);
}

// in, out: [rows, 256] uint32 (int32 tensors), contiguous.
extern "C" int cap_ntt(const void* in, void* out, int rows, void* stream) {
  return capk::launch<false>(in, out, rows, stream);
}

extern "C" int cap_intt(const void* in, void* out, int rows, void* stream) {
  return capk::launch<true>(in, out, rows, stream);
}
