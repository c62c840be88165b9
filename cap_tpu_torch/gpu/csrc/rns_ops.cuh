// RNS field arithmetic shared by the REDC and mixed-add kernels.
//
// One source for the Barrett fix, both base extensions, the REDC, the
// lazy add/sub and the packed table-word decode, the way the JAX
// package's pallas_redc.make_rns_ops keeps its REDC and mixed-add
// kernels from drifting apart. Every function works on ONE lane held
// by one thread; residues are int32 in registers (or local memory
// where the compiler spills them).
//
// Exactness, as in the JAX package (cap_tpu/tpu/pallas_redc.py):
// - fix(): a float32 quotient guess within ±1 of floor(v/m) for
//   0 <= v < 2^31, one correction each way. The multiply is
//   __fmul_rn and the α sum __fmul_rn/__fadd_rn (and the build passes
//   -fmad=false): a fused multiply-add would change the roundings the
//   bound counts on.
// - extend(): the 13-bit operands split into 7-bit halves and the
//   products sum as the hh/ll/mid integer dot products of
//   _extend_in_kernel; each sum is below 2I·127² < 2^20, and the
//   recombination fix(fix(hh)·c14 + mid·128 + ll) stays below 2^31.
#pragma once

#include <cstdint>

namespace capk {

constexpr int kMaxC = 32;      // c·p rows per context
constexpr int kDegMaxC = 20;   // same-x probe candidates (h < 20p)
constexpr int kDegCh = 2;      // probe channels

// Word offsets into the per-context constant buffer built by
// cap_tpu_torch/gpu/cuda_redc.py:kernel_consts (same order).
template <int IA, int IB>
struct Layout {
  static constexpr int mA = 0;
  static constexpr int mB = mA + IA;
  static constexpr int invA = mB + IB;      // float32 bits
  static constexpr int invB = invA + IA;    // float32 bits
  static constexpr int sigc = invB + IB;
  static constexpr int pB = sigc + IA;
  static constexpr int amodb = pB + IB;
  static constexpr int bmoda = amodb + IB;
  static constexpr int invab = bmoda + IA;
  static constexpr int invmib = invab + IB;
  static constexpr int c14a = invmib + IB;
  static constexpr int c14b = c14a + IA;
  static constexpr int oneA = c14b + IB;
  static constexpr int oneB = oneA + IA;
  static constexpr int whAB = oneB + IB;        // [IB][IA] 7-bit hi
  static constexpr int wlAB = whAB + IB * IA;   // [IB][IA] 7-bit lo
  static constexpr int whBA = wlAB + IB * IA;   // [IA][IB]
  static constexpr int wlBA = whBA + IA * IB;   // [IA][IB]
  static constexpr int cpA = wlBA + IA * IB;    // [kMaxC][IA]
  static constexpr int cpB = cpA + kMaxC * IA;  // [kMaxC][IB]
  static constexpr int words = cpB + kMaxC * IB;
};

template <int IA, int IB>
struct Pair {
  int a[IA];
  int b[IB];
};

// Copy the constant buffer into shared memory (every thread of the
// block helps, then all wait).
__device__ __forceinline__ void load_consts(int* dst, const int* src,
                                            int words) {
  for (int w = threadIdx.x; w < words; w += blockDim.x) dst[w] = src[w];
  __syncthreads();
}

__device__ __forceinline__ float fbits(const int* k, int off) {
  return __int_as_float(k[off]);
}

// Exact v mod m for 0 <= v < 2^31.
__device__ __forceinline__ int fix(int v, int m, float inv) {
  int q = __float2int_rz(floorf(__fmul_rn(__int2float_rn(v), inv)));
  int r = v - q * m;
  r = r < 0 ? r + m : r;
  return r >= m ? r - m : r;
}

// Base extension of sigma rows [IS] -> [ID] (rns._extend).
template <int IS, int ID>
__device__ __forceinline__ void extend(const int* k, const int (&sig)[IS],
                                       int inv_src, int m_dst, int inv_dst,
                                       int wh, int wl, int spmd, int c14,
                                       float offset, int (&out)[ID]) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < IS; ++i)
    acc = __fadd_rn(acc, __fmul_rn(__int2float_rn(sig[i]),
                                   fbits(k, inv_src + i)));
  const int alpha = __float2int_rz(floorf(__fadd_rn(acc, offset)));
#pragma unroll
  for (int j = 0; j < ID; ++j) {
    int hh = 0, ll = 0, mid = 0;
#pragma unroll
    for (int i = 0; i < IS; ++i) {
      const int hi = sig[i] >> 7, lo = sig[i] & 127;
      const int h = k[wh + j * IS + i], l = k[wl + j * IS + i];
      hh += h * hi;
      ll += l * lo;
      mid += l * hi + h * lo;
    }
    const int m = k[m_dst + j];
    const float inv = fbits(k, inv_dst + j);
    const int comb = fix(fix(hh, m, inv) * k[c14 + j] + mid * 128 + ll, m,
                         inv);
    const int aadj = alpha < 0 ? alpha + m : alpha;
    const int corr = fix(aadj * k[spmd + j], m, inv);
    const int r = comb - corr + m;
    out[j] = r >= m ? r - m : r;
  }
}

// RNS Montgomery reduction t = x·A^-1 mod p (rns._redc).
template <int IA, int IB>
__device__ __forceinline__ void redc(const int* k, const int (&xA)[IA],
                                     const int (&xB)[IB], int (&tA)[IA],
                                     int (&tB)[IB]) {
  using L = Layout<IA, IB>;
  int sig[IA];
#pragma unroll
  for (int i = 0; i < IA; ++i)
    sig[i] = fix(xA[i] * k[L::sigc + i], k[L::mA + i], fbits(k, L::invA + i));
  int q[IB];
  extend<IA, IB>(k, sig, L::invA, L::mB, L::invB, L::whAB, L::wlAB,
                 L::amodb, L::c14b, -1e-4f, q);
  int sig2[IB];
#pragma unroll
  for (int j = 0; j < IB; ++j) {
    const int m = k[L::mB + j];
    const float inv = fbits(k, L::invB + j);
    // q·p + x < 2^28: one fix covers the merged product-and-add
    int t = fix(xB[j] + q[j] * k[L::pB + j], m, inv);
    t = fix(t * k[L::invab + j], m, inv);
    tB[j] = t;
    sig2[j] = fix(t * k[L::invmib + j], m, inv);
  }
  extend<IB, IA>(k, sig2, L::invB, L::mA, L::invA, L::whBA, L::wlBA,
                 L::bmoda, L::c14a, static_cast<float>(0.5 - 1e-4), tA);
}

// (a·b)·A^-1 mod p on digit-bounded pairs (ec_rns.rmul). Kept out of
// line: a kernel that runs many multiplies (the mixed add runs 11)
// then carries one copy of the REDC instead of eleven — a fully
// inlined mixed add is ~10x the code, takes minutes in ptxas and
// thrashes the instruction cache.
template <int IA, int IB>
__device__ __noinline__ void rmul(const int* k, const Pair<IA, IB>& x,
                                  const Pair<IA, IB>& y,
                                  Pair<IA, IB>& out) {
  using L = Layout<IA, IB>;
  int pa[IA], pb[IB];
#pragma unroll
  for (int i = 0; i < IA; ++i)
    pa[i] = fix(x.a[i] * y.a[i], k[L::mA + i], fbits(k, L::invA + i));
#pragma unroll
  for (int j = 0; j < IB; ++j)
    pb[j] = fix(x.b[j] * y.b[j], k[L::mB + j], fbits(k, L::invB + j));
  redc<IA, IB>(k, pa, pb, out.a, out.b);
}

// a + b, lazy: digits grow, no fix (ec_rns.radd).
template <int IA, int IB>
__device__ __forceinline__ Pair<IA, IB> radd(const Pair<IA, IB>& x,
                                             const Pair<IA, IB>& y) {
  Pair<IA, IB> o;
#pragma unroll
  for (int i = 0; i < IA; ++i) o.a[i] = x.a[i] + y.a[i];
#pragma unroll
  for (int j = 0; j < IB; ++j) o.b[j] = x.b[j] + y.b[j];
  return o;
}

// a + cmul·p − b + guard·m, lazy (ec_rns.rsub: cmul·p dominates b's
// value bound, guard·m its digit bound).
template <int IA, int IB>
__device__ __forceinline__ Pair<IA, IB> rsub(const int* k,
                                             const Pair<IA, IB>& x,
                                             const Pair<IA, IB>& y,
                                             int cmul, int guard) {
  using L = Layout<IA, IB>;
  Pair<IA, IB> o;
#pragma unroll
  for (int i = 0; i < IA; ++i)
    o.a[i] = x.a[i] + k[L::cpA + cmul * IA + i] - y.a[i] +
             guard * k[L::mA + i];
#pragma unroll
  for (int j = 0; j < IB; ++j)
    o.b[j] = x.b[j] + k[L::cpB + cmul * IB + j] - y.b[j] +
             guard * k[L::mB + j];
  return o;
}

// Canonicalize the digits of a lazily grown pair (ec_rns.rfix).
template <int IA, int IB>
__device__ __forceinline__ Pair<IA, IB> rfix(const int* k,
                                             const Pair<IA, IB>& x) {
  using L = Layout<IA, IB>;
  Pair<IA, IB> o;
#pragma unroll
  for (int i = 0; i < IA; ++i)
    o.a[i] = fix(x.a[i], k[L::mA + i], fbits(k, L::invA + i));
#pragma unroll
  for (int j = 0; j < IB; ++j)
    o.b[j] = fix(x.b[j], k[L::mB + j], fbits(k, L::invB + j));
  return o;
}

// Decode one lane of packed table words: A channel j in the low 16
// bits of word j, B channel j in the high 16 (ec_rns._pack_residue_rows).
template <int IA, int IB>
__device__ __forceinline__ void unpack_words(const int* __restrict__ words,
                                             int n, int lane,
                                             Pair<IA, IB>& out) {
#pragma unroll
  for (int i = 0; i < IA; ++i) out.a[i] = words[i * n + lane] & 0xFFFF;
#pragma unroll
  for (int j = 0; j < IB; ++j) out.b[j] = words[j * n + lane] >> 16;
}

}  // namespace capk
