// Integer RNS arithmetic for every RNS kernel (redc.cu, madd.cu,
// ladder.cu, edw.cu), with one lane spread over a group of T threads.
//
// The residues of one lane (I_A + I_B channels a value) are cut into T
// contiguous shares: thread t of the group holds A channels
// [t·CA, t·CA + CA) and B channels [t·CB, t·CB + CB) of every value, in
// registers. Within a warp the lane runs fastest (thread k of a warp is
// lane k mod 32/T, share k div 32/T), so a load of an [I, N] plane by
// one share of the warp's lanes stays coalesced. The group meets only
// in the base extensions: each thread writes its σ digits (and their
// float α terms) to the lane's row in shared memory, the warp syncs,
// and each thread reads the whole row by 16-byte loads to form its own
// output channels. The same-x probe runs on share 0, which holds
// channels 0 and 1, and is broadcast by a shuffle.
//
// Exactness (the residues equal, word for word, those of a float32
// quotient guess with 7-bit split extension weights, the arithmetic of
// the plain version rns._redc and of the JAX package's kernels):
// - bred(): a Barrett reduction on the integer pipes, q = umulhi(v, μ)
//   with μ = ⌊2^32/m⌋. For 0 <= v < 2^32 and m < 2^13, q is floor(v/m)
//   or one less, so one conditional subtract gives v mod m exactly, the
//   residue a float guess with its ±1 correction gives, with no
//   conversion.
// - extend_sum(): whole 13-bit weights (A/a_i mod b_j), one int32
//   multiply-add each: every modulus and weight is below 4,900, so
//   Σ σ_i·w_ij over 45 channels stays below 1.1·10^9, and the α
//   correction α·((−A) mod b_j) < 2.4·10^7 is folded into the same sum,
//   reduced once: below 2^31 throughout.
// - α is the float32 sum of the products σ_i·(1/m_i) (__fmul_rn) in
//   channel order (__fadd_rn), built with -fmad=false, then
//   floor(sum + offset). Each thread forms the products of its own
//   digits once; every thread sums the whole row.
#pragma once

#include <cstdint>

namespace capk {
namespace ri {

constexpr int kThreads = 128;  // threads a block
constexpr int kProbeC = 20;    // same-x probe candidates (h < 20p)

// Threads a lane by shape, the fastest of 2, 4 and 8 on the H100 for
// the ES mixed adds (ladder_bench.py, PERF.md): 8 at 23+23 and 34+33,
// 4 at 45+45. redc and edw take the same (redc<45,45> measured 1.5x
// faster at 4 than at 8).
template <int IA, int IB>
constexpr int kGroup = IA + IB > 80 ? 4 : 8;

constexpr int round_up(int v, int k) { return (v + k - 1) / k * k; }

// Word offsets into the constant buffer built by
// cap_tpu_torch/gpu/cuda_madd.py:madd_consts (same order and padding).
// Per-channel vectors are padded to a multiple of 8 channels (every
// group size's shares fit), weight rows to a multiple of 4 (16-byte
// loads); padding channels hold a harmless modulus and zero constants.
template <int IA, int IB>
struct KLayout {
  static constexpr int PA = round_up(IA, 8), PB = round_up(IB, 8);
  static constexpr int SA = round_up(IA, 4), SB = round_up(IB, 4);
  static constexpr int mA = 0;
  static constexpr int muA = mA + PA;
  static constexpr int invA = muA + PA;    // float32 bits of 1/a_i
  static constexpr int sigc = invA + PA;
  static constexpr int negBA = sigc + PA;  // (−B) mod a_i
  static constexpr int oneA = negBA + PA;
  static constexpr int k16A = oneA + PA;   // rsub constants: 16p + m,
  static constexpr int k4A = k16A + PA;    // 4p + m,
  static constexpr int k8A = k4A + PA;     // 8p + 2m
  static constexpr int mB = k8A + PA;
  static constexpr int muB = mB + PB;
  static constexpr int invB = muB + PB;
  static constexpr int pB = invB + PB;
  static constexpr int invab = pB + PB;    // A^-1 mod b_j
  static constexpr int invmib = invab + PB;
  static constexpr int negAB = invmib + PB;  // (−A) mod b_j
  static constexpr int oneB = negAB + PB;
  static constexpr int k16B = oneB + PB;
  static constexpr int k4B = k16B + PB;
  static constexpr int k8B = k4B + PB;
  static constexpr int wAB = k8B + PB;         // [PB][SA]: A/a_i mod b_j
  static constexpr int wBA = wAB + PB * SA;    // [PA][SB]: B/b_j mod a_i
  static constexpr int probe = wBA + PA * SB;  // [kProbeC][2]: c·p on a_0, a_1
  static constexpr int words = probe + 2 * kProbeC;
};

// The shares of a group of T threads and its block geometry.
template <int IA, int IB, int T>
struct Group {
  static_assert(T == 2 || T == 4 || T == 8, "group of 2, 4 or 8 threads");
  static constexpr int CA = (IA + T - 1) / T;
  static constexpr int CB = (IB + T - 1) / T;
  static constexpr int kWarpLanes = 32 / T;
  static constexpr int kLanes = kThreads / T;  // lanes a block
  // exchange row stride: 16-byte aligned, an odd number of 16-byte
  // words, so the 8 rows a quarter warp reads fall in distinct banks
  static constexpr int S0 = round_up(IA > IB ? IA : IB, 4);
  static constexpr int S = (S0 / 4) % 2 ? S0 : S0 + 4;
  static_assert(T * CA <= KLayout<IA, IB>::PA, "A shares exceed padding");
  static_assert(T * CB <= KLayout<IA, IB>::PB, "B shares exceed padding");
  static_assert(CA >= 2, "share 0 must hold both probe channels");
};

template <int CA, int CB>
struct Share {
  int a[CA];
  int b[CB];
};

// What a thread knows of its place: its share t, its lane, the lane's
// exchange rows in shared memory, and the block's constants.
struct Ctx {
  const int* k;  // constants (KLayout) in shared memory
  int* xs;       // the lane's σ row
  float* xf;     // the lane's α-term row
  int t;         // share index within the group
  int src;       // warp lane of the group's share 0 (for the shuffle)
};

// Copy the constants into shared memory and zero the exchange rows
// (their padding words are read, times zero weights); then all wait.
__device__ __forceinline__ void load_block(int* k, const int* src, int words,
                                           int* xs, float* xf, int rows) {
  for (int w = threadIdx.x; w < words; w += blockDim.x) k[w] = src[w];
  for (int w = threadIdx.x; w < rows; w += blockDim.x) {
    xs[w] = 0;
    xf[w] = 0.f;
  }
  __syncthreads();
}

template <int IA, int IB, int T>
__device__ __forceinline__ Ctx make_ctx(const int* k, int* xs, float* xf,
                                        int& lane) {
  using G = Group<IA, IB, T>;
  const int w = threadIdx.x / 32, kk = threadIdx.x % 32;
  const int lw = kk % G::kWarpLanes;
  const int row = w * G::kWarpLanes + lw;
  lane = blockIdx.x * G::kLanes + row;
  return Ctx{k, xs + row * G::S, xf + row * G::S, kk / G::kWarpLanes, lw};
}

// Loads and stores that the compiler may neither merge with another
// access nor move across one: the epilogue's re-reads of inputs that
// were already read once, and the ladder's stash of its state.
__device__ __forceinline__ int ld_cg(const int* p) {
#ifdef __CUDA_ARCH__
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
#else
  return *static_cast<const volatile int*>(p);
#endif
}

__device__ __forceinline__ void st_cg(int* p, int v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.global.cg.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
#else
  *static_cast<volatile int*>(p) = v;
#endif
}

// v mod m for 0 <= v < 2^31 (μ = ⌊2^32/m⌋).
__device__ __forceinline__ int bred(int v, int m, int mu) {
  const int q = static_cast<int>(
      __umulhi(static_cast<unsigned>(v), static_cast<unsigned>(mu)));
  const int r = v - q * m;
  return r >= m ? r - m : r;
}

// One side of a base extension: the σ row of IS source digits (in the
// lane's exchange rows) times the J weight rows w[j·ws + i] of this
// thread's output channels, into acc; returns
// α = floor(Σ_i σ_i·(1/m_i) + offset) in channel order.
template <int IS, int J>
__device__ __forceinline__ int extend_sum(const Ctx& g, const int* w, int ws,
                                          float offset, int (&acc)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0;
  float a = 0.f;
  constexpr int kFull = IS / 4;
#pragma unroll 2
  for (int q = 0; q < kFull; ++q) {
    const int4 s = *reinterpret_cast<const int4*>(g.xs + 4 * q);
    const float4 f = *reinterpret_cast<const float4*>(g.xf + 4 * q);
    a = __fadd_rn(a, f.x);
    a = __fadd_rn(a, f.y);
    a = __fadd_rn(a, f.z);
    a = __fadd_rn(a, f.w);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int4 x = *reinterpret_cast<const int4*>(w + j * ws + 4 * q);
      acc[j] += s.x * x.x + s.y * x.y + s.z * x.z + s.w * x.w;
    }
  }
  if (IS % 4) {
    // the last partial group: padding σ words meet zero weights
    const int4 s = *reinterpret_cast<const int4*>(g.xs + 4 * kFull);
    const float4 f = *reinterpret_cast<const float4*>(g.xf + 4 * kFull);
    a = __fadd_rn(a, f.x);
    if (IS % 4 > 1) a = __fadd_rn(a, f.y);
    if (IS % 4 > 2) a = __fadd_rn(a, f.z);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int4 x = *reinterpret_cast<const int4*>(w + j * ws + 4 * kFull);
      acc[j] += s.x * x.x + s.y * x.y + s.z * x.z + s.w * x.w;
    }
  }
  return __float2int_rd(__fadd_rn(a, offset));
}

// Publish this thread's σ digits (channels c0 + i < I) and their α
// terms σ·(1/m) to the lane's rows, between two warp barriers: the
// first lets the previous extension's readers finish.
template <int I, int C>
__device__ __forceinline__ void publish(const Ctx& g, const int (&sig)[C],
                                        int c0, int inv) {
  __syncwarp();
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = c0 + i;
    if (c < I) {
      g.xs[c] = sig[i];
      g.xf[c] = __fmul_rn(__int2float_rn(sig[i]),
                          __int_as_float(g.k[inv + c]));
    }
  }
  __syncwarp();
}

// The input of a REDC, read digit by digit where the reduction takes
// it (so a product holds no register before its turn): Prod, the
// channel products of two shares (rmul); Digits, reduced digits held
// as a share (the REDC kernel).
template <int CA, int CB>
struct Prod {
  const Share<CA, CB>& x;
  const Share<CA, CB>& y;
  __device__ __forceinline__ int a(int i, int m, int mu) const {
    return bred(x.a[i] * y.a[i], m, mu);
  }
  __device__ __forceinline__ int b(int j, int m, int mu) const {
    return bred(x.b[j] * y.b[j], m, mu);
  }
};

template <int CA, int CB>
struct Digits {
  const Share<CA, CB>& x;
  __device__ __forceinline__ int a(int i, int, int) const { return x.a[i]; }
  __device__ __forceinline__ int b(int j, int, int) const { return x.b[j]; }
};

// The RNS Montgomery reduction t = x·A^-1 mod p (rns._redc) of x < A·p
// with canonical digits (given by `in`, a Prod or Digits): σ = x_A·sig_c,
// the A→B extension to q, t_B = (x_B + q·p)·A^-1, σ' = t_B·(B/b_j)^-1,
// the B→A extension. Output digits canonical, value < 3p. Every thread
// of the warp must call it.
template <int IA, int IB, int T, class In>
__device__ __forceinline__ Share<Group<IA, IB, T>::CA, Group<IA, IB, T>::CB>
redc(const Ctx& g, const In& in) {
  using L = KLayout<IA, IB>;
  using G = Group<IA, IB, T>;
  const int* k = g.k;
  const int a0 = g.t * G::CA, b0 = g.t * G::CB;
  Share<G::CA, G::CB> out;
  int sig[G::CA];
#pragma unroll
  for (int i = 0; i < G::CA; ++i) {
    const int m = k[L::mA + a0 + i], mu = k[L::muA + a0 + i];
    sig[i] = bred(in.a(i, m, mu) * k[L::sigc + a0 + i], m, mu);
  }
  publish<IA, G::CA>(g, sig, a0, L::invA);
  int q[G::CB];
  const int alpha = extend_sum<IA, G::CB>(g, k + L::wAB + b0 * L::SA, L::SA,
                                          -1e-4f, q);
  int sig2[G::CB];
#pragma unroll
  for (int j = 0; j < G::CB; ++j) {
    const int c = b0 + j;
    const int m = k[L::mB + c], mu = k[L::muB + c];
    const int aadj = alpha < 0 ? alpha + m : alpha;
    const int qj = bred(q[j] + aadj * k[L::negAB + c], m, mu);
    const int pb = in.b(j, m, mu);
    // q·p + x < 2^28: one reduction covers the product-and-add
    int t = bred(pb + qj * k[L::pB + c], m, mu);
    t = bred(t * k[L::invab + c], m, mu);
    out.b[j] = t;
    sig2[j] = bred(t * k[L::invmib + c], m, mu);
  }
  publish<IB, G::CB>(g, sig2, b0, L::invB);
  int r[G::CA];
  const int alpha2 = extend_sum<IB, G::CA>(
      g, k + L::wBA + a0 * L::SB, L::SB, static_cast<float>(0.5 - 1e-4), r);
#pragma unroll
  for (int i = 0; i < G::CA; ++i) {
    const int m = k[L::mA + a0 + i], mu = k[L::muA + a0 + i];
    const int aadj = alpha2 < 0 ? alpha2 + m : alpha2;
    out.a[i] = bred(r[i] + aadj * k[L::negBA + a0 + i], m, mu);
  }
  return out;
}

// (x·y)·A^-1 mod p on digit-bounded values (ec_rns.rmul): the channel
// products, then the REDC. Output digits canonical, value < 3p.
template <int IA, int IB, int T>
__device__ __forceinline__ Share<Group<IA, IB, T>::CA, Group<IA, IB, T>::CB>
rmul(const Ctx& g, const Share<Group<IA, IB, T>::CA, Group<IA, IB, T>::CB>& x,
     const Share<Group<IA, IB, T>::CA, Group<IA, IB, T>::CB>& y) {
  using G = Group<IA, IB, T>;
  return redc<IA, IB, T>(g, Prod<G::CA, G::CB>{x, y});
}

// a + b, lazy (ec_rns.radd).
template <int CA, int CB>
__device__ __forceinline__ Share<CA, CB> radd(const Share<CA, CB>& x,
                                              const Share<CA, CB>& y) {
  Share<CA, CB> o;
#pragma unroll
  for (int i = 0; i < CA; ++i) o.a[i] = x.a[i] + y.a[i];
#pragma unroll
  for (int j = 0; j < CB; ++j) o.b[j] = x.b[j] + y.b[j];
  return o;
}

// x + (cmul·p + guard·m) − y, lazy (ec_rns.rsub); ka/kb: the offsets
// of the constant's A and B vectors (k16A/k16B, k4A/k4B or k8A/k8B).
template <int CA, int CB>
__device__ __forceinline__ Share<CA, CB> rsub(const Ctx& g, int a0, int b0,
                                              const Share<CA, CB>& x,
                                              const Share<CA, CB>& y, int ka,
                                              int kb) {
  Share<CA, CB> o;
#pragma unroll
  for (int i = 0; i < CA; ++i) o.a[i] = x.a[i] + g.k[ka + a0 + i] - y.a[i];
#pragma unroll
  for (int j = 0; j < CB; ++j) o.b[j] = x.b[j] + g.k[kb + b0 + j] - y.b[j];
  return o;
}

// Canonical digits of a lazily grown value (ec_rns.rfix).
template <int IA, int IB, int CA, int CB>
__device__ __forceinline__ Share<CA, CB> rfix(const Ctx& g, int a0, int b0,
                                              const Share<CA, CB>& x) {
  using L = KLayout<IA, IB>;
  Share<CA, CB> o;
#pragma unroll
  for (int i = 0; i < CA; ++i)
    o.a[i] = bred(x.a[i], g.k[L::mA + a0 + i], g.k[L::muA + a0 + i]);
#pragma unroll
  for (int j = 0; j < CB; ++j)
    o.b[j] = bred(x.b[j], g.k[L::mB + b0 + j], g.k[L::muB + b0 + j]);
  return o;
}

// This thread's share of a value held as [I_A, n] and [I_B, n] planes
// (channels past I read as 0).
template <int IA, int IB, int CA, int CB>
__device__ __forceinline__ Share<CA, CB> load_share(
    const int* __restrict__ pa, const int* __restrict__ pb, int n, int lane,
    int t) {
  Share<CA, CB> o;
#pragma unroll
  for (int i = 0; i < CA; ++i) {
    const int c = t * CA + i;
    o.a[i] = c < IA ? pa[static_cast<size_t>(c) * n + lane] : 0;
  }
#pragma unroll
  for (int j = 0; j < CB; ++j) {
    const int c = t * CB + j;
    o.b[j] = c < IB ? pb[static_cast<size_t>(c) * n + lane] : 0;
  }
  return o;
}

// Write this thread's share of a value to [I_A, n] and [I_B, n] planes
// at ``lane`` (padding channels are not written).
template <int IA, int IB, int CA, int CB>
__device__ __forceinline__ void store_share(int* __restrict__ pa,
                                            int* __restrict__ pb, int n,
                                            int lane, int t,
                                            const Share<CA, CB>& v) {
#pragma unroll
  for (int i = 0; i < CA; ++i) {
    const int c = t * CA + i;
    if (c < IA) pa[static_cast<size_t>(c) * n + lane] = v.a[i];
  }
#pragma unroll
  for (int j = 0; j < CB; ++j) {
    const int c = t * CB + j;
    if (c < IB) pb[static_cast<size_t>(c) * n + lane] = v.b[j];
  }
}

// Decode this thread's C words of a packed table row (A channel c in
// the low 16 bits of word c, B channel c in the high 16; ec_rns
// _pack_residue_rows) into its share; padding channels read as 0.
template <int IA, int IB, int C>
__device__ __forceinline__ Share<C, C> decode(const int* w, int t) {
  Share<C, C> o;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    o.a[i] = t * C + i < IA ? (w[i] & 0xFFFF) : 0;
    o.b[i] = t * C + i < IB ? (w[i] >> 16) : 0;
  }
  return o;
}

}  // namespace ri
}  // namespace capk
