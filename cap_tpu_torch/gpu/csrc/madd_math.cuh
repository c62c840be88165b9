// One ES ladder window on one lane's shares: the RNS mixed add with
// the ladder's bookkeeping left to the callers.
//
// Shared by the per-window kernel (madd.cu) and the whole-ladder kernel
// (ladder.cu), the way the JAX package's _madd_kernel and
// _ladder_kernel share _madd_math (cap_tpu/tpu/pallas_madd.py), so the
// two kernels' numerics cannot diverge. The layer order and every lazy
// bound follow _madd_math (bounds documented in ec_rns._madd_rns); the
// arithmetic is rns_int.cuh's: integer reductions, whole-weight base
// extensions, one lane over a group of T threads.
#pragma once

#include "rns_int.cuh"

namespace capk {
namespace ri {

// The same-x probe of h (ec_rns.congruent_zero_probe: channels 0 and 1
// against the 20 c·p rows), computed on share 0 and broadcast to the
// group. Every thread of the warp must call it.
template <int IA, int IB, int CA, int CB>
__device__ __forceinline__ bool probe(const Ctx& g, const Share<CA, CB>& h) {
  using L = KLayout<IA, IB>;
  const int* k = g.k;
  // on share 0 these are channels 0 and 1; other shares' results are
  // replaced by the broadcast
  const int p0 = bred(h.a[0], k[L::mA], k[L::muA]);
  const int p1 = bred(h.a[1], k[L::mA + 1], k[L::muA + 1]);
  bool deg = false;
#pragma unroll
  for (int c = 0; c < kProbeC; ++c)
    deg = deg || (p0 == k[L::probe + 2 * c] && p1 == k[L::probe + 2 * c + 1]);
  return __shfl_sync(0xffffffffu, deg ? 1 : 0, g.src) != 0;
}

// (X3, Y3, Z3) = (X, Y, Z) + (x2, y2), the Jacobian + affine sum of
// ec_rns._madd_rns (the same layer order and lazy bounds as the JAX
// package's _madd_math), on this thread's shares; returns the same-x
// probe of h = x2·Z² − X (sufficient: a false positive only sends the
// lane to the oracle). State digit-canonical, values < 15p (X) and 11p
// (Y, Z); x2, y2 < p. The callers apply the ladder's bookkeeping (the
// probe counts on has && !inf lanes only; the infinity lift and the
// digit-0 select). Every thread of the warp must call it.
template <int IA, int IB, int T>
__device__ __forceinline__ bool madd_sum(
    const Ctx& g,
    const Share<Group<IA, IB, T>::CA, Group<IA, IB, T>::CB>& X,
    const Share<Group<IA, IB, T>::CA, Group<IA, IB, T>::CB>& Y,
    const Share<Group<IA, IB, T>::CA, Group<IA, IB, T>::CB>& Z,
    const Share<Group<IA, IB, T>::CA, Group<IA, IB, T>::CB>& x2,
    const Share<Group<IA, IB, T>::CA, Group<IA, IB, T>::CB>& y2,
    Share<Group<IA, IB, T>::CA, Group<IA, IB, T>::CB>& X3,
    Share<Group<IA, IB, T>::CA, Group<IA, IB, T>::CB>& Y3,
    Share<Group<IA, IB, T>::CA, Group<IA, IB, T>::CB>& Z3) {
  using L = KLayout<IA, IB>;
  using G = Group<IA, IB, T>;
  constexpr int CA = G::CA, CB = G::CB;
  const int a0 = g.t * CA, b0 = g.t * CB;
  // ordered so that few values are live at once
  const auto z1z1 = rmul<IA, IB, T>(g, Z, Z);
  const auto u2 = rmul<IA, IB, T>(g, x2, z1z1);
  const auto z1_3 = rmul<IA, IB, T>(g, Z, z1z1);
  const auto h = rsub(g, a0, b0, u2, X, L::k16A, L::k16B);
  const bool deg = probe<IA, IB>(g, h);
  const auto s2 = rmul<IA, IB, T>(g, y2, z1_3);
  const auto zh = radd(Z, h);
  const auto zh2 = rmul<IA, IB, T>(g, zh, zh);
  const auto hh = rmul<IA, IB, T>(g, h, h);
  Z3 = rfix<IA, IB>(g, a0, b0,
                    rsub(g, a0, b0,
                         rsub(g, a0, b0, zh2, z1z1, L::k4A, L::k4B), hh,
                         L::k4A, L::k4B));
  const auto hh2 = radd(hh, hh);
  const auto i4 = radd(hh2, hh2);
  const auto s2y1 = rsub(g, a0, b0, s2, Y, L::k16A, L::k16B);
  const auto rr = rfix<IA, IB>(g, a0, b0, radd(s2y1, s2y1));
  const auto j = rmul<IA, IB, T>(g, h, i4);
  const auto v = rmul<IA, IB, T>(g, X, i4);
  const auto r2 = rmul<IA, IB, T>(g, rr, rr);
  X3 = rfix<IA, IB>(g, a0, b0,
                    rsub(g, a0, b0,
                         rsub(g, a0, b0, r2, j, L::k4A, L::k4B), radd(v, v),
                         L::k8A, L::k8B));
  const auto y1j = rmul<IA, IB, T>(g, Y, j);
  const auto t5 = rmul<IA, IB, T>(
      g, rr, rsub(g, a0, b0, v, X3, L::k16A, L::k16B));
  Y3 = rfix<IA, IB>(g, a0, b0,
                    rsub(g, a0, b0, t5, radd(y1j, y1j), L::k8A, L::k8B));
  return deg;
}

// Decode this thread's share of packed words (A channel c in the low
// 16 bits of word c, B channel c in the high 16; ec_rns
// _pack_residue_rows): word c at w[c·stride].
template <int IA, int IB, int CA, int CB>
__device__ __forceinline__ Share<CA, CB> unpack_share(const int* w,
                                                      size_t stride, int t) {
  Share<CA, CB> o;
#pragma unroll
  for (int i = 0; i < CA; ++i) {
    const int c = t * CA + i;
    o.a[i] = c < IA ? (w[c * stride] & 0xFFFF) : 0;
  }
#pragma unroll
  for (int j = 0; j < CB; ++j) {
    const int c = t * CB + j;
    o.b[j] = c < IB ? (w[c * stride] >> 16) : 0;
  }
  return o;
}

}  // namespace ri
}  // namespace capk
