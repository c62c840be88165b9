// One ES ladder window on one lane's registers: the RNS mixed add with
// the ladder's bookkeeping.
//
// Shared by the per-window kernel (madd.cu) and the whole-ladder kernel
// (ladder.cu), the way the JAX package's _madd_kernel and
// _ladder_kernel share _madd_math (cap_tpu/tpu/pallas_madd.py), so the
// two kernels' numerics cannot diverge. The layer order and every lazy
// bound follow _madd_math (bounds documented in ec_rns._madd_rns); the
// arithmetic is rns_ops.cuh's, with rmul kept out of line.
#pragma once

#include "rns_ops.cuh"

namespace capk {

// Decode one lane's packed table row: A channel j in the low 16 bits of
// word j, B channel j in the high 16 (ec_rns._pack_residue_rows). The
// words are contiguous, as a row of the [rows, 2·iap] table holds them.
template <int IA, int IB>
__device__ __forceinline__ void unpack_row(const int* __restrict__ words,
                                           Pair<IA, IB>& out) {
#pragma unroll
  for (int i = 0; i < IA; ++i) out.a[i] = __ldg(words + i) & 0xFFFF;
#pragma unroll
  for (int j = 0; j < IB; ++j) out.b[j] = __ldg(words + j) >> 16;
}

// (X3, Y3, Z3) = (X, Y, Z) + (x2, y2), the Jacobian + affine sum, and
// the same-x probe of the sum's h = x2·Z² − X (2 channels over 20
// candidates): sufficient, false positives only send the lane to the
// oracle. State in digit-canonical, values < 15p (X) and 11p (Y, Z);
// x2, y2 < p. The callers apply the ladder's bookkeeping: the probe
// counts on has && !inf lanes only, and the infinity lift and digit-0
// select (ec_rns add_from_table semantics) pick X3 or the addend or the
// old state. madd.cu writes that select straight to its outputs,
// ladder.cu into the registers it carries to the next window.
template <int IA, int IB>
__device__ __forceinline__ bool madd_math(const int* k, const Pair<IA, IB>& X,
                                          const Pair<IA, IB>& Y,
                                          const Pair<IA, IB>& Z,
                                          const Pair<IA, IB>& x2,
                                          const Pair<IA, IB>& y2,
                                          Pair<IA, IB>& X3, Pair<IA, IB>& Y3,
                                          Pair<IA, IB>& Z3) {
  using L = Layout<IA, IB>;
  using P = Pair<IA, IB>;
  P z1z1, u2, z1_3, s2, hh, zh2, j, v, r2, y1j, t5;
  rmul<IA, IB>(k, Z, Z, z1z1);
  rmul<IA, IB>(k, x2, z1z1, u2);
  rmul<IA, IB>(k, Z, z1z1, z1_3);
  const P h = rsub<IA, IB>(k, u2, X, 16, 1);
  const P zh = radd<IA, IB>(Z, h);
  rmul<IA, IB>(k, y2, z1_3, s2);
  rmul<IA, IB>(k, h, h, hh);
  rmul<IA, IB>(k, zh, zh, zh2);
  const P hh2 = radd<IA, IB>(hh, hh);
  const P i4 = radd<IA, IB>(hh2, hh2);
  const P s2y1 = rsub<IA, IB>(k, s2, Y, 16, 1);
  const P rr = rfix<IA, IB>(k, radd<IA, IB>(s2y1, s2y1));
  rmul<IA, IB>(k, h, i4, j);
  rmul<IA, IB>(k, X, i4, v);
  rmul<IA, IB>(k, rr, rr, r2);
  const P vv = radd<IA, IB>(v, v);
  X3 = rfix<IA, IB>(
      k, rsub<IA, IB>(k, rsub<IA, IB>(k, r2, j, 4, 1), vv, 8, 2));
  rmul<IA, IB>(k, Y, j, y1j);
  rmul<IA, IB>(k, rr, rsub<IA, IB>(k, v, X3, 16, 1), t5);
  Y3 = rfix<IA, IB>(
      k, rsub<IA, IB>(k, t5, radd<IA, IB>(y1j, y1j), 8, 2));
  Z3 = rfix<IA, IB>(
      k, rsub<IA, IB>(k, rsub<IA, IB>(k, zh2, z1z1, 4, 1), hh, 4, 1));

  // same-x degeneracy probe (ec_rns.congruent_zero_probe)
  int probe[kDegCh];
#pragma unroll
  for (int c = 0; c < kDegCh; ++c)
    probe[c] = fix(h.a[c], k[L::mA + c], fbits(k, L::invA + c));
  bool deg = false;
#pragma unroll
  for (int cc = 0; cc < kDegMaxC; ++cc) {
    bool hit = true;
#pragma unroll
    for (int c = 0; c < kDegCh; ++c)
      hit = hit && probe[c] == k[L::cpA + cc * IA + c];
    deg = deg || hit;
  }
  return deg;
}

template <int IA, int IB>
__device__ __forceinline__ void load_pair(const int* __restrict__ pa,
                                          const int* __restrict__ pb, int n,
                                          int lane, Pair<IA, IB>& out) {
#pragma unroll
  for (int i = 0; i < IA; ++i) out.a[i] = pa[i * n + lane];
#pragma unroll
  for (int j = 0; j < IB; ++j) out.b[j] = pb[j * n + lane];
}

template <int IA, int IB>
__device__ __forceinline__ void store_pair(int* __restrict__ pa,
                                           int* __restrict__ pb, int n,
                                           int lane, const Pair<IA, IB>& v) {
#pragma unroll
  for (int i = 0; i < IA; ++i) pa[i * n + lane] = v.a[i];
#pragma unroll
  for (int j = 0; j < IB; ++j) pb[j * n + lane] = v.b[j];
}

}  // namespace capk
