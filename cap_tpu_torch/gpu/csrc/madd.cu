// One ladder window of the ES* verify: the RNS mixed add.
//
// Replaces: cap_tpu/tpu/pallas_madd.py, _madd_kernel (math in
// _madd_math, via _madd_call and madd_fused) — unpack the packed
// A|B<<16 table words, the Jacobian + affine mixed add (11 RNS
// multiplies, each a full REDC with both base extensions, plus the
// lazy adds and subs), the same-x degeneracy probe on 2 channels over
// 20 candidates, and the infinity lift and digit-0 select.
//
// What bounds it on the card: integer operations. Per P-256 lane it
// reads 186 and writes 139 int32 (about 1.3 KB) but runs 11 REDCs
// (~12k multiply-adds over the extension weights and ~1.5k Barrett
// reductions) — far more work per byte than the card's memory rate
// needs; P-384 and P-521 lanes grow the work by the square of the
// channel count.
//
// Design: each lane is spread over a group of T threads (rns_int.cuh:
// T = 8 at 23+23 and 34+33, 4 at 45+45; 128/T lanes to a block of 128
// threads), so each thread's share of the live values (X, Y, Z, x2, y2
// and the temporaries of the sum) stays in registers: no spills at
// 23+23 and 34+33. The arithmetic is
// conversion-free (integer Barrett reductions) and each extension takes
// whole 13-bit weights, one multiply-add each, from shared memory by
// 16-byte loads; the group exchanges σ through shared memory with warp
// barriers only. The sum and probe are madd_math.cuh's, shared with the
// whole-ladder kernel (ladder.cu). The epilogue re-reads the inputs it
// passes through (a digit-0 lane keeps its state, an infinity lane
// takes the table point) instead of keeping them live across the sum.
// The ragged edge: lanes past n compute on lane n−1's inputs and store
// nothing. Instantiated for 23+23 (P-256), 34+33 (P-384) and 45+45
// (P-521) channels.
#include <cuda_runtime.h>

#include "madd_math.cuh"

namespace capk {
namespace ri {

template <int IA, int IB, int T>
__global__ void __launch_bounds__(kThreads)
    madd_kernel(const int* __restrict__ xa, const int* __restrict__ xb,
                const int* __restrict__ ya, const int* __restrict__ yb,
                const int* __restrict__ za, const int* __restrict__ zb,
                const int* __restrict__ px, const int* __restrict__ py,
                const uint8_t* __restrict__ has_p,
                const uint8_t* __restrict__ inf_p, int* __restrict__ oxa,
                int* __restrict__ oxb, int* __restrict__ oya,
                int* __restrict__ oyb, int* __restrict__ oza,
                int* __restrict__ ozb, uint8_t* __restrict__ deg_p,
                const int* __restrict__ consts, int n) {
  using L = KLayout<IA, IB>;
  using G = Group<IA, IB, T>;
  using Sh = Share<G::CA, G::CB>;
  __shared__ __align__(16) int k[L::words];
  __shared__ __align__(16) int xs[G::kLanes * G::S];
  __shared__ __align__(16) float xf[G::kLanes * G::S];
  load_block(k, consts, L::words, xs, xf, G::kLanes * G::S);
  int lane;
  const Ctx g = make_ctx<IA, IB, T>(k, xs, xf, lane);
  const int ln = lane < n ? lane : n - 1;
  const int t = g.t;

  Sh X3, Y3, Z3;
  bool deg;
  {
    const Sh X = load_share<IA, IB, G::CA, G::CB>(xa, xb, n, ln, t);
    const Sh Y = load_share<IA, IB, G::CA, G::CB>(ya, yb, n, ln, t);
    const Sh Z = load_share<IA, IB, G::CA, G::CB>(za, zb, n, ln, t);
    const Sh x2 = unpack_share<IA, IB, G::CA, G::CB>(px + ln, n, t);
    const Sh y2 = unpack_share<IA, IB, G::CA, G::CB>(py + ln, n, t);
    deg = madd_sum<IA, IB, T>(g, X, Y, Z, x2, y2, X3, Y3, Z3);
  }
  if (lane >= n) return;
  const bool has = has_p[lane] != 0;
  const bool inf = inf_p[lane] != 0;
  if (t == 0) deg_p[lane] = (deg && !inf && has) ? 1 : 0;

  // infinity lift + digit-0 select, written straight to the outputs
#pragma unroll
  for (int i = 0; i < G::CA; ++i) {
    const int c = t * G::CA + i;
    if (c >= IA) break;
    const size_t o = static_cast<size_t>(c) * n + lane;
    int x = X3.a[i], y = Y3.a[i], z = Z3.a[i];
    if (!has) {
      x = ld_cg(xa + o), y = ld_cg(ya + o), z = ld_cg(za + o);
    } else if (inf) {
      x = ld_cg(px + o) & 0xFFFF, y = ld_cg(py + o) & 0xFFFF;
      z = k[L::oneA + c];
    }
    oxa[o] = x, oya[o] = y, oza[o] = z;
  }
#pragma unroll
  for (int j = 0; j < G::CB; ++j) {
    const int c = t * G::CB + j;
    if (c >= IB) break;
    const size_t o = static_cast<size_t>(c) * n + lane;
    int x = X3.b[j], y = Y3.b[j], z = Z3.b[j];
    if (!has) {
      x = ld_cg(xb + o), y = ld_cg(yb + o), z = ld_cg(zb + o);
    } else if (inf) {
      x = ld_cg(px + o) >> 16, y = ld_cg(py + o) >> 16;
      z = k[L::oneB + c];
    }
    oxb[o] = x, oyb[o] = y, ozb[o] = z;
  }
}

#ifndef CAPK_NO_LAUNCH
template <int IA, int IB>
int launch_madd(const int* const* in, const uint8_t* has,
                const uint8_t* inf, int* const* out, uint8_t* deg,
                const int* consts, int words, int n, cudaStream_t stream) {
  if (words != KLayout<IA, IB>::words) return int(cudaErrorInvalidValue);
  constexpr int T = kGroup<IA, IB>;
  constexpr int lanes = Group<IA, IB, T>::kLanes;
  madd_kernel<IA, IB, T><<<(n + lanes - 1) / lanes, kThreads, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], has, inf,
      out[0], out[1], out[2], out[3], out[4], out[5], deg, consts, n);
  return int(cudaGetLastError());
}
#endif

}  // namespace ri
}  // namespace capk

#ifndef CAPK_NO_LAUNCH
// consts: cuda_madd.madd_consts (KLayout); words: its length.
extern "C" int cap_madd(const void* xa, const void* xb, const void* ya,
                        const void* yb, const void* za, const void* zb,
                        const void* px, const void* py, const void* has,
                        const void* inf, void* oxa, void* oxb, void* oya,
                        void* oyb, void* oza, void* ozb, void* deg,
                        const void* consts, int words, int n, int ia,
                        int ib, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const int* in[8] = {
      static_cast<const int*>(xa), static_cast<const int*>(xb),
      static_cast<const int*>(ya), static_cast<const int*>(yb),
      static_cast<const int*>(za), static_cast<const int*>(zb),
      static_cast<const int*>(px), static_cast<const int*>(py)};
  int* out[6] = {static_cast<int*>(oxa), static_cast<int*>(oxb),
                 static_cast<int*>(oya), static_cast<int*>(oyb),
                 static_cast<int*>(oza), static_cast<int*>(ozb)};
  const auto* h = static_cast<const uint8_t*>(has);
  const auto* f = static_cast<const uint8_t*>(inf);
  auto* d = static_cast<uint8_t*>(deg);
  const auto* k = static_cast<const int*>(consts);
  auto s = static_cast<cudaStream_t>(stream);
  using capk::ri::launch_madd;
  // P-256, P-384, P-521 (cuda_redc.KERNEL_SHAPES)
  if (ia == 23 && ib == 23)
    return launch_madd<23, 23>(in, h, f, out, d, k, words, n, s);
  if (ia == 34 && ib == 33)
    return launch_madd<34, 33>(in, h, f, out, d, k, words, n, s);
  if (ia == 45 && ib == 45)
    return launch_madd<45, 45>(in, h, f, out, d, k, words, n, s);
  return int(cudaErrorInvalidValue);
}
#endif
