// One window of the Ed25519 ladder: the table gather and the RNS mixed
// add.
//
// Replaces: cap_tpu/tpu/pallas_edw.py, _edw_kernel (via _edw_call and
// edw_madd_fused) — the complete a = -1 extended + precomputed mixed
// add (madd-2008-hwcd-3): 7 RNS multiplies, each a full REDC with both
// base extensions, and the lazy adds and subs. The Edwards law is
// complete and the window tables hold the identity at digit 0, so
// there are no masks, no degeneracy probe and no lift. The JAX package
// gathers the window's table rows (jnp.take) before its kernel; here
// the kernel reads them itself.
//
// What bounds it on the card: integer operations. Per lane it reads
// the state (4 residue pairs, 184 int32), one packed table row (69
// int32: the triple (y−x, y+x, 2dxy) as A|B<<16 words) and its row
// index, and writes 4 pairs: 1,752 bytes against 7 REDCs.
//
// Design: madd.cu's (rns_int.cuh). Each lane runs on a group of
// kGroup<23, 23> = 8 threads, each holding its share of X, Y, Z and T
// in registers; the arithmetic is conversion-free (integer Barrett
// reductions) with whole-weight extensions from shared memory, the
// group meeting in shared memory between warp barriers. Each thread
// loads only its words of the lane's table row (read-only path, issued
// first so the state loads overlap them), keeps them packed and decodes
// a triple only where the sum takes it. The layer order and every lazy
// bound follow _edw_madd_rns; the four outputs are stored as soon as
// each is formed. The ragged edge: lanes past n compute on lane n−1's
// inputs and store nothing. Instantiated for the Ed25519 field's 23+23
// channels.
#include <cuda_runtime.h>

#include "rns_int.cuh"

namespace capk {
namespace ri {

// in: X, Y, Z, T as (A, B) plane pointers; out: X3, Y3, Z3, T3
// likewise. Every plane is [I, n] with lanes contiguous.
struct EdwPlanes {
  const int* in[8];
  int* out[8];
};

template <int IA, int IB, int T>
__global__ void __launch_bounds__(kThreads)
    edw_kernel(const EdwPlanes pl, const int* __restrict__ tab,
               const int* __restrict__ rows, const int* __restrict__ consts,
               int n) {
  using L = KLayout<IA, IB>;
  using G = Group<IA, IB, T>;
  static_assert(G::CA == G::CB, "a thread's A and B shares share words");
  constexpr int C = G::CA;
  constexpr int IAP = IA > IB ? IA : IB;
  using Sh = Share<C, C>;
  __shared__ __align__(16) int k[L::words];
  __shared__ __align__(16) int xs[G::kLanes * G::S];
  __shared__ __align__(16) float xf[G::kLanes * G::S];
  load_block(k, consts, L::words, xs, xf, G::kLanes * G::S);
  int lane;
  const Ctx g = make_ctx<IA, IB, T>(k, xs, xf, lane);
  const bool valid = lane < n;
  const int ln = valid ? lane : n - 1;
  const int t = g.t;
  const int a0 = t * C, b0 = t * C;

  // this thread's words of the row's three triples, kept packed
  const int* row = tab + static_cast<size_t>(__ldg(rows + ln)) * (3 * IAP);
  int wm[C], wp[C], w2[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c = t * C + j < IAP ? t * C + j : IAP - 1;
    wm[j] = __ldg(row + c);
    wp[j] = __ldg(row + IAP + c);
    w2[j] = __ldg(row + 2 * IAP + c);
  }
  const Sh X = load_share<IA, IB, C, C>(pl.in[0], pl.in[1], n, ln, t);
  const Sh Y = load_share<IA, IB, C, C>(pl.in[2], pl.in[3], n, ln, t);
  const Sh Z = load_share<IA, IB, C, C>(pl.in[4], pl.in[5], n, ln, t);
  const Sh Tt = load_share<IA, IB, C, C>(pl.in[6], pl.in[7], n, ln, t);

  // _edw_madd_rns, layer for layer (bounds documented there); rsub's
  // 4p + m is k4A/k4B
  const Sh a = rmul<IA, IB, T>(
      g, rsub(g, a0, b0, Y, X, L::k4A, L::k4B), decode<IA, IB, C>(wm, t));
  const Sh b = rmul<IA, IB, T>(g, radd(Y, X), decode<IA, IB, C>(wp, t));
  const Sh cc = rmul<IA, IB, T>(g, Tt, decode<IA, IB, C>(w2, t));
  const Sh d = radd(Z, Z);
  const Sh e = rsub(g, a0, b0, b, a, L::k4A, L::k4B);
  const Sh f = rsub(g, a0, b0, d, cc, L::k4A, L::k4B);
  const Sh gg = radd(d, cc);
  const Sh h = radd(b, a);
  const Sh X3 = rmul<IA, IB, T>(g, e, f);
  if (valid) store_share<IA, IB>(pl.out[0], pl.out[1], n, lane, t, X3);
  const Sh T3 = rmul<IA, IB, T>(g, e, h);
  if (valid) store_share<IA, IB>(pl.out[6], pl.out[7], n, lane, t, T3);
  const Sh Y3 = rmul<IA, IB, T>(g, gg, h);
  if (valid) store_share<IA, IB>(pl.out[2], pl.out[3], n, lane, t, Y3);
  const Sh Z3 = rmul<IA, IB, T>(g, f, gg);
  if (valid) store_share<IA, IB>(pl.out[4], pl.out[5], n, lane, t, Z3);
}

#ifndef CAPK_NO_LAUNCH
template <int IA, int IB>
int launch_edw(const EdwPlanes& pl, const int* tab, const int* rows,
               const int* consts, int words, int n, cudaStream_t stream) {
  if (words != KLayout<IA, IB>::words) return int(cudaErrorInvalidValue);
  constexpr int T = kGroup<IA, IB>;
  constexpr int lanes = Group<IA, IB, T>::kLanes;
  edw_kernel<IA, IB, T><<<(n + lanes - 1) / lanes, kThreads, 0, stream>>>(
      pl, tab, rows, consts, n);
  return int(cudaGetLastError());
}
#endif

}  // namespace ri
}  // namespace capk

#ifndef CAPK_NO_LAUNCH
// Planes X, Y, Z, T (each A then B), then the outputs X3, Y3, Z3, T3
// (each A then B); tab: [rows, 3·max(ia, ib)] packed words, row-major;
// rows: [n] int32 row of each lane; consts: cuda_madd.madd_consts
// (KLayout); words: its length.
extern "C" int cap_edw(const void* xa, const void* xb, const void* ya,
                       const void* yb, const void* za, const void* zb,
                       const void* ta, const void* tb, void* oxa, void* oxb,
                       void* oya, void* oyb, void* oza, void* ozb,
                       void* ota, void* otb, const void* tab,
                       const void* rows, const void* consts, int words,
                       int n, int ia, int ib, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const void* in[8] = {xa, xb, ya, yb, za, zb, ta, tb};
  void* out[8] = {oxa, oxb, oya, oyb, oza, ozb, ota, otb};
  capk::ri::EdwPlanes pl;
  for (int q = 0; q < 8; ++q) {
    pl.in[q] = static_cast<const int*>(in[q]);
    pl.out[q] = static_cast<int*>(out[q]);
  }
  // the Ed25519 field (cuda_edw.KERNEL_SHAPES)
  if (ia == 23 && ib == 23)
    return capk::ri::launch_edw<23, 23>(
        pl, static_cast<const int*>(tab), static_cast<const int*>(rows),
        static_cast<const int*>(consts), words, n,
        static_cast<cudaStream_t>(stream));
  return int(cudaErrorInvalidValue);
}
#endif
