// One window of the Ed25519 ladder: the RNS mixed add.
//
// Replaces: cap_tpu/tpu/pallas_edw.py, _edw_kernel (via _edw_call and
// edw_madd_fused) — the complete a = -1 extended + precomputed mixed
// add (madd-2008-hwcd-3): 7 RNS multiplies, each a full REDC with both
// base extensions, and the lazy adds and subs. The Edwards law is
// complete and the window tables hold the identity at digit 0, so
// there are no masks, no degeneracy probe and no lift.
//
// What bounds it on the card: integer operations. Per lane it reads 7
// residue pairs (322 int32) and writes 4 (184 int32), about 2 KB, but
// runs 7 REDCs (~23k integer multiply-adds and ~1k Barrett fixes) —
// far more work per byte than the card's memory rate needs.
//
// Design: the one of the madd kernel. One thread per lane, blocks of
// 128 lanes, the ragged edge masked in the kernel (no padding). The
// per-context constants sit in shared memory in the REDC kernel's
// layout, and all arithmetic is rns_ops.cuh's, so the three kernels
// cannot drift apart; rmul stays out of line, so the kernel carries one
// copy of the REDC. The three table planes arrive gathered by the
// caller. The layer order and every lazy bound follow _edw_madd_rns.
#include <cuda_runtime.h>

#include "rns_ops.cuh"

namespace capk {

template <int IA, int IB>
__device__ __forceinline__ void load_plane_pair(const int* __restrict__ pa,
                                                const int* __restrict__ pb,
                                                int n, int lane,
                                                Pair<IA, IB>& out) {
#pragma unroll
  for (int i = 0; i < IA; ++i) out.a[i] = pa[i * n + lane];
#pragma unroll
  for (int j = 0; j < IB; ++j) out.b[j] = pb[j * n + lane];
}

template <int IA, int IB>
__device__ __forceinline__ void store_plane_pair(int* __restrict__ pa,
                                                 int* __restrict__ pb, int n,
                                                 int lane,
                                                 const Pair<IA, IB>& v) {
#pragma unroll
  for (int i = 0; i < IA; ++i) pa[i * n + lane] = v.a[i];
#pragma unroll
  for (int j = 0; j < IB; ++j) pb[j * n + lane] = v.b[j];
}

// in: X, Y, Z, T, ym, yp, t2 as (A, B) plane pointers; out: X3, Y3,
// Z3, T3 likewise. Every plane is [I, n] with lanes contiguous.
struct EdwArgs {
  const int* in[14];
  int* out[8];
};

template <int IA, int IB>
__global__ void __launch_bounds__(128)
    edw_kernel(const EdwArgs args, const int* __restrict__ consts, int n) {
  using L = Layout<IA, IB>;
  using P = Pair<IA, IB>;
  __shared__ int k[L::words];
  load_consts(k, consts, L::words);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  P X, Y, Z, T, ym, yp, t2;
  load_plane_pair<IA, IB>(args.in[0], args.in[1], n, lane, X);
  load_plane_pair<IA, IB>(args.in[2], args.in[3], n, lane, Y);
  load_plane_pair<IA, IB>(args.in[4], args.in[5], n, lane, Z);
  load_plane_pair<IA, IB>(args.in[6], args.in[7], n, lane, T);
  load_plane_pair<IA, IB>(args.in[8], args.in[9], n, lane, ym);
  load_plane_pair<IA, IB>(args.in[10], args.in[11], n, lane, yp);
  load_plane_pair<IA, IB>(args.in[12], args.in[13], n, lane, t2);

  // _edw_madd_rns, layer for layer (bounds documented there).
  P a, b, cc, X3, Y3, Z3, T3;
  rmul<IA, IB>(k, rsub<IA, IB>(k, Y, X, 4, 1), ym, a);
  rmul<IA, IB>(k, radd<IA, IB>(Y, X), yp, b);
  rmul<IA, IB>(k, T, t2, cc);
  const P d = radd<IA, IB>(Z, Z);
  const P e = rsub<IA, IB>(k, b, a, 4, 1);
  const P f = rsub<IA, IB>(k, d, cc, 4, 1);
  const P g = radd<IA, IB>(d, cc);
  const P h = radd<IA, IB>(b, a);
  rmul<IA, IB>(k, e, f, X3);
  rmul<IA, IB>(k, g, h, Y3);
  rmul<IA, IB>(k, f, g, Z3);
  rmul<IA, IB>(k, e, h, T3);

  store_plane_pair<IA, IB>(args.out[0], args.out[1], n, lane, X3);
  store_plane_pair<IA, IB>(args.out[2], args.out[3], n, lane, Y3);
  store_plane_pair<IA, IB>(args.out[4], args.out[5], n, lane, Z3);
  store_plane_pair<IA, IB>(args.out[6], args.out[7], n, lane, T3);
}

template <int IA, int IB>
int launch_edw(const EdwArgs& args, const int* consts, int words, int n,
               cudaStream_t stream) {
  if (words != Layout<IA, IB>::words) return int(cudaErrorInvalidValue);
  const int threads = 128;
  edw_kernel<IA, IB><<<(n + threads - 1) / threads, threads, 0, stream>>>(
      args, consts, n);
  return int(cudaGetLastError());
}

}  // namespace capk

// Planes in the order X, Y, Z, T, ym, yp, t2 (each A then B), then the
// outputs X3, Y3, Z3, T3 (each A then B).
extern "C" int cap_edw(const void* xa, const void* xb, const void* ya,
                       const void* yb, const void* za, const void* zb,
                       const void* ta, const void* tb, const void* yma,
                       const void* ymb, const void* ypa, const void* ypb,
                       const void* t2a, const void* t2b, void* oxa,
                       void* oxb, void* oya, void* oyb, void* oza,
                       void* ozb, void* ota, void* otb, const void* consts,
                       int words, int n, int ia, int ib, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const void* in[14] = {xa, xb, ya, yb, za, zb, ta, tb,
                        yma, ymb, ypa, ypb, t2a, t2b};
  void* out[8] = {oxa, oxb, oya, oyb, oza, ozb, ota, otb};
  capk::EdwArgs args;
  for (int q = 0; q < 14; ++q) args.in[q] = static_cast<const int*>(in[q]);
  for (int q = 0; q < 8; ++q) args.out[q] = static_cast<int*>(out[q]);
  if (ia == 23 && ib == 23)
    return capk::launch_edw<23, 23>(args, static_cast<const int*>(consts),
                                    words, n,
                                    static_cast<cudaStream_t>(stream));
  return int(cudaErrorInvalidValue);
}
