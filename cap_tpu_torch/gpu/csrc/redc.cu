// RNS Montgomery reduction (REDC) for per-channel (EC) contexts.
//
// Replaces: cap_tpu/tpu/pallas_redc.py, _redc_kernel (via _redc_call
// and redc_fused) — t = x·A^-1 mod p on residue planes: σ = x_A·sig_c,
// the A->B extension, t_B = (x_B + q·p)·A^-1, the B->A extension.
//
// What bounds it on the card: bytes. A P-256 lane reads and writes
// 2·23 int32 (368 B) and runs two 23x23 extensions and ~140 reductions;
// counted per pipe (chip_smoke.rns_bound) the work takes less time
// than the bytes at every instantiated shape.
//
// Design: the REDC body of rns_int.cuh, the one every rmul of the
// mixed-add kernels runs (integer Barrett reductions, whole-weight
// extensions), with each lane over a group of kGroup<IA, IB> threads
// (8 at 23+23 and 34+33, 4 at 45+45) that meet in shared memory
// between warp barriers. Each thread loads and stores its own share of
// the lane's planes. A warp's load of one plane row then covers 32/T
// lanes, at T = 8 half a 32-byte sector whose other half the block's
// next warp loads; staging each tile through shared memory for
// whole-sector rows measured slower on the H100 at every shape
// (ladder_bench.py, PERF.md §6). The block copies KLayout's constants
// (6.7, 14.9 and 22.4 KB) into shared memory once and then walks over
// lane tiles (grid-stride), so the copy is not paid again for every
// 128/T lanes (one tile a block measured up to 40% slower). The
// ragged edge: lanes past n compute on lane n−1's inputs and store
// nothing. Instantiated for 23+23 (P-256 and the Ed25519 field), 34+33
// (P-384) and 45+45 (P-521) channels.
#include <cuda_runtime.h>

#include "rns_int.cuh"

namespace capk {
namespace ri {

template <int IA, int IB, int T>
__global__ void __launch_bounds__(kThreads)
    redc_kernel(const int* __restrict__ xa, const int* __restrict__ xb,
                int* __restrict__ ta, int* __restrict__ tb,
                const int* __restrict__ consts, int n) {
  using L = KLayout<IA, IB>;
  using G = Group<IA, IB, T>;
  constexpr int CA = G::CA, CB = G::CB;
  __shared__ __align__(16) int k[L::words];
  __shared__ __align__(16) int xs[G::kLanes * G::S];
  __shared__ __align__(16) float xf[G::kLanes * G::S];
  load_block(k, consts, L::words, xs, xf, G::kLanes * G::S);
  int lane;
  const Ctx g = make_ctx<IA, IB, T>(k, xs, xf, lane);
  const int row = lane - blockIdx.x * G::kLanes;  // its place in a tile
  const int tiles = (n + G::kLanes - 1) / G::kLanes;
#pragma unroll 1
  for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const int ln = tl * G::kLanes + row;
    const Share<CA, CB> x = load_share<IA, IB, CA, CB>(
        xa, xb, n, ln < n ? ln : n - 1, g.t);
    const Share<CA, CB> t = redc<IA, IB, T>(g, Digits<CA, CB>{x});
    if (ln < n) store_share<IA, IB>(ta, tb, n, ln, g.t, t);
  }
}

#ifndef CAPK_NO_LAUNCH
template <int IA, int IB>
int launch_redc(const int* xA, const int* xB, int* tA, int* tB,
                const int* consts, int words, int n, cudaStream_t stream) {
  if (words != KLayout<IA, IB>::words) return int(cudaErrorInvalidValue);
  constexpr int T = kGroup<IA, IB>;
  constexpr int lanes = Group<IA, IB, T>::kLanes;
  // as many blocks as the card holds at once, each walking over tiles
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, redc_kernel<IA, IB, T>, kThreads, 0);
    if (e != cudaSuccess) return int(e);
    resident = sms * per_sm;
  }
  const int tiles = (n + lanes - 1) / lanes;
  const int blocks = tiles < resident ? tiles : resident;
  redc_kernel<IA, IB, T><<<blocks, kThreads, 0, stream>>>(xA, xB, tA, tB,
                                                          consts, n);
  return int(cudaGetLastError());
}
#endif

}  // namespace ri
}  // namespace capk

#ifndef CAPK_NO_LAUNCH
// consts: cuda_madd.madd_consts (KLayout); words: its length.
extern "C" int cap_redc(const void* xA, const void* xB, void* tA, void* tB,
                        const void* consts, int words, int n, int ia,
                        int ib, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const auto* a = static_cast<const int*>(xA);
  const auto* b = static_cast<const int*>(xB);
  auto* ta = static_cast<int*>(tA);
  auto* tb = static_cast<int*>(tB);
  const auto* k = static_cast<const int*>(consts);
  auto s = static_cast<cudaStream_t>(stream);
  using capk::ri::launch_redc;
  // P-256 and Ed25519, P-384, P-521 (cuda_redc.KERNEL_SHAPES)
  if (ia == 23 && ib == 23)
    return launch_redc<23, 23>(a, b, ta, tb, k, words, n, s);
  if (ia == 34 && ib == 33)
    return launch_redc<34, 33>(a, b, ta, tb, k, words, n, s);
  if (ia == 45 && ib == 45)
    return launch_redc<45, 45>(a, b, ta, tb, k, words, n, s);
  return int(cudaErrorInvalidValue);
}
#endif
