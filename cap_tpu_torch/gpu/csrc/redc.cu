// RNS Montgomery reduction (REDC) for per-channel (EC) contexts.
//
// Replaces: cap_tpu/tpu/pallas_redc.py, _redc_kernel (via _redc_call
// and redc_fused) — t = x·A^-1 mod p on residue planes: σ = x_A·sig_c,
// the A->B extension, t_B = (x_B + q·p)·A^-1, the B->A extension.
//
// What bounds it on the card: integer operations. Per P-256 lane it
// reads and writes 2·23 int32 (368 bytes) but runs two 23x23
// extensions of three integer dot products each (~3.2k multiply-adds)
// plus ~140 Barrett fixes — roughly 20 integer operations per byte
// moved, well above the H100's ratio of integer rate to memory rate
// (P-384's 34+33 and P-521's 45+45 channels raise the ratio further).
//
// Design: one thread per lane, blocks of 128 lanes, the ragged edge
// masked. All per-context constants (moduli, σ and extension
// constants, the four 7-bit extension blocks) sit in shared memory:
// every thread of a warp reads the same word at the same time, a
// broadcast. The residue planes are [I, N] with lanes contiguous, so
// each channel's load and store is coalesced across the warp. The
// extension products are integer multiply-adds, exact by construction
// (see rns_ops.cuh); tensor cores and wgmma are left for later work.
// Instantiated for 23+23, 34+33 and 45+45 channels: the largest
// layout (11,610 words, 46,440 B) still fits static shared memory.
#include <cuda_runtime.h>

#include "rns_ops.cuh"

namespace capk {

template <int IA, int IB>
__global__ void __launch_bounds__(128)
    redc_kernel(const int* __restrict__ xA, const int* __restrict__ xB,
                int* __restrict__ tA, int* __restrict__ tB,
                const int* __restrict__ consts, int n) {
  __shared__ int k[Layout<IA, IB>::words];
  load_consts(k, consts, Layout<IA, IB>::words);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int a[IA], b[IB], ra[IA], rb[IB];
#pragma unroll
  for (int i = 0; i < IA; ++i) a[i] = xA[i * n + lane];
#pragma unroll
  for (int j = 0; j < IB; ++j) b[j] = xB[j * n + lane];
  redc<IA, IB>(k, a, b, ra, rb);
#pragma unroll
  for (int i = 0; i < IA; ++i) tA[i * n + lane] = ra[i];
#pragma unroll
  for (int j = 0; j < IB; ++j) tB[j * n + lane] = rb[j];
}

template <int IA, int IB>
int launch_redc(const int* xA, const int* xB, int* tA, int* tB,
                const int* consts, int words, int n, cudaStream_t stream) {
  if (words != Layout<IA, IB>::words) return int(cudaErrorInvalidValue);
  const int threads = 128;
  redc_kernel<IA, IB><<<(n + threads - 1) / threads, threads, 0, stream>>>(
      xA, xB, tA, tB, consts, n);
  return int(cudaGetLastError());
}

}  // namespace capk

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
  // P-256 and Ed25519, P-384, P-521 (cuda_redc.KERNEL_SHAPES)
  if (ia == 23 && ib == 23)
    return capk::launch_redc<23, 23>(a, b, ta, tb, k, words, n, s);
  if (ia == 34 && ib == 33)
    return capk::launch_redc<34, 33>(a, b, ta, tb, k, words, n, s);
  if (ia == 45 && ib == 45)
    return capk::launch_redc<45, 45>(a, b, ta, tb, k, words, n, s);
  return int(cudaErrorInvalidValue);
}
