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
// (~36k integer multiply-adds and ~1.6k Barrett fixes) — far more work
// per byte than the card's memory rate needs; P-384 and P-521 lanes
// grow the work by the square of the channel count.
//
// Design: one thread per lane, blocks of 128 lanes, the ragged edge
// masked in the kernel (no padding). The per-context constants share
// the REDC kernel's shared-memory layout and its rns_ops.cuh code, and
// the sum and probe are madd_math.cuh's, shared with the whole-ladder
// kernel (ladder.cu), so the kernels cannot drift apart. The lift and
// select go straight to the outputs: selecting into the X, Y, Z
// registers first, then storing them, made the 23+23 kernel 15%
// slower on the H100 (more spill stores). The live state of a
// lane (X, Y, Z and a dozen temporaries of I_A + I_B residues each)
// exceeds the register file; what spills goes to local memory, cached
// in L1. Instantiated for 23+23 (P-256), 34+33 (P-384) and 45+45
// (P-521) channels; the 45+45 constants take 46,440 B of the 48 KB of
// static shared memory.
#include <cuda_runtime.h>

#include "madd_math.cuh"

namespace capk {

template <int IA, int IB>
__global__ void __launch_bounds__(128)
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
  using L = Layout<IA, IB>;
  using P = Pair<IA, IB>;
  __shared__ int k[L::words];
  load_consts(k, consts, L::words);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  const bool has = has_p[lane] != 0;
  const bool inf = inf_p[lane] != 0;
  P X, Y, Z, x2, y2, X3, Y3, Z3;
  load_pair<IA, IB>(xa, xb, n, lane, X);
  load_pair<IA, IB>(ya, yb, n, lane, Y);
  load_pair<IA, IB>(za, zb, n, lane, Z);
  unpack_words<IA, IB>(px, n, lane, x2);
  unpack_words<IA, IB>(py, n, lane, y2);
  const bool deg = madd_math<IA, IB>(k, X, Y, Z, x2, y2, X3, Y3, Z3);
  deg_p[lane] = (deg && !inf && has) ? 1 : 0;

  // infinity lift + digit-0 select, written straight to the outputs
  const bool lift = inf && has;
#pragma unroll
  for (int i = 0; i < IA; ++i) {
    oxa[i * n + lane] = has ? (lift ? x2.a[i] : X3.a[i]) : X.a[i];
    oya[i * n + lane] = has ? (lift ? y2.a[i] : Y3.a[i]) : Y.a[i];
    oza[i * n + lane] = has ? (lift ? k[L::oneA + i] : Z3.a[i]) : Z.a[i];
  }
#pragma unroll
  for (int j = 0; j < IB; ++j) {
    oxb[j * n + lane] = has ? (lift ? x2.b[j] : X3.b[j]) : X.b[j];
    oyb[j * n + lane] = has ? (lift ? y2.b[j] : Y3.b[j]) : Y.b[j];
    ozb[j * n + lane] = has ? (lift ? k[L::oneB + j] : Z3.b[j]) : Z.b[j];
  }
}

template <int IA, int IB>
int launch_madd(const int* const* in, const uint8_t* has,
                const uint8_t* inf, int* const* out, uint8_t* deg,
                const int* consts, int words, int n, cudaStream_t stream) {
  if (words != Layout<IA, IB>::words) return int(cudaErrorInvalidValue);
  const int threads = 128;
  madd_kernel<IA, IB><<<(n + threads - 1) / threads, threads, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], has, inf,
      out[0], out[1], out[2], out[3], out[4], out[5], deg, consts, n);
  return int(cudaGetLastError());
}

}  // namespace capk

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
  // P-256, P-384, P-521 (cuda_redc.KERNEL_SHAPES)
  if (ia == 23 && ib == 23)
    return capk::launch_madd<23, 23>(in, h, f, out, d, k, words, n, s);
  if (ia == 34 && ib == 33)
    return capk::launch_madd<34, 33>(in, h, f, out, d, k, words, n, s);
  if (ia == 45 && ib == 45)
    return capk::launch_madd<45, 45>(in, h, f, out, d, k, words, n, s);
  return int(cudaErrorInvalidValue);
}
