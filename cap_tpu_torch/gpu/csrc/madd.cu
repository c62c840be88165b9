// One ladder window of the ES* verify: the RNS mixed add.
//
// Replaces: cap_tpu/tpu/pallas_madd.py, _madd_kernel (math in
// _madd_math, via _madd_call and madd_fused) — unpack the packed
// A|B<<16 table words, the Jacobian + affine mixed add (11 RNS
// multiplies, each a full REDC with both base extensions, plus the
// lazy adds and subs), the same-x degeneracy probe on 2 channels over
// 20 candidates, and the infinity lift and digit-0 select.
//
// What bounds it on the card: integer operations. Per lane it reads
// 186 and writes 139 int32 (about 1.3 KB) but runs 11 REDCs (~36k
// integer multiply-adds and ~1.6k Barrett fixes) — far more work per
// byte than the card's memory rate needs.
//
// Design: one thread per lane, blocks of 128 lanes, the ragged edge
// masked in the kernel (no padding). The per-context constants share
// the REDC kernel's shared-memory layout and its rns_ops.cuh code, so
// the two kernels cannot drift apart. The live state of a lane
// (X, Y, Z and a dozen temporaries of 46 residues each) exceeds the
// register file; what spills goes to local memory, cached in L1. The
// layer order and every lazy bound follow _madd_math exactly.
#include <cuda_runtime.h>

#include "rns_ops.cuh"

namespace capk {

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
  P X, Y, Z, x2, y2;
  load_pair<IA, IB>(xa, xb, n, lane, X);
  load_pair<IA, IB>(ya, yb, n, lane, Y);
  load_pair<IA, IB>(za, zb, n, lane, Z);
  unpack_words<IA, IB>(px, n, lane, x2);
  unpack_words<IA, IB>(py, n, lane, y2);

  // _madd_math, layer for layer (bounds documented in ec_rns._madd_rns).
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
  const P X3 = rfix<IA, IB>(
      k, rsub<IA, IB>(k, rsub<IA, IB>(k, r2, j, 4, 1), vv, 8, 2));
  rmul<IA, IB>(k, Y, j, y1j);
  rmul<IA, IB>(k, rr, rsub<IA, IB>(k, v, X3, 16, 1), t5);
  const P Y3 = rfix<IA, IB>(
      k, rsub<IA, IB>(k, t5, radd<IA, IB>(y1j, y1j), 8, 2));
  const P Z3 = rfix<IA, IB>(
      k, rsub<IA, IB>(k, rsub<IA, IB>(k, zh2, z1z1, 4, 1), hh, 4, 1));

  // same-x degeneracy probe (ec_rns.congruent_zero_probe): sufficient;
  // false positives only send the lane to the oracle.
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
  deg_p[lane] = (deg && !inf && has) ? 1 : 0;

  // infinity lift + digit-0 select (ec_rns add_from_table semantics)
  const bool lift = inf && has;
#pragma unroll
  for (int i = 0; i < IA; ++i) {
    oxa[i * n + lane] = has ? (lift ? x2.a[i] : X3.a[i]) : X.a[i];
    oya[i * n + lane] = has ? (lift ? y2.a[i] : Y3.a[i]) : Y.a[i];
    oza[i * n + lane] = has ? (lift ? k[L::oneA + i] : Z3.a[i]) : Z.a[i];
  }
#pragma unroll
  for (int j2 = 0; j2 < IB; ++j2) {
    oxb[j2 * n + lane] = has ? (lift ? x2.b[j2] : X3.b[j2]) : X.b[j2];
    oyb[j2 * n + lane] = has ? (lift ? y2.b[j2] : Y3.b[j2]) : Y.b[j2];
    ozb[j2 * n + lane] = has ? (lift ? k[L::oneB + j2] : Z3.b[j2]) : Z.b[j2];
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
  if (ia == 23 && ib == 23)
    return capk::launch_madd<23, 23>(
        in, static_cast<const uint8_t*>(has),
        static_cast<const uint8_t*>(inf), out, static_cast<uint8_t*>(deg),
        static_cast<const int*>(consts), words, n,
        static_cast<cudaStream_t>(stream));
  return int(cudaErrorInvalidValue);
}
