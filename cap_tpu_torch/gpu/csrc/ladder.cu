// The whole ES ladder in one launch: every window's mixed add with the
// state kept by its thread.
//
// Replaces: cap_tpu/tpu/pallas_madd.py, _ladder_kernel (via _ladder_call
// and ladder_fused) — all W windows of the per-window kernel (madd.cu),
// the accumulator starting at infinity (zero planes, inf = 1), each
// window's entry infinity the sequential form of JAX's exclusive
// any-scan (inf &= !has after the window), the same-x flags ORed over
// the windows, and the state written out once. Returns what
// ladder_fused returns: X, Y, Z residue planes, the final infinity
// mask and the OR of the degeneracy flags.
//
// What bounds it on the card: integer operations, W times madd's
// (11 REDCs a window). Per lane it reads one packed table row
// (2·iap int32) and one digit a window, and writes the state once:
// for P-256, 32 windows of 188 B and 552 B out, ~6.6 KB against ~1.5M
// integer operations.
//
// Design: one thread per lane, blocks of 128 lanes, the ragged edge
// masked. The context constants are loaded into static shared memory
// once a block for all W windows (46,440 B at 45+45 channels, within
// the 48 KB static limit). The sum and the probe are madd_math.cuh's,
// shared with the per-window kernel, so the two cannot diverge; the
// lift and select write into the registers carried to the next
// window. The ES path runs this kernel on the curves where it beats
// the per-window one (ec_rns.WHOLE_LADDER_CURVES). Unlike JAX's
// kernel, which streams a pre-gathered [W, 2·iap, M] table block a
// window, each thread gathers its own row of the row-major
// [rows, 2·iap] table (row = i·win_stride + base + d − 1 for a digit
// d > 0, the row at base for d = 0, whose sum is discarded): the
// table of a few keys is L2-resident, and the pre-gather would move
// W·2·iap·4 bytes a lane through device memory twice. The X, Y, Z
// state (3·(I_A + I_B) residues) lives across the window loop; what
// does not fit the registers spills to local memory, cached in L1.
#include <cuda_runtime.h>

#include "madd_math.cuh"

namespace capk {

struct LadderOut {
  int* xa;
  int* xb;
  int* ya;
  int* yb;
  int* za;
  int* zb;
  uint8_t* inf;
  uint8_t* deg;
};

template <int IA, int IB>
__global__ void __launch_bounds__(128)
    ladder_kernel(const int* __restrict__ tab, const int* __restrict__ d_all,
                  const int* __restrict__ base, int win_stride,
                  int n_windows, const LadderOut out,
                  const int* __restrict__ consts, int m) {
  using L = Layout<IA, IB>;
  using P = Pair<IA, IB>;
  constexpr int IAP = IA > IB ? IA : IB;
  __shared__ int k[L::words];
  load_consts(k, consts, L::words);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= m) return;

  P X = {}, Y = {}, Z = {};
  bool inf = true, deg = false;
  const int row_base = base[lane];
#pragma unroll 1
  for (int i = 0; i < n_windows; ++i) {
    const int d = d_all[static_cast<size_t>(i) * m + lane];
    const bool has = d > 0;
    const int r = i * win_stride + row_base + (has ? d - 1 : 0);
    const int* row = tab + static_cast<size_t>(r) * (2 * IAP);
    P x2, y2, X3, Y3, Z3;
    unpack_row<IA, IB>(row, x2);
    unpack_row<IA, IB>(row + IAP, y2);
    const bool hit = madd_math<IA, IB>(k, X, Y, Z, x2, y2, X3, Y3, Z3);
    deg = deg || (hit && has && !inf);
    // infinity lift + digit-0 select, into the carried state
    if (has) {
#pragma unroll
      for (int a = 0; a < IA; ++a) {
        X.a[a] = inf ? x2.a[a] : X3.a[a];
        Y.a[a] = inf ? y2.a[a] : Y3.a[a];
        Z.a[a] = inf ? k[L::oneA + a] : Z3.a[a];
      }
#pragma unroll
      for (int b = 0; b < IB; ++b) {
        X.b[b] = inf ? x2.b[b] : X3.b[b];
        Y.b[b] = inf ? y2.b[b] : Y3.b[b];
        Z.b[b] = inf ? k[L::oneB + b] : Z3.b[b];
      }
    }
    inf = inf && !has;
  }
  store_pair<IA, IB>(out.xa, out.xb, m, lane, X);
  store_pair<IA, IB>(out.ya, out.yb, m, lane, Y);
  store_pair<IA, IB>(out.za, out.zb, m, lane, Z);
  out.inf[lane] = inf ? 1 : 0;
  out.deg[lane] = deg ? 1 : 0;
}

template <int IA, int IB>
int launch_ladder(const int* tab, const int* d_all, const int* base,
                  int win_stride, int n_windows, const LadderOut& out,
                  const int* consts, int words, int m,
                  cudaStream_t stream) {
  if (words != Layout<IA, IB>::words) return int(cudaErrorInvalidValue);
  const int threads = 128;
  ladder_kernel<IA, IB><<<(m + threads - 1) / threads, threads, 0, stream>>>(
      tab, d_all, base, win_stride, n_windows, out, consts, m);
  return int(cudaGetLastError());
}

}  // namespace capk

// tab: [rows, 2·iap] packed x‖y words, row-major; d_all: [n_windows, m]
// digits; base: [m] per-lane slot base. Outputs: X, Y, Z planes
// ([I_A, m] and [I_B, m] each), inf and deg [m] bytes.
extern "C" int cap_ladder(const void* tab, const void* d_all,
                          const void* base, int win_stride, int n_windows,
                          void* oxa, void* oxb, void* oya, void* oyb,
                          void* oza, void* ozb, void* inf, void* deg,
                          const void* consts, int words, int m, int ia,
                          int ib, void* stream) {
  if (m <= 0 || n_windows <= 0) return int(cudaErrorInvalidValue);
  const capk::LadderOut out = {
      static_cast<int*>(oxa),     static_cast<int*>(oxb),
      static_cast<int*>(oya),     static_cast<int*>(oyb),
      static_cast<int*>(oza),     static_cast<int*>(ozb),
      static_cast<uint8_t*>(inf), static_cast<uint8_t*>(deg)};
  const auto* t = static_cast<const int*>(tab);
  const auto* d = static_cast<const int*>(d_all);
  const auto* b = static_cast<const int*>(base);
  const auto* k = static_cast<const int*>(consts);
  auto s = static_cast<cudaStream_t>(stream);
  // P-256, P-384, P-521 (cuda_redc.KERNEL_SHAPES)
  if (ia == 23 && ib == 23)
    return capk::launch_ladder<23, 23>(t, d, b, win_stride, n_windows, out,
                                       k, words, m, s);
  if (ia == 34 && ib == 33)
    return capk::launch_ladder<34, 33>(t, d, b, win_stride, n_windows, out,
                                       k, words, m, s);
  if (ia == 45 && ib == 45)
    return capk::launch_ladder<45, 45>(t, d, b, win_stride, n_windows, out,
                                       k, words, m, s);
  return int(cudaErrorInvalidValue);
}
