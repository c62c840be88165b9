// The whole ES ladder in one launch: every window's mixed add with the
// state kept in its group's registers.
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
// for P-256, 32 windows of 188 B and 552 B out, ~6.6 KB against ~0.5M
// integer instructions.
//
// Design: madd.cu's — each lane over a group of T threads (rns_int.cuh),
// the sum and probe of madd_math.cuh, the constants loaded into shared
// memory once a block for all W windows. X, Y, Z stay in the group's
// registers across the windows. Each thread gathers only its share of
// the lane's table row (row = i·win_stride + base + d − 1 for a digit
// d > 0, the row at base for d = 0, whose sum is discarded) from the
// row-major [rows, 2·iap] table. The digits may be of any width up to
// 16 bits (2^w − 1 rows a slot and window, the index in int). The
// table of G and 8 P-256 keys fits the H100's 50 MB L2 at 8-bit
// windows (13.5 MB); at 12-bit windows it does not (149 MB; P-384
// 321 MB, P-521 584 MB), nor does a 300-key table at 8 bits, and the
// gathers then come from device memory, a window's rows scattered
// over its (keys + 1)·(2^w − 1) rows. The next
// window's share is copied into shared memory by cp.async while the
// current window computes (on the H100 as fast as a register
// prefetch on P-256 and 5% faster on P-384 and P-521, where the
// registers are scarcer). A digit-0 lane
// keeps its state: it is parked in the output planes before the sum
// and read back after it, so the sum's live set does not carry it;
// the infinity lift re-reads the table point. Unlike JAX's kernel,
// which streams a pre-gathered [W, 2·iap, M] table block a window, the
// gather stays in the kernel: the pre-gather would move W·2·iap·4
// bytes a lane through device memory twice. The ES path runs this
// kernel on every curve: it beats the per-window one on all three
// (ladder_bench.py, PERF.md).
#include <cuda_runtime.h>

#include "madd_math.cuh"

namespace capk {
namespace ri {

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

// Copy this thread's words of a packed table row (its share of the x
// words, then of the y words) into its C + C words of shared memory by
// cp.async, one 4-byte copy a word, committed as one group;
// cp_async_wait() waits for them.
template <int IAP, int C>
__device__ __forceinline__ void fetch_row(int* dst, const int* row, int t) {
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = t * C + i < IAP ? t * C + i : IAP - 1;
#ifdef __CUDA_ARCH__
    const auto sx = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    const auto sy =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + C + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(sx),
                 "l"(row + c) : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(sy),
                 "l"(row + IAP + c) : "memory");
#else
    dst[i] = row[c];
    dst[C + i] = row[IAP + c];
#endif
  }
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}

__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// Park (to) or fetch (!to) this thread's share of a value in the
// lane's column of [I_A, m] / [I_B, m] planes.
template <int IA, int IB, int C>
__device__ __forceinline__ void park(int* pa, int* pb, int m, int lane,
                                     int t, Share<C, C>& v, bool to) {
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = t * C + i;
    if (c < IA) {
      int* p = pa + static_cast<size_t>(c) * m + lane;
      if (to) st_cg(p, v.a[i]); else v.a[i] = ld_cg(p);
    }
    if (c < IB) {
      int* p = pb + static_cast<size_t>(c) * m + lane;
      if (to) st_cg(p, v.b[i]); else v.b[i] = ld_cg(p);
    }
  }
}

template <int IA, int IB, int T>
__global__ void __launch_bounds__(kThreads)
    ladder_kernel(const int* __restrict__ tab, const int* __restrict__ d_all,
                  const int* __restrict__ base, int win_stride,
                  int n_windows, const LadderOut out,
                  const int* __restrict__ consts, int m) {
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
  const bool valid = lane < m;
  const int ln = valid ? lane : m - 1;
  const int t = g.t;
  const int row_base = base[ln];

  Sh X = {}, Y = {}, Z = {};
  bool inf = true, deg = false;
  int d = d_all[ln];
  const int* row = tab + static_cast<size_t>(row_base + (d > 0 ? d - 1 : 0)) *
                             (2 * IAP);
  // the row buffer is this thread's own: no barrier orders it
  __shared__ __align__(16) int rowbuf[kThreads * 2 * C];
  int* const mine = rowbuf + threadIdx.x * 2 * C;
  fetch_row<IAP, C>(mine, row, t);
#pragma unroll 1
  for (int i = 0; i < n_windows; ++i) {
    const bool has = d > 0;
    cp_async_wait();
    // the raw words, decoded only where the sum takes them: a decoded
    // share is twice the registers
    int wx[C], wy[C];
#pragma unroll
    for (int j = 0; j < C; ++j) wx[j] = mine[j], wy[j] = mine[C + j];
    // the next window's digit and row share, fetched under this window
    // into the words just read. cp.async is not ordered after the
    // thread's own shared loads; a barrier between the reads of a
    // buffer and the copies that overwrite it orders them (the CUDA C++
    // Programming Guide's single-stage memcpy_async loop), and the
    // lane's group is one warp's.
    const int inext = i + 1 < n_windows ? i + 1 : i;
    const int dn = d_all[static_cast<size_t>(inext) * m + ln];
    const int* row_n =
        tab + static_cast<size_t>(inext * win_stride + row_base +
                                  (dn > 0 ? dn - 1 : 0)) * (2 * IAP);
    __syncwarp();
    fetch_row<IAP, C>(mine, row_n, t);

    if (!has && valid) {
      park<IA, IB, C>(out.xa, out.xb, m, lane, t, X, true);
      park<IA, IB, C>(out.ya, out.yb, m, lane, t, Y, true);
      park<IA, IB, C>(out.za, out.zb, m, lane, t, Z, true);
    }
    Sh X3, Y3, Z3;
    const bool hit = madd_sum<IA, IB, T>(g, X, Y, Z, decode<IA, IB, C>(wx, t),
                                         decode<IA, IB, C>(wy, t), X3, Y3,
                                         Z3);
    deg = deg || (hit && has && !inf);
    // infinity lift + digit-0 select, into the carried state
    if (!has) {
      if (valid) {
        park<IA, IB, C>(out.xa, out.xb, m, lane, t, X, false);
        park<IA, IB, C>(out.ya, out.yb, m, lane, t, Y, false);
        park<IA, IB, C>(out.za, out.zb, m, lane, t, Z, false);
      }
    } else if (inf) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int c = t * C + j < IAP ? t * C + j : IAP - 1;
        wx[j] = ld_cg(row + c);
        wy[j] = ld_cg(row + IAP + c);
      }
      X = decode<IA, IB, C>(wx, t);
      Y = decode<IA, IB, C>(wy, t);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        Z.a[j] = k[L::oneA + t * C + j];
        Z.b[j] = k[L::oneB + t * C + j];
      }
    } else {
      X = X3, Y = Y3, Z = Z3;
    }
    inf = inf && !has;
    d = dn;
    row = row_n;
  }
  if (!valid) return;
  park<IA, IB, C>(out.xa, out.xb, m, lane, t, X, true);
  park<IA, IB, C>(out.ya, out.yb, m, lane, t, Y, true);
  park<IA, IB, C>(out.za, out.zb, m, lane, t, Z, true);
  if (t == 0) {
    out.inf[lane] = inf ? 1 : 0;
    out.deg[lane] = deg ? 1 : 0;
  }
}

#ifndef CAPK_NO_LAUNCH
template <int IA, int IB>
int launch_ladder(const int* tab, const int* d_all, const int* base,
                  int win_stride, int n_windows, const LadderOut& out,
                  const int* consts, int words, int m,
                  cudaStream_t stream) {
  if (words != KLayout<IA, IB>::words) return int(cudaErrorInvalidValue);
  constexpr int T = kGroup<IA, IB>;
  constexpr int lanes = Group<IA, IB, T>::kLanes;
  ladder_kernel<IA, IB, T><<<(m + lanes - 1) / lanes, kThreads, 0, stream>>>(
      tab, d_all, base, win_stride, n_windows, out, consts, m);
  return int(cudaGetLastError());
}
#endif

}  // namespace ri
}  // namespace capk

#ifndef CAPK_NO_LAUNCH
// tab: [rows, 2·iap] packed x‖y words, row-major; d_all: [n_windows, m]
// digits; base: [m] per-lane slot base; consts: cuda_madd.madd_consts.
// Outputs: X, Y, Z planes ([I_A, m] and [I_B, m] each), inf and deg
// [m] bytes.
extern "C" int cap_ladder(const void* tab, const void* d_all,
                          const void* base, int win_stride, int n_windows,
                          void* oxa, void* oxb, void* oya, void* oyb,
                          void* oza, void* ozb, void* inf, void* deg,
                          const void* consts, int words, int m, int ia,
                          int ib, void* stream) {
  if (m <= 0 || n_windows <= 0) return int(cudaErrorInvalidValue);
  const capk::ri::LadderOut out = {
      static_cast<int*>(oxa),     static_cast<int*>(oxb),
      static_cast<int*>(oya),     static_cast<int*>(oyb),
      static_cast<int*>(oza),     static_cast<int*>(ozb),
      static_cast<uint8_t*>(inf), static_cast<uint8_t*>(deg)};
  const auto* t = static_cast<const int*>(tab);
  const auto* d = static_cast<const int*>(d_all);
  const auto* b = static_cast<const int*>(base);
  const auto* k = static_cast<const int*>(consts);
  auto s = static_cast<cudaStream_t>(stream);
  using capk::ri::launch_ladder;
  // P-256, P-384, P-521 (cuda_redc.KERNEL_SHAPES)
  if (ia == 23 && ib == 23)
    return launch_ladder<23, 23>(t, d, b, win_stride, n_windows, out, k,
                                 words, m, s);
  if (ia == 34 && ib == 33)
    return launch_ladder<34, 33>(t, d, b, win_stride, n_windows, out, k,
                                 words, m, s);
  if (ia == 45 && ib == 45)
    return launch_ladder<45, 45>(t, d, b, win_stride, n_windows, out, k,
                                 words, m, s);
  return int(cudaErrorInvalidValue);
}
#endif
