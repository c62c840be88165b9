// Keccak-f[1600] on bit-interleaved 32-bit lane pairs (FIPS 202).
//
// Replaces: cap_tpu/tpu/pallas_keccak.py, _f1600_kernel (via
// _f1600_call and f1600_pallas): the 24-round permutation of a batch
// of Keccak states, each 64-bit lane held as two uint32 words (word 0
// the even-indexed bits, word 1 the odd), so a 64-bit rotation is two
// 32-bit rotations. The tensor keeps the JAX layout, [n, 25, 2] words
// (lane-major, even word first), so every host packing and compare
// target matches the JAX package's word for word.
//
// What bounds it on the card: at the ML-DSA path's 1,024 states a
// launch, latency. The work (24 rounds of ~180 integer instructions a
// state) fills only 8 SMs when one thread runs a whole state, each
// walking one warp a scheduler through ~4,400 dependent steps. Split
// over a warp, a round is four dependent shuffle levels; at large
// batches the shuffle unit's rate bounds it instead (16 a state and
// round, about one warp shuffle a clock an SM), which makes 65,536
// states slower than the one-thread-a-state design. That size is on
// no path.
//
// Design: 25 threads a state, one state a warp: thread l holds lane l
// (its even and odd word) for all 24 rounds. Every exchange is a
// __shfl_sync from a lane that the per-thread table names (g_lane_tab,
// generated by keccak.lane_tables and uploaded once by
// cap_keccak_set_tables), so no register array is indexed by a
// thread-dependent value:
// - theta: the column parity in two shuffle levels (y+1, then y+2 of
//   that sum, with y+4 beside the first), D from x-1 and x+1;
// - rho: the thread's own rotation, amounts and the even/odd swap read
//   from the table;
// - pi and chi together: each thread takes its output lane and that
//   lane's two row neighbours straight from their pi sources;
// - iota: XOR under a mask that is all ones on lane 0 only.
// Threads 25..31 and the warps past the last state run on zero words
// and skip the store; every thread executes every shuffle. A warp reads
// and writes its state's 200 contiguous bytes, 8 bytes a thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace capk {

constexpr int kWarps = 4;                // states a block
constexpr int kLanes = 25;
constexpr int kTabRows = 12;             // keccak.LANE_TAB_ROWS

// RC_IL of keccak.py: the iota constants, interleaved (even, odd).
__constant__ uint32_t c_rc[24][2] = {
    {0x00000001u, 0x00000000u}, {0x00000000u, 0x00000089u},
    {0x00000000u, 0x8000008bu}, {0x00000000u, 0x80008080u},
    {0x00000001u, 0x0000008bu}, {0x00000001u, 0x00008000u},
    {0x00000001u, 0x80008088u}, {0x00000001u, 0x80000082u},
    {0x00000000u, 0x0000000bu}, {0x00000000u, 0x0000000au},
    {0x00000001u, 0x00008082u}, {0x00000000u, 0x00008003u},
    {0x00000001u, 0x0000808bu}, {0x00000001u, 0x8000000bu},
    {0x00000001u, 0x8000008au}, {0x00000001u, 0x80000081u},
    {0x00000000u, 0x80000081u}, {0x00000000u, 0x80000008u},
    {0x00000000u, 0x00000083u}, {0x00000000u, 0x80008003u},
    {0x00000001u, 0x80008088u}, {0x00000000u, 0x80000088u},
    {0x00000001u, 0x00008000u}, {0x00000000u, 0x80008082u},
};

// keccak.LANE_TAB, [kTabRows][32]: row k holds constant k of every
// thread of a warp (global memory, so a warp's 32 different words are
// one coalesced load, not 32 serialized constant reads).
__device__ int32_t g_lane_tab[kTabRows * 32];

__device__ __forceinline__ uint32_t rotl(uint32_t x, int s) {
  return __funnelshift_l(x, x, s);       // s & 31; s = 0 gives x
}

__device__ __forceinline__ uint32_t shfl(uint32_t v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}

__global__ void __launch_bounds__(32 * kWarps)
    keccak_kernel(const uint2* __restrict__ in, uint2* __restrict__ out,
                  int n) {
  const int t = threadIdx.x & 31;
  const long st = long(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const bool live = st < n && t < kLanes;
  const int32_t* tab = g_lane_tab + t;
  const int up1 = __ldg(tab), up2 = __ldg(tab + 32), up4 = __ldg(tab + 64);
  const int xm1 = __ldg(tab + 96), xp1 = __ldg(tab + 128);
  const int re = __ldg(tab + 160), ro = __ldg(tab + 192);
  const uint32_t swap = uint32_t(__ldg(tab + 224));
  const int pi0 = __ldg(tab + 256), pi1 = __ldg(tab + 288);
  const int pi2 = __ldg(tab + 320);
  const uint32_t iota = uint32_t(__ldg(tab + 352));
  uint2 w = make_uint2(0u, 0u);
  if (live) w = in[st * kLanes + t];
  uint32_t e = w.x, o = w.y;
#pragma unroll
  for (int rnd = 0; rnd < 24; ++rnd) {
    // theta: C[x] = A[x, y..y+4], then D[x] = C[x-1] ^ rot64(C[x+1], 1)
    const uint32_t se = e ^ shfl(e, up1), so = o ^ shfl(o, up1);
    const uint32_t fe = shfl(e, up4), fo = shfl(o, up4);
    const uint32_t ce = se ^ shfl(se, up2) ^ fe;
    const uint32_t co = so ^ shfl(so, up2) ^ fo;
    const uint32_t me = shfl(ce, xm1), mo = shfl(co, xm1);
    const uint32_t pe = shfl(ce, xp1), po = shfl(co, xp1);
    e ^= me ^ rotl(po, 1);
    o ^= mo ^ pe;
    // rho on the thread's own lane: an odd amount swaps the words
    const uint32_t be = rotl((o & swap) | (e & ~swap), re);
    const uint32_t bo = rotl((e & swap) | (o & ~swap), ro);
    // pi + chi: B[l] ^ (~B[x+1] & B[x+2]), each from its pi source
    const uint32_t b0e = shfl(be, pi0), b0o = shfl(bo, pi0);
    const uint32_t b1e = shfl(be, pi1), b1o = shfl(bo, pi1);
    const uint32_t b2e = shfl(be, pi2), b2o = shfl(bo, pi2);
    e = b0e ^ (~b1e & b2e) ^ (c_rc[rnd][0] & iota);
    o = b0o ^ (~b1o & b2o) ^ (c_rc[rnd][1] & iota);
  }
  if (live) out[st * kLanes + t] = make_uint2(e, o);
}

}  // namespace capk

#ifndef CAPK_NO_LAUNCH
// tab: keccak.LANE_TAB, [12, 32] int32, copied once per process before
// the first launch.
extern "C" int cap_keccak_set_tables(const void* tab) {
  return int(cudaMemcpyToSymbol(capk::g_lane_tab, tab,
                                sizeof(int32_t) * capk::kTabRows * 32));
}

// in, out: [n, 25, 2] uint32 words (int32 tensors), contiguous.
extern "C" int cap_keccak(const void* in, void* out, int n, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const uintptr_t ends = reinterpret_cast<uintptr_t>(in) |
                         reinterpret_cast<uintptr_t>(out);
  if (ends % 8) return int(cudaErrorMisalignedAddress);   // 8-byte lanes
  const int grid = (n + capk::kWarps - 1) / capk::kWarps;
  capk::keccak_kernel<<<grid, 32 * capk::kWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(in), static_cast<uint2*>(out), n);
  return int(cudaGetLastError());
}
#endif
