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
// What bounds it on the card: integer operations. A state reads and
// writes 200 bytes each, and runs 24 rounds of ~180 32-bit integer
// instructions (theta's parities as three-input XORs, rho's 46 funnel
// shifts, chi as one three-input logic op a word): about twice the
// time its bytes need at the card's memory rate.
//
// Design: one thread per state, the whole state (50 words) in
// registers for all 24 rounds, fully unrolled so every lane index is a
// constant; round constants in __constant__. A block of 128 threads
// stages its 128 states through shared memory (rows padded to 51
// words, so a warp's row reads hit distinct banks), so the loads and
// stores of device memory are coalesced although each thread owns 200
// contiguous bytes. The ragged edge is masked in the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace capk {

constexpr int kThreads = 128;
constexpr int kWords = 50;       // 25 lanes x (even, odd)
constexpr int kStride = 51;      // shared row pitch (odd: no bank clash)

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

// rho offset of flat lane l = x + 5y (FIPS 202 §3.2.2)
__host__ __device__ __forceinline__ constexpr int rho_of(int l) {
  return l == 0 ? 0 : l == 1 ? 1 : l == 2 ? 62 : l == 3 ? 28
       : l == 4 ? 27 : l == 5 ? 36 : l == 6 ? 44 : l == 7 ? 6
       : l == 8 ? 55 : l == 9 ? 20 : l == 10 ? 3 : l == 11 ? 10
       : l == 12 ? 43 : l == 13 ? 25 : l == 14 ? 39 : l == 15 ? 41
       : l == 16 ? 45 : l == 17 ? 15 : l == 18 ? 21 : l == 19 ? 8
       : l == 20 ? 18 : l == 21 ? 2 : l == 22 ? 61 : l == 23 ? 56 : 14;
}

// pi: input lane x + 5y lands at y + 5((2x + 3y) mod 5)
__host__ __device__ __forceinline__ constexpr int pi_dest(int l) {
  return l / 5 + 5 * ((2 * (l % 5) + 3 * (l / 5)) % 5);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int s) {
  return s == 0 ? x : __funnelshift_l(x, x, s);
}

// The permutation on one state: e[l], o[l] the even and odd words of
// lane l. The 64-bit rotation by r: even r rotates both words by r/2;
// odd r swaps them, the new even word rotating by (r+1)/2 and the new
// odd one by r/2.
__device__ __forceinline__ void f1600(uint32_t (&e)[25], uint32_t (&o)[25]) {
#pragma unroll
  for (int rnd = 0; rnd < 24; ++rnd) {
    uint32_t ce[5], co[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      ce[x] = e[x] ^ e[x + 5] ^ e[x + 10] ^ e[x + 15] ^ e[x + 20];
      co[x] = o[x] ^ o[x + 5] ^ o[x + 10] ^ o[x + 15] ^ o[x + 20];
    }
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint32_t de = ce[(x + 4) % 5] ^ rotl(co[(x + 1) % 5], 1);
      const uint32_t d_o = co[(x + 4) % 5] ^ ce[(x + 1) % 5];
#pragma unroll
      for (int y = 0; y < 25; y += 5) {
        e[x + y] ^= de;
        o[x + y] ^= d_o;
      }
    }
    uint32_t be[25], bo[25];
#pragma unroll
    for (int l = 0; l < 25; ++l) {
      const int r = rho_of(l);
      const int d = pi_dest(l);
      if (r & 1) {
        be[d] = rotl(o[l], (r + 1) / 2);
        bo[d] = rotl(e[l], r / 2);
      } else {
        be[d] = rotl(e[l], r / 2);
        bo[d] = rotl(o[l], r / 2);
      }
    }
#pragma unroll
    for (int l = 0; l < 25; ++l) {
      const int row = l - l % 5;
      e[l] = be[l] ^ (~be[row + (l + 1) % 5] & be[row + (l + 2) % 5]);
      o[l] = bo[l] ^ (~bo[row + (l + 1) % 5] & bo[row + (l + 2) % 5]);
    }
    e[0] ^= c_rc[rnd][0];
    o[0] ^= c_rc[rnd][1];
  }
}

__global__ void __launch_bounds__(kThreads)
    keccak_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  int n) {
  __shared__ uint32_t tile[kThreads * kStride];
  const long first = long(blockIdx.x) * kThreads;
  const int cnt = n - first < kThreads ? int(n - first) : kThreads;
  const uint32_t* src = in + first * kWords;
  for (int w = threadIdx.x; w < cnt * kWords; w += kThreads)
    tile[(w / kWords) * kStride + w % kWords] = src[w];
  __syncthreads();
  uint32_t e[25], o[25];
  uint32_t* mine = tile + threadIdx.x * kStride;
  if (threadIdx.x < cnt) {
#pragma unroll
    for (int l = 0; l < 25; ++l) {
      e[l] = mine[2 * l];
      o[l] = mine[2 * l + 1];
    }
    f1600(e, o);
#pragma unroll
    for (int l = 0; l < 25; ++l) {
      mine[2 * l] = e[l];
      mine[2 * l + 1] = o[l];
    }
  }
  __syncthreads();
  uint32_t* dst = out + first * kWords;
  for (int w = threadIdx.x; w < cnt * kWords; w += kThreads)
    dst[w] = tile[(w / kWords) * kStride + w % kWords];
}

}  // namespace capk

// in, out: [n, 25, 2] uint32 words (int32 tensors), contiguous.
extern "C" int cap_keccak(const void* in, void* out, int n, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const int grid = (n + capk::kThreads - 1) / capk::kThreads;
  capk::keccak_kernel<<<grid, capk::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n);
  return int(cudaGetLastError());
}
