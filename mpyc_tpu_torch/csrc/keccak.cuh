// Keccak-f[1600] on one thread's 25 native 64-bit lanes.
//
// Device counterpart of mpyc_tpu/ops/keccak.py:94 _keccak_round. The TPU
// has no 64-bit lanes and splits every lane into hi/lo 32-bit words; here
// a lane is a uint64_t held in registers, and each rotation by a constant
// compiles to a pair of funnel shifts (SHF). The lane order, round
// constants and rotation offsets are FIPS 202's, as in the JAX package,
// so the output is hashlib's bit for bit.
#pragma once
#include <cstdint>

// A host build that counts the permutations a kernel runs defines this
// (tests/test_torch_kernels_host.py). Empty on the card.
#ifndef MTT_COUNT_PERM
#define MTT_COUNT_PERM()
#endif

namespace mtt {

static __constant__ uint64_t kKeccakRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

// rho offset of lane x + 5y
__host__ __device__ constexpr int keccak_rot(int lane) {
  return lane == 0 ? 0 : lane == 1 ? 1 : lane == 2 ? 62 : lane == 3 ? 28
       : lane == 4 ? 27 : lane == 5 ? 36 : lane == 6 ? 44 : lane == 7 ? 6
       : lane == 8 ? 55 : lane == 9 ? 20 : lane == 10 ? 3 : lane == 11 ? 10
       : lane == 12 ? 43 : lane == 13 ? 25 : lane == 14 ? 39 : lane == 15 ? 41
       : lane == 16 ? 45 : lane == 17 ? 15 : lane == 18 ? 21 : lane == 19 ? 8
       : lane == 20 ? 18 : lane == 21 ? 2 : lane == 22 ? 61 : lane == 23 ? 56
       : 14;
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return r == 0 ? x : (x << r) | (x >> (64 - r));
}

// The 24 rounds; the round body is unrolled so every lane index is a
// constant and the state never leaves registers.
__device__ __forceinline__ void keccak_f1600(uint64_t* A) {
  MTT_COUNT_PERM();
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    uint64_t C[5], D[5], B[25];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      C[x] = A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      D[x] = C[(x + 4) % 5] ^ rotl64(C[(x + 1) % 5], 1);
    // theta, rho and pi: lane (x, y) moves to (y, 2x + 3y)
#pragma unroll
    for (int x = 0; x < 5; ++x) {
#pragma unroll
      for (int y = 0; y < 5; ++y) {
        B[y + 5 * ((2 * x + 3 * y) % 5)] =
            rotl64(A[x + 5 * y] ^ D[x], keccak_rot(x + 5 * y));
      }
    }
    // chi
#pragma unroll
    for (int y = 0; y < 5; ++y) {
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        A[x + 5 * y] = B[x + 5 * y] ^
                       (~B[(x + 1) % 5 + 5 * y] & B[(x + 2) % 5 + 5 * y]);
      }
    }
    A[0] ^= kKeccakRC[round];  // iota
  }
}

// The absorbed state as the port stores it: (2, 25) uint32, row 0 the high
// and row 1 the low words of the lanes.
__device__ __forceinline__ void load_state(const uint32_t* __restrict__ st,
                                           uint64_t* A) {
#pragma unroll
  for (int k = 0; k < 25; ++k)
    A[k] = ((uint64_t)__ldg(st + k) << 32) | __ldg(st + 25 + k);
}

// A[lane] ^= v for a lane index known only at run time, as a masked XOR
// into every lane. With the branch `if (k == lane) A[k] ^= v` instead,
// ptxas (sm_90a) gives K1 and K2 a 200-byte stack frame, the whole state
// in local memory, as for an array indexed at run time; with the mask they
// have no stack frame and the state stays in registers.
__device__ __forceinline__ void xor_lane(uint64_t* A, int lane, uint64_t v) {
#pragma unroll
  for (int k = 0; k < 25; ++k)
    A[k] ^= v & (0ull - (uint64_t)(k == lane));
}

// Rate word w (0..41) of a squeezed block: [lo0, hi0, lo1, hi1, ...].
__device__ __forceinline__ uint32_t rate_word(const uint64_t* A, int w) {
  return (w & 1) ? (uint32_t)(A[w >> 1] >> 32) : (uint32_t)A[w >> 1];
}

}  // namespace mtt
