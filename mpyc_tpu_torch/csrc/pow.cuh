// K6: a power with a public exponent, a^e R mod p for every Montgomery
// element of an array.
//
// No Pallas kernel of the JAX package computes it: XLA runs
// mpyc_tpu/ops/limb.py:330 mont_pow_const (a lax.scan over e's bits, via
// mpyc_tpu/ops/fieldops.py:549 pow_const); the port's plain version is
// mpyc_tpu_torch/ops/limb.py mont_pow_const. Its caller on the
// fixed-point path is the inverse square root of np_random_bits, for a
// Blum prime the exponent (3p - 5) / 4 (fieldops.py:616): at SecFxp(14,
// 6)'s 52-bit field 51 squarings and 48 products an element.
//
// Bound: integer operations (an L-limb product is 2 L^2 + L multiplies
// and 3 L^2 + 2 L adds, and any addition chain for that exponent takes at
// least 56 products, against 16 bytes moved an element at L = 2).
// Design: one thread per element, the value and the running power in
// registers; left-to-right square and multiply, a product only where a
// bit of e is set. e is the same for every thread, so the branch on its
// bit never diverges; its words come from the parameter block one at a
// time with a constant index (a word read at a run-time index would put
// the block in local memory). Built for two- and three-limb fields.
#pragma once
#include <cstdint>

#include "limb.cuh"

namespace mtt {

// Mirrored by a ctypes structure in mpyc_tpu_torch/_build.py. Field
// constants fill the first nl limbs of their MAX_NL; e < 2^(32 MAX_NL).
struct PowParams {
  uint32_t p[MAX_NL];
  uint32_t n0inv;
  uint32_t one[MAX_NL];   // R mod p: the power for e = 0
  uint32_t e[MAX_NL];     // exponent, little-endian words
  int32_t nbits;          // bit length of e
  int32_t nl;             // limbs of the field
};

template <int NL>
__global__ void __launch_bounds__(256)
mont_pow_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                long long n, PowParams P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NL], r[NL];
  ldg_fe<NL>(a, i, x);
  if (P.nbits == 0) {
    fe_copy<NL>(P.one, r);
  } else {
    fe_copy<NL>(x, r);   // the top bit
#pragma unroll
    for (int w = MAX_NL - 1; w >= 0; --w) {
      const uint32_t word = P.e[w];
#pragma unroll 1
      for (int b = 31; b >= 0; --b) {
        if (w * 32 + b >= P.nbits - 1) continue;
        mont_mul<NL>(r, r, P.p, P.n0inv, r);
        if ((word >> b) & 1u) mont_mul<NL>(r, x, P.p, P.n0inv, r);
      }
    }
  }
  store_fe<NL>(out, i, r);
}

}  // namespace mtt
