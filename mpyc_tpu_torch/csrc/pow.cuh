// K6: a power with a public exponent, a^e R mod p for every Montgomery
// element of an array; K7: the tail of a round of random bits, built
// around the same power.
//
// No Pallas kernel of the JAX package computes either: XLA runs
// mpyc_tpu/ops/limb.py:330 mont_pow_const (a lax.scan over e's bits, via
// mpyc_tpu/ops/fieldops.py:550 pow_const) and the tail of
// mpyc_tpu/parallel/simulator.py:732 np_random_bits (:759-785). The plain
// versions are mpyc_tpu_torch/ops/limb.py mont_pow_const and
// mpyc_tpu_torch/models/pipelines.py _random_bits_tail_plain.
//
// What bounds them: integer instructions. A power is a chain of
// dependent Montgomery products (at SecFxp(14, 6)'s 52-bit field, e =
// (3p - 5) / 4 has 52 bits, 49 of them set), against 16 bytes moved an
// element at two limbs (K7: 73 bytes, r and z of three parties in, three
// bit shares and a flag out). So the design spends as few instructions on
// a product as it can:
// - The exponent is planned on the host (mpyc_tpu_torch/ops/fieldops.py
//   pow_plan): a left-to-right sliding window of up to 4 bits, a table
//   of the odd powers x^1..x^15 that the plan uses, then steps "square s
//   times, multiply by table entry j". 68 products at that e, where the
//   binary ladder does 99; there is no loop over e's bits, only a tight
//   loop of squarings a step.
// - The steps come in the parameter block and are copied once into
//   shared memory; the table lives in shared memory too, word (entry,
//   limb, slot) of a thread at [((entry NL + limb) EPT + slot)
//   threads + thread], so a warp reads 32 consecutive words. The entry is known
//   only at run time: in registers the table would go to local memory.
// - A squaring computes each cross product once and doubles it
//   (mont_sqr: 3 wide products where a general one takes 4 at two limbs,
//   6 where it takes 9 at three).
// - Where 4p < R (the 52-bit and 69-bit fields, and the LP solver's
//   102-, 136- and 142-bit ones), every product of the chain skips its
//   final subtraction (values stay below 2p) and one canonical() ends it
//   (LAZY). SecInt(32)'s 64-bit field takes the canonical products.
//   Built for one to six limbs, lazy or not: twenty-four kernels (a
//   one-limb field of p < 2^30 lazy, GF(2^31 - 1) canonical). From three
//   limbs on the products are the C++ form (the PTX carry chains are
//   written for two limbs). The table of odd powers is dynamic shared
//   memory (pow_smem_bytes): 40,960 bytes at five limbs, 24,576 at six
//   (one element a thread); with two a thread at six limbs it would take
//   49,152, past the 48 KB a CTA gets without opting in with the plan's
//   768 bytes of steps, and the launchers opt in where a table needs it. At two limbs the lazy products are PTX (limb.cuh):
//   a wide multiply for each 32 x 32-bit product and every carry in an
//   add.cc chain: 26 SASS instructions a squaring, where the C++ form
//   took 36.5 and moved its carries into registers on the multiply pipe.
// - Two elements a thread (pow_ept): two independent chains let the
//   scheduler fill one's multiply latency with the other's. One element
//   a thread was 15-18% slower on the card at two limbs (PERF.md).
//   At six limbs one (MTT_POW_EPT6), which halves the table to 24,576
//   bytes: 4-9% faster than two at the fixed-point LP's 139,104 random
//   bits, 3-6% slower at 2^20 (tools/pow_ab.py --six; PERF.md).
#pragma once
#include <cstdint>

#include "limb.cuh"

namespace mtt {

constexpr int POW_WINDOW = 4;                       // the widest window
constexpr int POW_TABLE = 1 << (POW_WINDOW - 1);    // x^1, x^3, .., x^15
constexpr int POW_MAX_STEPS = 32 * MAX_NL;           // a step a bit at most
constexpr int POW_THREADS = 128;

#ifndef MTT_POW_EPT6
#define MTT_POW_EPT6 1
#endif

// Elements a thread of the NL-limb instantiations.
template <int NL>
__host__ __device__ constexpr int pow_ept() {
  return NL <= 5 ? 2 : MTT_POW_EPT6;
}

// Dynamic shared memory of a K6 or K7 CTA: the table of odd powers,
// POW_TABLE entries of NL words for each element of the CTA.
template <int NL>
constexpr int pow_smem_bytes() {
  return POW_TABLE * NL * pow_ept<NL>() * POW_THREADS * 4;
}

// Mirrored by a ctypes structure in mpyc_tpu_torch/_build.py. Field
// constants fill the first nl limbs of their MAX_NL. The plan of e
// (pow_plan): x^(2 first + 1), then per step k square (step[k] & 0xFF)
// times and multiply by x^(2 (step[k] >> 8) + 1), then square tail times.
struct PowParams {
  uint32_t p[MAX_NL];
  uint32_t n0inv;
  uint32_t one[MAX_NL];   // R mod p: the power for e = 0
  int32_t nbits;          // bit length of e
  int32_t nl;             // limbs of the field
  int32_t n_table;        // odd powers the plan uses, 1..POW_TABLE
  int32_t first;
  int32_t n_steps;
  int32_t tail;
  uint32_t step[POW_MAX_STEPS];
};

// Copy the plan's steps into shared memory, each word at a constant index
// of the parameter block (a run-time index would put the block in local
// memory), before any thread leaves: step k by thread k mod POW_THREADS.
// An exponent below 2^(32 NL) has at most 32 NL steps (plan_ok), so an
// instantiation copies no more: copying all POW_MAX_STEPS cost the
// two-limb power 16 registers and a tenth of its time (PERF.md, PR 11).
template <int NL>
__device__ __forceinline__ void load_plan(const PowParams& P,
                                          uint32_t* steps) {
#pragma unroll
  for (int k = 0; k < 32 * NL; ++k)
    if ((int)threadIdx.x == k % POW_THREADS) steps[k] = P.step[k];
  __syncthreads();
}

template <int NL, int EPT>
__device__ __forceinline__ void table_put(uint32_t* col, int k,
                                          const uint32_t (&x)[EPT][NL]) {
#pragma unroll
  for (int q = 0; q < NL; ++q)
#pragma unroll
    for (int s = 0; s < EPT; ++s)
      col[((k * NL + q) * EPT + s) * POW_THREADS] = x[s][q];
}

template <int NL, int EPT>
__device__ __forceinline__ void table_get(const uint32_t* col, int k,
                                          uint32_t (&x)[EPT][NL]) {
#pragma unroll
  for (int q = 0; q < NL; ++q)
#pragma unroll
    for (int s = 0; s < EPT; ++s)
      x[s][q] = col[((k * NL + q) * EPT + s) * POW_THREADS];
}

template <int NL, bool LAZY>
__device__ __forceinline__ void pow_sqr(const uint32_t* a,
                                        const PowParams& P, uint32_t* out) {
  if constexpr (LAZY) mont_sqr_lazy<NL>(a, P.p, P.n0inv, out);
  else mont_sqr<NL>(a, P.p, P.n0inv, out);
}

template <int NL, bool LAZY>
__device__ __forceinline__ void pow_mul(const uint32_t* a, const uint32_t* b,
                                        const PowParams& P, uint32_t* out) {
  if constexpr (LAZY) mont_mul_lazy<NL>(a, b, P.p, P.n0inv, out);
  else mont_mul<NL>(a, b, P.p, P.n0inv, out);
}

// x[s] <- x[s]^e R mod p for the EPT elements of this thread (each
// < p), by the plan in P and `steps` (load_plan). tab: the block's
// table, POW_TABLE * NL * EPT * POW_THREADS words of shared memory.
// Canonical results.
template <int NL, bool LAZY, int EPT>
__device__ __forceinline__ void pow_by_plan(uint32_t (&x)[EPT][NL],
                                            const PowParams& P,
                                            const uint32_t* steps,
                                            uint32_t* tab) {
  if (P.nbits == 0) {
#pragma unroll
    for (int s = 0; s < EPT; ++s) fe_copy<NL>(P.one, x[s]);
    return;
  }
  uint32_t* col = tab + threadIdx.x;
  table_put<NL, EPT>(col, 0, x);
  if (P.n_table > 1) {
    uint32_t x2[EPT][NL];
#pragma unroll
    for (int s = 0; s < EPT; ++s) pow_sqr<NL, LAZY>(x[s], P, x2[s]);
#pragma unroll 1
    for (int k = 1; k < P.n_table; ++k) {
#pragma unroll
      for (int s = 0; s < EPT; ++s)
        pow_mul<NL, LAZY>(x[s], x2[s], P, x[s]);
      table_put<NL, EPT>(col, k, x);
    }
  }
  table_get<NL, EPT>(col, P.first, x);
#pragma unroll 1
  for (int k = 0; k < P.n_steps; ++k) {
    const uint32_t st = steps[k];
#pragma unroll 1
    for (int q = st & 0xFF; q > 0; --q) {
#pragma unroll
      for (int s = 0; s < EPT; ++s) pow_sqr<NL, LAZY>(x[s], P, x[s]);
    }
    uint32_t y[EPT][NL];
    table_get<NL, EPT>(col, st >> 8, y);
#pragma unroll
    for (int s = 0; s < EPT; ++s) pow_mul<NL, LAZY>(x[s], y[s], P, x[s]);
  }
#pragma unroll 1
  for (int q = P.tail; q > 0; --q) {
#pragma unroll
    for (int s = 0; s < EPT; ++s) pow_sqr<NL, LAZY>(x[s], P, x[s]);
  }
  if constexpr (LAZY) {
#pragma unroll
    for (int s = 0; s < EPT; ++s) canonical<NL>(x[s], P.p, x[s]);
  }
}

// K6: EPT elements a thread, POW_THREADS threads a block; slot s of
// a thread takes element blockIdx.x * POW_THREADS * EPT + s *
// POW_THREADS + threadIdx.x. A slot past n computes on 0 and stores nothing.
template <int NL, bool LAZY>
__global__ void __launch_bounds__(POW_THREADS)
mont_pow_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                long long n, PowParams P) {
  constexpr int EPT = pow_ept<NL>();
  extern __shared__ uint32_t pow_tab[];   // pow_smem_bytes<NL>()
  __shared__ uint32_t steps[POW_MAX_STEPS];
  uint32_t* tab = pow_tab;
  load_plan<NL>(P, steps);
  const long long base =
      (long long)blockIdx.x * (POW_THREADS * EPT) + threadIdx.x;
  uint32_t x[EPT][NL];
#pragma unroll
  for (int s = 0; s < EPT; ++s) {
    const long long e = base + s * POW_THREADS;
    if (e < n) {
      ldg_fe<NL>(a, e, x[s]);
    } else {
#pragma unroll
      for (int q = 0; q < NL; ++q) x[s][q] = 0;
    }
  }
  pow_by_plan<NL, LAZY, EPT>(x, P, steps, tab);
#pragma unroll
  for (int s = 0; s < EPT; ++s) {
    const long long e = base + s * POW_THREADS;
    if (e < n) store_fe<NL>(out, e, x[s]);
  }
}

// Mirrored by a ctypes structure in mpyc_tpu_torch/_build.py (K7).
struct TailParams {
  PowParams pow;             // the plan of (3p - 5) / 4
  uint32_t lag[MAX_SEND][MAX_NL];  // recombination at 0 of points 1..2t+1
  uint32_t scale[MAX_NL];    // a bit is r s scale (+ offset), Montgomery
  uint32_t offset[MAX_NL];
  int32_t has_scale, has_offset;
  int32_t t, m;
};

// K7 on (m, n, NL) shares r and z: per element u = sum_{i < 2t+1} lag_i
// (r_i^2 + z_i), the opening of r^2 + z at threshold 2t from parties
// 1..2t+1; flag u == 0 (and count it); s = u^((3p - 5) / 4) = 1 / sqrt(u)
// by the plan; bit_i = r_i (s scale) + offset for the m parties, with
// scale, offset = 2^(f - 1) for bits in {0, 1} ((r / sqrt(u) + 1) / 2
// times 2^f) and scale = 2^f, no offset, for signed bits. Exact field
// values, so equal to the plain version. Geometry as K6's. t and m are
// launch parameters (1 <= t <= MAX_T, 2t + 1 <= m <= MAX_M): the first
// three parties, senders at every t, are unrolled and their r stays in
// registers across the power; the loops over the other senders and
// parties are not unrolled (build time), read the Lagrange coefficients
// from shared memory (a run-time index into the parameter block would put
// the block in local memory) and their r again after the power (at m = 9
// and six limbs the r of all would take 54 words an element).
template <int NL, bool LAZY>
__global__ void __launch_bounds__(POW_THREADS)
random_bits_tail_kernel(const uint32_t* __restrict__ r,
                        const uint32_t* __restrict__ z,
                        uint32_t* __restrict__ bits,
                        uint8_t* __restrict__ flags, int* __restrict__ count,
                        long long n, TailParams P) {
  constexpr int EPT = pow_ept<NL>();
  constexpr int KEEP = 3;     // parties whose r stays in registers
  extern __shared__ uint32_t pow_tab[];   // pow_smem_bytes<NL>()
  __shared__ uint32_t steps[POW_MAX_STEPS];
  __shared__ uint32_t lag_s[MAX_SEND * NL];
  uint32_t* tab = pow_tab;
  const int ns = 2 * P.t + 1, m = P.m;
#pragma unroll
  for (int i = KEEP; i < MAX_SEND; ++i)
    copy_consts<NL>(reinterpret_cast<const uint32_t(&)[NL]>(P.lag[i]),
                    lag_s + i * NL, i < ns ? NL : 0);
  load_plan<NL>(P.pow, steps);   // synchronises
  const uint32_t* p = P.pow.p;
  const uint32_t n0inv = P.pow.n0inv;
  const long long base =
      (long long)blockIdx.x * (POW_THREADS * EPT) + threadIdx.x;
  uint32_t rs[EPT][KEEP][NL], u[EPT][NL];
#pragma unroll
  for (int s = 0; s < EPT; ++s) {
    const long long e = base + s * POW_THREADS;
    const long long ee = e < n ? e : n - 1;   // a slot past n: a copy
#pragma unroll
    for (int i = 0; i < KEEP; ++i) {
      uint32_t zi[NL], v[NL];
      ldg_fe<NL>(r + i * n * NL, ee, rs[s][i]);
      ldg_fe<NL>(z + i * n * NL, ee, zi);
      mont_sqr<NL>(rs[s][i], p, n0inv, v);
      add_mod<NL>(v, zi, p, v);
      mont_mul<NL>(v, P.lag[i], p, n0inv, v);
      if (i == 0) fe_copy<NL>(v, u[s]);
      else add_mod<NL>(u[s], v, p, u[s]);
    }
#pragma unroll 1
    for (int i = KEEP; i < ns; ++i) {
      uint32_t ri[NL], zi[NL], v[NL];
      ldg_fe<NL>(r + i * n * NL, ee, ri);
      ldg_fe<NL>(z + i * n * NL, ee, zi);
      mont_sqr<NL>(ri, p, n0inv, v);
      add_mod<NL>(v, zi, p, v);
      mont_mul<NL>(v, lag_s + i * NL, p, n0inv, v);
      add_mod<NL>(u[s], v, p, u[s]);
    }
    if (e < n) {
      const bool zero = is_zero<NL>(u[s]);
      flags[e] = (uint8_t)zero;
      if (zero) atomicAdd(count, 1);
    }
  }
  pow_by_plan<NL, LAZY, EPT>(u, P.pow, steps, tab);
#pragma unroll
  for (int s = 0; s < EPT; ++s) {
    const long long e = base + s * POW_THREADS;
    if (P.has_scale) mont_mul<NL>(u[s], P.scale, p, n0inv, u[s]);
#pragma unroll
    for (int i = 0; i < KEEP; ++i) {
      uint32_t b[NL];
      mont_mul<NL>(rs[s][i], u[s], p, n0inv, b);
      if (P.has_offset) add_mod<NL>(b, P.offset, p, b);
      if (e < n) store_fe<NL>(bits + i * n * NL, e, b);
    }
    if (e < n) {
#pragma unroll 1
      for (int i = KEEP; i < m; ++i) {
        uint32_t ri[NL], b[NL];
        ldg_fe<NL>(r + i * n * NL, e, ri);
        mont_mul<NL>(ri, u[s], p, n0inv, b);
        if (P.has_offset) add_mod<NL>(b, P.offset, p, b);
        store_fe<NL>(bits + i * n * NL, e, b);
      }
    }
  }
}

}  // namespace mtt
