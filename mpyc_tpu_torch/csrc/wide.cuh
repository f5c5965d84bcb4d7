// The field arithmetic of the wide kernels (wide.cu: K3, K6, K7, K9;
// sgn_wide.cu: K5) on 7 to 48 limbs, L a run-time count: each element
// an array of WIDE_MAX_NL words, of which the first L are used (local
// memory, shared memory or device memory alike). Included after
// common.cuh.
#pragma once
#include <cstdint>

namespace mtt {

constexpr int WIDE_MIN_NL = 7;       // _build.WIDE_MIN_NL
constexpr int WIDE_MAX_NL = 48;      // _build.WIDE_MAX_NL (p < 2^1536)
constexpr int WIDE_THREADS = 128;
constexpr int WIDE_POW_TABLE = 8;   // x^1, x^3, .., x^15 (pow.cuh POW_TABLE)
static_assert(WIDE_MAX_NL + 2 <= 2 * RATE_WORDS,
              "a fused draw of at most two sponge blocks");

// (a + b) mod p for a, b < p; out may be a or b.
static __device__ void wadd_mod(const uint32_t* a, const uint32_t* b,
                                const uint32_t* p, int L, uint32_t* out) {
  MTT_COUNT_OP(1);
  uint32_t s[WIDE_MAX_NL];
  uint32_t carry = 0;
  for (int i = 0; i < L; ++i) {
    const uint64_t v = (uint64_t)a[i] + b[i] + carry;
    s[i] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
  uint32_t borrow = 0;
  for (int i = 0; i < L; ++i)
    borrow = (uint32_t)(((uint64_t)s[i] - p[i] - borrow) >> 63);
  if (carry || !borrow) {
    borrow = 0;
    for (int i = 0; i < L; ++i) {
      const uint64_t v = (uint64_t)s[i] - p[i] - borrow;
      out[i] = (uint32_t)v;
      borrow = (uint32_t)(v >> 63);
    }
  } else {
    for (int i = 0; i < L; ++i) out[i] = s[i];
  }
}

// (a - b) mod p for a, b < p; out may be a or b.
static __device__ void wsub_mod(const uint32_t* a, const uint32_t* b,
                                const uint32_t* p, int L, uint32_t* out) {
  MTT_COUNT_OP(1);
  uint32_t d[WIDE_MAX_NL];
  uint32_t borrow = 0;
  for (int i = 0; i < L; ++i) {
    const uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const uint32_t mask = 0u - borrow;   // add p back after a borrow
  uint32_t carry = 0;
  for (int i = 0; i < L; ++i) {
    const uint64_t v = (uint64_t)d[i] + (p[i] & mask) + carry;
    out[i] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
}

// Montgomery product a * b * R^-1 mod p by CIOS (limb.cuh mont_mul with L
// a run-time count). a < R, b < p (or both < p). Result < p; out may be
// a or b.
static __device__ void wmont_mul(const uint32_t* a, const uint32_t* b,
                                 const uint32_t* p, uint32_t n0inv, int L,
                                 uint32_t* out) {
  MTT_COUNT_OP(0);
  uint32_t t[WIDE_MAX_NL + 2];
  for (int i = 0; i < L + 2; ++i) t[i] = 0;
  for (int i = 0; i < L; ++i) {
    const uint32_t bi = b[i];
    uint32_t c = 0;
    for (int j = 0; j < L; ++j) {
      const uint64_t v = (uint64_t)a[j] * bi + t[j] + c;
      t[j] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
    }
    uint64_t v = (uint64_t)t[L] + c;
    t[L] = (uint32_t)v;
    t[L + 1] += (uint32_t)(v >> 32);
    const uint32_t m = t[0] * n0inv;
    v = (uint64_t)m * p[0] + t[0];
    c = (uint32_t)(v >> 32);
    for (int j = 1; j < L; ++j) {
      v = (uint64_t)m * p[j] + t[j] + c;
      t[j - 1] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
    }
    v = (uint64_t)t[L] + c;
    t[L - 1] = (uint32_t)v;
    t[L] = t[L + 1] + (uint32_t)(v >> 32);
    t[L + 1] = 0;
  }
  // t < 2p: subtract p where t >= p (or the word above it is set)
  uint32_t borrow = 0;
  for (int i = 0; i < L; ++i)
    borrow = (uint32_t)(((uint64_t)t[i] - p[i] - borrow) >> 63);
  if (t[L] || !borrow) {
    borrow = 0;
    for (int i = 0; i < L; ++i) {
      const uint64_t v = (uint64_t)t[i] - p[i] - borrow;
      out[i] = (uint32_t)v;
      borrow = (uint32_t)(v >> 63);
    }
  } else {
    for (int i = 0; i < L; ++i) out[i] = t[i];
  }
}

static __device__ __forceinline__ void wload(const uint32_t* base,
                                             long long e, int L,
                                             uint32_t* v) {
  for (int q = 0; q < L; ++q) v[q] = __ldg(base + e * L + q);
}

static __device__ __forceinline__ void wstore(uint32_t* base, long long e,
                                              int L, const uint32_t* v) {
  for (int q = 0; q < L; ++q) base[e * L + q] = v[q];
}

static __device__ __forceinline__ void wcopy(const uint32_t* a, int L,
                                             uint32_t* out) {
  for (int q = 0; q < L; ++q) out[q] = a[q];
}

// Words 0 .. n - 1 of a device buffer into shared memory, by the whole CTA
// (the caller synchronises).
static __device__ __forceinline__ void wstage(const uint32_t* src, int n,
                                              uint32_t* sm) {
  for (int q = threadIdx.x; q < n; q += blockDim.x) sm[q] = __ldg(src + q);
}

// A draw of W words (words[0 .. W - 1] of a block) into GF(p), Montgomery
// form: sum over its L-word chunks c of chunk_c * radix_c (reduce_draw).
static __device__ void wreduce_draw(const uint32_t* words, int W,
                                    const uint32_t* C, uint32_t n0inv, int L,
                                    uint32_t* out) {
  const int nc = (W + L - 1) / L;
  for (int c = 0; c < nc; ++c) {
    uint32_t chunk[WIDE_MAX_NL];
    for (int q = 0; q < L; ++q) {
      const int w = c * L + q;
      chunk[q] = w < W ? words[w] : 0u;
    }
    if (c == 0) {
      wmont_mul(chunk, C + L, C, n0inv, L, out);
    } else {
      wmont_mul(chunk, C + (1 + c) * L, C, n0inv, L, chunk);
      wadd_mod(out, chunk, C, L, out);
    }
  }
}

}  // namespace mtt
