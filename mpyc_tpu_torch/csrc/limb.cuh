// Montgomery arithmetic on little-endian 32-bit limbs, R = 2^(32 L).
// Every function is a template on the limb count; the kernels are built
// for two-limb fields (p < 2^64) and three-limb fields (p < 2^96).
//
// Device counterpart of mpyc_tpu/ops/limb.py (mont_mul :247, add_mod :217,
// sub_mod :227, iszero_ll :195) and of its plain PyTorch version
// mpyc_tpu_torch/ops/limb.py.
// The TPU builds a 32x32->64-bit product from 16-bit halves; here each
// product is one wide multiply (mul.wide.u32: the low word and __umulhi's
// high word in one instruction), with the carries in 64-bit adds. Results
// are canonical (< p), so they equal the JAX package's limb for limb.
#pragma once
#include <cstdint>

// A host build that counts the field operations of a kernel (the bounds'
// operation counts are held against the source so) defines this: kind 0 a
// Montgomery product, 1 a modular add or subtract. Empty on the card.
#ifndef MTT_COUNT_OP
#define MTT_COUNT_OP(kind)
#endif

namespace mtt {

// Element e of an array of L-limb elements, the limbs consecutive words:
// one 8-byte access at L = 2, L 4-byte accesses otherwise (there is no
// 12-byte one). ldg_fe reads device memory that the kernel only reads;
// load_fe and store_fe read and write any memory, shared memory included.
template <int L>
__device__ __forceinline__ void ldg_fe(const uint32_t* __restrict__ base,
                                       long long e, uint32_t* v) {
  if constexpr (L == 2) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(base) + e);
    v[0] = w.x;
    v[1] = w.y;
  } else {
#pragma unroll
    for (int q = 0; q < L; ++q) v[q] = __ldg(base + e * L + q);
  }
}

template <int L>
__device__ __forceinline__ void load_fe(const uint32_t* base, long long e,
                                        uint32_t* v) {
  if constexpr (L == 2) {
    const uint2 w = reinterpret_cast<const uint2*>(base)[e];
    v[0] = w.x;
    v[1] = w.y;
  } else {
#pragma unroll
    for (int q = 0; q < L; ++q) v[q] = base[e * L + q];
  }
}

template <int L>
__device__ __forceinline__ void store_fe(uint32_t* base, long long e,
                                         const uint32_t* v) {
  if constexpr (L == 2) {
    reinterpret_cast<uint2*>(base)[e] = make_uint2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < L; ++q) base[e * L + q] = v[q];
  }
}

template <int L>
__device__ __forceinline__ void fe_copy(const uint32_t* a, uint32_t* out) {
#pragma unroll
  for (int q = 0; q < L; ++q) out[q] = a[q];
}

// (a + b) mod p for a, b < p.
template <int L>
__device__ __forceinline__ void add_mod(const uint32_t* a, const uint32_t* b,
                                        const uint32_t* p, uint32_t* out) {
  MTT_COUNT_OP(1);
  uint32_t s[L], d[L];
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t v = (uint64_t)a[i] + b[i] + carry;
    s[i] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t v = (uint64_t)s[i] - p[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const bool use_d = carry || !borrow;
#pragma unroll
  for (int i = 0; i < L; ++i) out[i] = use_d ? d[i] : s[i];
}

// (a - b) mod p for a, b < p.
template <int L>
__device__ __forceinline__ void sub_mod(const uint32_t* a, const uint32_t* b,
                                        const uint32_t* p, uint32_t* out) {
  MTT_COUNT_OP(1);
  uint32_t d[L];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add p back after a borrow
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t v = (uint64_t)d[i] + (p[i] & mask) + carry;
    out[i] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
}

// a == 0 (mpyc_tpu/ops/limb.py:195 iszero_ll).
template <int L>
__device__ __forceinline__ bool is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) acc |= a[i];
  return acc == 0;
}

// Montgomery product a * b * R^-1 mod p by CIOS. a < R, b < p (or both
// < p); n0inv = -p^-1 mod 2^32. Result < p.
template <int L>
__device__ __forceinline__ void mont_mul(const uint32_t* a, const uint32_t* b,
                                         const uint32_t* p, uint32_t n0inv,
                                         uint32_t* out) {
  MTT_COUNT_OP(0);
  uint32_t t[L + 2];
#pragma unroll
  for (int i = 0; i < L + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t v = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
    }
    uint64_t v = (uint64_t)t[L] + c;
    t[L] = (uint32_t)v;
    t[L + 1] += (uint32_t)(v >> 32);
    const uint32_t m = t[0] * n0inv;
    v = (uint64_t)m * p[0] + t[0];
    c = (uint32_t)(v >> 32);
#pragma unroll
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
  uint32_t d[L];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t v = (uint64_t)t[i] - p[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const bool use_d = (t[L] == 1) || !borrow;
#pragma unroll
  for (int i = 0; i < L; ++i) out[i] = use_d ? d[i] : t[i];
}

}  // namespace mtt
