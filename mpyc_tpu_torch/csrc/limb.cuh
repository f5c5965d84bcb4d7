// Montgomery arithmetic on little-endian 32-bit limbs, R = 2^(32 L).
// Every function is a template on the limb count; the kernels are built
// for fields of one to six limbs (p < 2^192; _build.py BUILT_NL). At one
// limb every loop over limbs above the first is empty: a product is one
// wide multiply and one row of reduction.
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

// The steps of a Montgomery product a * b * R^-1 mod p by CIOS, without
// its final subtraction: t[0..L] < a + p. a < R, b's limbs any words.
template <int L>
__device__ __forceinline__ void mont_mul_cios(const uint32_t* a,
                                              const uint32_t* b,
                                              const uint32_t* p,
                                              uint32_t n0inv, uint32_t* t) {
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
}

// out = t - p if t >= p (or the word above t is set), else t: a value
// below 2p brought below p.
template <int L>
__device__ __forceinline__ void sub_p_if_above(const uint32_t* t, bool over,
                                               const uint32_t* p,
                                               uint32_t* out) {
  uint32_t d[L];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t v = (uint64_t)t[i] - p[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const bool use_d = over || !borrow;
#pragma unroll
  for (int i = 0; i < L; ++i) out[i] = use_d ? d[i] : t[i];
}

// Montgomery product a * b * R^-1 mod p by CIOS. a < R, b < p (or both
// < p); n0inv = -p^-1 mod 2^32. Result < p.
template <int L>
__device__ __forceinline__ void mont_mul(const uint32_t* a, const uint32_t* b,
                                         const uint32_t* p, uint32_t n0inv,
                                         uint32_t* out) {
  MTT_COUNT_OP(0);
  uint32_t t[L + 2];
  mont_mul_cios<L>(a, b, p, n0inv, t);
  sub_p_if_above<L>(t, t[L] == 1, p, out);
}

// a brought below p, for a < 2p (the end of a lazy chain).
template <int L>
__device__ __forceinline__ void canonical(const uint32_t* a,
                                          const uint32_t* p, uint32_t* out) {
  sub_p_if_above<L>(a, false, p, out);
}

#if defined(__CUDA_ARCH__)
// Two-limb Montgomery reduction of the 4-word t in PTX: each 32 x 32-bit
// product one wide multiply (mul.wide.u32, both halves), every carry in
// the carry flag of an add.cc/addc chain (64-bit adds in C++ put each
// carry into a register). Result t[2..3]; where t < 2 R p the word above
// it is 0, so no carry leaves t3.
#define MTT_REDC2(t0, t1, t2, t3, p0, p1, n0inv)                         \
  asm("{\n\t.reg .u32 m, x0, x1, y0, y1;\n\t.reg .u64 w;\n\t"          \
      "mul.lo.u32 m, %0, %6;\n\t"                                       \
      "mul.wide.u32 w, m, %4;\n\tmov.b64 {x0, x1}, w;\n\t"              \
      "mul.wide.u32 w, m, %5;\n\tmov.b64 {y0, y1}, w;\n\t"              \
      "add.cc.u32 %0, %0, x0;\n\t"                                      \
      "addc.cc.u32 %1, %1, x1;\n\t"                                     \
      "addc.cc.u32 %2, %2, y1;\n\t"                                     \
      "addc.u32 %3, %3, 0;\n\t"                                         \
      "add.cc.u32 %1, %1, y0;\n\t"                                      \
      "addc.cc.u32 %2, %2, 0;\n\t"                                      \
      "addc.u32 %3, %3, 0;\n\t"                                         \
      "mul.lo.u32 m, %1, %6;\n\t"                                       \
      "mul.wide.u32 w, m, %4;\n\tmov.b64 {x0, x1}, w;\n\t"              \
      "mul.wide.u32 w, m, %5;\n\tmov.b64 {y0, y1}, w;\n\t"              \
      "add.cc.u32 %1, %1, x0;\n\t"                                      \
      "addc.cc.u32 %2, %2, x1;\n\t"                                     \
      "addc.u32 %3, %3, y1;\n\t"                                        \
      "add.cc.u32 %2, %2, y0;\n\t"                                      \
      "addc.u32 %3, %3, 0;\n\t}"                                        \
      : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3)                           \
      : "r"(p0), "r"(p1), "r"(n0inv))
#endif

// Lazy reduction, valid only where 4p < R: a, b < 2p give a * b * R^-1
// mod p below 2p (t < (4 p^2 + R p) / R < 2p), with no final
// subtraction. A chain of lazy products ends with canonical(). On the
// card two limbs take carry chains in PTX (the same values).
template <int L>
__device__ __forceinline__ void mont_mul_lazy(const uint32_t* a,
                                              const uint32_t* b,
                                              const uint32_t* p,
                                              uint32_t n0inv, uint32_t* out) {
  MTT_COUNT_OP(0);
#if defined(__CUDA_ARCH__)
  if constexpr (L == 2) {
    uint32_t t0, t1, t2, t3;
    asm("{\n\t.reg .u32 x0, x1, y0, y1;\n\t.reg .u64 w;\n\t"
        "mul.wide.u32 w, %4, %6;\n\tmov.b64 {%0, %1}, w;\n\t"
        "mul.wide.u32 w, %5, %7;\n\tmov.b64 {%2, %3}, w;\n\t"
        "mul.wide.u32 w, %4, %7;\n\tmov.b64 {x0, x1}, w;\n\t"
        "mul.wide.u32 w, %5, %6;\n\tmov.b64 {y0, y1}, w;\n\t"
        "add.cc.u32 %1, %1, x0;\n\t"
        "addc.cc.u32 %2, %2, x1;\n\t"
        "addc.u32 %3, %3, 0;\n\t"
        "add.cc.u32 %1, %1, y0;\n\t"
        "addc.cc.u32 %2, %2, y1;\n\t"
        "addc.u32 %3, %3, 0;\n\t}"
        : "=&r"(t0), "=&r"(t1), "=&r"(t2), "=&r"(t3)
        : "r"(a[0]), "r"(a[1]), "r"(b[0]), "r"(b[1]));
    MTT_REDC2(t0, t1, t2, t3, p[0], p[1], n0inv);
    out[0] = t2;
    out[1] = t3;
    return;
  }
#endif
  uint32_t t[L + 2];
  mont_mul_cios<L>(a, b, p, n0inv, t);
#pragma unroll
  for (int i = 0; i < L; ++i) out[i] = t[i];
}

// a^2 * R^-1 mod p before its final subtraction: the 2L-word square with
// each cross product a_i a_j (i < j) computed once and doubled by a
// funnel shift, then L rows of Montgomery reduction. Returns the word
// above the L result words (t[L..2L-1]), 0 where a < 2p and 4p < R.
template <int L>
__device__ __forceinline__ uint32_t mont_sqr_sos(const uint32_t* a,
                                                 const uint32_t* p,
                                                 uint32_t n0inv,
                                                 uint32_t* t) {
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < L - 1; ++i) {
    uint32_t c = 0;
#pragma unroll
    for (int j = i + 1; j < L; ++j) {
      const uint64_t v = (uint64_t)a[i] * a[j] + t[i + j] + c;
      t[i + j] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
    }
    t[i + L] = c;
  }
#pragma unroll
  for (int k = 2 * L - 1; k > 0; --k)
    t[k] = (t[k] << 1) | (t[k - 1] >> 31);   // t[0] is 0
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t v = (uint64_t)a[i] * a[i] + t[2 * i] + c;
    t[2 * i] = (uint32_t)v;
    v = (uint64_t)t[2 * i + 1] + (uint32_t)(v >> 32);
    t[2 * i + 1] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  uint32_t top = 0;   // the carry into t[i + L + 1] from row i
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t m = t[i] * n0inv;
    uint64_t v = (uint64_t)m * p[0] + t[i];
    c = (uint32_t)(v >> 32);
#pragma unroll
    for (int j = 1; j < L; ++j) {
      v = (uint64_t)m * p[j] + t[i + j] + c;
      t[i + j] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
    }
    v = (uint64_t)t[i + L] + c + top;
    t[i + L] = (uint32_t)v;
    top = (uint32_t)(v >> 32);
  }
  return top;
}

// Montgomery square a^2 * R^-1 mod p for a < p. Result < p.
template <int L>
__device__ __forceinline__ void mont_sqr(const uint32_t* a, const uint32_t* p,
                                         uint32_t n0inv, uint32_t* out) {
  MTT_COUNT_OP(0);
  uint32_t t[2 * L];
  const uint32_t top = mont_sqr_sos<L>(a, p, n0inv, t);
  sub_p_if_above<L>(t + L, top != 0, p, out);
}

// Lazy Montgomery square, valid only where 4p < R: a < 2p gives a result
// below 2p (a^2 < R p), with no final subtraction. On the card two limbs
// take carry chains in PTX (the same values).
template <int L>
__device__ __forceinline__ void mont_sqr_lazy(const uint32_t* a,
                                              const uint32_t* p,
                                              uint32_t n0inv, uint32_t* out) {
  MTT_COUNT_OP(0);
#if defined(__CUDA_ARCH__)
  if constexpr (L == 2) {
    uint32_t t0, t1, t2, t3;
    asm("{\n\t.reg .u32 c1, c2, x1, y0, y1;\n\t.reg .u64 w;\n\t"
        "mul.wide.u32 w, %4, %5;\n\tmov.b64 {c1, c2}, w;\n\t"
        "mul.wide.u32 w, %4, %4;\n\tmov.b64 {%0, x1}, w;\n\t"
        "mul.wide.u32 w, %5, %5;\n\tmov.b64 {y0, y1}, w;\n\t"
        "shf.l.wrap.b32 %2, c1, c2, 1;\n\t"
        "shl.b32 %1, c1, 1;\n\t"
        "shr.b32 %3, c2, 31;\n\t"
        "add.cc.u32 %1, %1, x1;\n\t"
        "addc.cc.u32 %2, %2, y0;\n\t"
        "addc.u32 %3, %3, y1;\n\t}"
        : "=&r"(t0), "=&r"(t1), "=&r"(t2), "=&r"(t3)
        : "r"(a[0]), "r"(a[1]));
    MTT_REDC2(t0, t1, t2, t3, p[0], p[1], n0inv);
    out[0] = t2;
    out[1] = t3;
    return;
  }
#endif
  uint32_t t[2 * L];
  mont_sqr_sos<L>(a, p, n0inv, t);
#pragma unroll
  for (int i = 0; i < L; ++i) out[i] = t[L + i];
}

}  // namespace mtt
