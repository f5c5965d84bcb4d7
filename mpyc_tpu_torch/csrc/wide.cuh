// The field arithmetic of the wide kernels (wide.cu: K3, K6, K7, K9;
// sgn_wide.cu: K5) on 7 to 48 limbs, L a run-time count, in two forms.
//
// - One thread a product (wmont_mul, wadd_mod, wsub_mod: the wide K3, K7
//   and K9): each element an array of WIDE_MAX_NL words, of which the
//   first L are used (local memory, shared memory or device memory alike).
// - A group of lanes a product (WGroup: the wide K5 and K6): g = 8, 16 or
//   32 lanes of a warp (wide_group(L)) hold an L-limb value as S = 1 or 2
//   words a lane, lane q words q and q + g, in registers. The Montgomery
//   product is CIOS row by row: b_i comes by __shfl_sync from the lane
//   that holds it, m = t_0 n0inv from the group's first lane, and the
//   one-word shift of each row by a rotation of the lanes. Each lane keeps
//   its words of the accumulator in a redundant form (a word and a part
//   below 2^33, the carries not yet passed on: two multiply-adds a row
//   that cannot overflow 64 bits), so a row has no carry chain; the
//   carries are resolved once a product by a carry-lookahead over the
//   group (__ballot_sync of the words that generate and that propagate a
//   carry), and the final t >= p by a group-wide borrow-lookahead. The
//   add and subtract mod p take the same two lookaheads. Every result is
//   canonical (below p), as the one-thread forms give it.
//
// Included after common.cuh.
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

// ---------------------------------------------------------------------------
// A group of lanes a product.
// ---------------------------------------------------------------------------

// Lanes of a group at L limbs (_build.wide_group).
__host__ __device__ constexpr int wide_group(int L) {
  return L <= 8 ? 8 : L <= 16 ? 16 : 32;
}
// Runs F::run<S, W>() for the instantiation of the group arithmetic that
// takes L limbs: 8 or 16 lanes a group to 16 limbs, a warp of one word a
// lane to 32, of two words to 48. Returns what it returns.
template <class F>
__host__ int wide_dispatch(int L, F f) {
  if (L <= 16) return f.template run<1, false>();
  if (L <= 32) return f.template run<1, true>();
  return f.template run<2, true>();
}

// A value of the group: this lane's words q + g s (0 past L).
template <int S>
struct WV {
  uint32_t w[S];
};

// The group of the calling thread (threadIdx.x / g), the field's p in its
// lanes' registers. Every lane of the group calls each operation together.
// A value's words past L are 0 in every operand and result. W: the group
// is a whole warp (g = 32, from 17 limbs on), so its shuffles and ballots
// name the full mask as a constant; a mask known only at run time (8 or
// 16 lanes, a group among others in the warp) costs each of them a
// convergence check. GL: the lanes of a group as a constant (4 or 8, the
// comparison of two to six limbs, sgn_wide.cu's CTA route), else
// wide_group(L) at run time.
template <int S, bool W, int GL = 0>
struct WGroup {
  int L, g, q;       // limbs, lanes, this lane
  int base;          // the warp lane of the group's lane 0
  unsigned mask;     // the group's lanes in the warp
  uint32_t n0;       // -p^-1 mod 2^32
  uint32_t p[S];

  __device__ void init(int L_, const uint32_t* pw, uint32_t n0_) {
    L = L_;
    g = W ? 32 : GL ? GL : wide_group(L_);
    q = threadIdx.x & (g - 1);
    base = W ? 0 : threadIdx.x & 31 & ~(g - 1);
    mask = W ? 0xFFFFFFFFu : ((1u << g) - 1u) << base;
    n0 = n0_;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = q + g * s;
      p[s] = j < L ? pw[j] : 0u;
    }
  }
  // lanes, mask and base as constants where the group is a warp; the
  // lanes where GL gives them
  __device__ int lanes() const { return W ? 32 : GL ? GL : g; }
  __device__ unsigned msk() const { return W ? 0xFFFFFFFFu : mask; }
  __device__ int bse() const { return W ? 0 : base; }
  __device__ bool lead() const { return q == 0; }

  __device__ WV<S> ld(const uint32_t* v) const {
    WV<S> r;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = q + lanes() * s;
      r.w[s] = j < L ? v[j] : 0u;
    }
    return r;
  }
  __device__ void st(uint32_t* v, const WV<S>& x) const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = q + lanes() * s;
      if (j < L) v[j] = x.w[s];
    }
  }
  // The constant c (c < 2^32 at word 0, the rest 0), and 2^j.
  __device__ WV<S> word0(uint32_t c) const {
    WV<S> r;
#pragma unroll
    for (int s = 0; s < S; ++s) r.w[s] = q + lanes() * s == 0 ? c : 0u;
    return r;
  }
  __device__ WV<S> pow2(int j) const {
    WV<S> r;
#pragma unroll
    for (int s = 0; s < S; ++s)
      r.w[s] = q + lanes() * s == (j >> 5) ? 1u << (j & 31) : 0u;
    return r;
  }
  // The l-bit prefix of the little-endian words w (l < 32 L).
  __device__ WV<S> low_bits(const uint32_t* w, int l) const {
    WV<S> r;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = q + lanes() * s, rem = l - 32 * j;
      r.w[s] = j >= L || rem <= 0 ? 0u
               : rem < 32 ? w[j] & ((1u << rem) - 1u) : w[j];
    }
    return r;
  }
  __device__ bool is_zero(const WV<S>& x) const {
    uint32_t acc = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) acc |= x.w[s];
    return (__ballot_sync(msk(), acc != 0) & msk()) == 0;
  }

  // The group's positions j = q + g s where pred holds, as bit j.
  __device__ uint64_t ballot(const bool (&pred)[S]) const {
    uint64_t r = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint64_t b = (__ballot_sync(msk(), pred[s]) & msk()) >> bse();
      r |= b << (lanes() * s);
    }
    return r;
  }
  // Carry-lookahead: the carries into each position of a sum whose words
  // generate a carry where gen and pass one on where prop (disjoint):
  // bit j is the carry into position j, bit L the carry out of the top.
  __device__ uint64_t carries(const bool (&gen)[S],
                              const bool (&prop)[S]) const {
    const uint64_t G = ballot(gen), P = ballot(prop);
    return ((G | P) + G) ^ P;
  }
  __device__ uint32_t bit(uint64_t v, int s) const {
    return (uint32_t)(v >> (q + lanes() * s)) & 1u;
  }

  // w - p where top is set or w >= p (w canonical words, top the bit
  // above them), else w: the result is below p when w + top 2^(32 L) <
  // 2p.
  __device__ WV<S> reduce(const WV<S>& w, bool top) const {
    bool gen[S], prop[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool in = q + lanes() * s < L;
      gen[s] = in && w.w[s] < p[s];
      prop[s] = in && w.w[s] == p[s];
    }
    const uint64_t B = carries(gen, prop);   // the borrows of w - p
    WV<S> r = w;
    if (top || !((B >> L) & 1u)) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        r.w[s] = q + lanes() * s < L ? w.w[s] - p[s] - bit(B, s) : 0u;
    }
    return r;
  }
  // Words v with carries e (0 or 1) out of each position into the next
  // (e set only where v is at most 2^32 - 2), resolved; top: the carry
  // out of the last.
  __device__ WV<S> settle(const WV<S>& v, const bool (&e)[S],
                          bool& top) const {
    bool prop[S];
#pragma unroll
    for (int s = 0; s < S; ++s) prop[s] = v.w[s] == 0xFFFFFFFFu;
    const uint64_t C = carries(e, prop);
    top = (C >> L) & 1u;
    WV<S> r;
#pragma unroll
    for (int s = 0; s < S; ++s)
      r.w[s] = q + lanes() * s < L ? v.w[s] + bit(C, s) : 0u;
    return r;
  }

  // (a + b) mod p for a, b < p.
  __device__ WV<S> add(const WV<S>& a, const WV<S>& b) const {
    if (lead()) MTT_COUNT_OP(1);
    WV<S> v;
    bool e[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint64_t z = (uint64_t)a.w[s] + b.w[s];
      v.w[s] = (uint32_t)z;
      e[s] = (z >> 32) != 0;
    }
    bool top;
    const WV<S> w = settle(v, e, top);
    return reduce(w, top);
  }

  // (a - b) mod p for a, b < p.
  __device__ WV<S> sub(const WV<S>& a, const WV<S>& b) const {
    if (lead()) MTT_COUNT_OP(1);
    bool gen[S], prop[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool in = q + lanes() * s < L;
      gen[s] = in && a.w[s] < b.w[s];
      prop[s] = in && a.w[s] == b.w[s];
    }
    const uint64_t B = carries(gen, prop);   // the borrows of a - b
    WV<S> d;
#pragma unroll
    for (int s = 0; s < S; ++s)
      d.w[s] = q + lanes() * s < L ? a.w[s] - b.w[s] - bit(B, s) : 0u;
    if (!((B >> L) & 1u)) return d;
    // a < b: add p back, the carry out of the top dropped
    WV<S> v;
    bool e[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint64_t z = (uint64_t)d.w[s] + p[s];
      v.w[s] = (uint32_t)z;
      e[s] = (z >> 32) != 0;
    }
    bool top;
    return settle(v, e, top);
  }

  // Montgomery product a b R^-1 mod p, a < R, b < p (or both < p): CIOS
  // row by row, the accumulator's words in a redundant form: position j
  // (lane q positions q + g s) holds h_j + u_j, h_j < 2^33 and u_j a word.
  // Row i (b_i from its lane, fetched a row ahead) adds a_j b_i + m p_j,
  // m = (h_0 + u_0 + a_0 b_i) n0 mod 2^32 so that position 0 becomes 0 mod
  // 2^32, in two multiply-adds that cannot overflow 64 bits: t = a_j b_i
  // + h_j, then e = m p_j + (t mod 2^32) + u_j; the new h_j is the high
  // parts of e and t, the new u_j the low word of e at position j + 1
  // (from the next lane). The value stays below 2p < 2^(32 L + 1), so L
  // positions hold it. With rows = k (0 < k < L; 0: L) only the first k
  // rows run: a b 2^(-32 k) mod p for b < 2^(32 k), a < p.
  __device__ WV<S> mul(const WV<S>& a, const WV<S>& b, int rows = 0) const {
    if (lead()) MTT_COUNT_OP(0);
    uint64_t h[S];
    uint32_t u[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      h[s] = 0;
      u[s] = 0;
    }
    const int nxt = (q + 1) & (lanes() - 1);
    uint32_t bn = __shfl_sync(msk(), b.w[0], 0, lanes());
    const int nr = rows ? rows : L;
    for (int i = 0; i < nr; ++i) {
      const uint32_t bi = bn;
      const int i1 = i + 1;
      const uint32_t bs = S == 1 || i1 < lanes() ? b.w[0] : b.w[S - 1];
      bn = __shfl_sync(msk(), bs, i1 & (lanes() - 1), lanes());
      uint64_t tv[S];
#pragma unroll
      for (int s = 0; s < S; ++s) tv[s] = (uint64_t)a.w[s] * bi + h[s];
      const uint32_t m =
          __shfl_sync(msk(), ((uint32_t)tv[0] + u[0]) * n0, 0, lanes());
      uint32_t lo[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const uint64_t e = (uint64_t)m * p[s] + (uint32_t)tv[s] + u[s];
        lo[s] = (uint32_t)e;
        h[s] = (e >> 32) + (tv[s] >> 32);
      }
      uint32_t r[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        r[s] = __shfl_sync(msk(), lo[s], nxt, lanes());
#pragma unroll
      for (int s = 0; s < S; ++s)
        u[s] = q == lanes() - 1
                   ? (s + 1 < S ? r[s + 1 < S ? s + 1 : s] : 0u)
                   : r[s];
    }
    // x_j = h_j + u_j < 2^34
    uint64_t x[S];
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = h[s] + u[s];
    // resolve: word j = low(x_j) + high(x_{j-1}), then the carries
    const int prv = (q - 1) & (lanes() - 1);
    uint32_t hp[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      hp[s] = __shfl_sync(msk(), (uint32_t)(x[s] >> 32), prv, lanes());
    WV<S> v;
    bool e[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t in =
          q == 0 ? (s > 0 ? hp[s > 0 ? s - 1 : 0] : 0u) : hp[s];
      const uint64_t z = (x[s] & 0xFFFFFFFFull) + in;
      v.w[s] = (uint32_t)z;
      e[s] = (z >> 32) != 0;
    }
    // the high part of the top digit: the value's bit 32 L with the
    // carry out of the last word (their sum is at most 1: the product is
    // below 2p < 2^(32 L + 1))
    const int jt = L - 1;
    const uint32_t ht = __shfl_sync(
        msk(), (uint32_t)((S == 1 || jt < lanes() ? x[0] : x[S - 1]) >> 32),
        jt & (lanes() - 1), lanes());
    bool top;
    const WV<S> w = settle(v, e, top);
    return reduce(w, top || ht != 0);
  }
};

}  // namespace mtt
