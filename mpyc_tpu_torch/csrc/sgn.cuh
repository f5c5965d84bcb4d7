// K5: the whole Toft-style secure comparison, one thread per element.
//
// Replaces mpyc_tpu/models/pipelines.py:503 make_sgn_step ->
// _build_pallas.kernel (:616, pallas_call :833), in the stream layout of
// its XLA step (:847-1061), so that the kernel equals its plain version
// (mpyc_tpu_torch/models/pipelines.py _sgn_step_plain) and the JAX package
// bit for bit. Included by kernels.cu after DrawParams and reduce_draw.
//
// The stream of a call: the absorbed state with the call counter XORed
// into lane 4, counter-mode blocks on lane 19.
//   stream A, blocks 0 .. blocks_a-1: element e takes words e*wpe + w,
//     first wb words of random bits, then wk words of r_divl;
//   stream B, from block blocks_a on: 16-byte draws into GF(p), ten a
//     block (draw d: block blocks_a + d / 10, slot d % 10), taken call by
//     call in the order of the XLA step; a call of c draws per element
//     gives element e the draws off + kk*n*c + e*c + i (kk < t, i < c).
//
// Per element the thread runs the whole protocol for all m parties: the
// dealer split of lb stream bits and of r_divl < 2^k, the masked open of
// c = a + 2^l + r_modl + 2^l r_divl, the public bit algebra and suffix
// sums, two log-depth product trees whose levels reshare in the thread,
// and the blinded zero test with one blinder per element. Device memory
// sees each input share read once and each output share written once.
//
// Bound: integer operations (sgn mode at l = 32, t = 1, m = 3: about 10
// sponge blocks, 900 Montgomery products and 1,430 modular adds per element,
// the draws' reduction included, against 48 bytes moved; SgnSpec.field_ops). Design, simple first: the bit shares (lb x m), the xor
// vector (l x m) and the E vector live in thread-private arrays, which go
// to local memory; the bit and tree loops are not unrolled (build time);
// the permutation is one out-of-line function behind a one-block cache,
// so consecutive draws of one call reuse a block. Draws of calls with one
// draw per element share a block among ten neighbouring elements, and
// each of their threads squeezes it again: about 25-30 permutations per
// element against about 10 stream blocks (PERF.md, open questions).
#pragma once
#include <cstdint>

#include "keccak.cuh"
#include "limb.cuh"

namespace mtt {

// Mirrored by a ctypes structure in mpyc_tpu_torch/_build.py. Field
// constants are Montgomery limbs unless named otherwise.
struct SgnParams {
  DrawParams draw;
  uint32_t lag_t[MAX_SEND][NL];   // Lagrange at 0 from shares 1..t+1
  uint32_t lag_2t[MAX_SEND][NL];  // Lagrange at 0 from shares 1..2t+1
  uint32_t xs[MAX_M][NL];         // evaluation points 1..m
  uint32_t one[NL], three[NL];
  uint32_t r2[NL];                // R^2 mod p: standard -> Montgomery
  uint32_t pow2l[NL], inv2l[NL], pow2l1[NL], powf[NL];
  uint32_t nonce_lo, nonce_hi;    // call counter, XORed into lane 4
  int32_t t, m, l, k, mode, has_f;
};

// Block `blk` of the call's stream, as its 21 rate lanes. Out of line:
// every draw of K5 comes through here, so the permutation is compiled
// once per instantiation.
__device__ __noinline__ void sgn_squeeze(const uint32_t* __restrict__ state,
                                         uint64_t nonce,
                                         unsigned long long blk,
                                         uint64_t* rate) {
  uint64_t A[25];
  load_state(state, A);
  A[4] ^= nonce;
  A[19] ^= blk;
  keccak_f1600(A);
#pragma unroll
  for (int q = 0; q < 21; ++q) rate[q] = A[q];
}

// The thread's view of the stream: the last block it squeezed.
struct SgnStream {
  const uint32_t* state;
  uint64_t nonce;
  long long blocks_a;  // stream B starts at this block
  long long cached;    // the block in `rate`, -1 for none
  uint64_t rate[21];

  __device__ __forceinline__ void fetch(long long blk) {
    if (blk != cached) {
      sgn_squeeze(state, nonce, (unsigned long long)blk, rate);
      cached = blk;
    }
  }
  // word w of stream A
  __device__ __forceinline__ uint32_t word_a(long long w) {
    fetch(w / RATE_WORDS);
    return rate_word(rate, (int)(w % RATE_WORDS));
  }
  // draw d of stream B, in GF(p), Montgomery form
  __device__ __forceinline__ void draw(long long d, const DrawParams& P,
                                       uint32_t* out) {
    constexpr int EPB = RATE_WORDS / 4;
    fetch(blocks_a + d / EPB);
    reduce_draw<4>(rate, (int)(d % EPB), P, out);
  }
};

__device__ __forceinline__ void fe_copy(const uint32_t* a, uint32_t* out) {
#pragma unroll
  for (int q = 0; q < NL; ++q) out[q] = a[q];
}

// The t coefficients of one element's polynomial in a call of c draws per
// element: draws off + kk*n*c + e*c + i.
template <int T>
__device__ __forceinline__ void sgn_coefs(SgnStream& S, const DrawParams& D,
                                          long long off, long long n,
                                          long long c, long long e, int i,
                                          uint32_t (*C)[NL]) {
#pragma unroll
  for (int kk = 0; kk < T; ++kk)
    S.draw(off + (long long)kk * n * c + e * c + i, D, C[kk]);
}

// Shares of value v at x_j: Horner(C, x_j) + v for the m parties.
template <int T, int M>
__device__ __forceinline__ void dealer_split(const uint32_t* v,
                                             const uint32_t (*C)[NL],
                                             const SgnParams& P,
                                             uint32_t (*out)[NL]) {
  const uint32_t* p = P.draw.p;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    uint32_t y[NL];
    fe_copy(C[0], y);
    mont_mul<NL>(y, P.xs[j], p, P.draw.n0inv, y);
#pragma unroll
    for (int kk = 1; kk < T; ++kk) {
      add_mod<NL>(y, C[kk], p, y);
      mont_mul<NL>(y, P.xs[j], p, P.draw.n0inv, y);
    }
    add_mod<NL>(y, v, p, out[j]);
  }
}

// GRR98 reshare of degree-2t shares x into degree-t shares (x and out may
// be the same array): S = sum_i lag_2t[i] x_i, out_j = Horner(C, x_j) + S.
template <int T, int M>
__device__ __forceinline__ void sgn_reshare(const uint32_t (*x)[NL],
                                            const uint32_t (*C)[NL],
                                            const SgnParams& P,
                                            uint32_t (*out)[NL]) {
  uint32_t S[NL];
#pragma unroll
  for (int i = 0; i < 2 * T + 1; ++i) {
    uint32_t term[NL];
    mont_mul<NL>(x[i], P.lag_2t[i], P.draw.p, P.draw.n0inv, term);
    if (i == 0) fe_copy(term, S);
    else add_mod<NL>(S, term, P.draw.p, S);
  }
  dealer_split<T, M>(S, C, P, out);
}

// Log-depth product of x[0..w-1] (each m shares) into x[0]: level by
// level, x_j <- reshare(x_j * x_{h+j}) for j < h = w / 2, an odd last one
// moves to x_h. A level is one call of h draws per element.
template <int T, int M>
__device__ __forceinline__ void prod_tree(uint32_t (*x)[M][NL], int w,
                                          SgnStream& S, const SgnParams& P,
                                          long long n, long long e,
                                          long long& off) {
#pragma unroll 1
  while (w > 1) {
    const int h = w >> 1;
#pragma unroll 1
    for (int j = 0; j < h; ++j) {
      uint32_t y[M][NL], C[T][NL];
#pragma unroll
      for (int i = 0; i < M; ++i)
        mont_mul<NL>(x[j][i], x[h + j][i], P.draw.p, P.draw.n0inv, y[i]);
      sgn_coefs<T>(S, P.draw, off, n, h, e, j, C);
      sgn_reshare<T, M>(y, C, P, x[j]);
    }
    if (w & 1) {
#pragma unroll
      for (int i = 0; i < M; ++i) fe_copy(x[2 * h][i], x[h][i]);
    }
    off += (long long)T * n * h;
    w = h + (w & 1);
  }
}

// MODE 0: sgn(a); 1: a < 0; 2: a == 0; times 2^f when P.has_f.
template <int MODE, int LBIT, int T, int M>
__global__ void __launch_bounds__(128)
sgn_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
           const uint32_t* __restrict__ state, long long n,
           long long blocks_a, SgnParams P) {
  constexpr bool LT = MODE == 1, EQ = MODE == 2;
  constexpr int LB = LBIT + (EQ ? 0 : 1);  // random bits (+ sign bit)
  constexpr int WB = (LB + 31) / 32;
  static_assert(NL == 2 && LB <= 64 && 2 * T + 1 <= M && M <= MAX_M,
                "K5 takes two-limb fields and l < 64");
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const uint32_t* p = P.draw.p;
  const uint32_t n0 = P.draw.n0inv;

  SgnStream S;
  S.state = state;
  S.nonce = ((uint64_t)P.nonce_hi << 32) | P.nonce_lo;
  S.blocks_a = blocks_a;
  S.cached = -1;

  // stream A: the random bits and r_divl < 2^k
  const int wk = (P.k + 31) / 32;
  const long long wa = e * (WB + wk);
  uint64_t bits = 0;
#pragma unroll
  for (int w = 0; w < WB; ++w)
    bits |= (uint64_t)S.word_a(wa + w) << (32 * w);
  uint32_t kl[NL];
#pragma unroll
  for (int q = 0; q < NL; ++q) {
    kl[q] = 0;
    if (q < wk) {
      const uint32_t v = S.word_a(wa + WB + q);
      const int rem = P.k - 32 * q;
      kl[q] = rem < 32 ? v & ((1u << rem) - 1u) : v;
    }
  }

  // dealer split of the bits: E holds their shares rb until the E vector
  // replaces them
  long long off = 0;
  uint32_t E[LB][M][NL];
#pragma unroll 1
  for (int j = 0; j < LB; ++j) {
    uint32_t bm[NL], C[T][NL];
    const bool bit = (bits >> j) & 1;
#pragma unroll
    for (int q = 0; q < NL; ++q) bm[q] = bit ? P.one[q] : 0u;
    sgn_coefs<T>(S, P.draw, off, n, LB, e, j, C);
    dealer_split<T, M>(bm, C, P, E[j]);
  }
  off += (long long)T * n * LB;

  uint32_t rdiv[M][NL];
  {
    uint32_t v[NL], C[T][NL];
    mont_mul<NL>(kl, P.r2, p, n0, v);
    sgn_coefs<T>(S, P.draw, off, n, 1, e, 0, C);
    dealer_split<T, M>(v, C, P, rdiv);
  }
  off += (long long)T * n;

  // a_r = a + r_modl + 2^l with r_modl = sum_{j<l} rb_j 2^j (by doubling)
  uint32_t ar[M][NL], z[M][NL];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    uint32_t acc[NL], ai[NL];
    fe_copy(E[LBIT - 1][i], acc);
#pragma unroll 1
    for (int j = LBIT - 2; j >= 0; --j) {
      add_mod<NL>(acc, acc, p, acc);
      add_mod<NL>(acc, E[j][i], p, acc);
    }
#pragma unroll
    for (int q = 0; q < NL; ++q) ai[q] = __ldg(a + ((long long)i * n + e) * NL + q);
    add_mod<NL>(ai, acc, p, ar[i]);
    add_mod<NL>(ar[i], P.pow2l, p, ar[i]);
  }

  // open c = a_r + 2^l r_divl from shares 1..t+1, to standard form
  uint32_t c[NL];
#pragma unroll
  for (int i = 0; i < T + 1; ++i) {
    uint32_t ci[NL];
    mont_mul<NL>(rdiv[i], P.pow2l, p, n0, ci);
    add_mod<NL>(ar[i], ci, p, ci);
    mont_mul<NL>(ci, P.lag_t[i], p, n0, ci);
    if (i == 0) fe_copy(ci, c);
    else add_mod<NL>(c, ci, p, c);
  }
  {
    const uint32_t unit[NL] = {1u, 0u};
    mont_mul<NL>(c, unit, p, n0, c);
  }
  const uint64_t cbits = (uint64_t)c[0] | ((uint64_t)c[1] << 32);
  {
    uint32_t cm[NL];  // c mod 2^l, then in Montgomery form
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      const int rem = LBIT - 32 * q;
      cm[q] = rem <= 0 ? 0u : rem < 32 ? c[q] & ((1u << rem) - 1u) : c[q];
    }
    mont_mul<NL>(cm, P.r2, p, n0, cm);
#pragma unroll
    for (int i = 0; i < M; ++i) sub_mod<NL>(cm, ar[i], p, z[i]);
  }

  // xor_j = c_j XOR r_j, as shares: c_j ? 1 - rb_j : rb_j
  uint32_t X[LBIT][M][NL];
#pragma unroll 1
  for (int j = 0; j < LBIT; ++j) {
    const bool cb = (cbits >> j) & 1;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (cb) sub_mod<NL>(P.one, E[j][i], p, X[j][i]);
      else fe_copy(E[j][i], X[j][i]);
    }
  }

  if constexpr (!EQ) {
    // s = 2 r_l - 1; E_j = s + (rb_j - c_j) + 3 sum_{j' > j} xor_j';
    // E_l = s - 1 + 3 sum_j xor_j
    uint32_t s[M][NL], suf[M][NL];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      add_mod<NL>(E[LBIT][i], E[LBIT][i], p, s[i]);
      sub_mod<NL>(s[i], P.one, p, s[i]);
#pragma unroll
      for (int q = 0; q < NL; ++q) suf[i][q] = 0u;
    }
#pragma unroll 1
    for (int j = LBIT - 1; j >= 0; --j) {
      const bool cb = (cbits >> j) & 1;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        uint32_t v[NL], s3[NL];
        if (cb) sub_mod<NL>(E[j][i], P.one, p, v);
        else fe_copy(E[j][i], v);
        add_mod<NL>(v, s[i], p, v);
        add_mod<NL>(suf[i], suf[i], p, s3);
        add_mod<NL>(s3, suf[i], p, s3);
        add_mod<NL>(v, s3, p, E[j][i]);
        add_mod<NL>(suf[i], X[j][i], p, suf[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      uint32_t s3[NL];
      add_mod<NL>(suf[i], suf[i], p, s3);
      add_mod<NL>(s3, suf[i], p, s3);
      sub_mod<NL>(s[i], P.one, p, E[LBIT][i]);
      add_mod<NL>(E[LBIT][i], s3, p, E[LBIT][i]);
    }
    prod_tree<T, M>(E, LBIT + 1, S, P, n, e, off);

    // blinded public zero test of the product, one blinder per element
    uint32_t bl[NL], C[T][NL], bsh[M][NL];
    S.draw(off + e, P.draw, bl);
    off += n;
    if (is_zero<NL>(bl)) fe_copy(P.one, bl);
    sgn_coefs<T>(S, P.draw, off, n, 1, e, 0, C);
    off += (long long)T * n;
    dealer_split<T, M>(bl, C, P, bsh);
    uint32_t po[NL];
#pragma unroll
    for (int i = 0; i < 2 * T + 1; ++i) {
      uint32_t pb[NL];
      mont_mul<NL>(E[0][i], bsh[i], p, n0, pb);
      mont_mul<NL>(pb, P.lag_2t[i], p, n0, pb);
      if (i == 0) fe_copy(pb, po);
      else add_mod<NL>(po, pb, p, po);
    }
    const bool g = is_zero<NL>(po);
    // h = s - 2 g s + 3; z = (z + 2^(l-1) h) / 2^l
#pragma unroll
    for (int i = 0; i < M; ++i) {
      uint32_t h[NL];
      if (g) sub_mod<NL>(P.three, s[i], p, h);
      else add_mod<NL>(s[i], P.three, p, h);
      mont_mul<NL>(h, P.pow2l1, p, n0, h);
      add_mod<NL>(z[i], h, p, z[i]);
      mont_mul<NL>(z[i], P.inv2l, p, n0, z[i]);
    }
  }

  if constexpr (!LT) {
#pragma unroll 1
    for (int j = 0; j < LBIT; ++j) {
#pragma unroll
      for (int i = 0; i < M; ++i) sub_mod<NL>(P.one, X[j][i], p, X[j][i]);
    }
    prod_tree<T, M>(X, LBIT, S, P, n, e, off);
    if constexpr (EQ) {
#pragma unroll
      for (int i = 0; i < M; ++i) fe_copy(X[0][i], z[i]);
    } else {
      // sgn = reshare((h_all - 1) (2z - 1))
      uint32_t y[M][NL], C[T][NL];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        uint32_t u[NL], v[NL];
        sub_mod<NL>(X[0][i], P.one, p, u);
        add_mod<NL>(z[i], z[i], p, v);
        sub_mod<NL>(v, P.one, p, v);
        mont_mul<NL>(u, v, p, n0, y[i]);
      }
      sgn_coefs<T>(S, P.draw, off, n, 1, e, 0, C);
      sgn_reshare<T, M>(y, C, P, z);
    }
  }

#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (P.has_f) mont_mul<NL>(z[i], P.powf, p, n0, z[i]);
#pragma unroll
    for (int q = 0; q < NL; ++q) out[((long long)i * n + e) * NL + q] = z[i][q];
  }
}

}  // namespace mtt
