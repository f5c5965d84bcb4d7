// K5: the whole Toft-style secure comparison, one thread per element.
//
// Replaces mpyc_tpu/models/pipelines.py:503 make_sgn_step ->
// _build_pallas.kernel (:616, pallas_call :833), in the stream layout of
// its XLA step (:847-1061), so that the kernel equals its plain version
// (mpyc_tpu_torch/models/pipelines.py _sgn_step_plain) and the JAX package
// bit for bit. Included after common.cuh (DrawParams, reduce_draw and the
// stage); sgn.cu builds it, one limb count a translation unit, and
// kernels.cu's mtt_sgn launches it.
//
// The stream of a call: the absorbed state with the call counter XORed
// into lane 4, counter-mode blocks on lane 19.
//   stream A, blocks 0 .. blocks_a-1: element e takes words e*wpe + w,
//     first wb words of random bits, then wk words of r_divl;
//   stream B, from block blocks_a on: draws of 4 (NL + 2) bytes into
//     GF(p), EPB a block (ten of 16 bytes at NL = 2, eight of 20 at NL =
//     3; draw d: block blocks_a + d / EPB, slot d % EPB), taken call by
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
// A launch may take many calls: the chunks of 1024 (or 2^20) elements
// into which the runtime cuts a comparison, each a call of its own with
// counter ctr + c (chunk c), its own stream and its own n (the last
// chunk's padded to its bucket). A CTA works in one chunk.
//
// The bit width l is a launch parameter (SgnParams.l): an instantiation
// takes every l whose random bits lb = l + 1 (l in EQ mode) fit its
// arrays, lb <= sgn_lb_max(NL) = 32 NL - 1, so every l with l + k + 2 <=
// bit length of p runs at t = 1. The party count m is a launch parameter
// (2t + 1 <= m <= MAX_M). The threshold t is the instantiation's (T = 1
// to MAX_T: the loops over the 2T + 1 senders and the T coefficients
// unroll, the arrays hold 2T + 1 shares, the Lagrange coefficients are
// read from the parameter block at constant indices), or a launch
// parameter from 2 to MAX_T (T = 0: the loops do not unroll, the arrays
// are sized for t = 4, the constants come from shared memory). At two
// limbs, the fields of every path at t > 1, each t has its
// instantiation: the run-time-t kernel took 1.26-1.40x as long at (2, 5),
// (3, 7) and (4, 9); at three to six limbs t > 1 takes the run-time-t
// kernel: an instantiation a t took the build from 46 s to 272 s
// (PERF.md). At t > 1 the bit call's draws (t lb an element) bound lb by
// sgn_lb_fit(t, NL) (from t = 2 at six limbs, lb <= 150, to t = 4 at six
// limbs, lb <= 75); wider comparisons raise. Built (sgn.cu) in all three
// modes: at two limbs for t = 1 to 4, at three to six for t = 1 and a
// run-time t, thirty-six kernels.
//
// Bound: integer operations (sgn mode at l = 32, t = 1, m = 3: about 10
// sponge blocks, 900 Montgomery products and 1,430 modular adds per
// element, the draws' reduction included, against 48 bytes moved;
// SgnSpec.field_ops; a three-limb product costs about twice a two-limb
// one, chip_smoke.mont_mul_ops).
//
// Design. Neighbouring elements take neighbouring draws of every call, so
// a thread squeezing its own draws repeats its neighbours' permutations,
// and in a warp the lanes whose draws cross a block boundary permute
// while the others wait: the warp runs a whole permutation for every few
// lanes. So the CTA of SGN_THREADS elements stages each call: before the
// call it squeezes every block of the call's draws once, one block a
// thread (stage.cuh), into shared memory, and after a barrier each thread
// reads its draws from there. No thread leaves early: lanes past n stage
// and synchronise, and write nothing. SGN_THREADS = 256: per warp of 32
// elements in LT mode the stage serialises about 7.4 permutations (8.5 at
// 128, 10.5 at 64; chip_smoke.sgn_squeezes), where a one-block cache in
// each thread serialised about 54 (PERF.md). The bit call, the largest,
// takes t x lb x 256 x 8 = 67,584 bytes at l = 32, so the draws and the
// words of stream A are dynamic shared memory (sgn_smem_bytes); at about
// 110 registers (ptxas) 2 CTAs, 16 warps, fit a SM by registers and by
// shared memory. 256 ran faster than 128 on the card (PERF.md). The CTA
// width B is the launch's: SGN_THREADS elements, halved (to a warp at
// the least) while the call's dynamic shared memory would pass the
// 227 KB a CTA may have (sgn_threads): at NL = 5 and l = 110, 2,244 bytes
// an element, so 64 elements a CTA. The bit shares (lb x (2t + 1)) and,
// in sgn and EQ mode, the xor vector (l x (2t + 1)) live in thread-private
// arrays in local memory, sized for the widest l of the instantiation
// (sgn_lb_arrays); in
// LT mode the suffix loop recomputes each xor bit from rb_j and c_j and
// keeps no xor vector. The bit and tree loops are not unrolled (build
// time). The random bits stay in the CTA's shared stream-A words and the
// opened c in registers, and bit j of either is read at run time
// (bit_of). The stack grows with the arrays (chip_smoke.py prints
// ptxas's report).
#pragma once
#include <cstdint>

#include "keccak.cuh"
#include "limb.cuh"
#include "stage.cuh"

namespace mtt {

// Mirrored by a ctypes structure in mpyc_tpu_torch/_build.py. Field
// constants are Montgomery limbs unless named otherwise.
struct SgnParams {
  DrawParams draw;
  uint32_t lag_t[MAX_SEND][MAX_NL];   // Lagrange at 0 from shares 1..t+1
  uint32_t lag_2t[MAX_SEND][MAX_NL];  // Lagrange at 0 from shares 1..2t+1
  uint32_t xs[MAX_M][MAX_NL];         // evaluation points 1..m
  uint32_t one[MAX_NL], three[MAX_NL];
  uint32_t r2[MAX_NL];                // R^2 mod p: standard -> Montgomery
  uint32_t pow2l[MAX_NL], inv2l[MAX_NL], pow2l1[MAX_NL], powf[MAX_NL];
  uint32_t nonce_lo, nonce_hi;        // counter of the first call
  int32_t t, m, l, k, mode, has_f;
};

// The constants a party loop reads: at a fixed t (T > 0) the parameter
// block's, whose loops unroll to constant indices; at a run-time t (T =
// 0) their copies in shared memory (a run-time index into the parameter
// block would put the block in local memory). The points of the parties
// past the senders are read from shared memory at every t.
template <int NL>
struct SgnConsts {
  const uint32_t (*xs)[NL];             // x_1..x_m
  const uint32_t (*lag)[MAX_SEND][NL];  // lag_t, lag_2t (T = 0)
};

template <int T, int NL>
__device__ __forceinline__ const uint32_t* sender_x(const SgnParams& P,
                                                    const SgnConsts<NL>& K,
                                                    int j) {
  if constexpr (T > 0) return P.xs[j];
  else return K.xs[j];
}

template <int T, int NL>
__device__ __forceinline__ const uint32_t* lag_t_of(const SgnParams& P,
                                                    const SgnConsts<NL>& K,
                                                    int i) {
  if constexpr (T > 0) return P.lag_t[i];
  else return K.lag[0][i];
}

template <int T, int NL>
__device__ __forceinline__ const uint32_t* lag_2t_of(const SgnParams& P,
                                                     const SgnConsts<NL>& K,
                                                     int i) {
  if constexpr (T > 0) return P.lag_2t[i];
  else return K.lag[1][i];
}

// The share of v at the point x: Horner(C, x) + v, C the t coefficients.
template <int NL>
__device__ __forceinline__ void horner_at(const uint32_t* v,
                                          const uint32_t (*C)[NL], int t,
                                          const uint32_t* x,
                                          const DrawParams& D,
                                          uint32_t* out) {
  uint32_t y[NL];
  fe_copy<NL>(C[0], y);
  mont_mul<NL>(y, x, D.p, D.n0inv, y);
#pragma unroll
  for (int kk = 1; kk < t; ++kk) {
    add_mod<NL>(y, C[kk], D.p, y);
    mont_mul<NL>(y, x, D.p, D.n0inv, y);
  }
  add_mod<NL>(y, v, D.p, out);
}

// Shares of value v at the senders' points x_1..x_{2t+1}.
template <int NL, int T>
__device__ __forceinline__ void dealer_split(const uint32_t* v,
                                             const uint32_t (*C)[NL], int t,
                                             const SgnParams& P,
                                             const SgnConsts<NL>& K,
                                             uint32_t (*out)[NL]) {
#pragma unroll
  for (int j = 0; j < 2 * t + 1; ++j)
    horner_at<NL>(v, C, t, sender_x<T, NL>(P, K, j), P.draw, out[j]);
}

// GRR98 reshare of the senders' degree-2t shares x into degree-t shares
// (x and out may be the same array): S = sum_i lag_2t[i] x_i, out_j =
// Horner(C, x_j) + S; S also to S_out (the parties past the senders take
// Horner(C, x_j) + S from it).
template <int NL, int T>
__device__ __forceinline__ void sgn_reshare(const uint32_t (*x)[NL],
                                            const uint32_t (*C)[NL], int t,
                                            const SgnParams& P,
                                            const SgnConsts<NL>& K,
                                            uint32_t (*out)[NL],
                                            uint32_t* S_out) {
  uint32_t S[NL];
#pragma unroll
  for (int i = 0; i < 2 * t + 1; ++i) {
    uint32_t term[NL];
    mont_mul<NL>(x[i], lag_2t_of<T, NL>(P, K, i), P.draw.p, P.draw.n0inv,
                 term);
    if (i == 0) fe_copy<NL>(term, S);
    else add_mod<NL>(S, term, P.draw.p, S);
  }
  dealer_split<NL, T>(S, C, t, P, K, out);
  fe_copy<NL>(S, S_out);
}

constexpr int SGN_THREADS = 256;      // elements of a K5 CTA, at most
// dynamic shared memory a CTA may have: 227 KB less the constants of t
// and m (SgnConsts)
constexpr int SGN_SMEM_MAX = 232448 - (MAX_M + 2 * MAX_SEND) * MAX_NL * 4;

// The widest random bits (lb) an instantiation of NL limbs takes: l + k +
// 2 <= 32 NL for any k >= 0.
__host__ __device__ constexpr int sgn_lb_max(int NL) { return 32 * NL - 1; }

// Dynamic shared memory of a K5 CTA of B elements: the draws of its
// largest call (the bits: t x lb an element, 4 NL bytes each) and its
// words of stream A (at most lb / 32 + 2 an element, k <= 64).
__host__ __device__ constexpr long long sgn_smem_bytes(int t, int lb, int nl,
                                                       int B) {
  return ((long long)t * lb * nl * 4 + ((lb + 31) / 32 + 2) * 4) * B;
}

// The widest random bits whose draws at threshold t fit a CTA of one
// warp, at most sgn_lb_max(nl): lb beyond takes passes of its bit call,
// which K5 does not make (t = 2 at six limbs past lb = 150; t = 3 at five
// and six limbs past 120 and 100; t = 4 at four, five and six limbs past
// 112, 90 and 75).
__host__ __device__ constexpr int sgn_lb_fit(int t, int nl) {
  int lb = sgn_lb_max(nl);
  while (lb > 0 && sgn_smem_bytes(t, lb, nl, 32) > SGN_SMEM_MAX) --lb;
  return lb;
}

// The bit arrays' length of an instantiation: every lb that t = T (T >
// 0), or any t from 2 on (T = 0), fits.
__host__ __device__ constexpr int sgn_lb_arrays(int T, int nl) {
  return sgn_lb_fit(T > 0 ? T : 2, nl);
}

// The CTA width of a launch: SGN_THREADS, halved while its shared memory
// would not fit (down to a warp; 0 if even that does not fit).
inline int sgn_threads(int t, int lb, int nl) {
  int B = SGN_THREADS;
  while (B > 32 && sgn_smem_bytes(t, lb, nl, B) > SGN_SMEM_MAX) B >>= 1;
  return sgn_smem_bytes(t, lb, nl, B) > SGN_SMEM_MAX ? 0 : B;
}

// The random bits of a comparison (l + 1, l in EQ mode) and its CTA
// width (sgn_threads); 0 for a configuration no instantiation takes.
inline int sgn_geometry(const SgnParams& P, int* lb) {
  if (!parties_ok(P.t, P.m) || P.k < 0 || P.k > 64) return 0;
  if (P.draw.nl < 2 || P.draw.nl > MAX_NL || P.mode < 0 || P.mode > 2)
    return 0;
  *lb = P.l + (P.mode == 2 ? 0 : 1);
  if (P.l < 1 || *lb > sgn_lb_fit(P.t, P.draw.nl)) return 0;
  return sgn_threads(P.t, *lb, P.draw.nl);
}

// Bit j of an NL-limb value held in registers (j known at run time only:
// an index into the array would move it to local memory).
template <int NL>
__device__ __forceinline__ bool bit_of(const uint32_t* v, int j) {
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < NL; ++q) w = (j >> 5) == q ? v[q] : w;
  return (w >> (j & 31)) & 1u;
}

// The CTA's view of stream B: the draws of one call at a time, staged in
// shared memory as [set kk][draw i][element].
template <int NL>
struct SgnDraws {
  const uint32_t* state;
  uint64_t nonce;
  long long n, blocks_a, e0;  // the call's n, its stream A, the CTA's first
  long long off;  // the first draw of the next call
  int cnt;        // live elements of the CTA
  int c;          // draws per element and set of the staged call
  int B;          // elements of the CTA
  uint32_t* sm;

  // Stage the next call: c draws per element in `reps` sets (set kk of
  // element e is draws off + kk*n*c + e*c + i, i < c). Every thread of
  // the CTA calls this, in the same order.
  __device__ __forceinline__ void stage(int c_, int reps,
                                        const DrawParams& D) {
    c = c_;
    __syncthreads();  // the last call's draws are read
#pragma unroll 1
    for (int kk = 0; kk < reps; ++kk)
      stage_draws<NL, fused_words<NL>()>(
          state, nonce, blocks_a, off + kk * n * c + e0 * c, cnt, c, D,
          sm + (long long)kk * c * B * NL, B);
    __syncthreads();
    off += (long long)reps * n * c;
  }
  // draw i of set kk of this thread's element
  __device__ __forceinline__ void get(int kk, int i, uint32_t* v) const {
    load_fe<NL>(sm, (long long)(kk * c + i) * B + threadIdx.x, v);
  }
  // the t coefficients of draw i
  __device__ __forceinline__ void coefs(int t, int i, uint32_t (*C)[NL])
      const {
#pragma unroll
    for (int kk = 0; kk < t; ++kk) get(kk, i, C[kk]);
  }
};

// Log-depth product of x[0..w-1] (each the senders' 2t + 1 shares) into
// x[0]: level by level, x_j <- reshare(x_j * x_{h+j}) for j < h = w / 2,
// an odd last one moves to x_h. A level is one call of h draws per
// element. With KEEP, the coefficients and S of each level's reshare of
// x_0 go to lastC and lastS: the parties past the senders take their
// share of the product from the last.
template <int NL, int T, int NS, bool KEEP>
__device__ __forceinline__ void prod_tree(uint32_t (*x)[NS][NL], int w,
                                          int t, SgnDraws<NL>& S,
                                          const SgnParams& P,
                                          const SgnConsts<NL>& K,
                                          uint32_t (*lastC)[NL],
                                          uint32_t* lastS) {
  constexpr int TM = T > 0 ? T : MAX_T;
#pragma unroll 1
  while (w > 1) {
    const int h = w >> 1;
    S.stage(h, t, P.draw);
#pragma unroll 1
    for (int j = 0; j < h; ++j) {
      uint32_t y[NS][NL], C[TM][NL], Sj[NL];
#pragma unroll
      for (int i = 0; i < 2 * t + 1; ++i)
        mont_mul<NL>(x[j][i], x[h + j][i], P.draw.p, P.draw.n0inv, y[i]);
      S.coefs(t, j, C);
      sgn_reshare<NL, T>(y, C, t, P, K, x[j], Sj);
      if (KEEP && j == 0) {
#pragma unroll
        for (int kk = 0; kk < t; ++kk) fe_copy<NL>(C[kk], lastC[kk]);
        fe_copy<NL>(Sj, lastS);
      }
    }
    if (w & 1) {
#pragma unroll
      for (int i = 0; i < 2 * t + 1; ++i) fe_copy<NL>(x[2 * h][i], x[h][i]);
    }
    w = h + (w & 1);
  }
}

// MODE 0: sgn(a); 1: a < 0; 2: a == 0; times 2^f when P.has_f; at
// bit width P.l (lb = l + 1, l in EQ mode, at most sgn_lb_fit(t, NL)),
// threshold t (T, or P.t when T = 0: at most MAX_T; mtt_sgn checks P.t
// against T) and m = P.m parties.
// a and out are (m, n) elements of NL limbs. The n elements are cut into
// chunks of `chunk`, each a call with counter P's + c; the last chunk's
// call is on n_last elements (its bucket), of which the first n - c *
// chunk are given: the rest are the zero rows that pad it, and no thread
// takes them (an element's draws depend on its index and the call's n
// only). A CTA of blockDim.x elements (sgn_threads) works in one chunk.
//
// Parties. Every reshare reads the shares of the first 2t + 1 parties
// (the senders) and gives every party Horner(C, x_j) + S; an opening reads
// at most those. So the value arrays keep the senders' shares only, and
// the parties past them (m > 2t + 1) keep what their output needs: in LT
// mode their c mod 2^l - a_r and 2 rb_l - 1 (the output is local there),
// in EQ mode at l = 1 their 1 - xor_0 (no tree), and otherwise the last
// reshare's C and S give their output. Every result is the same field
// value as the plain version's, which computes every party's share of
// every step.
template <int MODE, int T, int NL>
__global__ void __launch_bounds__(SGN_THREADS)
sgn_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
           const uint32_t* __restrict__ state, long long n, long long chunk,
           long long n_last, SgnParams P) {
  constexpr bool LT = MODE == 1, EQ = MODE == 2;
  constexpr int TM = T > 0 ? T : MAX_T;   // coefficients a draw
  constexpr int NS = 2 * TM + 1;           // shares a value keeps
  constexpr int NX = MAX_M - 3;            // parties past the senders
  constexpr int LBMAX = sgn_lb_arrays(T, NL);
  static_assert(T >= 0 && T <= MAX_T, "threshold");
  const int t = T > 0 ? T : P.t;
  const int ns = 2 * t + 1;
  const int m = P.m;
  const int l = P.l;
  const int lb = l + (EQ ? 0 : 1);       // random bits (+ sign bit)
  const int wb = (lb + 31) / 32;
  const int B = blockDim.x;
  extern __shared__ uint2 sgn_smem[];
  uint32_t* draws = reinterpret_cast<uint32_t*>(sgn_smem);
  uint32_t* words = draws + (long long)t * lb * NL * B;
  __shared__ uint32_t sx[MAX_M][NL];
  __shared__ uint32_t sl[T > 0 ? 1 : 2][MAX_SEND][NL];
#pragma unroll
  for (int j = 0; j < MAX_M; ++j)
    copy_consts<NL>(reinterpret_cast<const uint32_t(&)[NL]>(P.xs[j]),
                    sx[j], j < m ? NL : 0);
  if constexpr (T == 0) {
#pragma unroll
    for (int i = 0; i < MAX_SEND; ++i) {
      copy_consts<NL>(reinterpret_cast<const uint32_t(&)[NL]>(P.lag_t[i]),
                      sl[0][i], i < t + 1 ? NL : 0);
      copy_consts<NL>(reinterpret_cast<const uint32_t(&)[NL]>(P.lag_2t[i]),
                      sl[1][i], i < ns ? NL : 0);
    }
  }
  const SgnConsts<NL> K = {sx, sl};   // read after the first barrier
  const int tid = threadIdx.x;
  // the CTA's chunk c, its call (n_c elements, counter + c) and elements
  const long long per_chunk = (chunk + B - 1) / B;
  const long long ch = blockIdx.x / per_chunk;
  const long long first = ch * chunk;
  const long long given = n - first < chunk ? n - first : chunk;
  const long long n_c = first + chunk < n ? chunk : n_last;
  const long long e0 = (blockIdx.x - ch * per_chunk) * B;
  const long long e = first + e0 + tid;       // index into a and out
  const bool live = e0 + tid < given;
  const uint32_t* p = P.draw.p;
  const uint32_t n0 = P.draw.n0inv;

  SgnDraws<NL> S;
  S.state = state;
  S.nonce = (((uint64_t)P.nonce_hi << 32) | P.nonce_lo) + (uint64_t)ch;
  S.n = n_c;
  S.e0 = e0;
  S.off = 0;
  S.cnt = (int)(given - e0 < B ? given - e0 : B);
  S.c = 0;
  S.B = B;
  S.sm = draws;

  // stream A: the random bits and r_divl < 2^k; this element's words
  // stay in shared memory (bit j in word j / 32)
  const int wk = (P.k + 31) / 32;
  const int wpe = wb + wk;
  S.blocks_a = (n_c * wpe + RATE_WORDS - 1) / RATE_WORDS;
  if (S.blocks_a < 1) S.blocks_a = 1;
  stage_words(state, S.nonce, e0 * wpe, S.cnt * wpe, words);
  __syncthreads();
  const uint32_t* bits = words + tid * wpe;
  uint32_t kl[NL];
#pragma unroll
  for (int q = 0; q < NL; ++q) {
    kl[q] = 0;
    if (q < wk) {
      const uint32_t v = bits[wb + q];
      const int rem = P.k - 32 * q;
      kl[q] = rem < 32 ? v & ((1u << rem) - 1u) : v;
    }
  }

  // dealer split of the bits: E holds their shares rb until the E vector
  // replaces them
  uint32_t E[LBMAX][NS][NL];
  S.stage(lb, t, P.draw);
#pragma unroll 1
  for (int j = 0; j < lb; ++j) {
    uint32_t bm[NL], C[TM][NL];
    const bool bit = (bits[j >> 5] >> (j & 31)) & 1u;
#pragma unroll
    for (int q = 0; q < NL; ++q) bm[q] = bit ? P.one[q] : 0u;
    S.coefs(t, j, C);
    dealer_split<NL, T>(bm, C, t, P, K, E[j]);
  }
  // the parties past the senders, while the bits' draws are staged: in LT
  // mode a_r = a + r_modl + 2^l and rb_l, in EQ mode at l = 1 rb_0
  uint32_t xa[LT ? NX : 1][NL], xs1[LT || EQ ? NX : 1][NL];
  const int j_top = LT ? l : EQ && l == 1 ? 0 : -1;
#pragma unroll 1
  for (int i = ns; i < m; ++i) {
    uint32_t C[TM][NL], bm[NL], v[NL];
#pragma unroll 1
    for (int j = j_top; j >= 0; --j) {
      const bool bit = (bits[j >> 5] >> (j & 31)) & 1u;
#pragma unroll
      for (int q = 0; q < NL; ++q) bm[q] = bit ? P.one[q] : 0u;
      S.coefs(t, j, C);
      horner_at<NL>(bm, C, t, K.xs[i], P.draw, v);
      if (j == l || !LT) {
        fe_copy<NL>(v, xs1[i - ns]);
      } else if (j == l - 1) {
        fe_copy<NL>(v, xa[i - ns]);
      } else {
        add_mod<NL>(xa[i - ns], xa[i - ns], p, xa[i - ns]);
        add_mod<NL>(xa[i - ns], v, p, xa[i - ns]);
      }
    }
    if constexpr (LT) {
      if (live) {
        ldg_fe<NL>(a, (long long)i * n + e, v);
      } else {
#pragma unroll
        for (int q = 0; q < NL; ++q) v[q] = 0u;
      }
      add_mod<NL>(v, xa[i - ns], p, xa[i - ns]);
      add_mod<NL>(xa[i - ns], P.pow2l, p, xa[i - ns]);
    }
  }

  uint32_t rdiv[NS][NL];
  {
    uint32_t v[NL], C[TM][NL];
    mont_mul<NL>(kl, P.r2, p, n0, v);
    S.stage(1, t, P.draw);
    S.coefs(t, 0, C);
    dealer_split<NL, T>(v, C, t, P, K, rdiv);
  }
  // a_r = a + r_modl + 2^l with r_modl = sum_{j<l} rb_j 2^j (by doubling)
  uint32_t ar[NS][NL], z[NS][NL];
#pragma unroll
  for (int i = 0; i < ns; ++i) {
    uint32_t acc[NL], ai[NL];
    fe_copy<NL>(E[l - 1][i], acc);
#pragma unroll 1
    for (int j = l - 2; j >= 0; --j) {
      add_mod<NL>(acc, acc, p, acc);
      add_mod<NL>(acc, E[j][i], p, acc);
    }
    if (live) {
      ldg_fe<NL>(a, (long long)i * n + e, ai);
    } else {
#pragma unroll
      for (int q = 0; q < NL; ++q) ai[q] = 0u;
    }
    add_mod<NL>(ai, acc, p, ar[i]);
    add_mod<NL>(ar[i], P.pow2l, p, ar[i]);
  }

  // open c = a_r + 2^l r_divl from shares 1..t+1, to standard form
  uint32_t c[NL];
#pragma unroll
  for (int i = 0; i < t + 1; ++i) {
    uint32_t ci[NL];
    mont_mul<NL>(rdiv[i], P.pow2l, p, n0, ci);
    add_mod<NL>(ar[i], ci, p, ci);
    mont_mul<NL>(ci, lag_t_of<T, NL>(P, K, i), p, n0, ci);
    if (i == 0) fe_copy<NL>(ci, c);
    else add_mod<NL>(c, ci, p, c);
  }
  {
    uint32_t unit[NL] = {1u};
    mont_mul<NL>(c, unit, p, n0, c);
  }
  {
    uint32_t cm[NL];  // c mod 2^l, then in Montgomery form
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      const int rem = l - 32 * q;
      cm[q] = rem <= 0 ? 0u : rem < 32 ? c[q] & ((1u << rem) - 1u) : c[q];
    }
    mont_mul<NL>(cm, P.r2, p, n0, cm);
#pragma unroll
    for (int i = 0; i < ns; ++i) sub_mod<NL>(cm, ar[i], p, z[i]);
    if constexpr (LT) {   // the parties past the senders: z = cm - a_r
#pragma unroll 1
      for (int i = ns; i < m; ++i) sub_mod<NL>(cm, xa[i - ns], p, xa[i - ns]);
    }
  }
  if constexpr (EQ) {   // ... at l = 1: 1 - xor_0, their output
    const bool cb = bit_of<NL>(c, 0);
#pragma unroll 1
    for (int i = ns; i < m && l == 1; ++i) {
      if (cb) sub_mod<NL>(P.one, xs1[i - ns], p, xs1[i - ns]);
      sub_mod<NL>(P.one, xs1[i - ns], p, xs1[i - ns]);
    }
  }

  // xor_j = c_j XOR r_j, as shares: c_j ? 1 - rb_j : rb_j (in LT mode
  // recomputed where the suffix loop needs it)
  uint32_t X[LT ? 1 : LBMAX][NS][NL];
  if constexpr (!LT) {
#pragma unroll 1
    for (int j = 0; j < l; ++j) {
      const bool cb = bit_of<NL>(c, j);
#pragma unroll
      for (int i = 0; i < ns; ++i) {
        if (cb) sub_mod<NL>(P.one, E[j][i], p, X[j][i]);
        else fe_copy<NL>(E[j][i], X[j][i]);
      }
    }
  }

  bool g = false;
  if constexpr (!EQ) {
    // s = 2 r_l - 1; E_j = s + (rb_j - c_j) + 3 sum_{j' > j} xor_j';
    // E_l = s - 1 + 3 sum_j xor_j
    uint32_t s[NS][NL], suf[NS][NL];
#pragma unroll
    for (int i = 0; i < ns; ++i) {
      add_mod<NL>(E[l][i], E[l][i], p, s[i]);
      sub_mod<NL>(s[i], P.one, p, s[i]);
#pragma unroll
      for (int q = 0; q < NL; ++q) suf[i][q] = 0u;
    }
#pragma unroll 1
    for (int j = l - 1; j >= 0; --j) {
      const bool cb = bit_of<NL>(c, j);
#pragma unroll
      for (int i = 0; i < ns; ++i) {
        uint32_t v[NL], s3[NL], x[NL];
        if constexpr (LT) {  // xor_j, from rb_j before E_j replaces it
          if (cb) sub_mod<NL>(P.one, E[j][i], p, x);
          else fe_copy<NL>(E[j][i], x);
        } else {
          fe_copy<NL>(X[j][i], x);
        }
        if (cb) sub_mod<NL>(E[j][i], P.one, p, v);
        else fe_copy<NL>(E[j][i], v);
        add_mod<NL>(v, s[i], p, v);
        add_mod<NL>(suf[i], suf[i], p, s3);
        add_mod<NL>(s3, suf[i], p, s3);
        add_mod<NL>(v, s3, p, E[j][i]);
        add_mod<NL>(suf[i], x, p, suf[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < ns; ++i) {
      uint32_t s3[NL];
      add_mod<NL>(suf[i], suf[i], p, s3);
      add_mod<NL>(s3, suf[i], p, s3);
      sub_mod<NL>(s[i], P.one, p, E[l][i]);
      add_mod<NL>(E[l][i], s3, p, E[l][i]);
    }
    prod_tree<NL, T, NS, false>(E, l + 1, t, S, P, K, nullptr, nullptr);

    // blinded public zero test of the product, one blinder per element
    uint32_t bl[NL], C[TM][NL], bsh[NS][NL];
    S.stage(1, 1, P.draw);
    S.get(0, 0, bl);
    if (is_zero<NL>(bl)) fe_copy<NL>(P.one, bl);
    S.stage(1, t, P.draw);
    S.coefs(t, 0, C);
    dealer_split<NL, T>(bl, C, t, P, K, bsh);
    uint32_t po[NL];
#pragma unroll
    for (int i = 0; i < ns; ++i) {
      uint32_t pb[NL];
      mont_mul<NL>(E[0][i], bsh[i], p, n0, pb);
      mont_mul<NL>(pb, lag_2t_of<T, NL>(P, K, i), p, n0, pb);
      if (i == 0) fe_copy<NL>(pb, po);
      else add_mod<NL>(po, pb, p, po);
    }
    g = is_zero<NL>(po);
    // h = s - 2 g s + 3; z = (z + 2^(l-1) h) / 2^l
#pragma unroll
    for (int i = 0; i < ns; ++i) {
      uint32_t h[NL];
      if (g) sub_mod<NL>(P.three, s[i], p, h);
      else add_mod<NL>(s[i], P.three, p, h);
      mont_mul<NL>(h, P.pow2l1, p, n0, h);
      add_mod<NL>(z[i], h, p, z[i]);
      mont_mul<NL>(z[i], P.inv2l, p, n0, z[i]);
    }
  }

  // the coefficients and S of the reshare that gives the output (EQ: the
  // tree's last, sgn: the final one)
  uint32_t fC[LT ? 1 : TM][NL], fS[NL];
  if constexpr (!LT) {
#pragma unroll 1
    for (int j = 0; j < l; ++j) {
#pragma unroll
      for (int i = 0; i < ns; ++i) sub_mod<NL>(P.one, X[j][i], p, X[j][i]);
    }
    prod_tree<NL, T, NS, EQ>(X, l, t, S, P, K, fC, fS);
    if constexpr (EQ) {
#pragma unroll
      for (int i = 0; i < ns; ++i) fe_copy<NL>(X[0][i], z[i]);
    } else {
      // sgn = reshare((h_all - 1) (2z - 1))
      uint32_t y[NS][NL];
#pragma unroll
      for (int i = 0; i < ns; ++i) {
        uint32_t u[NL], v[NL];
        sub_mod<NL>(X[0][i], P.one, p, u);
        add_mod<NL>(z[i], z[i], p, v);
        sub_mod<NL>(v, P.one, p, v);
        mont_mul<NL>(u, v, p, n0, y[i]);
      }
      S.stage(1, t, P.draw);
      S.coefs(t, 0, fC);
      sgn_reshare<NL, T>(y, fC, t, P, K, z, fS);
    }
  }

#pragma unroll
  for (int i = 0; i < ns; ++i) {
    if (P.has_f) mont_mul<NL>(z[i], P.powf, p, n0, z[i]);
    if (live) store_fe<NL>(out, (long long)i * n + e, z[i]);
  }
#pragma unroll 1
  for (int i = ns; i < m; ++i) {
    uint32_t y[NL];
    if constexpr (LT) {   // as the senders' z, from c mod 2^l - a_r and s
      uint32_t h[NL], s1[NL];
      add_mod<NL>(xs1[i - ns], xs1[i - ns], p, s1);
      sub_mod<NL>(s1, P.one, p, s1);
      if (g) sub_mod<NL>(P.three, s1, p, h);
      else add_mod<NL>(s1, P.three, p, h);
      mont_mul<NL>(h, P.pow2l1, p, n0, h);
      add_mod<NL>(xa[i - ns], h, p, y);
      mont_mul<NL>(y, P.inv2l, p, n0, y);
    } else if (EQ && l == 1) {
      fe_copy<NL>(xs1[i - ns], y);
    } else {
      horner_at<NL>(fS, fC, t, K.xs[i], P.draw, y);
    }
    if (P.has_f) mont_mul<NL>(y, P.powf, p, n0, y);
    if (live) store_fe<NL>(out, (long long)i * n + e, y);
  }
}

}  // namespace mtt
