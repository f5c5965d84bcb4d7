// K5 on wide prime fields: the whole Toft-style secure comparison at 7 to
// 48 limbs (p < 2^1536), L, l, k, the mode, t and m all launch
// parameters, so one compiled kernel serves every field, width and party
// count (sgn_wide_kernel).
//
// Replaces mpyc_tpu/models/pipelines.py:503 make_sgn_step ->
// _build_pallas.kernel (pallas_call :833), whose docstring takes any limb
// count, in the stream layout of its XLA step, as sgn.cuh does at two to
// six limbs: stream A, blocks 0 .. blocks_a - 1, gives element e the words
// e wpe .. (wb words of random bits, then wk of r_divl); stream B, from
// block blocks_a on, the draws of W = L + 2 words, EPB = 42 / W a block (4
// at L = 7, 2 at L = 19, 1 from L = 20 on; from L = 41 on a draw owns two
// whole blocks, 2 d and 2 d + 1), taken call by call in
// SgnSpec.draw_calls() order: a call of c draws an element and `sets`
// sets gives element e of the call's n the draws off + kk n c + e c + i.
// The kernel equals its plain version (_sgn_step_plain) bit for bit:
// every value is canonical, and the field values are the same however the
// sums are ordered.
//
// Design. A CTA of SGN_WIDE_THREADS (512) threads takes one element at a
// time (a persistent grid walks over the elements), as groups of 8, 16 or
// 32 lanes (wide.cuh WGroup: the limbs in registers, S = 1 or 2 words a
// lane, a whole warp from 17 limbs on; wide_dispatch: three
// instantiations), 64, 32 or 16 groups a CTA. Every field
// operation is one group's: the bit split's Horner forms at the senders,
// the R_k terms and a draw's reduction, each node of the product trees
// and the zero test. Each phase hands its items (a bit and a sender, a
// node and a sender, a party) to the groups in turn, with a barrier
// between phases, so kb2's element (L = 19: 16 groups) keeps 16 products
// in flight on its SM, each about L times shorter than one thread's
// whose limbs were in local memory. The element's vectors (the bit shares
// E, lb x (2t + 1) values, and outside LT mode the xor vector X, l x (2t +
// 1)) live in shared memory where they fit beside the rest (kb2's LT E:
// 127,908 bytes), else in a device workspace of the launch, one region a
// CTA (sgn_wide_ws_words; SecInt(1504), or sgn mode at SecInt(560)): a
// generic pointer to either, one code. The suffix sums of the E vector
// are a blocked scan (each group a run of bits, a Hillis-Steele scan of
// the runs' sums over the groups); r mod 2^l's shares come from the sums
// R_k = sum_{j < l} 2^j C_{k, j} of the bit split's coefficients (the
// Horner form is linear in them): each group doubles its run of bits
// from the top and scales the run by one product, and the groups' sums
// are added in a tree. A product is L rows of shuffles and multiply-adds,
// an add two ballot lookaheads, so the small integers among the factors
// enter by doubling and adding, not by a product: a party's point x_i =
// i + 1 in the Horner forms, and the Lagrange coefficients at 0 of the
// points 1..n, (-1)^(i - 1) C(n, i). Each call's draws for the element
// are staged in shared memory, SGN_WIDE_STAGE a set at a time: each
// sponge block they touch is squeezed once, by one thread, which stores
// the draws' raw words; then the groups reduce them into GF(p) (a draw
// of the element's neighbour in the same block is squeezed again by the
// neighbour's CTA).
// The field's constants come from a device buffer that each CTA copies
// into shared memory (SgnSpec.wide_consts): p, the radix table of a draw
// (radix_1 times 2^64 R^-1: a draw's top two words enter by a product of
// two rows), one, three, r2, pow2l, inv2l, pow2l1 and powf.
//
// The CTA route (built a second time with -DMTT_SGN_CTA, unit sgn_cta:
// mtt_sgn_cta). The same kernel takes two to six limbs for the calls of
// few elements that the LP solvers and the ID3 trees make: sgn.cuh runs
// one element a thread, so LPExample's 288 elements at five limbs filled
// 5 of the 132 SMs (CTAs of 64: shared memory) and an ID3 node's one
// element one thread, with its limbs and vectors in local memory. Here an
// element has a CTA, a product is L rows of a group, and the vectors sit
// in shared memory, which also takes every t at the widths where
// sgn.cuh's draws run out (sgn_lb_fit). The CTA's shape follows the call
// (_build.sgn_cta_shape): 512 threads while one CTA an SM takes every
// element, then 256, then 128 (at most 128 registers a thread: 1, 2 or 4
// CTAs an SM), as a wider CTA runs an element sooner and a narrower one
// more elements at once; groups of a whole warp at 512 and 256 threads,
// whose shuffles and ballots name a constant mask (a group of 8 lanes
// among others in its warp names one at run time, and each collective
// pays a convergence check), and of 8 lanes (a template constant) at 128,
// where more groups a CTA won (groups of 4 lost everywhere: PERF.md).
// Calls of up to _build.SGN_CTA_MAX elements take it (measured per limb
// count); larger ones stay on sgn.cuh, whose one element a thread wins
// once the card is full.
//
// Parties. As in sgn.cuh, the vectors keep the 2t + 1 senders' shares;
// the parties past them take their output in LT mode from their own a_r
// and sign bit, in EQ mode at l = 1 from their xor bit, and otherwise from
// the last reshare's coefficients and S.
//
// Bound: integer operations (SgnSpec.field_ops's products at L limbs,
// chip_smoke.py's rows), against the shares read and written.
#include "common.cuh"
#include "wide.cuh"

namespace mtt {

constexpr int SGN_WIDE_THREADS = 512;  // _build.SGN_WIDE_THREADS
constexpr int SGN_WIDE_STAGE = 128;    // draws of a set staged at a time
constexpr int SGN_WIDE_WORDS = 64;     // stream A words of an element, at most
constexpr int SGN_WIDE_SMEM_MAX = 232448;   // a CTA's shared memory, at most

// Mirrored by a ctypes structure in mpyc_tpu_torch/_build.py.
struct SgnWide {
  int32_t nl, t, m, l, k, mode, has_f;
  uint32_t n0inv, nonce_lo, nonce_hi;
  int32_t group, threads;  // lanes of a group, threads of a CTA
  long long ws_stride;   // workspace words of a CTA (0: shared memory)
};

// The constants' L-word values in the device buffer: p, radix_0, radix_1
// 2^64 R^-1, one, three, r2, pow2l, inv2l, pow2l1, powf
// (pipelines.SgnSpec.wide_consts).
constexpr int SGN_WIDE_CONSTS = 10;

// The element's values in shared memory beside the constants and the
// staged draws, in L-word values: c (standard form), a_r then z (m), s
// (2t + 1), the zero test's terms (2t + 1), r_divl's shares (t + 1), R_k
// (t), the xor or sign bit of the parties past the senders (m), the last
// reshare's coefficients (t) and S, the blinder, the flag.
__host__ __device__ constexpr int sgn_wide_state(int t, int m) {
  return 1 + m + 2 * (2 * t + 1) + (t + 1) + t + m + t + 1 + 1 + 1;
}

// The groups of a wide K5 CTA at L limbs (the CTA route's: its threads
// over its group's lanes).
__host__ __device__ constexpr int sgn_wide_groups(int L) {
  return SGN_WIDE_THREADS / wide_group(L);
}

// Shared memory words of a CTA of ng groups but the vectors: the
// constants, the staged draws (t sets of SGN_WIDE_STAGE draws of L + 2
// words), the stream-A words, the element's values and the groups'
// scratch (two values a group for the scans, and two).
__host__ __device__ constexpr long long sgn_wide_base_words(int t, int m,
                                                            int L, int ng) {
  return (long long)(SGN_WIDE_CONSTS + sgn_wide_state(t, m) + 2 * ng + 2) *
             L +
         (long long)t * SGN_WIDE_STAGE * (L + 2) + SGN_WIDE_WORDS;
}

// The vectors' words: the bit shares E (lb x (2t + 1)) and, unless LT,
// the xor vector X (l x (2t + 1)), L words each.
__host__ __device__ constexpr long long sgn_wide_vec_words(int t, int L,
                                                           int l, int mode) {
  return (long long)(l + (mode == 2 ? 0 : 1) + (mode == 1 ? 0 : l)) *
         (2 * t + 1) * L;
}

// Whether the vectors fit in shared memory beside the rest; the dynamic
// shared memory of a CTA; the workspace words of a CTA (0 when they fit);
// ng groups a CTA.
__host__ __device__ constexpr bool sgn_wide_in_smem(int t, int m, int L,
                                                    int l, int mode,
                                                    int ng) {
  return (sgn_wide_base_words(t, m, L, ng) +
          sgn_wide_vec_words(t, L, l, mode)) * 4 <= SGN_WIDE_SMEM_MAX;
}
__host__ __device__ constexpr long long sgn_wide_smem_bytes(int t, int m,
                                                            int L, int l,
                                                            int mode,
                                                            int ng) {
  return (sgn_wide_base_words(t, m, L, ng) +
          (sgn_wide_in_smem(t, m, L, l, mode, ng)
               ? sgn_wide_vec_words(t, L, l, mode) : 0)) * 4;
}
__host__ __device__ constexpr long long sgn_wide_ws_words(int t, int m,
                                                          int L, int l,
                                                          int mode, int ng) {
  return sgn_wide_in_smem(t, m, L, l, mode, ng)
             ? 0 : sgn_wide_vec_words(t, L, l, mode);
}

// The group's field operations out of line: a product of 7 to 48 limbs
// is hundreds of instructions, against which a call costs little, and
// the kernel's many call sites each inlined would multiply the unit's
// build time.
template <int S, bool WARP, int GL>
static __device__ __noinline__ WV<S> sw_mul(const WGroup<S, WARP, GL> G,
                                            const WV<S> a, const WV<S> b,
                                            int rows) {
  return G.mul(a, b, rows);
}

template <int S, bool WARP, int GL>
static __device__ __noinline__ WV<S> sw_add(const WGroup<S, WARP, GL> G,
                                            const WV<S> a, const WV<S> b) {
  return G.add(a, b);
}

template <int S, bool WARP, int GL>
static __device__ __noinline__ WV<S> sw_sub(const WGroup<S, WARP, GL> G,
                                            const WV<S> a, const WV<S> b) {
  return G.sub(a, b);
}

// The raw words of draws base + kk setstride + j0 + r (kk < sets, r <
// cnt) of stream B (W-word draws from block blocks_a on) to sm[(kk
// SGN_WIDE_STAGE + r) W ..]. Every thread of the CTA calls it; each block
// is squeezed once, by one thread. Out of line, so the permutation is
// compiled once.
static __device__ __noinline__ void sgnw_squeeze(
    const uint32_t* __restrict__ state, uint64_t nonce, long long blocks_a,
    long long base, long long setstride, int sets, int j0, int cnt, int W,
    uint32_t* sm) {
  if (W <= RATE_WORDS) {
    const int epb = RATE_WORDS / W;
    int total = 0;
    for (int kk = 0; kk < sets; ++kk) {
      const long long d0 = base + kk * setstride + j0;
      total += (int)((d0 + cnt - 1) / epb - d0 / epb + 1);
    }
    for (int q = threadIdx.x; q < total; q += blockDim.x) {
      int kk = 0, rem = q;
      long long d0 = base + j0;
      for (;;) {
        d0 = base + kk * setstride + j0;
        const int nb = (int)((d0 + cnt - 1) / epb - d0 / epb + 1);
        if (rem < nb) break;
        rem -= nb;
        ++kk;
      }
      const long long blk = d0 / epb + rem;
      uint64_t A[25];
      squeeze_block(state, nonce, (unsigned long long)(blocks_a + blk), A);
      for (int s = 0; s < epb; ++s) {
        const long long r = blk * epb + s - d0;
        if (r >= 0 && r < cnt) {
          uint32_t* dst = sm + (kk * SGN_WIDE_STAGE + r) * W;
          for (int w = 0; w < W; ++w) dst[w] = rate_word(A, s * W + w);
        }
      }
    }
  } else {
    // from 41 limbs on: draw d owns the whole blocks 2 d and 2 d + 1, its
    // words the first W of their rate words; a thread a block
    for (int q = threadIdx.x; q < 2 * sets * cnt; q += blockDim.x) {
      const int h = q & 1, dq = q >> 1;
      const int kk = dq / cnt, r = dq - kk * cnt;
      const long long d = base + kk * setstride + j0 + r;
      uint64_t A[25];
      squeeze_block(state, nonce,
                    (unsigned long long)(blocks_a + 2 * d + h), A);
      uint32_t* dst = sm + (kk * SGN_WIDE_STAGE + r) * W + h * RATE_WORDS;
      const int nw = h ? W - RATE_WORDS : RATE_WORDS;
      for (int w = 0; w < nw; ++w) dst[w] = rate_word(A, w);
    }
  }
}

static __device__ __forceinline__ bool wbit(const uint32_t* w, int j) {
  return (w[j >> 5] >> (j & 31)) & 1u;
}

// The CTA's view of one launch and element: the group of this thread, the
// constants, the staged draws and the element's place in the stream.
template <int S, bool WARP, int GL>
struct Sgnw {
  WGroup<S, WARP, GL> G;
  int gi, NG, L, t, ns, W;
  const uint32_t *C, *p, *one, *three, *r2, *pow2l,
      *inv2l, *pow2l1, *powf;
  uint32_t* stage;
  const uint32_t* state;
  uint64_t nonce;
  long long blocks_a, nc, el, off;   // the call's n, the element, next draw

  __device__ WV<S> mul(const WV<S>& a, const WV<S>& b, int rows = 0) const {
    return sw_mul<S, WARP, GL>(G, a, b, rows);
  }
  __device__ WV<S> add(const WV<S>& a, const WV<S>& b) const {
    return sw_add<S, WARP, GL>(G, a, b);
  }
  __device__ WV<S> sub(const WV<S>& a, const WV<S>& b) const {
    return sw_sub<S, WARP, GL>(G, a, b);
  }
  __device__ WV<S> ld(const uint32_t* v) const { return G.ld(v); }
  __device__ void st(uint32_t* v, const WV<S>& x) const { G.st(v, x); }

  // The staged coefficients of draw slot r (t of them, stride cstride()).
  __device__ const uint32_t* coefs(int r) const { return stage + r * W; }
  __device__ long long cstride() const {
    return (long long)SGN_WIDE_STAGE * W;
  }
  // The call is taken: the next call's draws follow.
  __device__ void next(int sets, int c) { off += (long long)sets * nc * c; }

  // Stage draws j0 .. j0 + cnt - 1 of every set of the current call (c
  // draws an element and set), each reduced into GF(p) by a group: chunk
  // 0 (words 0 .. L - 1) times radix_0 plus chunk 1 (the last two words)
  // times radix_1: a product of two rows, chunk 1 times radix_1 2^64 R^-1
  // times 2^-64. In place. Every thread calls it; it ends with a
  // barrier.
  __device__ void stage_pass(int sets, int c, int j0, int cnt) {
    sgnw_squeeze(state, nonce, blocks_a, off + el * c, nc * c, sets, j0, cnt,
                 W, stage);
    __syncthreads();
    const WV<S> rad0 = ld(C + L), rad1 = ld(C + 2 * L);
    for (int it = gi; it < sets * cnt; it += NG) {
      const int kk = it / cnt, r = it - kk * cnt;
      uint32_t* d = stage + (kk * SGN_WIDE_STAGE + r) * W;
      WV<S> c1;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int j = G.q + G.g * s;
        c1.w[s] = j < W - L ? d[L + j] : 0u;
      }
      const WV<S> v = mul(ld(d), rad0);
      st(d, add(v, mul(rad1, c1, 2)));
    }
    __syncthreads();
  }

  // y k for a small integer k >= 1 (a party's point, a Lagrange
  // coefficient's size): by doubling and adding.
  __device__ WV<S> mul_pt(const WV<S>& y, int k) const {
    int top = 0;
    while (k >> (top + 1)) ++top;
    WV<S> r = y;
    for (int b = top - 1; b >= 0; --b) {
      r = add(r, r);
      if ((k >> b) & 1) r = add(r, y);
    }
    return r;
  }

  // y times the Lagrange coefficient at 0 of point i + 1 among the points
  // 1..n: (-1)^i C(n, i + 1), a small integer (at most 126, at n = 9).
  __device__ WV<S> mul_lag(const WV<S>& y, int n, int i) const {
    int c = 1;
    for (int j = 1; j <= i + 1; ++j) c = c * (n - j + 1) / j;
    const WV<S> r = mul_pt(y, c);
    if (!(i & 1)) return r;
    WV<S> z;
#pragma unroll
    for (int s = 0; s < S; ++s) z.w[s] = 0u;
    return sub(z, r);
  }

  // Horner(C, x_i) + v: C_kk at Cr + kk cs (t of them), x_i = i + 1 party
  // i's point.
  __device__ WV<S> horner(const WV<S>& v, const uint32_t* Cr, long long cs,
                          int i) const {
    WV<S> y = mul_pt(ld(Cr), i + 1);
    for (int kk = 1; kk < t; ++kk)
      y = mul_pt(add(y, ld(Cr + kk * cs)), i + 1);
    return add(y, v);
  }

  // Log-depth product of x[0..w-1] (each 2t + 1 shares of L words) into
  // x[0]: level by level, x_j <- reshare(x_j x_{h+j}) for j < h = w / 2,
  // an odd last one moved to x_h. A level is one call of h draws per
  // element and set, staged SGN_WIDE_STAGE at a time; its nodes' products
  // and Lagrange terms (a node and a sender an item) go to x_{h+j}, their
  // sum S_j to x_{h+j}'s first share, then each new share (a node and a
  // sender) is Horner(C_j, x_i) + S_j. With keep, the coefficients and S
  // of each level's reshare of x_0 go to lastC and lastS.
  __device__ void tree(uint32_t* x, int w, bool keep, uint32_t* lastC,
                       uint32_t* lastS) {
    const long long row = (long long)ns * L;
    while (w > 1) {
      const int h = w >> 1;
      for (int j0 = 0; j0 < h; j0 += SGN_WIDE_STAGE) {
        const int cnt = h - j0 < SGN_WIDE_STAGE ? h - j0 : SGN_WIDE_STAGE;
        stage_pass(t, h, j0, cnt);
        for (int it = gi; it < cnt * ns; it += NG) {
          const int r = it / ns, i = it - r * ns, j = j0 + r;
          uint32_t* y = x + (h + j) * row + i * L;
          st(y, mul_lag(mul(ld(x + j * row + i * L), ld(y)), ns, i));
        }
        __syncthreads();
        for (int r = gi; r < cnt; r += NG) {
          uint32_t* y = x + (h + j0 + r) * row;
          WV<S> s = ld(y);
          for (int i = 1; i < ns; ++i) s = add(s, ld(y + i * L));
          st(y, s);
        }
        __syncthreads();
        for (int it = gi; it < cnt * ns; it += NG) {
          const int r = it / ns, i = it - r * ns, j = j0 + r;
          const uint32_t* Sj = x + (h + j) * row;
          st(x + j * row + i * L,
             horner(ld(Sj), coefs(r), cstride(), i));
          if (keep && j == 0 && i == 0) {
            for (int kk = 0; kk < t; ++kk)
              st(lastC + kk * L, ld(coefs(0) + kk * cstride()));
            st(lastS, ld(Sj));
          }
        }
        __syncthreads();
      }
      next(t, h);
      if (w & 1) {
        for (long long q = threadIdx.x; q < row; q += blockDim.x)
          x[h * row + q] = x[2 * h * row + q];
        __syncthreads();
      }
      w = h + (w & 1);
    }
  }
};

// MODE 0: sgn(a); 1: a < 0; 2: a == 0; times 2^f when P.has_f; at bit
// width P.l, threshold P.t and P.m parties. a and out are (m, n) elements
// of L limbs, cut into chunks of `chunk`, each a call with counter P's +
// c; the last chunk's call is on n_last elements (its bucket), of which
// the given ones are its CTAs' (the padding rows' draws are skipped, as
// an element's draws depend only on its index and the call's n). CTA b
// takes the elements b, b + gridDim.x, ..., its vectors in shared memory
// or at ws + b ws_stride. THREADS threads a CTA, in groups of GL lanes (0:
// wide_group(L), 7 to 48 limbs), at most 128 registers a thread, so that
// 512 / THREADS CTAs fit an SM by registers.
template <int S, bool WARP, int THREADS, int GL>
__global__ void __launch_bounds__(THREADS, SGN_WIDE_THREADS / THREADS)
sgn_wide_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                const uint32_t* __restrict__ state, long long n,
                long long chunk, long long n_last,
                const uint32_t* __restrict__ consts, uint32_t* ws,
                SgnWide P) {
  extern __shared__ uint32_t sgnw_smem[];
  const int L = P.nl, t = P.t, m = P.m, ns = 2 * t + 1, l = P.l;
  const bool LT = P.mode == 1, EQ = P.mode == 2;
  const int lb = l + (EQ ? 0 : 1);       // random bits (+ sign bit)
  const int wb = (lb + 31) / 32, wk = (P.k + 31) / 32, wpe = wb + wk;
  Sgnw<S, WARP, GL> K;
  const int g = WARP ? 32 : GL ? GL : wide_group(L);
  K.L = L;
  K.t = t;
  K.ns = ns;
  K.W = L + 2;
  K.NG = THREADS / g;
  K.gi = threadIdx.x / g;
  K.C = sgnw_smem;
  K.stage = sgnw_smem + SGN_WIDE_CONSTS * L;
  uint32_t* words = K.stage + t * SGN_WIDE_STAGE * K.W;
  uint32_t* cstd = words + SGN_WIDE_WORDS;
  uint32_t* zs = cstd + L;               // a_r, then z, of each party
  uint32_t* ss = zs + m * L;             // s = 2 rb_l - 1 of each sender
  uint32_t* pb = ss + ns * L;            // the zero test's terms
  uint32_t* rdiv = pb + ns * L;          // r_divl's shares at 1..t + 1
  uint32_t* R = rdiv + (t + 1) * L;      // sum_{j < l} 2^j C_{k, j}
  uint32_t* xs1 = R + t * L;             // the parties past the senders
  uint32_t* fC = xs1 + m * L;            // the output's last reshare
  uint32_t* fS = fC + t * L;
  uint32_t* bl = fS + L;                 // the blinder
  uint32_t* flag = bl + L;
  uint32_t* scr = flag + L;              // two values a group, and two
  uint32_t* tmp = scr + 2 * K.NG * L;
  uint32_t* vec = tmp + 2 * L;           // the vectors, where they fit
  wstage(consts, SGN_WIDE_CONSTS * L, sgnw_smem);
  K.p = K.C;
  K.one = K.C + 3 * L;
  K.three = K.one + L;
  K.r2 = K.three + L;
  K.pow2l = K.r2 + L;
  K.inv2l = K.pow2l + L;
  K.pow2l1 = K.inv2l + L;
  K.powf = K.pow2l1 + L;
  K.state = state;
  __syncthreads();
  K.G.init(L, K.p, P.n0inv);
  const WGroup<S, WARP, GL>& G = K.G;
  const int gi = K.gi, NG = K.NG;
  const long long row = (long long)ns * L;
  const long long cs = K.cstride();
  uint32_t* Ev = sgn_wide_in_smem(t, m, L, l, P.mode, NG)
                     ? vec : ws + blockIdx.x * P.ws_stride;
  uint32_t* Xv = Ev + lb * row;          // xor vector (not LT)
  WV<S> zero;
#pragma unroll
  for (int s = 0; s < S; ++s) zero.w[s] = 0u;

#pragma unroll 1
  for (long long e = blockIdx.x; e < n; e += gridDim.x) {
    const long long ch = e / chunk;
    K.el = e - ch * chunk;
    K.nc = (ch + 1) * chunk < n ? chunk : n_last;
    K.nonce = (((uint64_t)P.nonce_hi << 32) | P.nonce_lo) + (uint64_t)ch;
    K.blocks_a = (K.nc * wpe + RATE_WORDS - 1) / RATE_WORDS;
    if (K.blocks_a < 1) K.blocks_a = 1;
    K.off = 0;
    stage_words(state, K.nonce, K.el * wpe, wpe, words);
    __syncthreads();

    // the bit split, call (t, lb): E[j] = split(rb_j), a bit and a sender
    // an item; R_k = sum_{j < l} 2^j C_{k, j} (this group's bits); the
    // parties past the senders take their share of rb_l (LT) or rb_0 (EQ
    // at l = 1)
    WV<S> acc[MAX_T];
#pragma unroll
    for (int kk = 0; kk < MAX_T; ++kk) acc[kk] = zero;
    const int j_top = LT ? l : EQ && l == 1 ? 0 : -1;
    for (int j0 = 0; j0 < lb; j0 += SGN_WIDE_STAGE) {
      const int cnt = lb - j0 < SGN_WIDE_STAGE ? lb - j0 : SGN_WIDE_STAGE;
      K.stage_pass(t, lb, j0, cnt);
      const int past = j_top >= j0 && j_top < j0 + cnt ? m - ns : 0;
      for (int it = gi; it < cnt * ns + past; it += NG) {
        int r, i;
        if (it < cnt * ns) {
          r = it / ns;
          i = it - r * ns;
        } else {
          r = j_top - j0;
          i = ns + it - cnt * ns;
        }
        const int j = j0 + r;
        const WV<S> bm = wbit(words, j) ? K.ld(K.one) : zero;
        K.st(i < ns ? Ev + j * row + i * L : xs1 + i * L,
             K.horner(bm, K.coefs(r), cs, i));
      }
      // this pass's bits below l, a run of q a group: its sum of 2^(j -
      // lo) C_{k, j} by doubling from the top, times 2^(j0 + lo) R^-1
      const int nb = l - j0 < cnt ? l - j0 : cnt;
      const int q = nb > 0 ? (nb + NG - 1) / NG : 0, lo = gi * q;
      const int hi = lo + q < nb ? lo + q : nb;
      if (lo < hi) {
        const WV<S> pw = G.pow2(j0 + lo);
#pragma unroll
        for (int kk = 0; kk < MAX_T; ++kk) {
          if (kk < t) {
            WV<S> sr = K.ld(K.coefs(hi - 1) + kk * cs);
            for (int r = hi - 2; r >= lo; --r)
              sr = K.add(K.add(sr, sr), K.ld(K.coefs(r) + kk * cs));
            acc[kk] = K.add(acc[kk], K.mul(pw, sr));
          }
        }
      }
      __syncthreads();
    }
    K.next(t, lb);
    // R_k: the groups' sums of 2^j C_{k, j} R^-1 added in a tree, times R^2
#pragma unroll
    for (int kk = 0; kk < MAX_T; ++kk) {
      if (kk < t) {
        K.st(scr + gi * L, acc[kk]);
        __syncthreads();
        for (int h = NG >> 1; h > 0; h >>= 1) {
          if (gi < h)
            K.st(scr + gi * L,
                 K.add(K.ld(scr + gi * L), K.ld(scr + (gi + h) * L)));
          __syncthreads();
        }
        if (gi == 0) K.st(R + kk * L, K.mul(K.ld(scr), K.ld(K.r2)));
      }
    }

    // r_divl < 2^k, call (t, 1): its shares at the points 1..t + 1; a_r =
    // a + r_modl + 2^l at every party, r_modl's shares Horner(R, x_i) + r
    // mod 2^l
    K.stage_pass(t, 1, 0, 1);
    if (gi == 0) K.st(tmp, K.mul(G.low_bits(words + wb, P.k), K.ld(K.r2)));
    if (gi == 1) K.st(tmp + L, K.mul(G.low_bits(words, l), K.ld(K.r2)));
    __syncthreads();
    for (int it = gi; it < t + 1 + m; it += NG) {
      if (it <= t) {
        K.st(rdiv + it * L, K.horner(K.ld(tmp), K.coefs(0), cs, it));
      } else {
        const int i = it - t - 1;
        const WV<S> rm = K.horner(K.ld(tmp + L), R, L, i);
        const WV<S> ai = K.add(K.ld(a + ((long long)i * n + e) * L), rm);
        K.st(zs + i * L, K.add(ai, K.ld(K.pow2l)));
      }
    }
    K.next(t, 1);
    __syncthreads();
    // open c = a_r + 2^l r_divl from shares 1..t + 1, to standard form
    for (int i = gi; i <= t; i += NG) {
      const WV<S> ci = K.add(K.ld(zs + i * L),
                             K.mul(K.ld(rdiv + i * L), K.ld(K.pow2l)));
      K.st(pb + i * L, K.mul_lag(ci, t + 1, i));
    }
    __syncthreads();
    if (gi == 0) {
      WV<S> c = K.ld(pb);
      for (int i = 1; i <= t; ++i) c = K.add(c, K.ld(pb + i * L));
      K.st(cstd, K.mul(c, G.word0(1u)));
      // each lane reads back the words it wrote
      K.st(tmp, K.mul(G.low_bits(cstd, l), K.ld(K.r2)));
    }
    __syncthreads();
    // z = (c mod 2^l) - a_r at every party; in EQ mode at l = 1 the
    // parties past the senders take 1 - xor_0. xor_j = c_j XOR r_j, as
    // shares: c_j ? 1 - rb_j : rb_j (not in LT mode, whose suffix sums
    // recompute it); s = 2 rb_l - 1 (not in EQ mode)
    {
      const int nx = LT ? 0 : l * ns, nz = EQ ? 0 : ns;
      for (int it = gi; it < m + nx + nz; it += NG) {
        if (it < m) {
          const int i = it;
          K.st(zs + i * L, K.sub(K.ld(tmp), K.ld(zs + i * L)));
          if (EQ && l == 1 && i >= ns) {
            WV<S> v = K.ld(xs1 + i * L);
            if (wbit(cstd, 0)) v = K.sub(K.ld(K.one), v);
            K.st(xs1 + i * L, K.sub(K.ld(K.one), v));
          }
        } else if (it < m + nx) {
          const int j = (it - m) / ns, i = it - m - j * ns;
          const uint32_t* x = Ev + j * row + i * L;
          K.st(Xv + j * row + i * L,
               wbit(cstd, j) ? K.sub(K.ld(K.one), K.ld(x)) : K.ld(x));
        } else {
          const int i = it - m - nx;
          const WV<S> rl = K.ld(Ev + l * row + i * L);
          K.st(ss + i * L, K.sub(K.add(rl, rl), K.ld(K.one)));
        }
      }
    }
    __syncthreads();

    bool gz = false;
    if (!EQ) {
      // E_j = s + (rb_j - c_j) + 3 sum_{j' > j} xor_j'; E_l = s - 1 + 3
      // sum_j xor_j. Group gi takes the bits lo .. hi - 1 of each sender.
      const int qb = (l + NG - 1) / NG;
      const int lo = gi * qb < l ? gi * qb : l;
      const int hi = lo + qb < l ? lo + qb : l;
      const WV<S> onev = K.ld(K.one), threev = K.ld(K.three);
      for (int i = 0; i < ns; ++i) {
        WV<S> part = zero;
        for (int j = lo; j < hi; ++j) {
          const uint32_t* ej = Ev + j * row + i * L;
          WV<S> x;
          if (LT) x = wbit(cstd, j) ? K.sub(onev, K.ld(ej)) : K.ld(ej);
          else x = K.ld(Xv + j * row + i * L);
          part = K.add(part, x);
        }
        K.st(scr + gi * L, part);
        __syncthreads();
        // inclusive suffix sums of the runs' sums over the groups
        uint32_t *src = scr, *dst = scr + NG * L;
        for (int h = 1; h < NG; h <<= 1) {
          WV<S> v = K.ld(src + gi * L);
          if (gi + h < NG) v = K.add(v, K.ld(src + (gi + h) * L));
          K.st(dst + gi * L, v);
          __syncthreads();
          uint32_t* sw = src;
          src = dst;
          dst = sw;
        }
        const WV<S> si = K.ld(ss + i * L);
        if (lo < hi) {
          // T_j = s + 3 (the sum of xor_j' over j' > j): E_j = rb_j - c_j
          // + T_j, T_(j-1) = T_j + 3 xor_j, 3 xor_j in LT mode from rb_j
          // (c_j ? 3 - 3 rb_j : 3 rb_j) before E_j replaces it
          const WV<S> suf = gi + 1 < NG ? K.ld(src + (gi + 1) * L) : zero;
          WV<S> T = K.add(K.add(K.add(suf, suf), suf), si);
          for (int j = hi - 1; j >= lo; --j) {
            uint32_t* ej = Ev + j * row + i * L;
            const bool cb = wbit(cstd, j);
            const WV<S> ev = K.ld(ej);
            const WV<S> x = LT ? ev : K.ld(Xv + j * row + i * L);
            const WV<S> x3 = K.add(K.add(x, x), x);
            const WV<S> ej1 = K.add(ev, T);
            K.st(ej, cb ? K.sub(ej1, onev) : ej1);
            T = LT && cb ? K.add(K.sub(T, x3), threev) : K.add(T, x3);
          }
        }
        if (gi == 0) {   // the total: every run's sum
          const WV<S> tot = K.ld(src);
          const WV<S> s3 = K.add(K.add(tot, tot), tot);
          K.st(Ev + l * row + i * L, K.add(K.sub(si, onev), s3));
        }
        __syncthreads();
      }
      K.tree(Ev, l + 1, false, nullptr, nullptr);

      // blinded public zero test of the product, one blinder per element
      K.stage_pass(1, 1, 0, 1);
      if (gi == 0) {
        const WV<S> b = K.ld(K.coefs(0));
        K.st(bl, G.is_zero(b) ? K.ld(K.one) : b);
      }
      K.next(1, 1);
      __syncthreads();
      K.stage_pass(t, 1, 0, 1);
      for (int i = gi; i < ns; i += NG) {
        const WV<S> bsh =
            K.horner(K.ld(bl), K.coefs(0), cs, i);
        K.st(pb + i * L, K.mul_lag(K.mul(K.ld(Ev + i * L), bsh), ns, i));
      }
      K.next(t, 1);
      __syncthreads();
      if (gi == 0) {
        WV<S> po = K.ld(pb);
        for (int i = 1; i < ns; ++i) po = K.add(po, K.ld(pb + i * L));
        const bool z = G.is_zero(po);
        if (G.lead()) flag[0] = z;
      }
      __syncthreads();
      gz = flag[0] != 0;
      // h = s - 2 g s + 3; z = (z + 2^(l-1) h) / 2^l
      for (int i = gi; i < ns; i += NG) {
        const WV<S> si = K.ld(ss + i * L), three = K.ld(K.three);
        const WV<S> h =
            K.mul(gz ? K.sub(three, si) : K.add(si, three), K.ld(K.pow2l1));
        K.st(zs + i * L,
             K.mul(K.add(K.ld(zs + i * L), h), K.ld(K.inv2l)));
      }
      __syncthreads();
    }

    if (!LT) {
      for (int it = gi; it < l * ns; it += NG) {
        const int j = it / ns, i = it - j * ns;
        uint32_t* x = Xv + j * row + i * L;
        K.st(x, K.sub(K.ld(K.one), K.ld(x)));
      }
      __syncthreads();
      K.tree(Xv, l, EQ, fC, fS);
      if (EQ) {
        for (int i = gi; i < ns; i += NG) K.st(zs + i * L, K.ld(Xv + i * L));
      } else {
        // sgn = reshare((h_all - 1) (2z - 1)), call (t, 1)
        for (int i = gi; i < ns; i += NG) {
          const WV<S> u = K.sub(K.ld(Xv + i * L), K.ld(K.one));
          const WV<S> zi = K.ld(zs + i * L);
          const WV<S> v = K.sub(K.add(zi, zi), K.ld(K.one));
          K.st(pb + i * L, K.mul_lag(K.mul(u, v), ns, i));
        }
        K.stage_pass(t, 1, 0, 1);
        if (gi == 0) {
          WV<S> s = K.ld(pb);
          for (int i = 1; i < ns; ++i) s = K.add(s, K.ld(pb + i * L));
          K.st(fS, s);
          for (int kk = 0; kk < t; ++kk)
            K.st(fC + kk * L, K.ld(K.coefs(0) + kk * cs));
        }
        K.next(t, 1);
        __syncthreads();
        for (int i = gi; i < ns; i += NG)
          K.st(zs + i * L, K.horner(K.ld(fS), fC, L, i));
      }
    }
    __syncthreads();

    for (int i = gi; i < m; i += NG) {
      WV<S> y;
      if (i < ns) {
        y = K.ld(zs + i * L);
      } else if (LT) {   // as the senders' z, from c mod 2^l - a_r and s
        const WV<S> x1 = K.ld(xs1 + i * L), three = K.ld(K.three);
        const WV<S> s1 = K.sub(K.add(x1, x1), K.ld(K.one));
        const WV<S> h =
            K.mul(gz ? K.sub(three, s1) : K.add(s1, three), K.ld(K.pow2l1));
        y = K.mul(K.add(K.ld(zs + i * L), h), K.ld(K.inv2l));
      } else if (EQ && l == 1) {
        y = K.ld(xs1 + i * L);
      } else {
        y = K.horner(K.ld(fS), fC, L, i);
      }
      if (P.has_f) y = K.mul(y, K.ld(K.powf));
      K.st(out + ((long long)i * n + e) * L, y);
    }
    __syncthreads();   // the element's shared values are read
  }
}

// A launch at an instantiation of the group arithmetic: the wide route's
// by wide_dispatch (CTAs of SGN_WIDE_THREADS, groups of wide_group(L)
// lanes), the CTA route's by its CTA width and group.
struct SgnWideLaunch {
  const void *a, *state, *consts;
  void *out, *ws, *stream;
  long long n, chunk, n_last, grid;
  int smem;
  SgnWide P;
  template <int S, bool WARP, int THREADS, int GL>
  int launch() const {
    // the most a CTA may take, allowed once past the default 48 KB
    static const cudaError_t rc = cudaFuncSetAttribute(
        sgn_wide_kernel<S, WARP, THREADS, GL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SGN_WIDE_SMEM_MAX);
    if (rc != cudaSuccess) return (int)rc;
    sgn_wide_kernel<S, WARP, THREADS, GL><<<(unsigned)grid, THREADS, smem,
                                            (cudaStream_t)stream>>>(
        (const uint32_t*)a, (uint32_t*)out, (const uint32_t*)state, n,
        chunk, n_last, (const uint32_t*)consts, (uint32_t*)ws, P);
    return (int)cudaGetLastError();
  }
  template <int S, bool WARP>
  int run() const {
    return launch<S, WARP, SGN_WIDE_THREADS, 0>();
  }
};

// The checks both routes share: a (mode, l, t, m, k) the kernel takes, a
// workspace where the vectors need one, a chunk geometry that holds.
inline bool sgn_wide_ok(const SgnWide& P, const void* ws, long long n,
                        long long chunk, long long n_last, long long grid,
                        int ng) {
  const int lb = P.l + (P.mode == 2 ? 0 : 1);
  if (!parties_ok(P.t, P.m) || P.k < 0 || P.k > 64 || P.mode < 0 ||
      P.mode > 2 || P.l < 1 || lb > 32 * P.nl - 1 ||
      (lb + 31) / 32 + (P.k + 31) / 32 > SGN_WIDE_WORDS)
    return false;
  const long long need = sgn_wide_ws_words(P.t, P.m, P.nl, P.l, P.mode, ng);
  if (need > 0 && (P.ws_stride < need || ws == nullptr)) return false;
  return n <= 0 || (chunk > 0 && n_last <= chunk &&
                    n_last >= n - (n - 1) / chunk * chunk && grid >= 1 &&
                    grid <= n);
}

#ifdef MTT_SGN_CTA
// The CTA route: two to six limbs, CTAs of 128, 256 or 512 threads in
// groups of SGN_CTA_GROUP lanes or of a whole warp (_build.sgn_cta_shape).
constexpr int SGN_CTA_MIN_NL = 2;   // _build.SGN_CTA_NL
constexpr int SGN_CTA_GROUP = 8;    // _build.SGN_CTA_GROUPS_BUILT
#endif

}  // namespace mtt

extern "C" {

#ifdef MTT_SGN_CTA
// K5's CTA route at L = 2..6 limbs, for calls of few elements: as
// mtt_sgn_wide, a CTA of P.threads (128, 256 or 512) threads an element,
// each field operation a group's of P.group (SGN_CTA_GROUP or 32) lanes.
// -1: a configuration it does not take.
int mtt_sgn_cta(const void* a, void* out, const void* state, long long n,
                long long chunk, long long n_last, const void* consts,
                void* ws, long long grid, const void* params, void* stream) {
  const mtt::SgnWide P = *(const mtt::SgnWide*)params;
  if (P.nl < mtt::SGN_CTA_MIN_NL || P.nl > mtt::MAX_NL ||
      (P.group != mtt::SGN_CTA_GROUP && P.group != 32) ||
      (P.threads != 128 && P.threads != 256 && P.threads != 512))
    return -1;
  const int ng = P.threads / P.group;
  if (!mtt::sgn_wide_ok(P, ws, n, chunk, n_last, grid, ng)) return -1;
  if (n <= 0) return 0;
  const int smem =
      (int)mtt::sgn_wide_smem_bytes(P.t, P.m, P.nl, P.l, P.mode, ng);
  const mtt::SgnWideLaunch f{a, state, consts, out, ws, stream, n, chunk,
                             n_last, grid, smem, P};
  constexpr int G = mtt::SGN_CTA_GROUP;
  // whole-warp groups: GL 32 keeps these instantiations apart from the
  // wide route's (GL 0), which the unit sgn_wide compiles
  if (P.group == 32)
    return P.threads == 128   ? f.launch<1, true, 128, 32>()
           : P.threads == 256 ? f.launch<1, true, 256, 32>()
                              : f.launch<1, true, 512, 32>();
  return P.threads == 128   ? f.launch<1, false, 128, G>()
         : P.threads == 256 ? f.launch<1, false, 256, G>()
                            : f.launch<1, false, 512, G>();
}

// Dynamic shared memory bytes of a CTA-route CTA of ng groups and its
// workspace words (0: the vectors in shared memory), for the tests.
int mtt_sgn_cta_smem(int t, int m, int L, int l, int mode, int ng) {
  return (int)mtt::sgn_wide_smem_bytes(t, m, L, l, mode, ng);
}

int mtt_sgn_cta_ws(int t, int m, int L, int l, int mode, int ng) {
  return (int)mtt::sgn_wide_ws_words(t, m, L, l, mode, ng);
}
#else
// K5 at L = 7..48 limbs: the comparison of (m, n, L) shares cut into chunks
// of `chunk` (the last call on n_last >= its given elements), one launch
// of `grid` CTAs (1 <= grid <= n), each an element at a time; ws: grid x
// P.ws_stride words of device workspace where the vectors do not fit in
// shared memory (sgn_wide_ws_words; else unused, may be null); consts:
// the SGN_WIDE_CONSTS L-word values of the kernel; P.threads and P.group
// SGN_WIDE_THREADS and wide_group(L). -1: a (mode, l, limbs, t, m, k) the
// kernel does not take (1 <= t <= 4, 2t + 1 <= m <= 16, 0 <= k <= 64, 1
// <= l with l + 1 random bits below 32 L), a workspace too small or a
// chunk geometry that does not hold.
int mtt_sgn_wide(const void* a, void* out, const void* state, long long n,
                 long long chunk, long long n_last, const void* consts,
                 void* ws, long long grid, const void* params, void* stream) {
  const mtt::SgnWide P = *(const mtt::SgnWide*)params;
  if (P.nl < mtt::WIDE_MIN_NL || P.nl > mtt::WIDE_MAX_NL ||
      P.threads != mtt::SGN_WIDE_THREADS ||
      P.group != mtt::wide_group(P.nl))
    return -1;
  const int ng = mtt::sgn_wide_groups(P.nl);
  if (!mtt::sgn_wide_ok(P, ws, n, chunk, n_last, grid, ng)) return -1;
  if (n <= 0) return 0;
  const int smem =
      (int)mtt::sgn_wide_smem_bytes(P.t, P.m, P.nl, P.l, P.mode, ng);
  return mtt::wide_dispatch(
      P.nl, mtt::SgnWideLaunch{a, state, consts, out, ws, stream, n, chunk,
                               n_last, grid, smem, P});
}

// Dynamic shared memory bytes of a K5 CTA and its workspace words (0: the
// vectors in shared memory) at (t, m, L, l, mode), for the tests and
// chip_smoke.py's reports.
int mtt_sgn_wide_smem(int t, int m, int L, int l, int mode) {
  return (int)mtt::sgn_wide_smem_bytes(t, m, L, l, mode,
                                       mtt::sgn_wide_groups(L));
}

int mtt_sgn_wide_ws(int t, int m, int L, int l, int mode) {
  return (int)mtt::sgn_wide_ws_words(t, m, L, l, mode,
                                     mtt::sgn_wide_groups(L));
}
#endif

}  // extern "C"
