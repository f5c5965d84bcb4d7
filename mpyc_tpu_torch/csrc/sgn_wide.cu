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
// Design. The narrow K5 runs one thread an element, its bit shares (lb x
// (2t + 1) values) in local memory and a call's draws for its CTA in
// shared memory. At kb2's SecInt(560) (L = 19, lb = 561) an element's bit
// shares take 125 KiB, at 48 limbs 847 KiB, past what a thread may have;
// and kb2's comparisons are small (about 70 elements a call), so one thread
// an element would run each comparison's 10^7 dependent instructions in
// series. Here a CTA of SGN_WIDE_THREADS threads takes one element at a
// time (a persistent grid walks over the elements), its vectors (the bit
// shares E, lb x (2t + 1) values, and outside LT mode the xor vector X, l
// x (2t + 1)) in a device workspace of the launch, one region a CTA
// (sgn_wide_ws_words). The bit positions, and each level of the two
// product trees, are spread over the CTA's threads with a barrier between
// steps; the suffix sums of the E vector are a blocked scan (each thread a
// run of bits, a Hillis-Steele scan of the runs' sums in shared memory);
// r mod 2^l's shares come from the sums R_k = sum_{j < l} 2^j C_{k, j} of
// the bit split's coefficients (the Horner form is linear in them), a CTA
// reduction, not a doubling chain. So an element takes about log2(l)
// barrier-separated levels rather than l dependent steps. Each call's
// draws for the element are staged in shared memory, SGN_WIDE_THREADS a
// set at a time: each sponge block they touch is squeezed once, by one
// thread, which reduces its draws into GF(p) (a draw of the element's
// neighbour in the same block is squeezed again by the neighbour's CTA).
// The field's constants come from a device buffer that each CTA copies
// into shared memory (SgnSpec.wide_consts): p, the radix table, lag_t,
// lag_2t, the m points, one, three, r2, pow2l, inv2l, pow2l1 and powf.
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

constexpr int SGN_WIDE_THREADS = 128;  // _build.SGN_WIDE_THREADS
constexpr int SGN_WIDE_WORDS = 64;     // stream A words of an element, at most

// Mirrored by a ctypes structure in mpyc_tpu_torch/_build.py.
struct SgnWide {
  int32_t nl, t, m, l, k, mode, has_f;
  uint32_t n0inv, nonce_lo, nonce_hi;
  long long ws_stride;   // workspace words of a CTA
};

// The constants' L-word values in the device buffer: p, radix_0, radix_1,
// lag_t (t + 1), lag_2t (2t + 1), the m points, one, three, r2, pow2l,
// inv2l, pow2l1, powf (pipelines.SgnSpec.wide_consts).
__host__ __device__ constexpr int sgn_wide_consts(int t, int m) {
  return 3 + (t + 1) + (2 * t + 1) + m + 7;
}

// The element's values in shared memory beside the constants and the
// staged draws, in L-word values: c (standard form), a_r then z (m), s
// (2t + 1), the zero test's terms (2t + 1), r_divl's shares (t + 1), R_k
// (t), the xor or sign bit of the parties past the senders (m), the last
// reshare's coefficients (t) and S, the blinder, the flag.
__host__ __device__ constexpr int sgn_wide_state(int t, int m) {
  return 1 + m + 2 * (2 * t + 1) + (t + 1) + t + m + t + 1 + 1 + 1;
}

// Dynamic shared memory of a CTA: the constants, the staged draws (t sets
// of SGN_WIDE_THREADS draws; the scans reuse the first set), the stream-A
// words and the element's values.
__host__ __device__ constexpr long long sgn_wide_smem_bytes(int t, int m,
                                                            int L) {
  return ((long long)(sgn_wide_consts(t, m) + t * SGN_WIDE_THREADS +
                      sgn_wide_state(t, m)) * L + SGN_WIDE_WORDS) * 4;
}

// Workspace words of a CTA: the bit shares E (lb x (2t + 1)) and, unless
// LT, the xor vector X (l x (2t + 1)), L words each.
__host__ __device__ constexpr long long sgn_wide_ws_words(int t, int L,
                                                          int l, int mode) {
  const int lb = l + (mode == 2 ? 0 : 1);
  return (long long)(lb + (mode == 1 ? 0 : l)) * (2 * t + 1) * L;
}

// The field operations of wide.cuh out of line: a product of 7 to 48 limbs
// is hundreds of instructions, against which a call costs little, and the
// kernel's many call sites each inlined took the unit's build from about
// 35 s (wide.cu) to 100 s.
static __device__ __noinline__ void sw_mul(const uint32_t* a,
                                           const uint32_t* b,
                                           const uint32_t* p, uint32_t n0,
                                           int L, uint32_t* out) {
  wmont_mul(a, b, p, n0, L, out);
}

static __device__ __noinline__ void sw_add(const uint32_t* a,
                                           const uint32_t* b,
                                           const uint32_t* p, int L,
                                           uint32_t* out) {
  wadd_mod(a, b, p, L, out);
}

static __device__ __noinline__ void sw_sub(const uint32_t* a,
                                           const uint32_t* b,
                                           const uint32_t* p, int L,
                                           uint32_t* out) {
  wsub_mod(a, b, p, L, out);
}

// Horner(C, x) + v: C_kk at C + kk * cstride (t of them); out may be v.
static __device__ void whorner(const uint32_t* v, const uint32_t* C,
                               int cstride, int t, const uint32_t* x,
                               const uint32_t* p, uint32_t n0, int L,
                               uint32_t* out) {
  uint32_t y[WIDE_MAX_NL];
  wcopy(C, L, y);
  sw_mul(y, x, p, n0, L, y);
  for (int kk = 1; kk < t; ++kk) {
    sw_add(y, C + kk * cstride, p, L, y);
    sw_mul(y, x, p, n0, L, y);
  }
  sw_add(y, v, p, L, out);
}

// Draws base + kk setstride + j (kk < sets, j0 <= j < j0 + cnt) of stream B
// (W-word draws from block blocks_a on), each reduced into GF(p), to
// sm[(kk SGN_WIDE_THREADS + j - j0) L ..]. Every thread of the CTA calls
// it; each block is squeezed once, by one thread. Out of line, so the
// permutation is compiled once.
static __device__ __noinline__ void sgnw_stage(
    const uint32_t* __restrict__ state, uint64_t nonce, long long blocks_a,
    long long base, long long setstride, int sets, int j0, int cnt,
    const uint32_t* C, uint32_t n0, int L, uint32_t* sm) {
  const int W = L + 2;
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
      uint32_t w[RATE_WORDS];
#pragma unroll
      for (int r = 0; r < RATE_WORDS; ++r) w[r] = rate_word(A, r);
      for (int s = 0; s < epb; ++s) {
        const long long r = blk * epb + s - d0;
        if (r >= 0 && r < cnt)
          wreduce_draw(w + s * W, W, C, n0, L,
                       sm + (kk * SGN_WIDE_THREADS + r) * L);
      }
    }
  } else {
    // from 41 limbs on: draw d owns the whole blocks 2 d and 2 d + 1
    for (int q = threadIdx.x; q < sets * cnt; q += blockDim.x) {
      const int kk = q / cnt, r = q - kk * cnt;
      const long long d = base + kk * setstride + j0 + r;
      uint32_t w[2 * RATE_WORDS];
      for (int h = 0; h < 2; ++h) {
        uint64_t A[25];
        squeeze_block(state, nonce,
                      (unsigned long long)(blocks_a + 2 * d + h), A);
#pragma unroll
        for (int x = 0; x < RATE_WORDS; ++x)
          w[h * RATE_WORDS + x] = rate_word(A, x);
      }
      wreduce_draw(w, W, C, n0, L, sm + (kk * SGN_WIDE_THREADS + r) * L);
    }
  }
}

// Inclusive suffix sums mod p of the CTA's values buf[tau] (L words each,
// one a thread): buf[tau] <- sum_{tau' >= tau} buf[tau'] (Hillis-Steele).
// The caller synchronises before (the values written) and the function
// ends with a barrier.
static __device__ void sgnw_suffix_scan(uint32_t* buf, const uint32_t* p,
                                        int L) {
  const int B = blockDim.x, tid = threadIdx.x;
  for (int off = 1; off < B; off <<= 1) {
    uint32_t v[WIDE_MAX_NL];
    const bool has = tid + off < B;
    if (has) wcopy(buf + (tid + off) * L, L, v);
    __syncthreads();
    if (has) sw_add(buf + tid * L, v, p, L, buf + tid * L);
    __syncthreads();
  }
}

// The value of an l-bit prefix of little-endian words as L limbs.
static __device__ __forceinline__ void low_bits(const uint32_t* w, int l,
                                                int L, uint32_t* out) {
  for (int q = 0; q < L; ++q) {
    const int rem = l - 32 * q;
    out[q] = rem <= 0 ? 0u : rem < 32 ? w[q] & ((1u << rem) - 1u) : w[q];
  }
}

static __device__ __forceinline__ bool wbit(const uint32_t* w, int j) {
  return (w[j >> 5] >> (j & 31)) & 1u;
}

static __device__ __forceinline__ bool wis_zero(const uint32_t* v, int L) {
  uint32_t acc = 0;
  for (int q = 0; q < L; ++q) acc |= v[q];
  return acc == 0;
}

// The element's view of one launch: the constants and its place in the
// stream.
struct SgnwElem {
  const uint32_t* state;
  uint64_t nonce;
  long long blocks_a, nc, el, off;   // the call's n, the element, next draw
  const uint32_t *C, *p, *lag_t, *lag_2t, *xs, *one, *three, *r2, *pow2l,
      *inv2l, *pow2l1, *powf;
  uint32_t n0;
  int L, t, ns;
  uint32_t* stage;

  // Stage draws j0 .. j0 + cnt - 1 of every set of the current call (c
  // draws an element and set).
  __device__ void stage_pass(int sets, int c, int j0, int cnt) const {
    sgnw_stage(state, nonce, blocks_a, off + el * c, nc * c, sets, j0, cnt,
               C, n0, L, stage);
  }
  // The call is taken: the next call's draws follow.
  __device__ void next(int sets, int c) { off += (long long)sets * nc * c; }
  // The staged coefficients of draw slot r (t of them, stride cstride()).
  __device__ const uint32_t* coefs(int r) const {
    return stage + r * L;
  }
  __device__ int cstride() const { return SGN_WIDE_THREADS * L; }
};

// Log-depth product of x[0..w-1] (each 2t + 1 shares of L words, the
// element's workspace) into x[0]: level by level, x_j <- reshare(x_j
// x_{h+j}) for j < h = w / 2, an odd last one moved to x_h. A level is one
// call of h draws per element and set, staged SGN_WIDE_THREADS at a time.
// With keep, the coefficients and S of each level's reshare of x_0 go to
// lastC and lastS.
static __device__ void sgnw_tree(uint32_t* x, int w, SgnwElem& E, bool keep,
                                 uint32_t* lastC, uint32_t* lastS) {
  const int L = E.L, t = E.t, ns = E.ns, B = SGN_WIDE_THREADS;
  const long long row = (long long)ns * L;
  while (w > 1) {
    const int h = w >> 1;
    for (int j0 = 0; j0 < h; j0 += B) {
      const int cnt = h - j0 < B ? h - j0 : B;
      E.stage_pass(t, h, j0, cnt);
      __syncthreads();
      const int j = j0 + threadIdx.x;
      if (j < h) {
        uint32_t S[WIDE_MAX_NL], y[WIDE_MAX_NL];
        for (int i = 0; i < ns; ++i) {
          sw_mul(x + j * row + i * L, x + (h + j) * row + i * L, E.p,
                    E.n0, L, y);
          sw_mul(y, E.lag_2t + i * L, E.p, E.n0, L, y);
          if (i == 0) wcopy(y, L, S);
          else sw_add(S, y, E.p, L, S);
        }
        const uint32_t* Cj = E.coefs(threadIdx.x);
        for (int i = 0; i < ns; ++i)
          whorner(S, Cj, E.cstride(), t, E.xs + i * L, E.p, E.n0, L,
                  x + j * row + i * L);
        if (keep && j == 0) {
          for (int kk = 0; kk < t; ++kk)
            wcopy(Cj + kk * E.cstride(), L, lastC + kk * L);
          wcopy(S, L, lastS);
        }
      }
      __syncthreads();
    }
    E.next(t, h);
    if (w & 1) {
      for (long long q = threadIdx.x; q < row; q += blockDim.x)
        x[h * row + q] = x[2 * h * row + q];
      __syncthreads();
    }
    w = h + (w & 1);
  }
}

// MODE 0: sgn(a); 1: a < 0; 2: a == 0; times 2^f when P.has_f; at bit
// width P.l, threshold P.t and P.m parties. a and out are (m, n) elements
// of L limbs, cut into chunks of `chunk`, each a call with counter P's +
// c; the last chunk's call is on n_last elements (its bucket), of which
// the given ones are its CTAs' (the padding rows' draws are skipped, as
// an element's draws depend only on its index and the call's n). CTA b
// takes the elements b, b + gridDim.x, ..., its vectors at ws + b
// ws_stride.
__global__ void __launch_bounds__(SGN_WIDE_THREADS)
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
  const int B = blockDim.x, tid = threadIdx.x;
  const int nconst = sgn_wide_consts(t, m);
  SgnwElem E;
  E.C = sgnw_smem;
  E.stage = sgnw_smem + nconst * L;
  uint32_t* words = E.stage + t * SGN_WIDE_THREADS * L;
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
  wstage(consts, nconst * L, sgnw_smem);
  E.p = E.C;
  E.lag_t = E.C + 3 * L;
  E.lag_2t = E.lag_t + (t + 1) * L;
  E.xs = E.lag_2t + ns * L;
  E.one = E.xs + m * L;
  E.three = E.one + L;
  E.r2 = E.three + L;
  E.pow2l = E.r2 + L;
  E.inv2l = E.pow2l + L;
  E.pow2l1 = E.inv2l + L;
  E.powf = E.pow2l1 + L;
  E.n0 = P.n0inv;
  E.L = L;
  E.t = t;
  E.ns = ns;
  E.state = state;
  const uint32_t* p = E.p;
  const uint32_t n0 = P.n0inv;
  const long long row = (long long)ns * L;
  uint32_t* Ev = ws + blockIdx.x * P.ws_stride;  // bit shares, E vector
  uint32_t* Xv = Ev + lb * row;                  // xor vector (not LT)
  __syncthreads();

#pragma unroll 1
  for (long long g = blockIdx.x; g < n; g += gridDim.x) {
    const long long ch = g / chunk;
    E.el = g - ch * chunk;
    E.nc = (ch + 1) * chunk < n ? chunk : n_last;
    E.nonce = (((uint64_t)P.nonce_hi << 32) | P.nonce_lo) + (uint64_t)ch;
    E.blocks_a = (E.nc * wpe + RATE_WORDS - 1) / RATE_WORDS;
    if (E.blocks_a < 1) E.blocks_a = 1;
    E.off = 0;
    stage_words(state, E.nonce, E.el * wpe, wpe, words);
    __syncthreads();

    // the bit split, call (t, lb): E[j] = split(rb_j); R_k = sum_{j < l}
    // 2^j C_{k, j} (this thread's bits); the parties past the senders take
    // their share of rb_l (LT) or rb_0 (EQ at l = 1)
    uint32_t acc[MAX_T][WIDE_MAX_NL];
    for (int kk = 0; kk < t; ++kk)
      for (int q = 0; q < L; ++q) acc[kk][q] = 0u;
    const int j_top = LT ? l : EQ && l == 1 ? 0 : -1;
    for (int j0 = 0; j0 < lb; j0 += B) {
      const int cnt = lb - j0 < B ? lb - j0 : B;
      E.stage_pass(t, lb, j0, cnt);
      __syncthreads();
      const int j = j0 + tid;
      if (j < lb) {
        uint32_t bm[WIDE_MAX_NL];
        const bool bit = wbit(words, j);
        for (int q = 0; q < L; ++q) bm[q] = bit ? E.one[q] : 0u;
        const uint32_t* Cj = E.coefs(tid);
        for (int i = 0; i < ns; ++i)
          whorner(bm, Cj, E.cstride(), t, E.xs + i * L, p, n0, L,
                  Ev + j * row + i * L);
        if (j < l) {
          uint32_t pw[WIDE_MAX_NL], v[WIDE_MAX_NL];
          for (int q = 0; q < L; ++q)
            pw[q] = q == (j >> 5) ? 1u << (j & 31) : 0u;
          for (int kk = 0; kk < t; ++kk) {
            sw_mul(pw, Cj + kk * E.cstride(), p, n0, L, v);
            sw_add(acc[kk], v, p, L, acc[kk]);
          }
        }
        if (j == j_top)
          for (int i = ns; i < m; ++i)
            whorner(bm, Cj, E.cstride(), t, E.xs + i * L, p, n0, L,
                    xs1 + i * L);
      }
      __syncthreads();
    }
    E.next(t, lb);
    // R_k: the CTA's sum of the threads' 2^j C_{k, j} R^-1, times R^2
    for (int kk = 0; kk < t; ++kk) {
      wcopy(acc[kk], L, E.stage + tid * L);
      __syncthreads();
      sgnw_suffix_scan(E.stage, p, L);
      if (tid == 0) sw_mul(E.stage, E.r2, p, n0, L, R + kk * L);
      __syncthreads();
    }

    // r_divl < 2^k, call (t, 1): its shares at the points 1..t + 1
    E.stage_pass(t, 1, 0, 1);
    __syncthreads();
    if (tid <= t) {
      uint32_t kl[WIDE_MAX_NL];
      low_bits(words + wb, P.k, L, kl);
      sw_mul(kl, E.r2, p, n0, L, kl);
      whorner(kl, E.coefs(0), E.cstride(), t, E.xs + tid * L, p, n0, L,
              rdiv + tid * L);
    }
    E.next(t, 1);
    // a_r = a + r_modl + 2^l at every party, r_modl's shares
    // Horner(R, x_i) + r mod 2^l
    if (tid < m) {
      uint32_t rm[WIDE_MAX_NL], ai[WIDE_MAX_NL];
      low_bits(words, l, L, rm);
      sw_mul(rm, E.r2, p, n0, L, rm);
      whorner(rm, R, L, t, E.xs + tid * L, p, n0, L, rm);
      wload(a, (long long)tid * n + g, L, ai);
      sw_add(ai, rm, p, L, ai);
      sw_add(ai, E.pow2l, p, L, zs + tid * L);
    }
    __syncthreads();
    // open c = a_r + 2^l r_divl from shares 1..t + 1, to standard form
    if (tid == 0) {
      uint32_t c[WIDE_MAX_NL], ci[WIDE_MAX_NL];
      for (int i = 0; i <= t; ++i) {
        sw_mul(rdiv + i * L, E.pow2l, p, n0, L, ci);
        sw_add(zs + i * L, ci, p, L, ci);
        sw_mul(ci, E.lag_t + i * L, p, n0, L, ci);
        if (i == 0) wcopy(ci, L, c);
        else sw_add(c, ci, p, L, c);
      }
      uint32_t unit[WIDE_MAX_NL];
      for (int q = 0; q < L; ++q) unit[q] = q == 0 ? 1u : 0u;
      sw_mul(c, unit, p, n0, L, cstd);
    }
    __syncthreads();
    // z = (c mod 2^l) - a_r at every party; in EQ mode at l = 1 the
    // parties past the senders take 1 - xor_0
    if (tid < m) {
      uint32_t cm[WIDE_MAX_NL];
      low_bits(cstd, l, L, cm);
      sw_mul(cm, E.r2, p, n0, L, cm);
      sw_sub(cm, zs + tid * L, p, L, zs + tid * L);
      if (EQ && l == 1 && tid >= ns) {
        if (wbit(cstd, 0)) sw_sub(E.one, xs1 + tid * L, p, L, xs1 + tid * L);
        sw_sub(E.one, xs1 + tid * L, p, L, xs1 + tid * L);
      }
    }
    // xor_j = c_j XOR r_j, as shares: c_j ? 1 - rb_j : rb_j (not in LT
    // mode, whose suffix sums recompute it)
    if (!LT) {
      for (int j = tid; j < l; j += B) {
        const bool cb = wbit(cstd, j);
        for (int i = 0; i < ns; ++i) {
          if (cb) sw_sub(E.one, Ev + j * row + i * L, p, L,
                           Xv + j * row + i * L);
          else wcopy(Ev + j * row + i * L, L, Xv + j * row + i * L);
        }
      }
    }
    __syncthreads();

    bool gz = false;
    if (!EQ) {
      // s = 2 rb_l - 1; E_j = s + (rb_j - c_j) + 3 sum_{j' > j} xor_j';
      // E_l = s - 1 + 3 sum_j xor_j. Thread tid takes the bits lo .. hi - 1.
      if (tid < ns) {
        sw_add(Ev + l * row + tid * L, Ev + l * row + tid * L, p, L,
                 ss + tid * L);
        sw_sub(ss + tid * L, E.one, p, L, ss + tid * L);
      }
      const int qb = (l + B - 1) / B;
      const int lo = tid * qb < l ? tid * qb : l;
      const int hi = lo + qb < l ? lo + qb : l;
      for (int i = 0; i < ns; ++i) {
        uint32_t part[WIDE_MAX_NL], x[WIDE_MAX_NL];
        for (int q = 0; q < L; ++q) part[q] = 0u;
        for (int j = lo; j < hi; ++j) {
          const uint32_t* e = Ev + j * row + i * L;
          if (LT) {
            if (wbit(cstd, j)) sw_sub(E.one, e, p, L, x);
            else wcopy(e, L, x);
            sw_add(part, x, p, L, part);
          } else {
            sw_add(part, Xv + j * row + i * L, p, L, part);
          }
        }
        wcopy(part, L, E.stage + tid * L);
        __syncthreads();
        sgnw_suffix_scan(E.stage, p, L);
        uint32_t suf[WIDE_MAX_NL], s3[WIDE_MAX_NL], v[WIDE_MAX_NL];
        if (tid + 1 < B) wcopy(E.stage + (tid + 1) * L, L, suf);
        else for (int q = 0; q < L; ++q) suf[q] = 0u;
        for (int j = hi - 1; j >= lo; --j) {
          uint32_t* e = Ev + j * row + i * L;
          const bool cb = wbit(cstd, j);
          if (LT) {   // xor_j, from rb_j before E_j replaces it
            if (cb) sw_sub(E.one, e, p, L, x);
            else wcopy(e, L, x);
          } else {
            wcopy(Xv + j * row + i * L, L, x);
          }
          if (cb) sw_sub(e, E.one, p, L, v);
          else wcopy(e, L, v);
          sw_add(v, ss + i * L, p, L, v);
          sw_add(suf, suf, p, L, s3);
          sw_add(s3, suf, p, L, s3);
          sw_add(v, s3, p, L, e);
          sw_add(suf, x, p, L, suf);
        }
        if (tid == 0) {   // the total: every run's sum
          uint32_t* e = Ev + l * row + i * L;
          sw_add(E.stage, E.stage, p, L, s3);
          sw_add(s3, E.stage, p, L, s3);
          sw_sub(ss + i * L, E.one, p, L, e);
          sw_add(e, s3, p, L, e);
        }
        __syncthreads();
      }
      sgnw_tree(Ev, l + 1, E, false, nullptr, nullptr);

      // blinded public zero test of the product, one blinder per element
      E.stage_pass(1, 1, 0, 1);
      __syncthreads();
      if (tid == 0) {
        wcopy(E.coefs(0), L, bl);
        if (wis_zero(bl, L)) wcopy(E.one, L, bl);
      }
      E.next(1, 1);
      __syncthreads();
      E.stage_pass(t, 1, 0, 1);
      __syncthreads();
      if (tid < ns) {
        uint32_t bsh[WIDE_MAX_NL];
        whorner(bl, E.coefs(0), E.cstride(), t, E.xs + tid * L, p, n0, L,
                bsh);
        sw_mul(Ev + tid * L, bsh, p, n0, L, bsh);
        sw_mul(bsh, E.lag_2t + tid * L, p, n0, L, pb + tid * L);
      }
      E.next(t, 1);
      __syncthreads();
      if (tid == 0) {
        uint32_t po[WIDE_MAX_NL];
        wcopy(pb, L, po);
        for (int i = 1; i < ns; ++i) sw_add(po, pb + i * L, p, L, po);
        flag[0] = wis_zero(po, L);
      }
      __syncthreads();
      gz = flag[0] != 0;
      // h = s - 2 g s + 3; z = (z + 2^(l-1) h) / 2^l
      if (tid < ns) {
        uint32_t h[WIDE_MAX_NL];
        if (gz) sw_sub(E.three, ss + tid * L, p, L, h);
        else sw_add(ss + tid * L, E.three, p, L, h);
        sw_mul(h, E.pow2l1, p, n0, L, h);
        sw_add(zs + tid * L, h, p, L, zs + tid * L);
        sw_mul(zs + tid * L, E.inv2l, p, n0, L, zs + tid * L);
      }
      __syncthreads();
    }

    if (!LT) {
      for (int j = tid; j < l; j += B)
        for (int i = 0; i < ns; ++i)
          sw_sub(E.one, Xv + j * row + i * L, p, L, Xv + j * row + i * L);
      __syncthreads();
      sgnw_tree(Xv, l, E, EQ, fC, fS);
      if (EQ) {
        if (tid < ns) wcopy(Xv + tid * L, L, zs + tid * L);
      } else {
        // sgn = reshare((h_all - 1) (2z - 1)), call (t, 1)
        if (tid < ns) {
          uint32_t u[WIDE_MAX_NL], v[WIDE_MAX_NL];
          sw_sub(Xv + tid * L, E.one, p, L, u);
          sw_add(zs + tid * L, zs + tid * L, p, L, v);
          sw_sub(v, E.one, p, L, v);
          sw_mul(u, v, p, n0, L, u);
          sw_mul(u, E.lag_2t + tid * L, p, n0, L, pb + tid * L);
        }
        E.stage_pass(t, 1, 0, 1);
        __syncthreads();
        if (tid == 0) {
          wcopy(pb, L, fS);
          for (int i = 1; i < ns; ++i) sw_add(fS, pb + i * L, p, L, fS);
          for (int kk = 0; kk < t; ++kk)
            wcopy(E.coefs(0) + kk * E.cstride(), L, fC + kk * L);
        }
        E.next(t, 1);
        __syncthreads();
        if (tid < ns)
          whorner(fS, fC, L, t, E.xs + tid * L, p, n0, L, zs + tid * L);
      }
    }
    __syncthreads();

    if (tid < m) {
      uint32_t y[WIDE_MAX_NL];
      if (tid < ns) {
        wcopy(zs + tid * L, L, y);
      } else if (LT) {   // as the senders' z, from c mod 2^l - a_r and s
        uint32_t h[WIDE_MAX_NL], s1[WIDE_MAX_NL];
        sw_add(xs1 + tid * L, xs1 + tid * L, p, L, s1);
        sw_sub(s1, E.one, p, L, s1);
        if (gz) sw_sub(E.three, s1, p, L, h);
        else sw_add(s1, E.three, p, L, h);
        sw_mul(h, E.pow2l1, p, n0, L, h);
        sw_add(zs + tid * L, h, p, L, y);
        sw_mul(y, E.inv2l, p, n0, L, y);
      } else if (EQ && l == 1) {
        wcopy(xs1 + tid * L, L, y);
      } else {
        whorner(fS, fC, L, t, E.xs + tid * L, p, n0, L, y);
      }
      if (P.has_f) sw_mul(y, E.powf, p, n0, L, y);
      wstore(out, (long long)tid * n + g, L, y);
    }
    __syncthreads();   // the element's shared values are read
  }
}

}  // namespace mtt

extern "C" {

// K5 at L = 7..48 limbs: the comparison of (m, n, L) shares cut into chunks
// of `chunk` (the last call on n_last >= its given elements), one launch
// of `grid` CTAs (1 <= grid <= n), each an element at a time; ws: grid x
// P.ws_stride words of device workspace; consts: the
// sgn_wide_consts(t, m) L words of the kernel. -1: a (mode, l, limbs, t,
// m, k) the kernel does not take (1 <= t <= 4, 2t + 1 <= m <= 16, 0 <= k
// <= 64, 1 <= l with l + 1 random bits below 32 L), a workspace too small
// or a chunk geometry that does not hold.
int mtt_sgn_wide(const void* a, void* out, const void* state, long long n,
                 long long chunk, long long n_last, const void* consts,
                 void* ws, long long grid, const void* params, void* stream) {
  const mtt::SgnWide P = *(const mtt::SgnWide*)params;
  const int lb = P.l + (P.mode == 2 ? 0 : 1);
  if (P.nl < mtt::WIDE_MIN_NL || P.nl > mtt::WIDE_MAX_NL ||
      !mtt::parties_ok(P.t, P.m) || P.k < 0 || P.k > 64 || P.mode < 0 ||
      P.mode > 2 || P.l < 1 || lb > 32 * P.nl - 1 ||
      (lb + 31) / 32 + (P.k + 31) / 32 > mtt::SGN_WIDE_WORDS ||
      P.ws_stride < mtt::sgn_wide_ws_words(P.t, P.nl, P.l, P.mode))
    return -1;
  if (n <= 0) return 0;
  if (chunk <= 0 || n_last > chunk || n_last < n - (n - 1) / chunk * chunk ||
      grid < 1 || grid > n)
    return -1;
  // the most any (t, m) and L take, allowed once past the default 48 KB
  static const cudaError_t rc = cudaFuncSetAttribute(
      mtt::sgn_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mtt::sgn_wide_smem_bytes(mtt::MAX_T, mtt::MAX_M,
                                    mtt::WIDE_MAX_NL));
  if (rc != cudaSuccess) return (int)rc;
  const int smem = (int)mtt::sgn_wide_smem_bytes(P.t, P.m, P.nl);
  mtt::sgn_wide_kernel<<<(unsigned)grid, mtt::SGN_WIDE_THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)out, (const uint32_t*)state, n, chunk,
      n_last, (const uint32_t*)consts, (uint32_t*)ws, P);
  return (int)cudaGetLastError();
}

// Dynamic shared memory bytes of a K5 CTA at (t, m) and L limbs, and the
// workspace words of a CTA at (t, L, l, mode), for the tests and
// chip_smoke.py's reports.
int mtt_sgn_wide_smem(int t, int m, int L) {
  return (int)mtt::sgn_wide_smem_bytes(t, m, L);
}

int mtt_sgn_wide_ws(int t, int L, int l, int mode) {
  return (int)mtt::sgn_wide_ws_words(t, L, l, mode);
}

}  // extern "C"
