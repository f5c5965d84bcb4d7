// Kernels of the port for wide prime fields: 7 to 48 limbs (p < 2^1536),
// the limb count L a parameter of the launch. The secure linear algebra
// over wide fields runs here: ridge regression's SecFld(min_order=2 bound
// + 1) of 7 to 12 limbs and student-mat's 1,314-bit field of 42,
// multilateration's SecInt(335) field of 12, the pseudoinverse's wider
// secure integers.
//
// - K3 (reshare_wide_kernel): one GRR98 reshare round, with the local
//   product when fused, at every threshold t and party count m of
//   parties_ok (launch parameters). Replaces mpyc_tpu/models/
//   pipelines.py:87 make_reshare_step (the Pallas call at :249 tiles (...,
//   L, ...) for any L and (t, m)), in the stream layout of its XLA twin
//   step_xla, as reshare.cuh's reshare_kernel: coefficient C_k of element
//   e is draw k n + e of the squeeze_mont stream, W = L + 2 words, EPB =
//   42 / W draws a sponge block (4 at L = 7, 3 at L = 12, 2 at L = 19, 1
//   from L = 20 on); from L = 41 on a draw is wider than a block and owns
//   two whole blocks, as the JAX package's words_to_elements lays them
//   out.
// - K9 (field_op_wide_kernel): an elementwise product, add or subtraction
//   mod p, an operand of step 0 a constant: the field context's arithmetic
//   between the kernels, the PRSS draws' reduction into the field (two
//   products and an add a draw) and the field matmul's fold.
// - K6 (mont_pow_wide_kernel): a^e R mod p by the host's plan of e
//   (fieldops.pow_plan): the public inverses of the reciprocals, the
//   Legendre symbols of [NO07]'s zero tests. A group of lanes an element
//   (wide.cuh WGroup: the limbs in registers, each product the group's),
//   the odd powers x, x^3, .., x^15 in shared memory, a table a group.
// - K7 (random_bits_tail_wide_kernel): the tail of a round of random bits
//   around the inverse square root, as pow.cuh's random_bits_tail_kernel,
//   at every (t, m) too.
// K5 on these fields is csrc/sgn_wide.cu; the field arithmetic of both is
// wide.cuh's.
//
// Design. K3, K7 and K9: one thread an element, WIDE_THREADS a CTA. At
// 42 limbs three shares and the CIOS accumulator alone would take about
// 170 registers, so the limbs stay in local memory (arrays of WIDE_MAX_NL
// words indexed by loops to L: L1-cached, no register spills, a stack
// frame ptxas reports) and the field's constants (p, the radix table, the
// Lagrange coefficients and points, the power's plan) come from a device
// buffer that each CTA first copies into shared memory, where every thread
// of a warp reads the same word at once. The narrow kernels' parameter
// blocks (DrawParams, PowParams: MAX_NL-sized arrays) stay as they were,
// so nothing here changes their registers or stack. One instantiation a
// kernel serves every L, so the build takes seconds, not thirty
// instantiations. K3 stages its CTA's draws in shared memory as
// reshare_kernel does: each sponge block each of the CTA's t sets of 128
// draws touches is squeezed once, by one thread, which reduces its draws
// into GF(p). K6: a group of 8, 16 or 32 lanes an element (wide.cuh
// WGroup), S = 1 or 2 words a lane, a whole warp from 17 limbs on
// (wide_dispatch: three instantiations): a power is a chain of dependent
// products, which a group runs about L times faster than one thread whose
// limbs are in local memory. Every result is canonical, so each kernel
// equals its plain version bit for bit.
#include "common.cuh"
#include "wide.cuh"

namespace mtt {

// Mirrored by ctypes structures in mpyc_tpu_torch/_build.py. The plan of
// e (fieldops.pow_plan): x^(2 first + 1), then per step k square
// steps[2 k] times and multiply by table entry steps[2 k + 1]; then
// square tail times. The steps follow the field's constants in the device
// buffer, two words a step: a wide exponent can have a run of more than
// 255 zero bits (p - 2 of p = 2^1029 + 639), past the byte that
// PowParams gives a step's squarings.
struct WidePow {
  int32_t nl, nbits, n_table, first, n_steps, tail;
  uint32_t n0inv;
};

struct WideTail {
  WidePow pow;
  int32_t has_scale, has_offset;
  int32_t t, m;   // threshold and parties (parties_ok)
};

// x <- x^e R mod p by the plan (x < p), one thread (K7). one: R mod p,
// the power for e = 0. The table of odd powers x^1, x^3, .., x^15 lives
// in local memory, its entry chosen at run time.
static __device__ void wpow(uint32_t* x, const WidePow& P, const uint32_t* p,
                            const uint32_t* one, const uint32_t* steps) {
  const int L = P.nl;
  if (P.nbits == 0) {
    wcopy(one, L, x);
    return;
  }
  uint32_t tab[WIDE_POW_TABLE][WIDE_MAX_NL];
  wcopy(x, L, tab[0]);
  if (P.n_table > 1) {
    uint32_t x2[WIDE_MAX_NL];
    wmont_mul(x, x, p, P.n0inv, L, x2);
    for (int k = 1; k < P.n_table; ++k) {
      wmont_mul(x, x2, p, P.n0inv, L, x);
      wcopy(x, L, tab[k]);
    }
  }
  wcopy(tab[P.first], L, x);
  for (int k = 0; k < P.n_steps; ++k) {
    for (int q = (int)steps[2 * k]; q > 0; --q)
      wmont_mul(x, x, p, P.n0inv, L, x);
    wmont_mul(x, tab[steps[2 * k + 1]], p, P.n0inv, L, x);
  }
  for (int q = P.tail; q > 0; --q) wmont_mul(x, x, p, P.n0inv, L, x);
}

// The same by the group G: x^e R mod p, the odd powers in tab (8 L words,
// the group's own: each lane reads back only the words it wrote).
template <int S, bool W>
static __device__ WV<S> gpow(const WGroup<S, W>& G, WV<S> x, const WidePow& P,
                             const uint32_t* one, const uint32_t* steps,
                             uint32_t* tab) {
  const int L = P.nl;
  if (P.nbits == 0) return G.ld(one);
  G.st(tab, x);
  if (P.n_table > 1) {
    const WV<S> x2 = G.mul(x, x);
    for (int k = 1; k < P.n_table; ++k) {
      x = G.mul(x, x2);
      G.st(tab + k * L, x);
    }
  }
  x = G.ld(tab + P.first * L);
  for (int k = 0; k < P.n_steps; ++k) {
    for (int q = (int)steps[2 * k]; q > 0; --q) x = G.mul(x, x);
    x = G.mul(x, G.ld(tab + steps[2 * k + 1] * L));
  }
  for (int q = P.tail; q > 0; --q) x = G.mul(x, x);
  return x;
}

// ---------------------------------------------------------------------------
// K9: out_e = a_e op b_e, op 0 a Montgomery product (a may be below R),
// 1 an add, 2 a subtraction mod p; an operand of step 0 one element for
// all. consts: p (L words).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(WIDE_THREADS)
field_op_wide_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out, long long n, int a_step,
                     int b_step, int op, const uint32_t* __restrict__ consts,
                     uint32_t n0inv, int L) {
  __shared__ uint32_t p[WIDE_MAX_NL];
  wstage(consts, L, p);
  __syncthreads();
  const long long e = (long long)blockIdx.x * WIDE_THREADS + threadIdx.x;
  if (e >= n) return;
  uint32_t x[WIDE_MAX_NL], y[WIDE_MAX_NL];
  wload(a, e * a_step, L, x);
  wload(b, e * b_step, L, y);
  if (op == 0) wmont_mul(x, y, p, n0inv, L, x);
  else if (op == 1) wadd_mod(x, y, p, L, x);
  else wsub_mod(x, y, p, L, x);
  wstore(out, e, L, x);
}

// ---------------------------------------------------------------------------
// K3 at threshold t and m parties (1 <= t <= MAX_T, 2t + 1 <= m <= MAX_M,
// launch parameters). consts: p, radix_0, radix_1 (2^(32 L c) R^2 mod p),
// lag_0..2t (Lagrange coefficients at 0 of the points 1..2t + 1), x_1..m
// (the points), each L words, Montgomery form (wide_reshare_consts words
// a limb). Dynamic shared memory: those words, then the CTA's t x
// WIDE_THREADS coefficients (coefficient k of element e is draw k n + e,
// as reshare.cuh lays them out).
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int wide_reshare_consts(int t, int m) {
  return 3 + 2 * t + 1 + m;
}

__global__ void __launch_bounds__(WIDE_THREADS)
reshare_wide_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ state, long long n,
                    const uint32_t* __restrict__ consts, uint32_t n0inv,
                    int L, uint32_t nonce_lo, uint32_t nonce_hi, int fuse,
                    int t, int m) {
  extern __shared__ uint32_t wide_smem[];
  const int ns = 2 * t + 1;
  uint32_t* C = wide_smem;
  uint32_t* coefs = wide_smem + wide_reshare_consts(t, m) * L;
  const uint32_t* lag = C + 3 * L;
  const uint32_t* xs = lag + ns * L;
  wstage(consts, wide_reshare_consts(t, m) * L, C);
  __syncthreads();
  const uint64_t nonce = ((uint64_t)nonce_hi << 32) | nonce_lo;
  const long long e0 = (long long)blockIdx.x * WIDE_THREADS;
  const int cnt = (int)(n - e0 < WIDE_THREADS ? n - e0 : WIDE_THREADS);
  const int W = L + 2;
  for (int k = 0; k < t; ++k) {
    const long long d0 = (long long)k * n + e0;   // the set's first draw
    uint32_t* dst = coefs + k * WIDE_THREADS * L;
    if (W <= RATE_WORDS) {
      const int epb = RATE_WORDS / W;
      const long long first = d0 / epb;
      const int nb = (int)((d0 + cnt - 1) / epb - first + 1);
      for (int q = threadIdx.x; q < nb; q += blockDim.x) {
        const long long blk = first + q;
        uint64_t A[25];
        squeeze_block(state, nonce, (unsigned long long)blk, A);
        uint32_t w[RATE_WORDS];
#pragma unroll
        for (int r = 0; r < RATE_WORDS; ++r) w[r] = rate_word(A, r);
        for (int s = 0; s < epb; ++s) {
          const long long d = blk * epb + s - d0;
          if (d >= 0 && d < cnt)
            wreduce_draw(w + s * W, W, C, n0inv, L, dst + d * L);
        }
      }
    } else {
      // from 41 limbs on a draw is wider than a block: draw d owns the
      // two whole blocks 2 d and 2 d + 1, its words the first W of their
      // rate words in order (rng.words_to_elements); a thread a draw
      for (int q = threadIdx.x; q < cnt; q += blockDim.x) {
        uint32_t w[2 * RATE_WORDS];
        for (int h = 0; h < 2; ++h) {
          uint64_t A[25];
          squeeze_block(state, nonce,
                        (unsigned long long)(2 * (d0 + q) + h), A);
#pragma unroll
          for (int r = 0; r < RATE_WORDS; ++r)
            w[h * RATE_WORDS + r] = rate_word(A, r);
        }
        wreduce_draw(w, W, C, n0inv, L, dst + q * L);
      }
    }
  }
  __syncthreads();
  const int el = threadIdx.x;
  if (el >= cnt) return;
  const long long e = e0 + el;
  const uint32_t* p = C;
  uint32_t S[WIDE_MAX_NL], si[WIDE_MAX_NL];
  for (int i = 0; i < ns; ++i) {
    wload(a, (long long)i * n + e, L, si);
    if (fuse) {
      uint32_t bi[WIDE_MAX_NL];
      wload(b, (long long)i * n + e, L, bi);
      wmont_mul(si, bi, p, n0inv, L, si);
    }
    if (i == 0) {
      wmont_mul(si, lag, p, n0inv, L, S);
    } else {
      wmont_mul(si, lag + i * L, p, n0inv, L, si);
      wadd_mod(S, si, p, L, S);
    }
  }
  for (int j = 0; j < m; ++j) {
    // Horner(C, x_j) + S
    uint32_t y[WIDE_MAX_NL];
    for (int k = 0; k < t; ++k) {
      const uint32_t* c = coefs + (k * WIDE_THREADS + el) * L;
      if (k == 0) wcopy(c, L, y);
      else wadd_mod(y, c, p, L, y);
      wmont_mul(y, xs + j * L, p, n0inv, L, y);
    }
    wadd_mod(y, S, p, L, y);
    wstore(out, (long long)j * n + e, L, y);
  }
}

// ---------------------------------------------------------------------------
// K6. consts: p, one (R mod p), L words each, then the plan's n_steps
// steps (two words each). Dynamic shared memory: the same words, then a
// table of 8 L words for each group of the CTA. Element e is group e of
// the grid's; a group past n returns whole.
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int wide_pow_groups(int L) {
  return WIDE_THREADS / wide_group(L);
}

template <int S, bool W>
__global__ void __launch_bounds__(WIDE_THREADS)
mont_pow_wide_kernel(const uint32_t* __restrict__ a,
                     uint32_t* __restrict__ out, long long n,
                     const uint32_t* __restrict__ consts, WidePow P) {
  extern __shared__ uint32_t wide_smem[];
  const int L = P.nl, g = wide_group(L);
  const int nc = 2 * L + 2 * P.n_steps;
  wstage(consts, nc, wide_smem);
  __syncthreads();
  const int gi = threadIdx.x / g;
  const long long e = (long long)blockIdx.x * wide_pow_groups(L) + gi;
  if (e >= n) return;
  WGroup<S, W> G;
  G.init(L, wide_smem, P.n0inv);
  WV<S> x = G.ld(a + e * L);
  x = gpow(G, x, P, wide_smem + L, wide_smem + 2 * L,
           wide_smem + nc + gi * WIDE_POW_TABLE * L);
  G.st(out + e * L, x);
}

// ---------------------------------------------------------------------------
// The group arithmetic alone, for the tests: out_e = a_e op b_e as K9's
// (op 0 a Montgomery product, a below R; 1 an add, 2 a subtraction mod
// p; 3 (a - b) (a + b) R^-1, the results of two operations the operands
// of a third in registers), a group an element. consts: p (L words).
// ---------------------------------------------------------------------------
template <int S, bool W>
__global__ void __launch_bounds__(WIDE_THREADS)
group_op_wide_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out, long long n, int op,
                     const uint32_t* __restrict__ consts, uint32_t n0inv,
                     int L) {
  const int gi = threadIdx.x / wide_group(L);
  const long long e = (long long)blockIdx.x * wide_pow_groups(L) + gi;
  if (e >= n) return;
  WGroup<S, W> G;
  G.init(L, consts, n0inv);
  const WV<S> x = G.ld(a + e * L), y = G.ld(b + e * L);
  G.st(out + e * L, op == 0   ? G.mul(x, y)
                    : op == 1 ? G.add(x, y)
                    : op == 2 ? G.sub(x, y)
                              : G.mul(G.sub(x, y), G.add(x, y)));
}

// ---------------------------------------------------------------------------
// K7 at threshold t and m parties, as random_bits_tail_kernel: per
// element u = sum_{i <= 2t} lag_i (r_i^2 + z_i), its flag u == 0
// (counted), s = u^((3p - 5) / 4) by the plan, bit_i = r_i (s scale) +
// offset for each of the m parties. consts: p, one, lag_0..2t, scale,
// offset (L words each: wide_tail_consts), then the plan's steps.
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int wide_tail_consts(int t) {
  return 4 + 2 * t + 1;
}

__global__ void __launch_bounds__(WIDE_THREADS)
random_bits_tail_wide_kernel(const uint32_t* __restrict__ r,
                             const uint32_t* __restrict__ z,
                             uint32_t* __restrict__ bits,
                             uint8_t* __restrict__ flags,
                             int* __restrict__ count, long long n,
                             const uint32_t* __restrict__ consts,
                             WideTail P) {
  extern __shared__ uint32_t wide_smem[];
  const int L = P.pow.nl;
  const int ns = 2 * P.t + 1;
  const int nc = wide_tail_consts(P.t);
  const uint32_t n0inv = P.pow.n0inv;
  wstage(consts, nc * L + 2 * P.pow.n_steps, wide_smem);
  __syncthreads();
  const uint32_t* p = wide_smem;
  const uint32_t* scale = wide_smem + (2 + ns) * L;
  const uint32_t* offset = scale + L;
  const long long e = (long long)blockIdx.x * WIDE_THREADS + threadIdx.x;
  if (e >= n) return;
  uint32_t u[WIDE_MAX_NL];
  for (int i = 0; i < ns; ++i) {
    uint32_t v[WIDE_MAX_NL], zi[WIDE_MAX_NL];
    wload(r + i * n * L, e, L, v);
    wload(z + i * n * L, e, L, zi);
    wmont_mul(v, v, p, n0inv, L, v);
    wadd_mod(v, zi, p, L, v);
    wmont_mul(v, wide_smem + (2 + i) * L, p, n0inv, L, v);
    if (i == 0) wcopy(v, L, u);
    else wadd_mod(u, v, p, L, u);
  }
  uint32_t acc = 0;
  for (int q = 0; q < L; ++q) acc |= u[q];
  flags[e] = (uint8_t)(acc == 0);
  if (acc == 0) atomicAdd(count, 1);
  wpow(u, P.pow, p, wide_smem + L, wide_smem + nc * L);
  if (P.has_scale) wmont_mul(u, scale, p, n0inv, L, u);
  for (int i = 0; i < P.m; ++i) {
    uint32_t bit[WIDE_MAX_NL];
    wload(r + i * n * L, e, L, bit);
    wmont_mul(bit, u, p, n0inv, L, bit);
    if (P.has_offset) wadd_mod(bit, offset, p, L, bit);
    wstore(bits + i * n * L, e, L, bit);
  }
}

// Whether a plan fits the kernels (plan_ok of kernels.cu at L limbs).
static bool wide_plan_ok(const WidePow& P) {
  if (P.nl < WIDE_MIN_NL || P.nl > WIDE_MAX_NL) return false;
  if (P.nbits < 0 || P.nbits > 32 * P.nl) return false;
  if (P.n_table < 1 || P.n_table > WIDE_POW_TABLE) return false;
  if (P.n_steps < 0 || P.n_steps > 32 * P.nl || P.tail < 0) return false;
  return P.first >= 0 && P.first < P.n_table;
}

static unsigned wide_grid(long long n) {
  return (unsigned)((n + WIDE_THREADS - 1) / WIDE_THREADS);
}

// K6's and the group test kernel's launches at an instantiation of the
// group arithmetic (wide_dispatch).
struct PowWideLaunch {
  const void *a, *consts;
  void *out, *stream;
  long long n;
  unsigned grid;
  int smem;
  WidePow P;
  template <int S, bool W>
  int run() const {
    mont_pow_wide_kernel<S, W><<<grid, WIDE_THREADS, smem,
                                 (cudaStream_t)stream>>>(
        (const uint32_t*)a, (uint32_t*)out, n, (const uint32_t*)consts, P);
    return (int)cudaGetLastError();
  }
};

struct GroupOpLaunch {
  const void *a, *b, *consts;
  void *out, *stream;
  long long n;
  unsigned grid, n0inv;
  int op, L;
  template <int S, bool W>
  int run() const {
    group_op_wide_kernel<S, W><<<grid, WIDE_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, op,
        (const uint32_t*)consts, n0inv, L);
    return (int)cudaGetLastError();
  }
};

}  // namespace mtt

extern "C" {

// K9 at L = 7..48 limbs: out = a op b for n elements (op 0 a Montgomery
// product, 1 an add, 2 a subtraction mod p; a_step and b_step 1, or 0 for
// one element taken by all); consts: p's L limbs on the device. -1: a limb
// count, op or step not built.
int mtt_field_op_wide(const void* a, const void* b, void* out, long long n,
                      int a_step, int b_step, int op, const void* consts,
                      unsigned n0inv, int L, void* stream) {
  if (L < mtt::WIDE_MIN_NL || L > mtt::WIDE_MAX_NL || op < 0 || op > 2 ||
      a_step < 0 || a_step > 1 || b_step < 0 || b_step > 1)
    return -1;
  if (n <= 0) return 0;
  mtt::field_op_wide_kernel<<<mtt::wide_grid(n), mtt::WIDE_THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, a_step,
      b_step, op, (const uint32_t*)consts, n0inv, L);
  return (int)cudaGetLastError();
}

// K3 at threshold t with m parties (1 <= t <= 4, 2t + 1 <= m <= 16) and L
// = 7..48 limbs on (m, n, L) shares (times b's when fuse), the call's
// counter (nonce_lo, nonce_hi) XORed into lane 4 of the absorbed state;
// consts: the wide_reshare_consts(t, m) L words of reshare_wide_kernel. -1:
// a limb count or (t, m) not built.
int mtt_reshare_wide(const void* a, const void* b, void* out,
                     const void* state, long long n, int fuse,
                     const void* consts, unsigned n0inv, int L,
                     unsigned nonce_lo, unsigned nonce_hi, int t, int m,
                     void* stream) {
  if (L < mtt::WIDE_MIN_NL || L > mtt::WIDE_MAX_NL ||
      !mtt::parties_ok(t, m))
    return -1;
  if (n <= 0) return 0;
  // the most any (t, m) and L take, allowed once past the default 48 KB
  static const cudaError_t rc = cudaFuncSetAttribute(
      mtt::reshare_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (mtt::wide_reshare_consts(mtt::MAX_T, mtt::MAX_M) +
       mtt::MAX_T * mtt::WIDE_THREADS) * mtt::WIDE_MAX_NL * 4);
  if (rc != cudaSuccess) return (int)rc;
  const int smem =
      (mtt::wide_reshare_consts(t, m) + t * mtt::WIDE_THREADS) * L * 4;
  mtt::reshare_wide_kernel<<<mtt::wide_grid(n), mtt::WIDE_THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out,
      (const uint32_t*)state, n, (const uint32_t*)consts, n0inv, L,
      nonce_lo, nonce_hi, fuse, t, m);
  return (int)cudaGetLastError();
}

// K6 at L = 7..48 limbs: a^e R mod p for n elements, e by its plan
// (params: a WidePow on the host); consts: p, R mod p and the steps. -1: a
// limb count not built, or a plan that does not fit.
int mtt_mont_pow_wide(const void* a, void* out, long long n,
                      const void* consts, const void* params, void* stream) {
  const mtt::WidePow P = *(const mtt::WidePow*)params;
  if (!mtt::wide_plan_ok(P)) return -1;
  if (n <= 0) return 0;
  const int ng = mtt::wide_pow_groups(P.nl);
  const unsigned grid = (unsigned)((n + ng - 1) / ng);
  const int smem =
      (2 * P.nl + 2 * P.n_steps + ng * mtt::WIDE_POW_TABLE * P.nl) * 4;
  return mtt::wide_dispatch(
      P.nl, mtt::PowWideLaunch{a, consts, out, stream, n, grid, smem, P});
}

// The group arithmetic alone at L = 7..48 limbs (tests): out = a op b for
// n elements (op 0 a Montgomery product, 1 an add, 2 a subtraction mod
// p, 3 (a - b) (a + b) R^-1); consts: p's L limbs on the device. -1: a
// limb count or op not built.
int mtt_group_op_wide(const void* a, const void* b, void* out, long long n,
                      int op, const void* consts, unsigned n0inv, int L,
                      void* stream) {
  if (L < mtt::WIDE_MIN_NL || L > mtt::WIDE_MAX_NL || op < 0 || op > 3)
    return -1;
  if (n <= 0) return 0;
  const int ng = mtt::wide_pow_groups(L);
  return mtt::wide_dispatch(
      L, mtt::GroupOpLaunch{a, b, consts, out, stream, n,
                (unsigned)((n + ng - 1) / ng), n0inv, op, L});
}

// K7 at threshold t with m parties (1 <= t <= 4, 2t + 1 <= m <= 16) and L
// = 7..48 limbs on (m, n, L) shares r and z: bits (m, n, L), flags (n
// bytes), count (one int, added to); params: a WideTail on the host;
// consts: the wide_tail_consts(t) L words of the kernel and the steps. -1:
// a limb count or (t, m) not built, or a plan that does not fit.
int mtt_random_bits_tail_wide(const void* r, const void* z, void* bits,
                              void* flags, void* count, long long n,
                              const void* consts, const void* params,
                              void* stream) {
  const mtt::WideTail P = *(const mtt::WideTail*)params;
  if (!mtt::wide_plan_ok(P.pow) || !mtt::parties_ok(P.t, P.m)) return -1;
  if (n <= 0) return 0;
  const int smem =
      (mtt::wide_tail_consts(P.t) * P.pow.nl + 2 * P.pow.n_steps) * 4;
  mtt::random_bits_tail_wide_kernel<<<mtt::wide_grid(n), mtt::WIDE_THREADS,
                                      smem, (cudaStream_t)stream>>>(
      (const uint32_t*)r, (const uint32_t*)z, (uint32_t*)bits,
      (uint8_t*)flags, (int*)count, n, (const uint32_t*)consts, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
