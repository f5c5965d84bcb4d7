// K3, the fused reshare round (kernels.cu instantiates it at (t, m) =
// (1, 3), reshare.cu at a run-time (t, m)). Included after common.cuh.
#pragma once
#include <cstdint>

#include "stage.cuh"

namespace mtt {

// ---------------------------------------------------------------------------
// K3: one whole GRR98 reshare round, with the local product when FUSE.
// Replaces mpyc_tpu/models/pipelines.py:87 make_reshare_step ->
// make_pallas.kernel (:179), in the stream layout of its XLA twin
// step_xla (:145): coefficient C_k of element e is draw k*n + e of the
// squeeze_mont stream (counter in lane 19) of the absorbed state with the
// per-call nonce XORed into lane 4 (t draws an element: the JAX package
// draws the aggregated C_k = sum_i lag_i c_{i,k} directly, not the
// (2t + 1) t coefficients of the senders). Output row j (party j+1) is
//   Horner(C, x_j) + S,  S = sum_{i < 2t+1} lag_i * s_i,
//   s_i = a_i * b_i (FUSE) or a_i.
// Bound: integer operations (at t = 1, m = 3: a tenth of a permutation
// and 11 Montgomery multiplies per element, against 72 bytes moved; in
// general t draws, 2t + 1 (FUSE: 2 (2t + 1)) products of the senders and
// m t of Horner).
// Design: a CTA of RESHARE_THREADS = 320 threads takes RESHARE_ELEMS =
// 3,200 consecutive elements, whose k = 0 coefficients are exactly 320
// sponge blocks: every thread squeezes one and reduces its ten draws
// once, through the stage (stage.cuh; for k > 0 the draws may straddle
// 321 blocks, and thread 0 takes the last), into shared memory. Then each
// thread takes the elements e0 + r*320 + tid (r < 10): each share is one
// 8-byte load and each output one 8-byte store at NL = 2, neighbouring
// lanes on neighbouring elements, so a warp's access is 256 contiguous
// bytes. At NL >= 3 an element is 4 NL bytes, which no vector access
// loads: a share is NL 4-byte loads, each of a warp's 32 lanes 4 NL bytes
// apart, so together they read the warp's 128 NL contiguous bytes. (With
// one element a thread, one warp in ten squeezed while the others waited
// at the barrier, and K3 took twice as long: PERF.md.) The staged
// coefficients take 12,800 NL t bytes, past the 48 KB of static shared
// memory from NL = 4 on, so they are dynamic shared memory
// (reshare_smem_bytes); where t of them would pass the 227 KB a CTA may
// have (t = 4 at five and six limbs), a CTA takes fewer multiples of 320
// elements (reshare_elems). Two instantiations a limb count and mode:
// T, M = 1, 3, the sender and party loops unrolled and the constants
// read from the parameter block, and T = M = 0, t and m launch
// parameters (1 <= t <= MAX_T, 2t + 1 <= m <= MAX_M), the loops not
// unrolled and the points and Lagrange coefficients copied into shared
// memory (a run-time index into the parameter block would put the block
// in local memory). NL = 1 to 6; draws of W = NL + 2 words (at NL = 1
// three words, 14 a block, so a CTA's 3,200 draws touch 229 blocks:
// fewer than its threads, each squeezed once).
// Small calls. The LP solvers reshare a few thousand elements a call (the
// fixed-point kb2's rank-1 update is 2,898 at six limbs), which at 3,200
// elements a CTA ran on one CTA of one SM, its threads taking nine
// elements each in turn. So the launch takes the CTA's elements from n
// (reshare_cta_elems): below the SM count times the most a CTA takes, n
// spread over the SMs in multiples of a warp (at least 32), a CTA's
// threads its elements up to RESHARE_THREADS; from there on the geometry
// above. The staged coefficients stay dynamic shared memory, and a sponge
// block whose draws straddle two CTAs is squeezed by both.
// ---------------------------------------------------------------------------
constexpr int RESHARE_THREADS = 320;
constexpr int RESHARE_ELEMS = 10 * RESHARE_THREADS;
// dynamic shared memory a K3 CTA may have beside the constants of t and m
constexpr int RESHARE_SMEM_MAX = 232448 - (MAX_M + MAX_SEND) * MAX_NL * 4;

// Elements of a K3 CTA at threshold t: RESHARE_ELEMS, or the most
// multiples of RESHARE_THREADS whose t coefficients fit.
__host__ __device__ constexpr int reshare_elems(int t, int nl) {
  int r = RESHARE_ELEMS / RESHARE_THREADS;
  while (r > 1 && t * r * RESHARE_THREADS * nl * 4 > RESHARE_SMEM_MAX) --r;
  return r * RESHARE_THREADS;
}

// The staged coefficients of a K3 CTA of the most elements: t of each.
__host__ __device__ constexpr int reshare_smem_bytes(int t, int nl) {
  return t * reshare_elems(t, nl) * nl * 4;
}

// Elements of a K3 CTA on a call of n on a card of sms SMs: the most a CTA
// takes (reshare_elems) where the call fills every SM with them, else n
// spread over the SMs, rounded up to a multiple of a warp (at least 32).
__host__ __device__ constexpr int reshare_cta_elems(long long n, int t,
                                                    int nl, int sms) {
  const int most = reshare_elems(t, nl);
  if (n >= (long long)sms * most) return most;
  const long long per = ((n + sms - 1) / sms + 31) / 32 * 32;
  return per < most ? (int)per : most;
}

// The most any t takes (the run-time t instantiations' opt-in).
__host__ __device__ constexpr int reshare_smem_most(int nl) {
  int most = 0;
  for (int t = 1; t <= MAX_T; ++t)
    most = reshare_smem_bytes(t, nl) > most ? reshare_smem_bytes(t, nl)
                                            : most;
  return most;
}

template <int NL, bool FUSE, int T, int M>
__global__ void __launch_bounds__(RESHARE_THREADS)
reshare_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, const uint32_t* __restrict__ state,
               long long n, ReshareParams P, int elems) {
  constexpr bool FIXED = M > 0;
  static_assert(!FIXED || (2 * T + 1 <= MAX_SEND && M <= MAX_M &&
                           2 * T + 1 <= M), "shape");
  const int t = FIXED ? T : P.t;
  const int m = FIXED ? M : P.m;
  const int ns = 2 * t + 1;
  // the staged coefficients, NL words an element (8-byte aligned: an
  // element is one 8-byte word at NL = 2)
  extern __shared__ uint2 reshare_smem[];
  uint32_t* coefs = reinterpret_cast<uint32_t*>(reshare_smem);
  // the points and Lagrange coefficients, at run-time t and m
  __shared__ uint32_t cs[FIXED ? 1 : (MAX_M + MAX_SEND) * NL];
  if constexpr (!FIXED) {
#pragma unroll
    for (int j = 0; j < MAX_M; ++j)
      copy_consts<NL>(reinterpret_cast<const uint32_t(&)[NL]>(P.xs[j]),
                      cs + j * NL, j < m ? NL : 0);
#pragma unroll
    for (int i = 0; i < MAX_SEND; ++i)
      copy_consts<NL>(reinterpret_cast<const uint32_t(&)[NL]>(P.lag[i]),
                      cs + (MAX_M + i) * NL, i < ns ? NL : 0);
  }
  const int per = elems;
  const long long e0 = (long long)blockIdx.x * per;
  const int cnt = (int)(n - e0 < per ? n - e0 : per);
  const uint32_t* p = P.draw.p;
  const uint32_t n0 = P.draw.n0inv;
  const uint64_t nonce = ((uint64_t)P.nonce_hi << 32) | P.nonce_lo;
#pragma unroll
  for (int k = 0; k < t; ++k)
    stage_draws<NL, fused_words<NL>()>(
        state, nonce, 0, (long long)k * n + e0, cnt, 1, P.draw,
        coefs + k * per * NL, per);
  __syncthreads();

#pragma unroll 1
  for (int el = threadIdx.x; el < cnt; el += blockDim.x) {
    const long long e = e0 + el;
    uint32_t S[NL];
#pragma unroll
    for (int i = 0; i < ns; ++i) {
      uint32_t si[NL], term[NL];
      ldg_fe<NL>(a, (long long)i * n + e, si);
      if (FUSE) {
        uint32_t bi[NL];
        ldg_fe<NL>(b, (long long)i * n + e, bi);
        mont_mul<NL>(si, bi, p, n0, si);
      }
      if constexpr (FIXED) {
        mont_mul<NL>(si, P.lag[i], p, n0, term);
      } else {
        mont_mul<NL>(si, cs + (MAX_M + i) * NL, p, n0, term);
      }
      if (i == 0) {
        fe_copy<NL>(term, S);
      } else {
        add_mod<NL>(S, term, p, S);
      }
    }
#pragma unroll
    for (int j = 0; j < m; ++j) {
      const uint32_t* xj;
      if constexpr (FIXED) {
        xj = P.xs[j];
      } else {
        xj = cs + j * NL;
      }
      uint32_t y[NL];
#pragma unroll
      for (int k = 0; k < t; ++k) {
        uint32_t c[NL];
        load_fe<NL>(coefs + k * per * NL, el, c);
        if (k == 0) {
          fe_copy<NL>(c, y);
        } else {
          add_mod<NL>(y, c, p, y);
        }
        mont_mul<NL>(y, xj, p, n0, y);
      }
      add_mod<NL>(y, S, p, y);
      store_fe<NL>(out, (long long)j * n + e, y);
    }
  }
}

// K3 at (t, m) = (1, 3) (T, M = 1, 3) or at t and m of the parameter
// block (T = M = 0).
template <int NL, bool FUSE, int T, int M>
int launch_reshare(const void* a, const void* b, void* out, const void* state,
                   long long n, const ReshareParams& P, cudaStream_t stream) {
  const int t = M > 0 ? T : P.t;
  const int elems = reshare_cta_elems(n, t, NL, sm_count());
  const long long grid = (n + elems - 1) / elems;
  const int threads = elems < RESHARE_THREADS ? elems : RESHARE_THREADS;
  const int smem = t * elems * NL * 4;
  // the most any t takes, allowed once past the default 48 KB
  constexpr int most = M > 0 ? reshare_smem_bytes(T, NL)
                             : reshare_smem_most(NL);
  if (most > 48 * 1024) {
    static const cudaError_t rc = cudaFuncSetAttribute(
        reshare_kernel<NL, FUSE, T, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (rc != cudaSuccess) return (int)rc;
  }
  reshare_kernel<NL, FUSE, T, M><<<(unsigned)grid, threads, smem,
                                   stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out,
      (const uint32_t*)state, n, P, elems);
  return (int)cudaGetLastError();
}

template <bool FUSE, int T, int M>
int launch_reshare_nl(const void* a, const void* b, void* out,
                      const void* state, long long n,
                      const ReshareParams& P, cudaStream_t s) {
  switch (P.draw.nl) {
    case 1: return launch_reshare<1, FUSE, T, M>(a, b, out, state, n, P, s);
    case 2: return launch_reshare<2, FUSE, T, M>(a, b, out, state, n, P, s);
    case 3: return launch_reshare<3, FUSE, T, M>(a, b, out, state, n, P, s);
    case 4: return launch_reshare<4, FUSE, T, M>(a, b, out, state, n, P, s);
    case 5: return launch_reshare<5, FUSE, T, M>(a, b, out, state, n, P, s);
    case 6: return launch_reshare<6, FUSE, T, M>(a, b, out, state, n, P, s);
    default: return -1;
  }
}

}  // namespace mtt
