// CUDA kernels of the port (sm_90a): K1-K3 of secure multiplication, K4
// the split/recombine round, K5 the secure comparison (sgn.cuh).
//
// Built by mpyc_tpu_torch/_build.py with plain nvcc into one shared library
// whose extern "C" launchers are called through ctypes. Each launcher takes
// device pointers, sizes, constants (by value, from a host struct) and a
// stream, launches, and returns cudaGetLastError().
//
// Field elements are little-endian 32-bit limbs in Montgomery form with
// R = 2^64: the kernels take two-limb fields (p < 2^64), the field of
// SecInt(32). Every result is canonical, so each kernel equals its plain
// PyTorch version (and the JAX package) bit for bit.
#include <cuda_runtime.h>
#include <cstdint>

#include "keccak.cuh"
#include "limb.cuh"

namespace mtt {

constexpr int NL = 2;          // limbs per element
constexpr int MAX_NC = 4;      // chunks per draw
constexpr int MAX_SEND = 9;    // senders aggregated by a reshare (2t + 1)
constexpr int MAX_M = 16;      // parties
constexpr int RATE_WORDS = 42; // 32-bit words in a 168-byte block

// Mirrored by ctypes structures in mpyc_tpu_torch/_build.py.
struct DrawParams {
  uint32_t p[NL];
  uint32_t n0inv;
  uint32_t radix[MAX_NC][NL];  // 2^(32 NL c) R^2 mod p, chunk c
};

struct ReshareParams {
  DrawParams draw;
  uint32_t lag[MAX_SEND][NL];  // Lagrange coefficients at 0, Montgomery
  uint32_t xs[MAX_M][NL];      // evaluation points 1..m, Montgomery
  uint32_t nonce_lo, nonce_hi; // per-call counter, XORed into lane 4
  int32_t t, m, n_send;
};

// Draw `slot` of a squeezed block (W words a draw) mapped into GF(p),
// Montgomery form: sum over chunks c of chunk_c * 2^(32 NL c) mod p, one
// Montgomery multiply by radix[c] per chunk (mpyc_tpu/ops/limb.py
// reduce_wide). With `slot` a constant every word index is one too.
template <int W>
__device__ __forceinline__ void reduce_draw(const uint64_t* A, int slot,
                                            const DrawParams& P,
                                            uint32_t* out) {
  constexpr int NC = (W + NL - 1) / NL;
  static_assert(NC <= MAX_NC, "draw wider than the radix table");
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    uint32_t chunk[NL], term[NL];
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      const int w = c * NL + q;
      chunk[q] = w < W ? rate_word(A, slot * W + w) : 0u;
    }
    mont_mul<NL>(chunk, P.radix[c], P.p, P.n0inv, term);
    if (c == 0) {
#pragma unroll
      for (int q = 0; q < NL; ++q) out[q] = term[q];
    } else {
      add_mod<NL>(out, term, P.p, out);
    }
  }
}

}  // namespace mtt

#include "stage.cuh"

namespace mtt {

// ---------------------------------------------------------------------------
// K1: counter-mode SHAKE128 squeeze.
// Replaces mpyc_tpu/ops/keccak.py:215 _squeeze_ctr_pallas (kernel :235).
// Instance i XORs base + i into lane ctr_lane of the absorbed state, runs
// Keccak-f[1600] and writes its 21 rate lanes: (n, 42) uint32 words
// [lo0, hi0, ...], which as little-endian 64-bit lanes is a plain store.
// Bound: integer operations (about 4,300 32-bit logic and shift
// instructions per permutation against 168 bytes written). Design: one
// sponge per thread, the 25 lanes as uint64_t in registers for all 24
// rounds (no stack frame: see xor_lane), so device memory sees only the
// output rows.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
keccak_ctr_kernel(const uint32_t* __restrict__ state,
                  uint64_t* __restrict__ out, long long n, int ctr_lane,
                  unsigned long long base) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t A[25];
  load_state(state, A);
  xor_lane(A, ctr_lane, base + (unsigned long long)i);
  keccak_f1600(A);
  uint64_t* row = out + i * 21;
#pragma unroll
  for (int k = 0; k < 21; ++k) row[k] = A[k];
}

// ---------------------------------------------------------------------------
// K2: squeeze fused with the map into GF(p).
// Replaces mpyc_tpu/ops/rng.py:99 _squeeze_mont_kernel (kernel :130).
// Block b holds EPB = 42 / W draws; draw d = b * EPB + j takes words
// j*W .. j*W+W-1 of block d / EPB (the JAX package's stream order).
// Bound: integer operations (a permutation per EPB draws plus one
// Montgomery multiply per chunk; 8 bytes written per draw). Design: one
// sponge per thread; the rate words stay in registers and only the
// reduced draws are written, instead of the 168-byte blocks.
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(256)
squeeze_mont_kernel(const uint32_t* __restrict__ state,
                    uint32_t* __restrict__ out, long long n_draws,
                    long long n_blocks, int ctr_lane,
                    unsigned long long base, DrawParams P) {
  constexpr int EPB = RATE_WORDS / W;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  uint64_t A[25];
  load_state(state, A);
  xor_lane(A, ctr_lane, base + (unsigned long long)b);
  keccak_f1600(A);
#pragma unroll
  for (int j = 0; j < EPB; ++j) {
    const long long d = b * EPB + j;
    if (d < n_draws) {
      uint32_t v[NL];
      reduce_draw<W>(A, j, P, v);
#pragma unroll
      for (int q = 0; q < NL; ++q) out[d * NL + q] = v[q];
    }
  }
}

// K4's t coefficients of the EPB = 10 elements e0 .. e0 + 9 (e0 a multiple
// of 10) in the stream layout of the JAX package's XLA steps: coefficient
// C_k of element e is draw k*n + e of the squeeze_mont stream of the
// absorbed state S0 (16-byte draws, counter in lane 19). For k = 0 the
// group's draws are exactly one sponge block; for k > 0 they may straddle
// two, and the thread then squeezes both (written for general t).
template <int T>
__device__ __forceinline__ void group_coefs(const uint64_t* S0, long long n,
                                            long long e0,
                                            const DrawParams& P,
                                            uint32_t (*C)[RATE_WORDS / 4][NL]) {
  constexpr int W = 4;  // 16-byte draws: fused_draw_bytes(p) for 2 limbs
  constexpr int EPB = RATE_WORDS / W;
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const long long d0 = (long long)k * n + e0;
    if (k == 0 || d0 % EPB == 0) {
      uint64_t A[25];
#pragma unroll
      for (int q = 0; q < 25; ++q) A[q] = S0[q];
      A[19] ^= (uint64_t)(d0 / EPB);
      keccak_f1600(A);
#pragma unroll
      for (int s = 0; s < EPB; ++s) reduce_draw<W>(A, s, P, C[k][s]);
    } else {
      const long long blk = d0 / EPB;
      const int s0 = (int)(d0 % EPB);
      uint32_t Rd[2 * EPB][NL];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint64_t A[25];
#pragma unroll
        for (int q = 0; q < 25; ++q) A[q] = S0[q];
        A[19] ^= (uint64_t)(blk + h);
        keccak_f1600(A);
#pragma unroll
        for (int j = 0; j < EPB; ++j)
          reduce_draw<W>(A, j, P, Rd[h * EPB + j]);
      }
#pragma unroll
      for (int s = 0; s < EPB; ++s) {
#pragma unroll
        for (int q = 0; q < NL; ++q) C[k][s][q] = Rd[s0 + s][q];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: one whole GRR98 reshare round, with the local product when FUSE.
// Replaces mpyc_tpu/models/pipelines.py:87 make_reshare_step ->
// make_pallas.kernel (:179), in the stream layout of its XLA twin
// step_xla (:145): coefficient C_k of element e is draw k*n + e of the
// squeeze_mont stream (counter in lane 19) of the absorbed state with the
// per-call nonce XORed into lane 4. Output row j (party j+1) is
//   Horner(C, x_j) + S,  S = sum_{i < 2t+1} lag_i * s_i,
//   s_i = a_i * b_i (FUSE) or a_i.
// Bound: integer operations (at t = 1, m = 3: a tenth of a permutation
// and 11 Montgomery multiplies per element, against 72 bytes moved).
// Design: a CTA of RESHARE_THREADS = 320 threads takes RESHARE_ELEMS =
// 3,200 consecutive elements, whose k = 0 coefficients are exactly 320
// sponge blocks: every thread squeezes one and reduces its ten draws
// once, through the stage (stage.cuh; for k > 0 the draws may straddle
// 321 blocks, and thread 0 takes the last), into shared memory. Then each
// thread takes the elements e0 + r*320 + tid (r < 10): each share is one
// 8-byte load and each output one 8-byte store, neighbouring lanes on
// neighbouring elements, so a warp's access is 256 contiguous bytes.
// (With one element a thread, one warp in ten squeezed while the others
// waited at the barrier, and K3 took twice as long: PERF.md.) Written for
// general t; built for t = 1, m = 3.
// ---------------------------------------------------------------------------
constexpr int RESHARE_THREADS = 320;
constexpr int RESHARE_ELEMS = 10 * RESHARE_THREADS;

template <bool FUSE, int T, int M>
__global__ void __launch_bounds__(RESHARE_THREADS)
reshare_kernel(const uint2* __restrict__ a, const uint2* __restrict__ b,
               uint2* __restrict__ out, const uint32_t* __restrict__ state,
               long long n, ReshareParams P) {
  constexpr int NSEND = 2 * T + 1;
  static_assert(NSEND <= MAX_SEND && M <= MAX_M && NSEND <= M, "shape");
  __shared__ uint2 coefs[T * RESHARE_ELEMS];
  const long long e0 = (long long)blockIdx.x * RESHARE_ELEMS;
  const int cnt = (int)(n - e0 < RESHARE_ELEMS ? n - e0 : RESHARE_ELEMS);
  const uint32_t* p = P.draw.p;
  const uint32_t n0 = P.draw.n0inv;
  const uint64_t nonce = ((uint64_t)P.nonce_hi << 32) | P.nonce_lo;
#pragma unroll
  for (int k = 0; k < T; ++k)
    stage_draws(state, nonce, 0, (long long)k * n + e0, cnt, 1, P.draw,
                coefs + k * RESHARE_ELEMS, RESHARE_ELEMS);
  __syncthreads();

#pragma unroll 1
  for (int el = threadIdx.x; el < cnt; el += RESHARE_THREADS) {
    const long long e = e0 + el;
    uint32_t S[NL];
#pragma unroll
    for (int i = 0; i < NSEND; ++i) {
      const uint2 av = __ldg(a + (long long)i * n + e);
      uint32_t si[NL] = {av.x, av.y}, term[NL];
      if (FUSE) {
        const uint2 bv = __ldg(b + (long long)i * n + e);
        const uint32_t bi[NL] = {bv.x, bv.y};
        mont_mul<NL>(si, bi, p, n0, si);
      }
      mont_mul<NL>(si, P.lag[i], p, n0, term);
      if (i == 0) {
        S[0] = term[0];
        S[1] = term[1];
      } else {
        add_mod<NL>(S, term, p, S);
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      uint32_t y[NL];
#pragma unroll
      for (int k = 0; k < T; ++k) {
        const uint2 ck = coefs[k * RESHARE_ELEMS + el];
        const uint32_t c[NL] = {ck.x, ck.y};
        if (k == 0) {
          y[0] = c[0];
          y[1] = c[1];
        } else {
          add_mod<NL>(y, c, p, y);
        }
        mont_mul<NL>(y, P.xs[j], p, n0, y);
      }
      add_mod<NL>(y, S, p, y);
      out[(long long)j * n + e] = make_uint2(y[0], y[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4: one Shamir round trip, split at x = 1..m and recombined at 0.
// Replaces mpyc_tpu/models/pipelines.py:378 make_split_recombine_fused ->
// kernel (:415, pallas_call :475), in the stream layout of its XLA twin
// make_split_recombine (:35): coefficient C_k of element e is draw k*n + e
// of the squeeze_mont stream of the given state (no call nonce). Share j
// is Horner(C, x_j) + s; the output is sum_{i < t+1} lag_i * share_i, the
// secret again. `shares`, when not null, receives the (m, n) shares.
// Bound: integer operations (at t = 1, m = 3: a tenth of a permutation
// and 7 Montgomery multiplies per element, against 16 bytes moved).
// Design: one thread per group of 10 elements whose coefficients are one
// sponge block (group_coefs); everything between the read of the secret
// and the write of the output stays in registers. K4 moves 16 bytes an
// element, so its strided 4-byte accesses cost little (PERF.md has its
// time against its bound), and it keeps this layout.
// ---------------------------------------------------------------------------
template <int T, int M>
__global__ void __launch_bounds__(128)
split_recombine_kernel(const uint32_t* __restrict__ sec,
                       uint32_t* __restrict__ out,
                       uint32_t* __restrict__ shares,
                       const uint32_t* __restrict__ state, long long n,
                       ReshareParams P) {
  constexpr int EPB = RATE_WORDS / 4;
  static_assert(T + 1 <= MAX_SEND && M <= MAX_M && T < M, "shape");
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long e0 = g * EPB;
  if (e0 >= n) return;
  uint64_t S0[25];
  load_state(state, S0);
  const uint32_t* p = P.draw.p;
  const uint32_t n0 = P.draw.n0inv;

  uint32_t C[T][EPB][NL];
  group_coefs<T>(S0, n, e0, P.draw, C);

#pragma unroll
  for (int s = 0; s < EPB; ++s) {
    const long long e = e0 + s;
    if (e < n) {
      uint32_t sv[NL], acc[NL];
#pragma unroll
      for (int q = 0; q < NL; ++q) sv[q] = __ldg(sec + e * NL + q);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        uint32_t y[NL];
#pragma unroll
        for (int k = 0; k < T; ++k) {
          if (k == 0) {
#pragma unroll
            for (int q = 0; q < NL; ++q) y[q] = C[0][s][q];
          } else {
            add_mod<NL>(y, C[k][s], p, y);
          }
          mont_mul<NL>(y, P.xs[j], p, n0, y);
        }
        add_mod<NL>(y, sv, p, y);
        if (shares != nullptr) {
          const long long o = ((long long)j * n + e) * NL;
#pragma unroll
          for (int q = 0; q < NL; ++q) shares[o + q] = y[q];
        }
        if (j < T + 1) {
          mont_mul<NL>(y, P.lag[j], p, n0, y);
          if (j == 0) {
#pragma unroll
            for (int q = 0; q < NL; ++q) acc[q] = y[q];
          } else {
            add_mod<NL>(acc, y, p, acc);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < NL; ++q) out[e * NL + q] = acc[q];
    }
  }
}

}  // namespace mtt

#include "sgn.cuh"

namespace mtt {

template <int W>
int launch_squeeze(const void* state, void* out, long long n_draws,
                   int ctr_lane, unsigned long long base,
                   const DrawParams& P, cudaStream_t stream) {
  constexpr int EPB = RATE_WORDS / W;
  const long long n_blocks = (n_draws + EPB - 1) / EPB;
  const int threads = 256;
  const long long grid = (n_blocks + threads - 1) / threads;
  squeeze_mont_kernel<W><<<(unsigned)grid, threads, 0, stream>>>(
      (const uint32_t*)state, (uint32_t*)out, n_draws, n_blocks, ctr_lane,
      base, P);
  return (int)cudaGetLastError();
}

template <bool FUSE>
int launch_reshare(const void* a, const void* b, void* out, const void* state,
                   long long n, const ReshareParams& P, cudaStream_t stream) {
  const long long grid = (n + RESHARE_ELEMS - 1) / RESHARE_ELEMS;
  reshare_kernel<FUSE, 1, 3><<<(unsigned)grid, RESHARE_THREADS, 0, stream>>>(
      (const uint2*)a, (const uint2*)b, (uint2*)out, (const uint32_t*)state,
      n, P);
  return (int)cudaGetLastError();
}

int launch_split_recombine(const void* sec, void* out, void* shares,
                           const void* state, long long n,
                           const ReshareParams& P, cudaStream_t stream) {
  constexpr int EPB = RATE_WORDS / 4;
  const long long groups = (n + EPB - 1) / EPB;
  const int threads = 128;
  const long long grid = (groups + threads - 1) / threads;
  split_recombine_kernel<1, 3><<<(unsigned)grid, threads, 0, stream>>>(
      (const uint32_t*)sec, (uint32_t*)out, (uint32_t*)shares,
      (const uint32_t*)state, n, P);
  return (int)cudaGetLastError();
}

template <int MODE, int LBIT>
int launch_sgn(const void* a, void* out, const void* state, long long n,
               long long blocks_a, const SgnParams& P, cudaStream_t stream) {
  const long long grid = (n + SGN_THREADS - 1) / SGN_THREADS;
  constexpr int smem = sgn_smem_bytes<MODE, LBIT, 1>();
  const cudaError_t rc = cudaFuncSetAttribute(
      sgn_kernel<MODE, LBIT, 1, 3>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  sgn_kernel<MODE, LBIT, 1, 3><<<(unsigned)grid, SGN_THREADS, smem, stream>>>(
      (const uint2*)a, (uint2*)out, (const uint32_t*)state, n, blocks_a, P);
  return (int)cudaGetLastError();
}

template <int LBIT>
int launch_sgn_modes(const void* a, void* out, const void* state,
                     long long n, long long blocks_a, const SgnParams& P,
                     cudaStream_t s) {
  switch (P.mode) {
    case 0: return launch_sgn<0, LBIT>(a, out, state, n, blocks_a, P, s);
    case 1: return launch_sgn<1, LBIT>(a, out, state, n, blocks_a, P, s);
    case 2: return launch_sgn<2, LBIT>(a, out, state, n, blocks_a, P, s);
    default: return -1;
  }
}

}  // namespace mtt

extern "C" {

int mtt_keccak_ctr(const void* state, void* out, long long n, int ctr_lane,
                   unsigned long long base, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long grid = (n + threads - 1) / threads;
  mtt::keccak_ctr_kernel<<<(unsigned)grid, threads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)state, (uint64_t*)out, n, ctr_lane, base);
  return (int)cudaGetLastError();
}

// l_words: words per draw (4 for the reshare stream's 16-byte draws, 6 for
// the 24-byte draws of the input randomness). -1: a width not built.
int mtt_squeeze_mont(const void* state, void* out, long long n_draws,
                     int l_words, int ctr_lane, unsigned long long base,
                     const void* params, void* stream) {
  if (n_draws <= 0) return 0;
  const mtt::DrawParams P = *(const mtt::DrawParams*)params;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (l_words) {
    case 4: return mtt::launch_squeeze<4>(state, out, n_draws, ctr_lane,
                                          base, P, s);
    case 6: return mtt::launch_squeeze<6>(state, out, n_draws, ctr_lane,
                                          base, P, s);
    default: return -1;
  }
}

// b is ignored unless fuse. -1: a (t, m) the kernel was not built for.
int mtt_reshare(const void* a, const void* b, void* out, const void* state,
                long long n, int fuse, const void* params, void* stream) {
  const mtt::ReshareParams P = *(const mtt::ReshareParams*)params;
  if (P.t != 1 || P.m != 3 || P.n_send != 3) return -1;
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return fuse ? mtt::launch_reshare<true>(a, b, out, state, n, P, s)
              : mtt::launch_reshare<false>(a, b, out, state, n, P, s);
}

// shares may be null. -1: a (t, m) the kernel was not built for.
int mtt_split_recombine(const void* sec, void* out, void* shares,
                        const void* state, long long n, const void* params,
                        void* stream) {
  const mtt::ReshareParams P = *(const mtt::ReshareParams*)params;
  if (P.t != 1 || P.m != 3 || P.n_send != 2) return -1;
  if (n <= 0) return 0;
  return mtt::launch_split_recombine(sec, out, shares, state, n, P,
                                     (cudaStream_t)stream);
}

// -1: a (mode, l, t, m, k) the kernel was not built for (l = 32, 14 or
// 10, t = 1, m = 3, 0 <= k <= 64; mpyc_tpu_torch/_build.py SGN_BUILT).
int mtt_sgn(const void* a, void* out, const void* state, long long n,
            long long blocks_a, const void* params, void* stream) {
  const mtt::SgnParams P = *(const mtt::SgnParams*)params;
  if (P.t != 1 || P.m != 3 || P.k < 0 || P.k > 64) return -1;
  if (P.l != 32 && P.l != 14 && P.l != 10) return -1;
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  using mtt::launch_sgn_modes;
  switch (P.l) {
    case 32: return launch_sgn_modes<32>(a, out, state, n, blocks_a, P, s);
    case 14: return launch_sgn_modes<14>(a, out, state, n, blocks_a, P, s);
    default: return launch_sgn_modes<10>(a, out, state, n, blocks_a, P, s);
  }
}

// Elements of a K5 thread block (SGN_THREADS), for models of its stage.
int mtt_sgn_threads() { return mtt::SGN_THREADS; }

const char* mtt_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
