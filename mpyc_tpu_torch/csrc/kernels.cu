// CUDA kernels of the port (sm_90a): K1-K3 of secure multiplication (K3
// in reshare.cuh: its instantiations at (t, m) = (1, 3) here, at a
// run-time (t, m) in reshare.cu), K4 the split/recombine round, K5 the
// secure comparison (sgn.cuh), K6 a
// power with a public exponent and K7 the tail of a round of random bits
// around it (pow.cuh), K9 elementwise field arithmetic (K8, the GF(2^d)
// reshare, is gf2.cu).
//
// Built by mpyc_tpu_torch/_build.py with plain nvcc into one shared library
// whose extern "C" launchers are called through ctypes. Each launcher takes
// device pointers, sizes, constants (by value, from a host struct) and a
// stream, launches, and returns cudaGetLastError().
//
// Field elements are little-endian 32-bit limbs in Montgomery form with
// R = 2^(32 NL). K3, K6, K7 and K9 are built for fields of one to six
// limbs (p < 2^192: the secure prime fields SecFld(p) of p < 2^32 one,
// e.g. GF(11), GF(1031), GF(2^31 - 1); SecInt(32)'s and SecInt(14)'s two,
// SecInt(37)'s and SecInt(64)'s three, the LP solver's SecInt(70) and
// SecFxp(52) four, SecInt(104) and SecInt(110) five, SecFxp(96) six), K5
// for two to six (a secure integer's field has l + k + 2 > 32 bits), K2
// for the draws of two- and three-limb fields that a path takes and K4
// for two-limb fields; each launcher picks the instantiation from
// the parameter block's limb count. Every result is
// canonical, so each kernel equals its plain PyTorch version (and the JAX
// package) bit for bit.
#include "common.cuh"
#include "reshare.cuh"


namespace mtt {

// ---------------------------------------------------------------------------
// K1: counter-mode SHAKE128 squeeze.
// Replaces mpyc_tpu/ops/keccak.py:215 _squeeze_ctr_pallas (kernel :235).
// Instance i XORs base + i into lane ctr_lane of the absorbed state, runs
// Keccak-f[1600] and writes its 21 rate lanes: (n, 42) uint32 words
// [lo0, hi0, ...], which as little-endian 64-bit lanes is a plain store.
// Bound: integer operations (about 4,300 32-bit logic and shift
// instructions per permutation against 168 bytes written). At the paths'
// small shapes (293 and 512 blocks for input draws and the pool, 1,561
// for AES's random bits, 9,363 for a SHA3 round while K8 read K1's
// blocks) the time is one warp's stream of those instructions: a
// scheduler gives a warp's logic instructions 16 lanes a clock, so a warp
// of sponges takes about 8,600 clocks whatever its count. Design: one
// sponge per thread, the 25 lanes as uint64_t in registers for all 24
// rounds (no stack frame: see xor_lane). The CTA's
// width comes from n (keccak_ctr_cta: 32 to 256 threads, the widest at
// which the grid still has two CTAs an SM), so that the grid reaches
// every SM whenever n allows and each scheduler holds as few warps as n
// permits. Each thread stages its 168 bytes in dynamic shared memory (168
// x width bytes, conflict-free: rows 42 words apart), and the CTA then
// writes its contiguous rows as 16-byte stores, consecutive threads on
// consecutive addresses, instead of 21 8-byte stores a thread 168 bytes
// apart. Up to one CTA an SM of 24 sponges, K1 spreads each permutation
// over five threads instead (keccak_ctr5_kernel), which shortens a warp's
// stream.
// ---------------------------------------------------------------------------
constexpr int KECCAK_CTR_MAX_THREADS = 256;

__global__ void __launch_bounds__(KECCAK_CTR_MAX_THREADS)
keccak_ctr_kernel(const uint32_t* __restrict__ state,
                  uint64_t* __restrict__ out, long long n, int ctr_lane,
                  unsigned long long base) {
  constexpr int LANES = RATE_WORDS / 2;
  extern __shared__ uint4 keccak_rows[];   // blockDim.x rows of 21 lanes
  uint64_t* rows = reinterpret_cast<uint64_t*>(keccak_rows);
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * blockDim.x;
  const int cnt = (int)(n - r0 < blockDim.x ? n - r0 : blockDim.x);
  if (tid < cnt) {
    uint64_t A[25];
    load_state(state, A);
    xor_lane(A, ctr_lane, base + (unsigned long long)(r0 + tid));
    keccak_f1600(A);
#pragma unroll
    for (int k = 0; k < LANES; ++k) rows[tid * LANES + k] = A[k];
  }
  __syncthreads();
  // the CTA's rows are cnt x 168 contiguous bytes at out + 21 r0, 16-byte
  // aligned (blockDim.x is even and the launcher checks out); an odd cnt
  // leaves one 8-byte lane
  uint4* dst = reinterpret_cast<uint4*>(out + r0 * LANES);
  const int n16 = cnt * LANES / 2;
  for (int i = tid; i < n16; i += blockDim.x) dst[i] = keccak_rows[i];
  if ((cnt & 1) && tid == 0)
    out[(r0 + cnt) * LANES - 1] = rows[cnt * LANES - 1];
}

// K1 on few blocks: one permutation over five threads. With few sponges
// K1 runs one warp a scheduler, and a warp's stream of about 4,300 logic
// instructions (16 lanes a clock for a warp) is the time; spread over five
// threads, a permutation's stream is shorter. Thread x (0..4) of a sponge
// holds column x, the lanes x + 5y. Per round: theta's column parity is
// local and its two neighbours' come by __shfl_sync; rho rotates each
// lane by its own offset (read once from a table); pi moves lane (x, y) to
// (y, 2x + 3y): in step k every thread sends its lane (x + 2k) mod 5 and
// receives row k of its new column from thread (3k + x) mod 5; chi takes
// the new columns x + 1 and x + 2 by __shfl_sync. Six sponges a warp
// (lanes 0..29; lanes 30 and 31 shuffle with themselves and store
// nothing), 24 a CTA of 128 threads. The output is small here, so each
// thread stores its rate lanes itself. (Exchanging the lanes through
// shared memory instead, between __syncwarp()s, was slower at every block
// count: PERF.md section 6.)
constexpr int KECCAK5_THREADS = 128;
constexpr int KECCAK5_PER_WARP = 6;
constexpr int KECCAK5_PER_CTA = KECCAK5_PER_WARP * KECCAK5_THREADS / 32;

// rho offsets of lane x + 5y: a thread reads its column's five once (a
// table: keccak_rot at a run-time lane is a chain of 24 selects, which
// cost the five-thread kernel its lead)
static __constant__ uint8_t kKeccakRot[25] = {
    0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43,
    25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
  const uint32_t lo = __shfl_sync(0xFFFFFFFFu, (uint32_t)v, src);
  const uint32_t hi = __shfl_sync(0xFFFFFFFFu, (uint32_t)(v >> 32), src);
  return ((uint64_t)hi << 32) | lo;
}

// v rotated left by 32 swap + r (r < 32): the halves swapped, then two
// funnel shifts
__device__ __forceinline__ uint64_t rotl_var(uint64_t v, bool swap, int r) {
  uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32);
  if (swap) {
    const uint32_t t = lo;
    lo = hi;
    hi = t;
  }
  const uint32_t nh = __funnelshift_l(lo, hi, r);
  const uint32_t nl = __funnelshift_l(hi, lo, r);
  return ((uint64_t)nh << 32) | nl;
}

// A[i] for an index known only at run time, as selects
__device__ __forceinline__ uint64_t pick5(const uint64_t* A, int i) {
  uint64_t v = A[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) v = i == k ? A[k] : v;
  return v;
}

__global__ void __launch_bounds__(KECCAK5_THREADS)
keccak_ctr5_kernel(const uint32_t* __restrict__ state,
                   uint64_t* __restrict__ out, long long n, int ctr_lane,
                   unsigned long long base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = lane < 5 * KECCAK5_PER_WARP;
  const int x = live ? lane % 5 : 0;
  const int b0 = live ? lane - x : lane;   // lane of the sponge's thread 0
  const auto at = [&](int k) { return live ? b0 + k % 5 : lane; };
  const long long s = ((long long)blockIdx.x * (KECCAK5_THREADS / 32) +
                       warp) * KECCAK5_PER_WARP + lane / 5;
  uint64_t A[5];
  bool swap[5];
  int rot[5];
#pragma unroll
  for (int y = 0; y < 5; ++y) {
    const int k = x + 5 * y;
    A[y] = ((uint64_t)__ldg(state + k) << 32) | __ldg(state + 25 + k);
    if (k == ctr_lane) A[y] ^= base + (unsigned long long)s;
    swap[y] = kKeccakRot[k] >= 32;
    rot[y] = kKeccakRot[k] & 31;
  }
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    const uint64_t C = A[0] ^ A[1] ^ A[2] ^ A[3] ^ A[4];
    const uint64_t D =
        shfl64(C, at(x + 4)) ^ rotl64(shfl64(C, at(x + 1)), 1);
#pragma unroll
    for (int y = 0; y < 5; ++y) A[y] = rotl_var(A[y] ^ D, swap[y], rot[y]);
    uint64_t B[5];
#pragma unroll
    for (int k = 0; k < 5; ++k)
      B[k] = shfl64(pick5(A, (x + 2 * k) % 5), at(3 * k + x));
#pragma unroll
    for (int y = 0; y < 5; ++y) {
      const uint64_t b1 = shfl64(B[y], at(x + 1));
      const uint64_t b2 = shfl64(B[y], at(x + 2));
      A[y] = B[y] ^ (~b1 & b2);
    }
    if (x == 0) A[0] ^= kKeccakRC[round];
  }
  if (live && s < n) {
#pragma unroll
    for (int y = 0; y < 5; ++y)
      if (x + 5 * y < RATE_WORDS / 2)
        out[s * (RATE_WORDS / 2) + x + 5 * y] = A[y];
  }
}

// Sponges a K1 CTA takes on n blocks: KECCAK5_PER_CTA (five threads a
// sponge) while the grid has at most one CTA an SM, where that design is
// the faster (tools/kernel_ab.py, PERF.md section 6); beyond, one thread a
// sponge, 32 threads doubled up to 256 while the grid keeps at least two
// CTAs an SM.
inline int keccak_ctr_cta(long long n) {
  if (n <= (long long)KECCAK5_PER_CTA * sm_count()) return KECCAK5_PER_CTA;
  const long long warps = (n + 31) / 32;
  int w = 1;
  while (32 * w < KECCAK_CTR_MAX_THREADS && warps >= 4LL * w * sm_count())
    w *= 2;
  return 32 * w;
}

// An empty kernel: its replayed launch is the floor under every time of a
// launch on the card (chip_smoke.py prints it beside K1's and K8's).
__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// K9: elementwise arithmetic in GF(p) on Montgomery limbs: out_e = a_e op
// b_e for n elements, op a Montgomery product (0), a modular add (1) or
// a modular subtraction (2), an operand of step 0 one element for all
// (a public constant). No Pallas kernel of the JAX package computes it:
// XLA runs its limb arithmetic (mpyc_tpu/ops/limb.py mont_mul :247,
// add_mod :217, sub_mod :227) as fused elementwise programs; the plain
// versions are mpyc_tpu_torch/ops/limb.py's. On the card every secure
// protocol step between the kernels above (PRSS draws' reduction and
// products, truncations, openings, local products, public encodings)
// is such an operation, and the plain torch form takes about 150
// launches a six-limb product: one thread an element here. Results are
// canonical (mont_mul's a may be below R, b below p: a draw's chunk).
// ---------------------------------------------------------------------------
constexpr int FIELD_OP_THREADS = 256;

template <int NL>
__global__ void __launch_bounds__(FIELD_OP_THREADS)
field_op_kernel(const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                long long n, int a_step, int b_step, int op, DrawParams P) {
  const long long e = (long long)blockIdx.x * FIELD_OP_THREADS + threadIdx.x;
  if (e >= n) return;
  uint32_t x[NL], y[NL], r[NL];
  ldg_fe<NL>(a, e * a_step, x);
  ldg_fe<NL>(b, e * b_step, y);
  if (op == 0) mont_mul<NL>(x, y, P.p, P.n0inv, r);
  else if (op == 1) add_mod<NL>(x, y, P.p, r);
  else sub_mod<NL>(x, y, P.p, r);
  store_fe<NL>(out, e, r);
}

// ---------------------------------------------------------------------------
// K2: squeeze fused with the map into GF(p).
// Replaces mpyc_tpu/ops/rng.py:99 _squeeze_mont_kernel (kernel :130).
// Block b holds EPB = 42 / W draws; draw d = b * EPB + j takes words
// j*W .. j*W+W-1 of block d / EPB (the JAX package's stream order).
// Bound: integer operations (a permutation per EPB draws plus one
// Montgomery multiply per chunk; 4 NL bytes written per draw). Design: one
// sponge per thread; the rate words stay in registers and only the
// reduced draws are written, instead of the 168-byte blocks. Built for
// (NL, W) = (2, 4), (2, 6), (3, 7): the fused streams' draws of two-limb
// fields and the word-aligned input draws of SecInt(32) and SecInt(64).
// (A one-limb field's 20-byte input draws are five chunks, more than the
// radix table's MAX_NC: K1 squeezes them and K9 reduces the chunks.)
// ---------------------------------------------------------------------------
template <int NL, int W>
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
      reduce_draw<NL, W>(A, j, P, v);
      store_fe<NL>(out, d, v);
    }
  }
}

// K4's t coefficients of the EPB = 10 elements e0 .. e0 + 9 (e0 a multiple
// of 10) in the stream layout of the JAX package's XLA steps: coefficient
// C_k of element e is draw k*n + e of the squeeze_mont stream of the
// absorbed state S0 (16-byte draws, counter in lane 19). For k = 0 the
// group's draws are exactly one sponge block; for k > 0 they may straddle
// two, and the thread then squeezes both. t is a constant of the
// instantiation at (t, m) = (1, 3) (the loop unrolls, C stays in
// registers), else a launch parameter of at most MAX_T.
__device__ __forceinline__ void group_coefs(const uint64_t* S0, long long n,
                                            long long e0, int t,
                                            const DrawParams& P,
                                            uint32_t (*C)[RATE_WORDS / 4][2]) {
  constexpr int NL = 2, W = fused_words<NL>();  // 16-byte draws
  constexpr int EPB = RATE_WORDS / W;
#pragma unroll
  for (int k = 0; k < t; ++k) {
    const long long d0 = (long long)k * n + e0;
    if (k == 0 || d0 % EPB == 0) {
      uint64_t A[25];
#pragma unroll
      for (int q = 0; q < 25; ++q) A[q] = S0[q];
      A[19] ^= (uint64_t)(d0 / EPB);
      keccak_f1600(A);
#pragma unroll
      for (int s = 0; s < EPB; ++s) reduce_draw<NL, W>(A, s, P, C[k][s]);
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
          reduce_draw<NL, W>(A, j, P, Rd[h * EPB + j]);
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
// K4: one Shamir round trip, split at x = 1..m and recombined at 0.
// Replaces mpyc_tpu/models/pipelines.py:378 make_split_recombine_fused ->
// kernel (:415, pallas_call :475), in the stream layout of its XLA twin
// make_split_recombine (:35): coefficient C_k of element e is draw k*n + e
// of the squeeze_mont stream of the given state (no call nonce). Share j
// is Horner(C, x_j) + s; the output is sum_{i < t+1} lag_i * share_i, the
// secret again. `shares`, when not null, receives the (m, n) shares.
// Bound: integer operations (at t = 1, m = 3: a tenth of a permutation
// and 7 Montgomery multiplies per element, against 16 bytes moved; in
// general t draws, m t products of Horner and t + 1 of the opening).
// Design: one thread per group of 10 elements whose coefficients are one
// sponge block (group_coefs); everything between the read of the secret
// and the write of the output stays in registers. K4 moves 16 bytes an
// element, so its strided 4-byte accesses cost little (PERF.md has its
// time against its bound), and it keeps this layout. Built for two-limb
// fields: T, M = 1, 3 (loops unrolled, the coefficients in registers), and
// T = M = 0 with t and m launch parameters (1 <= t <= MAX_T, 2t + 1 <= m
// <= MAX_M; the coefficients in local memory, the points and Lagrange
// coefficients copied into shared memory).
// ---------------------------------------------------------------------------
constexpr int SPLIT_THREADS = 128;

template <int T, int M>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_recombine_kernel(const uint32_t* __restrict__ sec,
                       uint32_t* __restrict__ out,
                       uint32_t* __restrict__ shares,
                       const uint32_t* __restrict__ state, long long n,
                       ReshareParams P) {
  constexpr int NL = 2;
  constexpr int EPB = RATE_WORDS / fused_words<NL>();
  constexpr bool FIXED = M > 0;
  constexpr int TM = FIXED ? T : MAX_T;
  static_assert(!FIXED || (T + 1 <= MAX_SEND && M <= MAX_M && T < M),
                "shape");
  const int t = FIXED ? T : P.t;
  const int m = FIXED ? M : P.m;
  __shared__ uint32_t cs[FIXED ? 1 : (MAX_M + MAX_SEND) * NL];
  if constexpr (!FIXED) {
#pragma unroll
    for (int j = 0; j < MAX_M; ++j)
      copy_consts<NL>(reinterpret_cast<const uint32_t(&)[NL]>(P.xs[j]),
                      cs + j * NL, j < m ? NL : 0);
#pragma unroll
    for (int i = 0; i < MAX_SEND; ++i)
      copy_consts<NL>(reinterpret_cast<const uint32_t(&)[NL]>(P.lag[i]),
                      cs + (MAX_M + i) * NL, i < t + 1 ? NL : 0);
    __syncthreads();
  }
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long e0 = g * EPB;
  if (e0 >= n) return;
  uint64_t S0[25];
  load_state(state, S0);
  const uint32_t* p = P.draw.p;
  const uint32_t n0 = P.draw.n0inv;

  uint32_t C[TM][EPB][NL];
  group_coefs(S0, n, e0, t, P.draw, C);

#pragma unroll
  for (int s = 0; s < EPB; ++s) {
    const long long e = e0 + s;
    if (e < n) {
      uint32_t sv[NL], acc[NL];
#pragma unroll
      for (int q = 0; q < NL; ++q) sv[q] = __ldg(sec + e * NL + q);
#pragma unroll
      for (int j = 0; j < m; ++j) {
        const uint32_t *xj, *lj;
        if constexpr (FIXED) {
          xj = P.xs[j];
          lj = P.lag[j < T + 1 ? j : 0];
        } else {
          xj = cs + j * NL;
          lj = cs + (MAX_M + j) * NL;
        }
        uint32_t y[NL];
#pragma unroll
        for (int k = 0; k < t; ++k) {
          if (k == 0) {
#pragma unroll
            for (int q = 0; q < NL; ++q) y[q] = C[0][s][q];
          } else {
            add_mod<NL>(y, C[k][s], p, y);
          }
          mont_mul<NL>(y, xj, p, n0, y);
        }
        add_mod<NL>(y, sv, p, y);
        if (shares != nullptr) {
          const long long o = ((long long)j * n + e) * NL;
#pragma unroll
          for (int q = 0; q < NL; ++q) shares[o + q] = y[q];
        }
        if (j < t + 1) {
          mont_mul<NL>(y, lj, p, n0, y);
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

template <int NL, int W>
int launch_squeeze(const void* state, void* out, long long n_draws,
                   int ctr_lane, unsigned long long base,
                   const DrawParams& P, cudaStream_t stream) {
  constexpr int EPB = RATE_WORDS / W;
  const long long n_blocks = (n_draws + EPB - 1) / EPB;
  const int threads = 256;
  const long long grid = (n_blocks + threads - 1) / threads;
  squeeze_mont_kernel<NL, W><<<(unsigned)grid, threads, 0, stream>>>(
      (const uint32_t*)state, (uint32_t*)out, n_draws, n_blocks, ctr_lane,
      base, P);
  return (int)cudaGetLastError();
}

template <int NL>
int launch_field_op(const void* a, const void* b, void* out, long long n,
                    int a_step, int b_step, int op, const DrawParams& P,
                    cudaStream_t stream) {
  const long long grid = (n + FIELD_OP_THREADS - 1) / FIELD_OP_THREADS;
  field_op_kernel<NL><<<(unsigned)grid, FIELD_OP_THREADS, 0, stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, a_step,
      b_step, op, P);
  return (int)cudaGetLastError();
}

template <int T, int M>
int launch_split_recombine(const void* sec, void* out, void* shares,
                           const void* state, long long n,
                           const ReshareParams& P, cudaStream_t stream) {
  constexpr int EPB = RATE_WORDS / 4;
  const long long groups = (n + EPB - 1) / EPB;
  const long long grid = (groups + SPLIT_THREADS - 1) / SPLIT_THREADS;
  split_recombine_kernel<T, M><<<(unsigned)grid, SPLIT_THREADS, 0,
                                 stream>>>(
      (const uint32_t*)sec, (uint32_t*)out, (uint32_t*)shares,
      (const uint32_t*)state, n, P);
  return (int)cudaGetLastError();
}

}  // namespace mtt

extern "C" {

// K3 at a run-time (t, m), compiled from reshare.cu in a translation unit
// of its own (_build.py builds it beside this one).
int mtt_reshare_t(const void* a, const void* b, void* out, const void* state,
                  long long n, int fuse, const void* params, void* stream);

// K5's launchers, one a limb count and threshold (nl<L>_t<t>; t0: a
// run-time t >= 2), each compiled from sgn.cu in a translation unit of
// its own (_build.py builds them in parallel).
#define MTT_SGN_LAUNCHER(NAME)                                             \
  int NAME(const void* a, void* out, const void* state, long long n,      \
           long long chunk, long long n_last, const void* params, int lb, \
           int B, void* stream);
MTT_SGN_LAUNCHER(mtt_sgn_launch_nl2_t1)
MTT_SGN_LAUNCHER(mtt_sgn_launch_nl2_t2)
MTT_SGN_LAUNCHER(mtt_sgn_launch_nl2_t3)
MTT_SGN_LAUNCHER(mtt_sgn_launch_nl2_t4)
MTT_SGN_LAUNCHER(mtt_sgn_launch_nl3_t1)
MTT_SGN_LAUNCHER(mtt_sgn_launch_nl4_t1)
MTT_SGN_LAUNCHER(mtt_sgn_launch_nl5_t1)
MTT_SGN_LAUNCHER(mtt_sgn_launch_nl6_t1)
MTT_SGN_LAUNCHER(mtt_sgn_launch_nl3_t0)
MTT_SGN_LAUNCHER(mtt_sgn_launch_nl4_t0)
MTT_SGN_LAUNCHER(mtt_sgn_launch_nl5_t0)
MTT_SGN_LAUNCHER(mtt_sgn_launch_nl6_t0)
#undef MTT_SGN_LAUNCHERS
#undef MTT_SGN_LAUNCHER

// -1: an output that is not 16-byte aligned.
int mtt_keccak_ctr(const void* state, void* out, long long n, int ctr_lane,
                   unsigned long long base, void* stream) {
  if ((uintptr_t)out % 16) return -1;
  if (n <= 0) return 0;
  const int per = mtt::keccak_ctr_cta(n);
  const long long grid = (n + per - 1) / per;
  const cudaStream_t s = (cudaStream_t)stream;
  if (per == mtt::KECCAK5_PER_CTA) {
    mtt::keccak_ctr5_kernel<<<(unsigned)grid, mtt::KECCAK5_THREADS, 0, s>>>(
        (const uint32_t*)state, (uint64_t*)out, n, ctr_lane, base);
  } else {
    mtt::keccak_ctr_kernel<<<(unsigned)grid, per, per * 4 * mtt::RATE_WORDS,
                             s>>>((const uint32_t*)state, (uint64_t*)out, n,
                                  ctr_lane, base);
  }
  return (int)cudaGetLastError();
}

// Sponges (blocks) a K1 CTA takes on n blocks, for the tests and
// chip_smoke.py's reports: 24 for five threads a sponge, else the CTA's
// threads.
int mtt_keccak_ctr_cta(long long n) { return mtt::keccak_ctr_cta(n); }

// out = a op b elementwise for n elements (K9): op 0 a Montgomery
// product, 1 an add, 2 a subtraction mod p; a_step and b_step 1, or 0
// for one element taken by all; one to six limbs. -1: a limb count, op or
// step not built.
int mtt_field_op(const void* a, const void* b, void* out, long long n,
                 int a_step, int b_step, int op, const void* params,
                 void* stream) {
  const mtt::DrawParams P = *(const mtt::DrawParams*)params;
  if (op < 0 || op > 2 || a_step < 0 || a_step > 1 || b_step < 0 ||
      b_step > 1)
    return -1;
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (P.nl) {
    case 1: return mtt::launch_field_op<1>(a, b, out, n, a_step, b_step, op,
                                           P, s);
    case 2: return mtt::launch_field_op<2>(a, b, out, n, a_step, b_step, op,
                                           P, s);
    case 3: return mtt::launch_field_op<3>(a, b, out, n, a_step, b_step, op,
                                           P, s);
    case 4: return mtt::launch_field_op<4>(a, b, out, n, a_step, b_step, op,
                                           P, s);
    case 5: return mtt::launch_field_op<5>(a, b, out, n, a_step, b_step, op,
                                           P, s);
    case 6: return mtt::launch_field_op<6>(a, b, out, n, a_step, b_step, op,
                                           P, s);
    default: return -1;
  }
}

int mtt_empty(void* stream) {
  mtt::empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// l_words: words per draw: (limbs, l_words) = (2, 4) for the fused
// streams' draws, (2, 6) and (3, 7) for the input draws of SecInt(32) and
// SecInt(64). -1: a width not built.
int mtt_squeeze_mont(const void* state, void* out, long long n_draws,
                     int l_words, int ctr_lane, unsigned long long base,
                     const void* params, void* stream) {
  if (n_draws <= 0) return 0;
  const mtt::DrawParams P = *(const mtt::DrawParams*)params;
  const cudaStream_t s = (cudaStream_t)stream;
  using mtt::launch_squeeze;
  switch (P.nl * 16 + l_words) {
    case 2 * 16 + 4:
      return launch_squeeze<2, 4>(state, out, n_draws, ctr_lane, base, P, s);
    case 2 * 16 + 6:
      return launch_squeeze<2, 6>(state, out, n_draws, ctr_lane, base, P, s);
    case 3 * 16 + 7:
      return launch_squeeze<3, 7>(state, out, n_draws, ctr_lane, base, P, s);
    default: return -1;
  }
}

// b is ignored unless fuse. -1: a (t, m) or limb count the kernel was not
// built for (1 <= t <= 4, 2t + 1 <= m <= 16, one to six limbs).
int mtt_reshare(const void* a, const void* b, void* out, const void* state,
                long long n, int fuse, const void* params, void* stream) {
  const mtt::ReshareParams P = *(const mtt::ReshareParams*)params;
  if (!mtt::parties_ok(P.t, P.m) || P.n_send != 2 * P.t + 1) return -1;
  if (P.draw.nl < 1 || P.draw.nl > mtt::MAX_NL) return -1;
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  using mtt::launch_reshare_nl;
  if (P.t == 1 && P.m == 3)
    return fuse ? launch_reshare_nl<true, 1, 3>(a, b, out, state, n, P, s)
                : launch_reshare_nl<false, 1, 3>(a, b, out, state, n, P, s);
  return mtt_reshare_t(a, b, out, state, n, fuse, &P, stream);
}

// shares may be null. -1: a (t, m) or limb count the kernel was not built
// for (two limbs, 1 <= t <= 4, 2t + 1 <= m <= 16).
int mtt_split_recombine(const void* sec, void* out, void* shares,
                        const void* state, long long n, const void* params,
                        void* stream) {
  const mtt::ReshareParams P = *(const mtt::ReshareParams*)params;
  if (!mtt::parties_ok(P.t, P.m) || P.n_send != P.t + 1 || P.draw.nl != 2)
    return -1;
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (P.t == 1 && P.m == 3)
    return mtt::launch_split_recombine<1, 3>(sec, out, shares, state, n, P,
                                             s);
  return mtt::launch_split_recombine<0, 0>(sec, out, shares, state, n, P, s);
}

// n elements in calls of `chunk` (counters P's, P's + 1, ...), the last on
// n_last >= its given elements (mtt_sgn(a, out, state, n, n, n, ...) is
// one call). -1: a (mode, l, limbs, t, m, k) the kernel was not built for
// (1 <= t <= 4, 2t + 1 <= m <= 16, 0 <= k <= 64, two to six limbs, 1 <= l
// and the random bits within sgn_lb_fit(t, limbs): any l with l + k + 2
// <= 32 limbs at t = 1), or a chunk geometry that does not hold.
int mtt_sgn(const void* a, void* out, const void* state, long long n,
            long long chunk, long long n_last, const void* params,
            void* stream) {
  const mtt::SgnParams P = *(const mtt::SgnParams*)params;
  int lb = 0;
  const int B = mtt::sgn_geometry(P, &lb);
  if (B == 0) return -1;
  if (n <= 0) return 0;
  if (chunk <= 0 || n_last > chunk || n_last < n - (n - 1) / chunk * chunk)
    return -1;
  using L = int (*)(const void*, void*, const void*, long long, long long,
                    long long, const void*, int, int, void*);
  // two limbs: the instantiation of t; three to six: of t = 1, or of a
  // run-time t
  static const L at_nl2[] = {mtt_sgn_launch_nl2_t1, mtt_sgn_launch_nl2_t2,
                             mtt_sgn_launch_nl2_t3, mtt_sgn_launch_nl2_t4};
  static const L at_1[] = {mtt_sgn_launch_nl3_t1, mtt_sgn_launch_nl4_t1,
                           mtt_sgn_launch_nl5_t1, mtt_sgn_launch_nl6_t1};
  static const L at_t[] = {mtt_sgn_launch_nl3_t0, mtt_sgn_launch_nl4_t0,
                           mtt_sgn_launch_nl5_t0, mtt_sgn_launch_nl6_t0};
  const L launch = P.draw.nl == 2 ? at_nl2[P.t - 1]
                   : (P.t == 1 ? at_1 : at_t)[P.draw.nl - 3];
  return launch(a, out, state, n, chunk, n_last, &P, lb, B, stream);
}

// K6's and K7's launchers (mtt_mont_pow, mtt_random_bits_tail) are in
// pow.cu, one translation unit each.

// Elements of a K3 CTA on a call of n at threshold t and nl limbs (its
// threads: as many, up to 320), for the tests and chip_smoke.py's rows.
int mtt_reshare_cta(long long n, int t, int nl) {
  return mtt::reshare_cta_elems(n, t, nl, mtt::sm_count());
}

// Elements of a K5 thread block for a comparison's parameters (the
// launch's sgn_threads), for models of its stage; -1 for a configuration
// mtt_sgn refuses.
int mtt_sgn_threads(const void* params) {
  int lb = 0;
  const int B = mtt::sgn_geometry(*(const mtt::SgnParams*)params, &lb);
  return B == 0 ? -1 : B;
}

const char* mtt_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
