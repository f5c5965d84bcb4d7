// K8: one GRR98 reshare round over a binary field GF(2^d), d <= 32, with
// the carry-less local product when FUSE, on K1's stream.
//
// Replaces mpyc_tpu/models/pipelines.py:1065 make_reshare2_step, an XLA
// program around K1 (it squeezes its stream with keccak.py:215
// _squeeze_ctr_pallas at :1122, and with the XLA squeeze below 1,024
// blocks: the same bits). The port keeps that split: the wrapper
// (pipelines.reshare2_stream) launches K1 on the absorbed state with the
// call's counter XORed into lane 4, block counter in lane 19, and K8
// reads its draws from K1's output. Coefficient k, sender i of element e
// is draw (k (2t + 1) + i) n + e of that stream: ceil(d / 8) little-endian
// bytes (byte-granular, 168 / ceil(d / 8) draws a block, a draw never
// straddling two blocks), masked to d bits. Output row j (party j + 1) is
//   Horner(C, x_j) + S,  S = sum_{i < 2t+1} lag_i * s_i,
//   C_k = sum_i lag_i * r_{k,i},  s_i = a_i * b_i (FUSE) or a_i,
// sums XOR, products in GF(2^d) (gf2_mul), the points 1..m read as
// polynomials (3 is x + 1), as the JAX package reads them.
//
// Bound: bytes (36 bytes of shares an element at FUSE, 24 without, and
// the stream's draws). At the points 1, x, x + 1 every Lagrange
// coefficient is 1, so the function needs only the 3 local products and
// the Horner products by x and x + 1 (chip_smoke.py's reshare2_ops counts
// them at their fewest, under the bytes' time at d = 2 and 8); this
// kernel takes lag and xs as general elements and computes all 12 (9
// without FUSE) products, of d shift-XOR and d - 1 reduction steps each.
// Design: one thread an element, everything in registers; neighbouring
// threads take neighbouring elements, so each share is one coalesced
// 4-byte load a warp-lane and each draw a byte of a 32-byte run of the
// stream. The residues x^(d + j) mod f go to shared
// memory once a CTA (read at a run-time index: d is a launch parameter).
// Built for (t, m) = (1, 3); d is a launch parameter, 1 <= d <= 32.
#include "common.cuh"

namespace mtt {

// Mirrored by ctypes in mpyc_tpu_torch/_build.py (Reshare2Params).
struct Reshare2Params {
  uint32_t red[32];         // x^(d + j) mod f, j < d - 1
  uint32_t lag[MAX_SEND];   // Lagrange coefficients at 0 of 1..2t+1
  uint32_t xs[MAX_M];       // the party points 1..m as elements
  int32_t d;
};

constexpr int RESHARE2_THREADS = 256;

// a b mod f: the carry-less product in 64 bits (at most 2d - 1 <= 63),
// then one masked XOR of a residue for each bit above d - 1.
__device__ __forceinline__ uint32_t gf2_mul(uint32_t a, uint32_t b, int d,
                                            uint32_t mask,
                                            const uint32_t* red) {
  MTT_COUNT_OP(0);
  uint64_t p = 0;
#pragma unroll 1
  for (int i = 0; i < d; ++i)
    p ^= ((uint64_t)b << i) & (0ull - (uint64_t)((a >> i) & 1u));
  uint32_t r = (uint32_t)p & mask;
#pragma unroll 1
  for (int j = 0; j + 1 < d; ++j)
    r ^= red[j] & (0u - (uint32_t)((p >> (d + j)) & 1ull));
  return r;
}

template <bool FUSE, int T, int M>
__global__ void __launch_bounds__(RESHARE2_THREADS)
reshare2_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out,
                const uint8_t* __restrict__ blocks, long long n,
                Reshare2Params P) {
  constexpr int NSEND = 2 * T + 1;
  static_assert(NSEND <= MAX_SEND && M <= MAX_M && NSEND <= M, "shape");
  __shared__ uint32_t red[32];
  if (threadIdx.x < 32) red[threadIdx.x] = P.red[threadIdx.x];
  __syncthreads();
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int d = P.d, lb = (d + 7) / 8;
  // draws a 168-byte block; draw indices below 2^32 (the launcher checks
  // t (2t + 1) n), so a draw's block is a 32-bit division
  const uint32_t epb = (uint32_t)(4 * RATE_WORDS / lb);
  const uint32_t mask = d == 32 ? 0xFFFFFFFFu : (1u << d) - 1u;

  uint32_t S = 0;
#pragma unroll
  for (int i = 0; i < NSEND; ++i) {
    uint32_t s = __ldg(a + (long long)i * n + e);
    if (FUSE) s = gf2_mul(s, __ldg(b + (long long)i * n + e), d, mask, red);
    S ^= gf2_mul(P.lag[i], s, d, mask, red);
  }
  uint32_t C[T];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < NSEND; ++i) {
      const uint32_t D = (uint32_t)((long long)(k * NSEND + i) * n + e);
      const uint32_t blk = D / epb;
      const uint8_t* q = blocks + (size_t)blk * (4 * RATE_WORDS) +
                         (D - blk * epb) * (uint32_t)lb;
      uint32_t v = 0;
#pragma unroll 1
      for (int u = 0; u < lb; ++u) v |= (uint32_t)q[u] << (8 * u);
      acc ^= gf2_mul(P.lag[i], v & mask, d, mask, red);
    }
    C[k] = acc;
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
    uint32_t y = 0;
#pragma unroll
    for (int k = 0; k < T; ++k) {
      y = k == 0 ? C[0] : y ^ C[k];
      y = gf2_mul(P.xs[j], y, d, mask, red);
    }
    out[(long long)j * n + e] = y ^ S;
  }
}

template <bool FUSE>
int launch_reshare2(const void* a, const void* b, void* out,
                    const void* blocks, long long n,
                    const Reshare2Params& P, cudaStream_t stream) {
  const long long grid = (n + RESHARE2_THREADS - 1) / RESHARE2_THREADS;
  reshare2_kernel<FUSE, 1, 3><<<(unsigned)grid, RESHARE2_THREADS, 0,
                                stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out,
      (const uint8_t*)blocks, n, P);
  return (int)cudaGetLastError();
}

}  // namespace mtt

extern "C" {

// (3, n) GF(2^d) shares a (times b's when fuse; b is ignored otherwise)
// and the call's stream (K1's blocks) -> out, at (t, m) = (1, 3) (the
// caller, pipelines.Reshare2Spec, refuses any other). -1: a d outside
// 1..32, or 3 n draws past 2^32.
int mtt_reshare2(const void* a, const void* b, void* out, const void* blocks,
                 long long n, int fuse, const void* params, void* stream) {
  const mtt::Reshare2Params P = *(const mtt::Reshare2Params*)params;
  if (P.d < 1 || P.d > 32) return -1;
  if (n > 0xFFFFFFFFll / 3) return -1;
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return fuse ? mtt::launch_reshare2<true>(a, b, out, blocks, n, P, s)
              : mtt::launch_reshare2<false>(a, b, out, blocks, n, P, s);
}

}  // extern "C"
