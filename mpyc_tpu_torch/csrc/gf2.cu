// K8: one GRR98 reshare round over a binary field GF(2^d), d <= 32, with
// the carry-less local product when FUSE, squeezing its own stream.
//
// Replaces mpyc_tpu/models/pipelines.py:1065 make_reshare2_step, an XLA
// program around K1 (it squeezes its stream with keccak.py:215
// _squeeze_ctr_pallas at :1122, and with the XLA squeeze below 1,024
// blocks: the same bits). The stream is the absorbed state with the
// call's counter XORed into lane 4 and the block counter into lane 19.
// Coefficient k, sender i of element e is draw (k (2t + 1) + i) n + e of
// it: ceil(d / 8) little-endian bytes (byte-granular, 168 / ceil(d / 8)
// draws a block, a draw never straddling two blocks), masked to d bits.
// Output row j (party j + 1) is
//   Horner(C, x_j) + S,  S = sum_{i < 2t+1} lag_i * s_i,
//   C_k = sum_i lag_i * r_{k,i},  s_i = a_i * b_i (FUSE) or a_i,
// sums XOR, products in GF(2^d), the points 1..m read as polynomials (3
// is x + 1), as the JAX package reads them. At (t, m) = (1, 3), the only
// shape built, the points are 1, x, x + 1 and every Lagrange coefficient
// at 0 is 1 (pipelines.Reshare2Spec.params checks both on the host), so
// with C = r_0 + r_1 + r_2 and S = s_0 + s_1 + s_2 the rows are
//   C + S,  xC + S,  xC + C + S:
// the 3 local products (FUSE) are the only general products, and xC is a
// shift, a conditional XOR of x^d mod f and a mask.
//
// Bound: bytes (36 bytes of shares an element at FUSE, 24 without); the
// stream's permutations (3 n / (168 / ceil(d / 8)) of them) and the
// products sit under it at SHA3's d = 2 and AES's d = 8 (chip_smoke.py
// reshare2_meas). What the card spends beside the bytes is integer
// instructions: a warp's stream of them, at 16 lanes a clock, is both the
// permutation's latency and the elements' cost. Design: the stream never
// leaves the chip. A CTA of RESHARE2_THREADS threads takes E = ept x
// RESHARE2_THREADS consecutive elements (ept from n: reshare2_ept), whose
// draws are three runs of the stream (one a sender); it merges the runs'
// blocks where they share some (small n) and squeezes each block once,
// one a thread, into shared memory (stage.cuh stage_blocks). Before that,
// each thread issues the loads of its elements' shares, so their latency
// hides behind the permutations. Then each thread takes the elements
// e0 + r x RESHARE2_THREADS + tid (r < ept): neighbouring lanes on
// neighbouring elements, each share a coalesced 4-byte access and each
// draw a byte of a 32-byte run of shared memory, at a byte offset fixed a
// run (no division an element). A block on the edge of two CTAs is
// squeezed by both; ept grows with n so that this stays under 1.2x the
// stream's blocks at n = 2^19 while the grid covers the SMs at AES's
// n = 32,768 (256 CTAs). d is a launch parameter, 1 <= d <= 32; SHA3's
// d = 2 and AES's d = 8 have instantiations of their own, whose products
// unroll (template parameter D), any other d runs the general loops.
#include "common.cuh"

namespace mtt {

// Mirrored by ctypes in mpyc_tpu_torch/_build.py (Reshare2Params).
struct Reshare2Params {
  uint32_t red[32];            // x^(d + j) mod f, j < d - 1
  uint32_t nonce_lo, nonce_hi; // per-call counter, XORed into lane 4
  int32_t d;
};

constexpr int RESHARE2_THREADS = 128;
constexpr int RESHARE2_MAX_EPT = 8;
constexpr int RESHARE2_MAX_ELEMS = RESHARE2_MAX_EPT * RESHARE2_THREADS;
// The most blocks a CTA stages: three runs of up to RESHARE2_MAX_ELEMS
// draws, each on at most ceil((E - 1) / 42) + 1 blocks (42 four-byte
// draws a block, the fewest).
constexpr int RESHARE2_MAX_BLOCKS =
    3 * ((RESHARE2_MAX_ELEMS - 1 + 41) / 42 + 1);

// Elements a thread: the largest power of two up to RESHARE2_MAX_EPT at
// which the grid still has a CTA for every SM (1 where n is too small for
// even that).
inline int reshare2_ept(long long n) {
  const long long per = (long long)RESHARE2_THREADS * sm_count();
  int ept = 1;
  while (ept < RESHARE2_MAX_EPT && n >= 2LL * ept * per) ept *= 2;
  return ept;
}

// a b mod f: the carry-less product in 64 bits (at most 2d - 1 <= 63),
// then one masked XOR of a residue for each bit above d - 1. D > 0 is d
// known when compiled: the loops unroll, the residues are constants of the
// parameter block, and at 2 D - 1 <= 32 the product stays in 32 bits.
template <int D>
__device__ __forceinline__ uint32_t gf2_mul(uint32_t a, uint32_t b, int d,
                                            uint32_t mask,
                                            const uint32_t* red) {
  MTT_COUNT_OP(0);
  if constexpr (D > 0 && 2 * D - 1 <= 32) {
    uint32_t p = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) p ^= (b << i) & (0u - ((a >> i) & 1u));
    uint32_t r = p & mask;
#pragma unroll
    for (int j = 0; j + 1 < D; ++j) r ^= red[j] & (0u - ((p >> (D + j)) & 1u));
    return r;
  } else {
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
}

// A draw of lb bytes at q, little-endian; q is a multiple of lb bytes
// into the staged blocks, so a draw of 2 or 4 bytes is one aligned load.
__device__ __forceinline__ uint32_t read_draw(const uint8_t* q, int lb) {
  if (lb == 1) return q[0];
  if (lb == 2) return *reinterpret_cast<const uint16_t*>(q);
  if (lb == 4) return *reinterpret_cast<const uint32_t*>(q);
  return q[0] | (uint32_t)q[1] << 8 | (uint32_t)q[2] << 16;
}

// D: d when compiled (2, SHA3's GF(4); 8, AES's GF(2^8)), or 0 for d of
// the parameter block.
template <int D, bool FUSE>
__global__ void __launch_bounds__(RESHARE2_THREADS)
reshare2_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out,
                const uint32_t* __restrict__ state, long long n, int ept,
                Reshare2Params P) {
  constexpr int NSEND = 3, LANES = RATE_WORDS / 2, BLOCK = 4 * RATE_WORDS;
  __shared__ uint64_t blocks[RESHARE2_MAX_BLOCKS * LANES];
  __shared__ uint32_t red_sm[32];
  const int tid = threadIdx.x;
  const long long E = (long long)ept * RESHARE2_THREADS;
  const long long e0 = (long long)blockIdx.x * E;
  const int cnt = (int)(n - e0 < E ? n - e0 : E);

  // the shares first: their loads are in flight while the stream is
  // squeezed
  uint32_t sa[NSEND][RESHARE2_MAX_EPT], sb[NSEND][RESHARE2_MAX_EPT];
#pragma unroll
  for (int r = 0; r < RESHARE2_MAX_EPT; ++r) {
    const int el = r * RESHARE2_THREADS + tid;
    if (r < ept && el < cnt) {
#pragma unroll
      for (int i = 0; i < NSEND; ++i) {
        sa[i][r] = __ldg(a + (long long)i * n + e0 + el);
        if (FUSE) sb[i][r] = __ldg(b + (long long)i * n + e0 + el);
      }
    }
  }

  const int d = D > 0 ? D : P.d;
  const int lb = (d + 7) / 8;
  // lb divides 168, so the stream's draws are its bytes in order: draw D
  // is bytes D lb .. D lb + lb - 1, in block D / epb
  const int epb = BLOCK / lb;
  const uint32_t mask = d == 32 ? 0xFFFFFFFFu : (1u << d) - 1u;
  // sender i's draws i n + e0 .. are blocks first .. last; the runs only
  // move forward, so a run that shares blocks with the one before stages
  // only those past it. Its staged blocks are consecutive, so its draw
  // e0 + el is byte off[i] + el lb of the staged blocks.
  long long start[NSEND];
  int cnts[NSEND], off[NSEND];
  int staged = 0;
  long long prev_last = -1;
#pragma unroll
  for (int i = 0; i < NSEND; ++i) {
    const long long d0 = (long long)i * n + e0;
    const long long first = d0 / epb, last = (d0 + cnt - 1) / epb;
    start[i] = first > prev_last ? first : prev_last + 1;
    cnts[i] = last >= start[i] ? (int)(last - start[i] + 1) : 0;
    off[i] = (staged - (int)(start[i] - first)) * BLOCK +
             (int)(d0 - first * epb) * lb;
    staged += cnts[i];
    if (last > prev_last) prev_last = last;
  }
  const uint64_t nonce = ((uint64_t)P.nonce_hi << 32) | P.nonce_lo;
  stage_blocks<NSEND>(state, nonce, start, cnts, blocks);
  const uint32_t* red = P.red;
  if (FUSE && D == 0) {   // read at a run-time index: from shared memory
    if (tid < 32) red_sm[tid] = P.red[tid];
    red = red_sm;
  }
  __syncthreads();

  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(blocks);
#pragma unroll
  for (int r = 0; r < RESHARE2_MAX_EPT; ++r) {
    const int el = r * RESHARE2_THREADS + tid;
    if (r < ept && el < cnt) {
      uint32_t S = 0, C = 0;
#pragma unroll
      for (int i = 0; i < NSEND; ++i) {
        S ^= FUSE ? gf2_mul<D>(sa[i][r], sb[i][r], d, mask, red) : sa[i][r];
        C ^= read_draw(bytes + off[i] + el * lb, lb);
      }
      C &= mask;
      const uint32_t xC = ((C << 1) & mask) ^
                          (P.red[0] & (0u - ((C >> (d - 1)) & 1u)));
      uint32_t* o = out + e0 + el;
      o[0] = C ^ S;
      o[n] = xC ^ S;
      o[2 * n] = xC ^ C ^ S;
    }
  }
}

template <int D, bool FUSE>
int launch_reshare2(const void* a, const void* b, void* out,
                    const void* state, long long n,
                    const Reshare2Params& P, cudaStream_t stream) {
  const int ept = reshare2_ept(n);
  const long long E = (long long)ept * RESHARE2_THREADS;
  const long long grid = (n + E - 1) / E;
  reshare2_kernel<D, FUSE><<<(unsigned)grid, RESHARE2_THREADS, 0, stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out,
      (const uint32_t*)state, n, ept, P);
  return (int)cudaGetLastError();
}

// The instantiation for P.d: SHA3's d = 2 and AES's d = 8 unrolled, any
// other d at run time.
template <bool FUSE>
int launch_reshare2_d(const void* a, const void* b, void* out,
                      const void* state, long long n,
                      const Reshare2Params& P, cudaStream_t s) {
  switch (P.d) {
    case 2: return launch_reshare2<2, FUSE>(a, b, out, state, n, P, s);
    case 8: return launch_reshare2<8, FUSE>(a, b, out, state, n, P, s);
    default: return launch_reshare2<0, FUSE>(a, b, out, state, n, P, s);
  }
}

}  // namespace mtt

extern "C" {

// (3, n) GF(2^d) shares a (times b's when fuse; b is ignored otherwise)
// -> out, the call's stream squeezed from the absorbed state with the
// counter of params, at (t, m) = (1, 3) with the points 1, x, x + 1 (the
// caller, pipelines.Reshare2Spec, refuses any other). -1: a d outside
// 1..32, or 3 n draws past 2^32.
int mtt_reshare2(const void* a, const void* b, void* out, const void* state,
                 long long n, int fuse, const void* params, void* stream) {
  const mtt::Reshare2Params P = *(const mtt::Reshare2Params*)params;
  if (P.d < 1 || P.d > 32) return -1;
  if (n > 0xFFFFFFFFll / 3) return -1;
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return fuse ? mtt::launch_reshare2_d<true>(a, b, out, state, n, P, s)
              : mtt::launch_reshare2_d<false>(a, b, out, state, n, P, s);
}

// Elements of a K8 CTA on n elements (ept x RESHARE2_THREADS), for the
// tests and chip_smoke.py's reports.
int mtt_reshare2_elems(long long n) {
  return mtt::reshare2_ept(n) * mtt::RESHARE2_THREADS;
}

}  // extern "C"
