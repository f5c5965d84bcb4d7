// Shared by the translation units of the port's kernels (kernels.cu,
// reshare.cu, pow.cu, sgn.cu, gf2.cu, wide.cu): the limits and parameter
// blocks of the fused streams, the map of a squeezed draw into GF(p), the
// card's SM count for the launchers that size their grid from n, the copy
// of a parameter block's constants into shared memory, and the shared
// squeeze stage.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

#include "keccak.cuh"
#include "limb.cuh"

namespace mtt {

constexpr int MAX_NL = 6;      // limbs per element (_build.py MAX_NL)
constexpr int MAX_NC = 4;      // chunks per draw
constexpr int MAX_SEND = 9;    // senders aggregated by a reshare (2t + 1)
constexpr int MAX_T = (MAX_SEND - 1) / 2;   // threshold t: 1 to 4
constexpr int MAX_M = 16;      // parties
constexpr int RATE_WORDS = 42; // 32-bit words in a 168-byte block

// The current device's streaming multiprocessors (132 on an H100 SXM),
// read once: K1's and K8's launchers derive their CTA shape from n so that
// the grid reaches every SM where n allows.
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return sms;
}

// Mirrored by ctypes structures in mpyc_tpu_torch/_build.py.
// Field constants fill the first nl limbs of their MAX_NL.
struct DrawParams {
  uint32_t p[MAX_NL];
  uint32_t n0inv;
  uint32_t radix[MAX_NC][MAX_NL];  // 2^(32 nl c) R^2 mod p, chunk c
  int32_t nl;                      // limbs of the field
};

struct ReshareParams {
  DrawParams draw;
  uint32_t lag[MAX_SEND][MAX_NL];  // Lagrange coefficients at 0, Montgomery
  uint32_t xs[MAX_M][MAX_NL];      // evaluation points 1..m, Montgomery
  uint32_t nonce_lo, nonce_hi; // per-call counter, XORed into lane 4
  int32_t t, m, n_send;
};

// Whether the kernels take threshold t with m parties: 1 <= t <= MAX_T,
// 2t + 1 <= m <= MAX_M (t and m launch parameters; K3, K4 and K5 also
// keep their instantiations of t = 1, m = 3, and K5 of t = 1).
__host__ __device__ constexpr bool parties_ok(int t, int m) {
  return t >= 1 && t <= MAX_T && 2 * t + 1 <= m && m <= MAX_M;
}

// Words a draw of the fused streams (K3, K4, K5) takes: fused_draw_bytes(p)
// / 4 = NL + 2 (p's bytes and 8 of widening, in words: 12 bytes for every
// one-limb field, whose p has 1 to 4 bytes; the Python side checks it for
// each field it launches on: ReshareSpec, SgnSpec).
template <int NL>
__host__ __device__ constexpr int fused_words() {
  static_assert(NL >= 1 && NL <= MAX_NL,
                "fused draws of 1 to MAX_NL limbs (_build.py BUILT_NL)");
  return NL + 2;
}

// Draw `slot` of a squeezed block (W words a draw) mapped into GF(p),
// Montgomery form: sum over chunks c of chunk_c * 2^(32 NL c) mod p, one
// Montgomery multiply by radix[c] per chunk (mpyc_tpu/ops/limb.py
// reduce_wide). With `slot` a constant every word index is one too.
template <int NL, int W>
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

// Copy `words` words of a parameter block's constants into shared memory,
// each at a constant index (the loop unrolls), word k by thread k mod the
// CTA's width; the caller synchronises before they are read.
template <int WORDS>
__device__ __forceinline__ void copy_consts(const uint32_t (&src)[WORDS],
                                            uint32_t* dst, int words) {
#pragma unroll
  for (int k = 0; k < WORDS; ++k)
    if (k < words && (int)threadIdx.x == k % (int)blockDim.x) dst[k] = src[k];
}

}  // namespace mtt

#include "stage.cuh"
