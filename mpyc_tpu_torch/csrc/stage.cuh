// The shared squeeze stage of K3, K5 and K8.
//
// A thread block (CTA) that needs a range of a stream squeezes each sponge
// block that the range touches exactly once, one block a thread (so a
// range of up to 32 blocks is one warp's work, and more take as many warps
// as there are groups of 32), and hands what the threads need to them
// through shared memory. Each squeezing thread also reduces its block's
// draws into GF(p), so every draw is reduced once. A block on the edge
// between two CTAs, or between two calls of K5, is squeezed by both: about
// one block per range per CTA.
//
// Every draw keeps its index in the stream, so the layout is the JAX
// package's XLA layout bit for bit (reshare.cuh, sgn.cuh, gf2.cu).
//
// Included by common.cuh after DrawParams and reduce_draw. Each function
// is called by every thread of the CTA; the caller synchronises before
// the threads read what was staged, and before a stage overwrites what
// they read.
#pragma once
#include <cstdint>

#include "keccak.cuh"

namespace mtt {

// Block `blk` of a counter-mode stream: the absorbed state with `nonce`
// XORed into lane 4 and the block counter into lane 19, permuted.
__device__ __forceinline__ void squeeze_block(const uint32_t* __restrict__ state,
                                              uint64_t nonce,
                                              unsigned long long blk,
                                              uint64_t* A) {
  load_state(state, A);
  A[4] ^= nonce;
  A[19] ^= blk;
  keccak_f1600(A);
}

// Draws d0 + j*c + i (j < cnt, i < c) of the squeeze_mont stream of
// W-word draws, EPB = 42 / W a block (ten of 16 bytes at NL = 2, eight of
// 20 at NL = 3, seven of 24 at NL = 4, six of 28 at NL = 5), draw d in
// block blk0 + d / EPB, each reduced into GF(p) in Montgomery form, to
// element i * stride + j of sm (NL words an element): the threads of the
// CTA read draw i of their element j from consecutive elements, with no
// bank conflict at NL = 2 (8-byte words) and at NL = 3 and 5 (an odd
// stride of words); at NL = 4 a warp's word q of its elements takes four
// passes. Out of line, so the
// permutation is compiled once per instantiation.
template <int NL, int W>
__device__ __noinline__ void stage_draws(const uint32_t* __restrict__ state,
                                         uint64_t nonce, long long blk0,
                                         long long d0, int cnt, int c,
                                         DrawParams P, uint32_t* sm,
                                         int stride) {
  constexpr int EPB = RATE_WORDS / W;
  const long long total = (long long)cnt * c;
  if (total <= 0) return;
  const long long first = d0 / EPB;
  const long long nb = (d0 + total - 1) / EPB - first + 1;
  for (long long b = threadIdx.x; b < nb; b += blockDim.x) {
    const long long blk = first + b;
    uint64_t A[25];
    squeeze_block(state, nonce, (unsigned long long)(blk0 + blk), A);
#pragma unroll
    for (int s = 0; s < EPB; ++s) {
      const long long r = blk * EPB + s - d0;
      if (r >= 0 && r < total) {
        const int j = (int)(r / c);
        const int i = (int)(r - (long long)j * c);
        uint32_t v[NL];
        reduce_draw<NL, W>(A, s, P, v);
        store_fe<NL>(sm, (long long)i * stride + j, v);
      }
    }
  }
}

// Raw words w0 .. w0 + cnt - 1 of the stream from block 0 (word w: rate
// word w % 42 of block w / 42) to sm[w - w0].
static __device__ __noinline__ void stage_words(
    const uint32_t* __restrict__ state, uint64_t nonce, long long w0,
    int cnt, uint32_t* sm) {
  if (cnt <= 0) return;
  const long long first = w0 / RATE_WORDS;
  const long long nb = (w0 + cnt - 1) / RATE_WORDS - first + 1;
  for (long long b = threadIdx.x; b < nb; b += blockDim.x) {
    const long long blk = first + b;
    uint64_t A[25];
    squeeze_block(state, nonce, (unsigned long long)blk, A);
#pragma unroll
    for (int s = 0; s < RATE_WORDS; ++s) {
      const long long r = blk * RATE_WORDS + s - w0;
      if (r >= 0 && r < cnt) sm[r] = rate_word(A, s);
    }
  }
}

// Blocks of the stream for byte-granular draws (K8, whose draws need no
// reduction): R disjoint runs of blocks, run r the blocks start[r] ..
// start[r] + cnt[r] - 1, numbered j = 0, 1, ... in order over the runs.
// Thread j % blockDim.x squeezes block j once and stores its 21 rate lanes
// to sm[21 j ..] (little-endian: byte q of the block is byte q of that
// run). A caller whose draw runs share blocks merges them first, so that
// no block is squeezed twice in a CTA.
template <int R>
__device__ __forceinline__ void stage_blocks(
    const uint32_t* __restrict__ state, uint64_t nonce,
    const long long (&start)[R], const int (&cnt)[R], uint64_t* sm) {
  int total = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) total += cnt[r];
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    long long blk = 0;
    int rem = j;
    bool found = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!found && rem < cnt[r]) {
        blk = start[r] + rem;
        found = true;
      } else if (!found) {
        rem -= cnt[r];
      }
    }
    uint64_t A[25];
    squeeze_block(state, nonce, (unsigned long long)blk, A);
#pragma unroll
    for (int k = 0; k < RATE_WORDS / 2; ++k)
      sm[(RATE_WORDS / 2) * j + k] = A[k];
  }
}

}  // namespace mtt
