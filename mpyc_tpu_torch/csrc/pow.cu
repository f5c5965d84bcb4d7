// K6's and K7's launchers (pow.cuh), one kernel a translation unit:
// MTT_POW_KERNEL = 6 builds mtt_mont_pow, 7 mtt_random_bits_tail, each
// with its twelve instantiations (one to six limbs, lazy or not), so that
// _build.py compiles them beside the other units.
#include "common.cuh"
#include "pow.cuh"

#ifndef MTT_POW_KERNEL
#error "build with -DMTT_POW_KERNEL=<6 or 7>"
#endif

namespace mtt {

// The instantiation of K6 and K7 for a plan's field: LAZY where 4p < R
// (p's top limb below 2^30; at one limb p itself: GF(1031) lazy, GF(2^31 -
// 1) canonical).
template <int NL, bool LAZY>
struct PowKind {};

template <class F>
int pow_dispatch(const PowParams& P, F launch) {
  if (P.nl < 1 || P.nl > MAX_NL) return -1;
  const bool lazy = P.p[P.nl - 1] < (1u << 30);
  switch (P.nl * 10 + lazy) {
    case 10: return launch(PowKind<1, false>());
    case 11: return launch(PowKind<1, true>());
    case 20: return launch(PowKind<2, false>());
    case 21: return launch(PowKind<2, true>());
    case 30: return launch(PowKind<3, false>());
    case 31: return launch(PowKind<3, true>());
    case 40: return launch(PowKind<4, false>());
    case 41: return launch(PowKind<4, true>());
    case 50: return launch(PowKind<5, false>());
    case 51: return launch(PowKind<5, true>());
    case 60: return launch(PowKind<6, false>());
    default: return launch(PowKind<6, true>());
  }
}


// Whether a plan fits the kernels: its exponent's width, its table and
// steps within their arrays, every table index within the table.
inline bool plan_ok(const PowParams& P) {
  if (P.nbits < 0 || P.nbits > 32 * MAX_NL) return false;
  if (P.n_table < 1 || P.n_table > POW_TABLE) return false;
  if (P.n_steps < 0 || P.n_steps > 32 * P.nl || P.tail < 0) return false;
  if (P.first < 0 || P.first >= P.n_table) return false;
  for (int k = 0; k < P.n_steps; ++k)
    if ((int)(P.step[k] >> 8) >= P.n_table) return false;
  return true;
}

#if MTT_POW_KERNEL == 6
template <int NL, bool LAZY>
int launch_mont_pow(PowKind<NL, LAZY>, const void* a, void* out,
                    long long n, const PowParams& P, cudaStream_t stream) {
  constexpr int EPB = POW_THREADS * pow_ept<NL>();
  constexpr int smem = pow_smem_bytes<NL>();
  const long long grid = (n + EPB - 1) / EPB;
  // past the 48 KB a CTA gets by default (the plan's steps included):
  // allowed once
  if constexpr (smem + 4 * POW_MAX_STEPS > 48 * 1024) {
    static const cudaError_t rc = cudaFuncSetAttribute(
        mont_pow_kernel<NL, LAZY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  mont_pow_kernel<NL, LAZY><<<(unsigned)grid, POW_THREADS, smem, stream>>>(
      (const uint32_t*)a, (uint32_t*)out, n, P);
  return (int)cudaGetLastError();
}
#else
template <int NL, bool LAZY>
int launch_random_bits_tail(PowKind<NL, LAZY>, const void* r,
                            const void* z, void* bits, void* flags,
                            void* count, long long n, const TailParams& P,
                            cudaStream_t stream) {
  constexpr int EPB = POW_THREADS * pow_ept<NL>();
  constexpr int smem = pow_smem_bytes<NL>();
  const long long grid = (n + EPB - 1) / EPB;
  if constexpr (smem + 4 * POW_MAX_STEPS > 48 * 1024) {   // as K6's
    static const cudaError_t rc = cudaFuncSetAttribute(
        random_bits_tail_kernel<NL, LAZY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  random_bits_tail_kernel<NL, LAZY><<<(unsigned)grid, POW_THREADS, smem,
                                     stream>>>(
      (const uint32_t*)r, (const uint32_t*)z, (uint32_t*)bits,
      (uint8_t*)flags, (int*)count, n, P);
  return (int)cudaGetLastError();
}
#endif

}  // namespace mtt

extern "C" {

#if MTT_POW_KERNEL == 6
// a^e R mod p for n elements (K6), e by its plan in params. -1: a limb
// count the kernel was not built for, or a plan that does not fit it.
int mtt_mont_pow(const void* a, void* out, long long n, const void* params,
                 void* stream) {
  const mtt::PowParams P = *(const mtt::PowParams*)params;
  if (!mtt::plan_ok(P)) return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  return mtt::pow_dispatch(P, [&](auto kind) {
    return n <= 0 ? 0 : mtt::launch_mont_pow(kind, a, out, n, P, s);
  });
}
#else
// The tail of a round of random bits (K7) on (m, n, limbs) shares r and
// z: bits (m, n, limbs), flags (n bytes) and count (one int, which the
// launch adds to). -1: a (t, m) or limb count the kernel was not built
// for (1 <= t <= 4, 2t + 1 <= m <= 16), or a plan that does not fit it.
int mtt_random_bits_tail(const void* r, const void* z, void* bits,
                         void* flags, void* count, long long n,
                         const void* params, void* stream) {
  const mtt::TailParams P = *(const mtt::TailParams*)params;
  if (!mtt::parties_ok(P.t, P.m) || !mtt::plan_ok(P.pow)) return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  return mtt::pow_dispatch(P.pow, [&](auto kind) {
    return n <= 0 ? 0 : mtt::launch_random_bits_tail(kind, r, z, bits, flags,
                                                      count, n, P, s);
  });
}
#endif

}  // extern "C"
