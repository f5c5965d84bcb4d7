// K5's launchers for the fields of MTT_SGN_NL limbs (_build.py
// SGN_BUILT_NL) at threshold t = MTT_SGN_T (1 to MAX_T), or at a run-time
// t (MTT_SGN_T = 0, 2 <= t <= MAX_T): one translation unit a limb count
// and threshold, so that _build.py compiles them in parallel (the
// comparison's instantiations, three modes a unit, take most of the
// build). kernels.cu's mtt_sgn checks the parameters and calls
// mtt_sgn_launch_nl<MTT_SGN_NL>_t<MTT_SGN_T> (declared there).
#include "common.cuh"
#include "sgn.cuh"

#ifndef MTT_SGN_NL
#error "build with -DMTT_SGN_NL=<limbs>"
#endif
#ifndef MTT_SGN_T
#error "build with -DMTT_SGN_T=<threshold 1 to 4, or 0 for a run-time t>"
#endif

namespace mtt {

// One launch of every chunk: the CTAs of each full chunk, then those of the
// last chunk's given elements, B elements a CTA.
template <int MODE, int T, int NL>
int launch_sgn(const void* a, void* out, const void* state, long long n,
               long long chunk, long long n_last, const SgnParams& P, int lb,
               int B, cudaStream_t stream) {
  const long long per_chunk = (chunk + B - 1) / B;
  const long long full = (n - 1) / chunk;
  const long long grid = full * per_chunk + (n - full * chunk + B - 1) / B;
  const int smem = (int)sgn_smem_bytes(P.t, lb, NL, B);
  const cudaError_t rc = cudaFuncSetAttribute(
      sgn_kernel<MODE, T, NL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  sgn_kernel<MODE, T, NL><<<(unsigned)grid, B, smem, stream>>>(
      (const uint32_t*)a, (uint32_t*)out, (const uint32_t*)state, n, chunk,
      n_last, P);
  return (int)cudaGetLastError();
}

template <int T, int NL>
int launch_sgn_modes(const void* a, void* out, const void* state,
                     long long n, long long chunk, long long n_last,
                     const SgnParams& P, int lb, int B, cudaStream_t s) {
  switch (P.mode) {
    case 0: return launch_sgn<0, T, NL>(a, out, state, n, chunk, n_last, P,
                                        lb, B, s);
    case 1: return launch_sgn<1, T, NL>(a, out, state, n, chunk, n_last, P,
                                        lb, B, s);
    default: return launch_sgn<2, T, NL>(a, out, state, n, chunk, n_last, P,
                                         lb, B, s);
  }
}

}  // namespace mtt

#define MTT_CAT2(a, b) a##b
#define MTT_CAT(a, b) MTT_CAT2(a, b)
#define MTT_SGN_NAME \
  MTT_CAT(MTT_CAT(MTT_CAT(mtt_sgn_launch_nl, MTT_SGN_NL), _t), MTT_SGN_T)

// lb and B from sgn_geometry (checked by mtt_sgn).
extern "C" int MTT_SGN_NAME(const void* a, void* out, const void* state,
                            long long n, long long chunk, long long n_last,
                            const void* params, int lb, int B,
                            void* stream) {
  return mtt::launch_sgn_modes<MTT_SGN_T, MTT_SGN_NL>(
      a, out, state, n, chunk, n_last, *(const mtt::SgnParams*)params, lb,
      B, (cudaStream_t)stream);
}
