// K3 at a run-time threshold t and party count m (1 <= t <= MAX_T,
// 2t + 1 <= m <= MAX_M): its twelve instantiations (one to six limbs,
// fused or not) in a translation unit of their own, so that _build.py
// compiles them beside kernels.cu, which keeps K3's instantiations of
// (t, m) = (1, 3) and calls mtt_reshare_t (declared there) for the rest.
#include "common.cuh"
#include "reshare.cuh"

// As mtt_reshare, whose checks the parameters passed.
extern "C" int mtt_reshare_t(const void* a, const void* b, void* out,
                             const void* state, long long n, int fuse,
                             const void* params, void* stream) {
  const mtt::ReshareParams P = *(const mtt::ReshareParams*)params;
  const cudaStream_t s = (cudaStream_t)stream;
  return fuse ? mtt::launch_reshare_nl<true, 0, 0>(a, b, out, state, n, P, s)
              : mtt::launch_reshare_nl<false, 0, 0>(a, b, out, state, n, P,
                                                    s);
}
