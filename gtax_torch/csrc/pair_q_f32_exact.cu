// The fp32 paired int8 kernels with the exact GELU in fc1
// (approx_gelu=False): pair_q_kernel<hd, temporal, true, float> of
// pair_q.cuh, in a translation unit of its own so that nvcc compiles them
// beside pair_q_f32.cu's tanh-GELU kernels.
#include "pair_q.cuh"

namespace pairq {

int launch_f32_exact(int hd, bool temporal, const PairArgs& a,
                     const PairMaps& maps, cudaStream_t st) {
  return launch_hd<float, true>(hd, temporal, a, maps, st);
}

}  // namespace pairq
