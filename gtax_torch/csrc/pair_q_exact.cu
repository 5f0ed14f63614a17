// The paired int8 kernels with the exact GELU in fc1 (approx_gelu=False):
// pair_q_kernel<hd, temporal, true, bf16> of pair_q.cuh, in a translation
// unit of its own so that nvcc compiles them beside pair_q.cu's tanh-GELU
// kernels.
#include "pair_q.cuh"

namespace pairq {

int launch_exact(int hd, bool temporal, const PairArgs& a,
                 const PairMaps& maps, cudaStream_t st) {
  return launch_hd<bf16, true>(hd, temporal, a, maps, st);
}

}  // namespace pairq
