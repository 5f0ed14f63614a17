// The paired int8 kernels with the exact GELU in fc1 (approx_gelu=False):
// pair_q_kernel<hd, temporal, true> of pair_q.cuh, in a translation unit of
// its own so that nvcc compiles them beside pair_q.cu's tanh-GELU kernels.
#include "pair_q.cuh"

namespace pairq {

int launch_exact(int hd, bool temporal, const PairArgs& a,
                 const PairMaps& maps, cudaStream_t st) {
  switch (hd * 2 + temporal) {
    case 64:
      return launch_gelu<32, false, true>(a, maps, st);
    case 65:
      return launch_gelu<32, true, true>(a, maps, st);
    case 128:
      return launch_gelu<64, false, true>(a, maps, st);
    case 129:
      return launch_gelu<64, true, true>(a, maps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace pairq
