// Weight-gradient GEMM of the branch backwards: C = A^T @ B summed over
// token rows, A (M, Ka) and B (M, N) row-major bf16, C (Ka, N) fp32; plus
// the fixed-order row reduction that finishes split sums.
//
// Replaces the dW accumulations of the TPU backward kernels
// (gtax/kernels/backward.py _spatial_bwd_kernel/_temporal_bwd_kernel/
// _mlp_bwd_kernel: `dw_ref[:] += dot_general(a, dy, (((0,), (0,)), ...))`
// over a sequential grid of token tiles, with the fp32 accumulator resident
// in VMEM across the grid).
// Hopper runs blocks in no order, so the sum over the M token rows is a
// GEMM with K = M: each block owns a 128x256 tile of C (128x128 where N is
// not a multiple of 256) and loops over one chunk of rows (split K); with
// more than one chunk each writes its own fp32 partial and
// gtax_reduce_rows adds the partials in chunk order. No float atomics: a
// run is bit-equal to the next.
// Bound: operations at training shapes (M = 11,520 rows, Ka x N up to
// 4096 x 1024: 2*M*Ka*N flops against ~(M*(Ka+N)*2 + Ka*N*4) bytes).
// Design: the Hopper mainloop of gemm_sm90.cuh with both operands
// MN-major: A^T is read from A's rows as M-major boxes and B as N-major
// boxes, so neither is transposed in memory. A chunk is a multiple of the
// 64-row k-step, so only the last one is ragged, and TMA zero-fills past M.
#include "gemm_sm90.cuh"

namespace {

// out[c] = sum over r < R of in[r * C + c], r in order
__global__ void reduce_rows_kernel(const float* __restrict__ in,
                                   float* __restrict__ out, int R, size_t C) {
  const size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) acc += in[(size_t)r * C + c];
  out[c] = acc;
}

// Columns of the tile at width N: the wide tile whenever N allows it;
// split K, not narrow tiles, fills the card
// (gtax_torch/kernels/backward.py wgrad_plan)
int tile_n(int N) { return N % sm90::kWideBN == 0 ? sm90::kWideBN : sm90::BN; }

}  // namespace

// The tile columns gtax_gemm_wgrad uses at width N, or minus a CUDA error
// code.
GTAX_ENTRY gtax_gemm_wgrad_tile_n(int N) {
  return N > 0 && N % 64 == 0 ? tile_n(N) : -(int)cudaErrorInvalidValue;
}

// A: (M, Ka) bf16; B: (M, N) bf16; C: (splits, Ka, N) fp32, one partial per
// chunk of `chunk` rows (chunk a multiple of the k-step, 64; splits =
// ceil(M / chunk)).
GTAX_ENTRY gtax_gemm_wgrad(const void* A, const void* B, void* C, int M,
                           int Ka, int N, int chunk, void* stream) {
  if (M <= 0 || Ka <= 0 || N <= 0 || Ka % 64 || N % 64 || chunk <= 0 ||
      chunk % sm90::BK)
    return (int)cudaErrorInvalidValue;
  const int splits = (M + chunk - 1) / chunk;
  const EpiArgs e{C, nullptr, nullptr, nullptr, nullptr, 0,
                  nullptr, nullptr, 0, 1};
  return sm90::launch<EPI_F32, true, true>(A, B, e, Ka, N, M, chunk, splits,
                                           tile_n(N) == sm90::kWideBN,
                                           (cudaStream_t)stream);
}

// in: (R, C) fp32; out: (C,) fp32 column sums.
GTAX_ENTRY gtax_reduce_rows(const void* in, void* out, int R, long long C,
                            void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((C + threads - 1) / threads);
  reduce_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(in), static_cast<float*>(out), R, (size_t)C);
  return (int)cudaGetLastError();
}
