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
// GEMM with K = M: each block owns a 64x64 tile of C and loops over one
// chunk of rows (split K); with more than one chunk each writes its own fp32
// partial and gtax_reduce_rows adds the partials in chunk order. No float
// atomics: a run is bit-equal to the next.
// Bound: operations at training shapes (M = 11,520 rows, Ka x N up to
// 1024 x 4096: 2*M*Ka*N flops against ~(M*(Ka+N)*2 + Ka*N*4) bytes).
// Design: as gemm_bf16 (64x64 tiles, 4 warps of 32x32 wmma fragments,
// two-stage cp.async), with the A tile kept [row][ka] as it lies in memory
// and read as a column-major fragment (A^T). Ragged row chunks are
// zero-filled. Later work: wgmma + TMA.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int PAD = 8;
constexpr int kThreads = 128;

struct Tiles {
  bf16 a[2][BK][BM + PAD];
  bf16 b[2][BK][BN + PAD];
};

__global__ void __launch_bounds__(kThreads)
    wgrad_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 float* __restrict__ C, int M, int Ka, int N, int chunk) {
  __shared__ __align__(128) Tiles sm;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;  // C tile (ka, n)
  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(M, r_begin + chunk);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 32 rows x 8 chunks of 8, A and B
      const int ch = tid + i * kThreads;
      const int r = ch >> 3, c = (ch & 7) * 8;
      const int row = k0 + r;
      const bool ok = row < r_end;
      const size_t rr = ok ? (size_t)row : 0;
      cp_async16(&sm.a[stage][r][c], A + rr * Ka + m0 + c, ok ? 16 : 0);
      cp_async16(&sm.b[stage][r][c], B + rr * N + n0 + c, ok ? 16 : 0);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = (r_end - r_begin + BK - 1) / BK;
  if (KT > 0) {
    load_tile(0, r_begin);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load_tile((kt + 1) & 1, r_begin + (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sm.a[st][kk][wm + i * 16], BM + PAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sm.b[st][kk][wn + j * 16], BN + PAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = C + (size_t)blockIdx.z * Ka * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          out + (size_t)(m0 + wm + i * 16) * N + n0 + wn + j * 16, acc[i][j],
          N, wmma::mem_row_major);
}

// out[c] = sum over r < R of in[r * C + c], r in order
__global__ void reduce_rows_kernel(const float* __restrict__ in,
                                   float* __restrict__ out, int R, size_t C) {
  const size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) acc += in[(size_t)r * C + c];
  out[c] = acc;
}

}  // namespace

// A: (M, Ka) bf16; B: (M, N) bf16; C: (splits, Ka, N) fp32, one partial per
// chunk of `chunk` rows (chunk a multiple of 32, splits = ceil(M / chunk)).
GTAX_ENTRY gtax_gemm_wgrad(const void* A, const void* B, void* C, int M,
                           int Ka, int N, int chunk, void* stream) {
  if (M <= 0 || Ka <= 0 || N <= 0 || Ka % BM || N % BN || chunk <= 0 ||
      chunk % BK)
    return (int)cudaErrorInvalidValue;
  const int splits = (M + chunk - 1) / chunk;
  const dim3 grid(N / BN, Ka / BM, splits);
  wgrad_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(B),
      static_cast<float*>(C), M, Ka, N, chunk);
  return (int)cudaGetLastError();
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
