// The row-wise parts of a DiT branch backward: the gated-residual backward
// at its start and the LayerNorm + modulate backward at its end, each with
// its per-frame reductions.
//
// Replaces the elementwise and reduction steps of the TPU backward kernels
// (gtax/kernels/backward.py: the gate backward `dg = seg_sum(ct * y)`,
// `dy = ct * g` at the head of _mlp_bwd_kernel/_spatial_bwd_kernel/
// _temporal_bwd_kernel, and _ln_mod_bwd32 with the per-frame dshift/dscale
// sums and the residual add `dx = ct + dx_pre` at their tail).
// Bound: bytes. gate_bwd reads ct and y and writes dy (6 bytes a token
// element); ln_mod_bwd reads x, ct and the fp32 dmod and writes dx (10
// bytes). One block per frame makes each per-frame sum a fixed-order loop
// over the frame's rows: no atomics, so a run is bit-equal to the next.
// All math in fp32; dy and dx are rounded to bf16 once, as the TPU kernels
// round them. The element type is a template parameter: the fp32 branches
// (gtax's backward kernels at x.dtype = float32, where every cast is a
// no-op) take the same kernels over fp32 ct, y, gate, x, scale, dy and dx
// (gtax_gate_bwd_f32, gtax_ln_mod_bwd_f32; 12 and 20 bytes a token
// element), nothing rounded, the per-frame sums in the same order.
#include "common.cuh"

namespace {

// a pair (c, c + 1) of a bf16 or fp32 row as fp32
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// gate backward of out = x + g[f] * y over frame f's S rows:
// dy = bf16(ct * g), dg[f] = sum_rows ct * y, dysum[f] = sum_rows ct * g
// (the bias gradient's per-frame part, summed unrounded). Block (f, j)
// takes columns [j * 2 kGateThreads, ...) of frame f, so a B=16 step's 80
// frames give 320 blocks, and each thread's row loop is unrolled to keep
// several rows' loads in flight; a column's sums still add its rows in
// order.
constexpr int kGateThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kGateThreads)
    gate_bwd_kernel(const T* __restrict__ ct, const T* __restrict__ y,
                    const T* __restrict__ gate, int gate_stride,
                    T* __restrict__ dy, float* __restrict__ dg,
                    float* __restrict__ dysum, int S, int D) {
  const size_t f = blockIdx.x;
  const T* g = gate + f * gate_stride;
  const int c = (blockIdx.y * kGateThreads + threadIdx.x) * 2;
  if (c < D) {
    const float2 gv = ld2(g + c);
    float2 sg = make_float2(0.f, 0.f), sd = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const size_t o = (f * S + s) * D + c;
      const float2 cv = ld2(ct + o);
      const float2 yv = ld2(y + o);
      const float d0 = cv.x * gv.x, d1 = cv.y * gv.y;
      store_pair(dy, o, d0, d1);
      sg.x += cv.x * yv.x;
      sg.y += cv.y * yv.y;
      sd.x += d0;
      sd.y += d1;
    }
    *reinterpret_cast<float2*>(dg + f * D + c) = sg;
    *reinterpret_cast<float2*>(dysum + f * D + c) = sd;
  }
}

// LayerNorm (no affine, eps 1e-6) + modulate backward for frame f's rows,
// one warp per row, lane l owning columns 2l + 64p, p < P (D = 64 P):
//   ln = (x - mean) * r, dln = dmod * (1 + scale + 1e-6),
//   dx = bf16(ct + r * (dln - mean(dln) - ln * mean(dln * ln))),
//   dshift[f] = sum_rows dmod, dscale[f] = sum_rows dmod * ln.
template <int P, typename T>
__global__ void __launch_bounds__(kThreads)
    ln_mod_bwd_kernel(const T* __restrict__ x,
                      const float* __restrict__ dmod,
                      const T* __restrict__ scale, int p_stride,
                      const T* __restrict__ ct, T* __restrict__ dx,
                      float* __restrict__ dshift, float* __restrict__ dscale,
                      int S) {
  constexpr int D = 64 * P;
  __shared__ float2 red[2][D / 2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t f = blockIdx.x;
  const T* sc = scale + f * p_stride;
  float2 acc_sh[P], acc_sc[P], s1[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    acc_sh[p] = acc_sc[p] = make_float2(0.f, 0.f);
    const float2 sv = ld2(sc + 2 * lane + 64 * p);
    s1[p] = make_float2((1.0f + sv.x) + 1e-6f, (1.0f + sv.y) + 1e-6f);
  }
  for (int s = warp; s < S; s += kWarps) {
    const size_t row = (f * S + s) * D;
    float2 xv[P];
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      xv[p] = ld2(x + row + 2 * lane + 64 * p);
      sum += xv[p].x + xv[p].y;
    }
    const float mean = warp_sum(sum) / D;
    float var = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      xv[p].x -= mean;
      xv[p].y -= mean;
      var += xv[p].x * xv[p].x + xv[p].y * xv[p].y;
    }
    const float r = rsqrtf(warp_sum(var) / D + 1e-6f);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float2 dm = *reinterpret_cast<const float2*>(
          dmod + row + 2 * lane + 64 * p);
      xv[p].x *= r;  // ln
      xv[p].y *= r;
      const float dl0 = dm.x * s1[p].x, dl1 = dm.y * s1[p].y;
      m1 += dl0 + dl1;
      m2 += dl0 * xv[p].x + dl1 * xv[p].y;
      acc_sh[p].x += dm.x;
      acc_sh[p].y += dm.y;
      acc_sc[p].x += dm.x * xv[p].x;
      acc_sc[p].y += dm.y * xv[p].y;
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = 2 * lane + 64 * p;
      const float2 dm = *reinterpret_cast<const float2*>(dmod + row + c);
      const float2 cv = ld2(ct + row + c);
      const float d0 = r * (dm.x * s1[p].x - m1 - xv[p].x * m2);
      const float d1 = r * (dm.y * s1[p].y - m1 - xv[p].y * m2);
      store_pair(dx, row + c, cv.x + d0, cv.y + d1);
    }
  }
  // per-frame sums: the warps' partials added in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = lane + 32 * p;
        if (w == 0) {
          red[0][i] = acc_sh[p];
          red[1][i] = acc_sc[p];
        } else {
          red[0][i].x += acc_sh[p].x;
          red[0][i].y += acc_sh[p].y;
          red[1][i].x += acc_sc[p].x;
          red[1][i].y += acc_sc[p].y;
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < D / 2; i += kThreads) {
    const int lane_i = i % 32, p = i / 32;
    const int c = 2 * lane_i + 64 * p;
    *reinterpret_cast<float2*>(dshift + f * D + c) = red[0][i];
    *reinterpret_cast<float2*>(dscale + f * D + c) = red[1][i];
  }
}

template <int P, typename T>
int launch_ln_mod_bwd(const T* x, const float* dmod, const T* scale,
                      int p_stride, const T* ct, T* dx, float* dshift,
                      float* dscale, int F, int S, cudaStream_t st) {
  ln_mod_bwd_kernel<P, T><<<F, kThreads, 0, st>>>(
      x, dmod, scale, p_stride, ct, dx, dshift, dscale, S);
  return (int)cudaGetLastError();
}

template <typename T>
int gate_bwd(const void* ct, const void* y, const void* gate,
             int gate_stride, void* dy, void* dg, void* dysum, int F, int S,
             int D, void* stream) {
  if (F <= 0 || S <= 0 || D <= 0 || D % 2) return (int)cudaErrorInvalidValue;
  const dim3 grid(F, (D / 2 + kGateThreads - 1) / kGateThreads);
  gate_bwd_kernel<T><<<grid, kGateThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(ct), static_cast<const T*>(y),
      static_cast<const T*>(gate), gate_stride, static_cast<T*>(dy),
      static_cast<float*>(dg), static_cast<float*>(dysum), S, D);
  return (int)cudaGetLastError();
}

template <typename T>
int ln_mod_bwd(const void* x, const void* dmod, const void* scale,
               int p_stride, const void* ct, void* dx, void* dshift,
               void* dscale, int F, int S, int D, void* stream) {
  if (F <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const T* xb = static_cast<const T*>(x);
  const float* dm = static_cast<const float*>(dmod);
  const T* sc = static_cast<const T*>(scale);
  const T* cb = static_cast<const T*>(ct);
  T* o = static_cast<T*>(dx);
  float* dsh = static_cast<float*>(dshift);
  float* dsc = static_cast<float*>(dscale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
#define GTAX_LN_BWD_CASE(P)                                               \
  case 64 * P:                                                            \
    return launch_ln_mod_bwd<P, T>(xb, dm, sc, p_stride, cb, o, dsh, dsc, \
                                   F, S, st);
    GTAX_LN_BWD_CASE(1)
    GTAX_LN_BWD_CASE(2)
    GTAX_LN_BWD_CASE(4)
    GTAX_LN_BWD_CASE(8)
    GTAX_LN_BWD_CASE(16)
#undef GTAX_LN_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ct, y, dy: (F * S, D) bf16; gate: F rows of D bf16, row stride
// gate_stride; dg, dysum: (F, D) fp32.
GTAX_ENTRY gtax_gate_bwd(const void* ct, const void* y, const void* gate,
                         int gate_stride, void* dy, void* dg, void* dysum,
                         int F, int S, int D, void* stream) {
  return gate_bwd<bf16>(ct, y, gate, gate_stride, dy, dg, dysum, F, S, D,
                        stream);
}

// gtax_gate_bwd over fp32 ct, y, gate and dy
GTAX_ENTRY gtax_gate_bwd_f32(const void* ct, const void* y, const void* gate,
                             int gate_stride, void* dy, void* dg,
                             void* dysum, int F, int S, int D, void* stream) {
  return gate_bwd<float>(ct, y, gate, gate_stride, dy, dg, dysum, F, S, D,
                         stream);
}

// x, ct, dx: (F * S, D) bf16; dmod: (F * S, D) fp32; scale: F rows of D
// bf16, row stride p_stride (the shift's value is not needed: its gradient
// is dmod itself); dshift, dscale: (F, D) fp32. D is one of 64, 128, 256,
// 512, 1024.
GTAX_ENTRY gtax_ln_mod_bwd(const void* x, const void* dmod, const void* scale,
                           int p_stride, const void* ct,
                           void* dx, void* dshift, void* dscale, int F, int S,
                           int D, void* stream) {
  return ln_mod_bwd<bf16>(x, dmod, scale, p_stride, ct, dx, dshift, dscale,
                          F, S, D, stream);
}

// gtax_ln_mod_bwd over fp32 x, scale, ct and dx
GTAX_ENTRY gtax_ln_mod_bwd_f32(const void* x, const void* dmod,
                               const void* scale, int p_stride,
                               const void* ct, void* dx, void* dshift,
                               void* dscale, int F, int S, int D,
                               void* stream) {
  return ln_mod_bwd<float>(x, dmod, scale, p_stride, ct, dx, dshift, dscale,
                           F, S, D, stream);
}
