// Non-causal attention over the S tokens of one frame, per (frame, head,
// query tile), with rotary embedding applied to q and k as they load.
//
// Replaces the attention core of the TPU spatial branch
// (gtax/kernels/block.py _spatial_attention_core: full-d axial pixel rope,
// fp32 qkv in) and of the VAE block (gtax/kernels/vae_block.py
// _vae_block_kernel: bf16 qkv in, rope on the first `rot` dims of a head).
// Rounding points follow the TPU kernels: rope in fp32 (its sin and cos
// from a reduction to [-pi, pi] and the SFU, within 1e-6), q/k/v cast to bf16,
// scores and softmax in fp32, probabilities cast to bf16 before PV, fp32
// PV, then a bf16 output, or the fp32 sums themselves for the int8 spatial
// branch, which quantizes them unrounded (gtax/kernels/quant.py
// _spatial_kernel_q). For training (emit_train, the residuals of
// gtax/kernels/block.py _spatial_attention_core's qkv_out) it also stores
// the roped q and k and the cast v as bf16, exactly the values it attends
// with.
// Bound: operations (S^2 * d per head) at S = 576, bytes at S = 144.
// Design (attn_frame.cuh): QK^T and PV on the tensor cores (mma.sync
// m16n8k16, ldmatrix), 16 query rows a warp, 128 a block (fewer where
// that leaves SMs idle: frame_qtile); two passes over
// the keys so the probabilities are normalised before their bf16 cast, as
// gtax's are. A block keeps its head's roped K resident (72 KB at S = 576,
// head dim 64) and streams V in 64-key tiles, so two blocks fit on an SM and
// a head's K and V are staged 5 times at S = 576, not once per 64 queries.
// The fp32 branches (#1 and #5 at x.dtype = float32) take attn_frame_f32
// below: fp32 q/k/v, probabilities and output, nothing rounded, on the CUDA
// cores (no tensor-core type keeps fp32: TF32 keeps ten mantissa bits);
// for training (#1's emit_train in fp32) its rope pass also stores the
// fp32 roped q, k and the v.
#include <algorithm>

#include "attn_f32.cuh"
#include "attn_frame.cuh"

namespace {

// one block per (query tile, head, frame); the body is attn_frame_unit
// (attn_frame.cuh). FULL: 128-row tiles, a constant, so that instantiation
// carries no per-warp tile check; else qtile rows.
template <int HD, bool FULL>
__global__ void __launch_bounds__(kAttnWarps * 32, 2)
    attn_frame_kernel(const void* __restrict__ qkv, int qkv_f32,
                      const float* __restrict__ freqs, void* __restrict__ out,
                      int out_f32, bf16* __restrict__ q_out,
                      bf16* __restrict__ k_out, bf16* __restrict__ v_out,
                      int S, int D, int rot, int qtile) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn_frame_unit<HD>(smem, qkv, qkv_f32, freqs, out, out_f32, q_out, k_out,
                      v_out, S, D, rot, blockIdx.x, blockIdx.y, blockIdx.z,
                      FULL ? kAttnQTile : qtile);
}

// Query rows a block: 128 where those tiles give every SM a block, else
// the smallest tile of three or more whole warps that covers the frame
// exactly (a denoise step's 144 tokens: 48 rows, 48 blocks a frame at 16
// heads instead of 32, and no tile of 16 live rows out of 128), else 128.
// Three warps is the least measured: every block stages its head's keys.
int frame_qtile(int S, int heads, int n_frames) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if ((long long)((S + kAttnQTile - 1) / kAttnQTile) * heads * n_frames >=
      sms)
    return kAttnQTile;
  for (int w = 3; w < kAttnWarps; ++w)
    if (S % (16 * w) == 0) return 16 * w;
  return kAttnQTile;
}

template <int HD, bool FULL>
int launch_tiles(const void* qkv, int qkv_f32, const float* freqs, void* out,
                 int out_f32, bf16* qo, bf16* ko, bf16* vo, int n_frames,
                 int S, int D, int rot, int qtile, cudaStream_t st) {
  const size_t smem = attn_frame_smem<HD>(S);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // the attributes once per instantiation, the opt-in again only when S
  // needs more shared memory than any launch before it
  static size_t opted = 0;
  if (opted == 0) {
    // all of the SM's unified memory as shared memory, so two blocks of up
    // to 101 KB (S = 576) fit on an SM
    const cudaError_t e = cudaFuncSetAttribute(
        attn_frame_kernel<HD, FULL>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    opted = 48 * 1024;
  }
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_frame_kernel<HD, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  const dim3 grid((S + qtile - 1) / qtile, D / HD, n_frames);
  attn_frame_kernel<HD, FULL><<<grid, kAttnWarps * 32, smem, st>>>(
      qkv, qkv_f32, freqs, out, out_f32, qo, ko, vo, S, D, rot, qtile);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* qkv, int qkv_f32, const float* freqs, void* out,
           int out_f32, bf16* qo, bf16* ko, bf16* vo, int n_frames, int S,
           int D, int rot, cudaStream_t st) {
  const int qtile = frame_qtile(S, D / HD, n_frames);
  return qtile == kAttnQTile
             ? launch_tiles<HD, true>(qkv, qkv_f32, freqs, out, out_f32, qo,
                                      ko, vo, n_frames, S, D, rot, qtile, st)
             : launch_tiles<HD, false>(qkv, qkv_f32, freqs, out, out_f32, qo,
                                       ko, vo, n_frames, S, D, rot, qtile, st);
}

// ------------------------------------------------------------- fp32
//
// The fp32 branches' frame attention (gtax's kernels at x.dtype = float32:
// nothing is cast, probabilities included), on the CUDA cores, in two
// launches (attn_f32.cuh holds the device code, which the fp32 paired int8
// kernels share):
//  1. the rope pass, one thread per (position, pair of dims, frame group):
//     the pair's angles reduced once (sincosf), then that pair of q and k
//     of every head of the group's frames roped into a workspace (or, for
//     emit_train, into q_out and k_out, and v copied to v_out: each row
//     stored once);
//  2. the attention, one block per (query tile, head, frame), over the
//     roped rows through cp.async: up to 144 tokens a head's K and V whole
//     in shared memory and one softmax pass, past 144 a 2-stage ring of
//     64-key tiles. The query tile is the caller's (block.f32_frame_shape):
//     a row's bits do not depend on it. It is launched as the rope pass's
//     programmatic dependent, so its launch and its v staging overlap the
//     rope pass.
// Bound: operations at S = 576 and at many frames (4 S^2 d a head at 67
// TFLOP/s of fp32 FFMA), bytes at one frame of 144 tokens.

// frame groups of the rope pass: its items (position, pair of dims) take
// every head of a group's frames, enough items for 2048 a SM (the frames
// split into groups beyond that), so an angle is reduced once per group
int rope_groups(int n_frames, int items) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return std::min(n_frames, std::max(1, 2048 * sms / items));
}

// One thread an item (position, pair of dims) of a frame group (rope_item);
// the attention launched after it as its programmatic dependent may start
// (staging v) as soon as every block of this grid has started.
__global__ void __launch_bounds__(256)
    attn_rope_f32_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ freqs, float* q_dst,
                         int q_ld, float* k_dst, int k_ld, float* v_dst,
                         int v_ld, int n_frames, int S, int D, int hd,
                         int rot, int groups) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int pairs = hd / 2;
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (long long)S * pairs * groups) return;
  const int g = (int)(item / ((long long)S * pairs));
  const int pj = (int)(item % ((long long)S * pairs));
  rope_item(freqs, rot, pj / pairs, pj % pairs, S, D, hd, qkv, q_dst, q_ld,
            k_dst, k_ld, v_dst, v_ld, g, groups, n_frames);
}

template <int HD, class T>
__global__ void __launch_bounds__(T::THREADS)
    attn_frame_f32_kernel(const float* __restrict__ q, int q_ld,
                          const float* __restrict__ k, int k_ld,
                          const float* __restrict__ v, int v_ld,
                          float* __restrict__ out, int S, int D) {
  extern __shared__ __align__(16) float fsm[];
  const size_t n = blockIdx.z, hc = (size_t)blockIdx.y * HD;
  frame_f32_unit<HD, T>(
      fsm, q + n * S * q_ld + hc, q_ld, k + n * S * k_ld + hc, k_ld,
      v + n * S * v_ld + hc, v_ld, out + n * S * D + hc, D, S,
      blockIdx.x * T::QT, 1.0f / sqrtf((float)HD),
      // the rope pass's q and k: wait for that grid's end
      [] { asm volatile("griddepcontrol.wait;" ::: "memory"); });
}

// the attention over the roped rows, launched as the rope pass's
// programmatic dependent (its blocks stage v while the rope pass ends)
template <int HD, class T>
int launch_f32_shape(const float* q, int q_ld, const float* k, int k_ld,
                     const float* v, int v_ld, float* out, int n_frames,
                     int S, int D, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const cudaError_t e =
      opt_in_smem(attn_frame_f32_kernel<HD, T>, T::smem(), opted);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((S + T::QT - 1) / T::QT, D / HD, n_frames);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::smem();
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, attn_frame_f32_kernel<HD, T>, q, q_ld,
                                 k, k_ld, v, v_ld, out, S, D);
}

template <int HD>
int launch_f32(const float* qkv, const float* freqs, float* out, float* qo,
               float* ko, float* vo, float* ws, int n_frames, int S, int D,
               int rot, int shape, cudaStream_t st) {
  if (!f32_frame_shape_ok<HD>(shape, S))
    return (int)cudaErrorInvalidValue;
  // the roped rows: the workspace (q at column 0, k at D, rows 2D apart),
  // or for emit_train q_out and k_out
  float* qr = qo != nullptr ? qo : ws;
  float* kr = qo != nullptr ? ko : ws + D;
  const int ld = qo != nullptr ? D : 2 * D;
  const int items = S * (HD / 2), groups = rope_groups(n_frames, items);
  attn_rope_f32_kernel<<<(items * groups + 255) / 256, 256, 0, st>>>(
      qkv, freqs, qr, ld, kr, ld, vo, D, n_frames, S, D, HD, rot, groups);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (shape) {
#define GTAX_CASE(I, ...)                                               \
  case I:                                                               \
    return launch_f32_shape<HD, __VA_ARGS__>(qr, ld, kr, ld, qkv + 2 * D, \
                                             3 * D, out, n_frames, S, D, \
                                             st);
    GTAX_F32_FRAME_SHAPES(GTAX_CASE)
#undef GTAX_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv: (n_frames * S, 3D) fp32 (qkv_f32 = 1) or bf16; freqs: (S, rot) fp32
// rotary table; out: (n_frames * S, D) fp32 (out_f32 = 1) or bf16, head h
// in columns [h * hd, (h + 1) * hd); q_out/k_out/v_out: all three null, or
// (n_frames * S, D) bf16 outputs of the roped q, k and the cast v.
GTAX_ENTRY gtax_attn_frame(const void* qkv, int qkv_f32, const void* freqs,
                           void* out, int out_f32, void* q_out, void* k_out,
                           void* v_out, int n_frames, int S, int D,
                           int num_heads, int rot, void* stream) {
  if (n_frames <= 0 || S <= 0 || num_heads <= 0 || D % num_heads ||
      rot < 0 || rot % 2 || (q_out == nullptr) != (k_out == nullptr) ||
      (q_out == nullptr) != (v_out == nullptr))
    return (int)cudaErrorInvalidValue;
  bf16* qo = static_cast<bf16*>(q_out);
  bf16* ko = static_cast<bf16*>(k_out);
  bf16* vo = static_cast<bf16*>(v_out);
  const int hd = D / num_heads;
  if (rot > hd) return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(freqs);
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch<32>(qkv, qkv_f32, f, out, out_f32, qo, ko, vo, n_frames, S,
                        D, rot, st);
    case 64:
      return launch<64>(qkv, qkv_f32, f, out, out_f32, qo, ko, vo, n_frames, S,
                        D, rot, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fp32 form: qkv (n_frames * S, 3D) fp32; freqs (S, rot) fp32 rotary
// table, rope on the first rot dims of each head's q and k; out
// (n_frames * S, D) fp32, head h in columns [h * hd, (h + 1) * hd), hd 32,
// 64 or 128; q_out/k_out/v_out: all three null, or (n_frames * S, D) fp32
// outputs of the roped q, k and the v (the emit_train residuals); ws: with
// no q_out, an (n_frames * S, 2D) fp32 workspace for the roped q and k;
// shape: the query tile (csrc/attn_f32.cuh GTAX_F32_FRAME_SHAPES), of the
// whole kind up to 144 tokens and of the ring kind past them. Every
// pointer 16-byte aligned, D a multiple of 4.
GTAX_ENTRY gtax_attn_frame_f32(const void* qkv, const void* freqs, void* out,
                               void* q_out, void* k_out, void* v_out,
                               void* ws, int n_frames, int S, int D,
                               int num_heads, int rot, int shape,
                               void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(qkv) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(q_out) |
                         reinterpret_cast<uintptr_t>(k_out) |
                         reinterpret_cast<uintptr_t>(v_out) |
                         reinterpret_cast<uintptr_t>(ws);
  if (n_frames <= 0 || S <= 0 || num_heads <= 0 || D % num_heads ||
      rot < 0 || rot % 2 || rot > D / num_heads || D % 4 || ptrs % 16 ||
      shape < 0 || shape >= kF32FrameShapes ||
      (q_out == nullptr) != (k_out == nullptr) ||
      (q_out == nullptr) != (v_out == nullptr) ||
      (q_out == nullptr && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(qkv);
  const float* f = static_cast<const float*>(freqs);
  float* o = static_cast<float*>(out);
  float* qo = static_cast<float*>(q_out);
  float* ko = static_cast<float*>(k_out);
  float* vo = static_cast<float*>(v_out);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch_f32<32>(q, f, o, qo, ko, vo, w, n_frames, S, D, rot,
                            shape, st);
    case 64:
      return launch_f32<64>(q, f, o, qo, ko, vo, w, n_frames, S, D, rot,
                            shape, st);
    case 128:
      return launch_f32<128>(q, f, o, qo, ko, vo, w, n_frames, S, D, rot,
                             shape, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
