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
// for training (#1's emit_train in fp32) it also stores the fp32 roped q,
// k and the v, in an instantiation of its own.
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
// nothing is cast, probabilities included), on the CUDA cores: one block
// per (query tile of kF32Rows, head, frame), the body attn_frame_f32_unit
// (attn_f32.cuh), which the fp32 paired int8 kernels share. Three blocks
// an SM, what the unit's 67 KB of shared memory lets co-reside: so told,
// ptxas keeps the unit in 80 registers at head dim 64 (left to itself it
// took 64 and spilled).
// STORE: the emit_train form, which also stores the roped q, k and the v
// (attn_frame_f32_unit), its own instantiation so that the serving
// kernel's code is unchanged.
template <int HD, bool STORE>
__global__ void __launch_bounds__(kF32Threads, 3)
    attn_frame_f32_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ freqs,
                          float* __restrict__ out, int S, int D, int rot,
                          float* __restrict__ q_out, float* __restrict__ k_out,
                          float* __restrict__ v_out) {
  extern __shared__ __align__(16) float fsm[];
  attn_frame_f32_unit<HD, STORE>(fsm, qkv, freqs, out, S, D, rot, blockIdx.x,
                                 blockIdx.y, blockIdx.z, q_out, k_out, v_out);
}

template <int HD, bool STORE>
int launch_f32_as(const float* qkv, const float* freqs, float* out,
                  int n_frames, int S, int D, int rot, float* qo, float* ko,
                  float* vo, cudaStream_t st) {
  constexpr size_t smem = attn_f32_smem<HD>();
  static size_t opted = 48 * 1024;
  const cudaError_t e =
      opt_in_smem(attn_frame_f32_kernel<HD, STORE>, smem, opted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kF32Rows - 1) / kF32Rows, D / HD, n_frames);
  attn_frame_f32_kernel<HD, STORE><<<grid, kF32Threads, smem, st>>>(
      qkv, freqs, out, S, D, rot, qo, ko, vo);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const float* qkv, const float* freqs, float* out,
               int n_frames, int S, int D, int rot, float* qo, float* ko,
               float* vo, cudaStream_t st) {
  return qo == nullptr
             ? launch_f32_as<HD, false>(qkv, freqs, out, n_frames, S, D, rot,
                                        qo, ko, vo, st)
             : launch_f32_as<HD, true>(qkv, freqs, out, n_frames, S, D, rot,
                                       qo, ko, vo, st);
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
// (n_frames * S, D) fp32, head h in columns [h * hd, (h + 1) * hd);
// q_out/k_out/v_out: all three null, or (n_frames * S, D) fp32 outputs of
// the roped q, k and the v (the emit_train residuals).
GTAX_ENTRY gtax_attn_frame_f32(const void* qkv, const void* freqs, void* out,
                               void* q_out, void* k_out, void* v_out,
                               int n_frames, int S, int D, int num_heads,
                               int rot, void* stream) {
  if (n_frames <= 0 || S <= 0 || num_heads <= 0 || D % num_heads ||
      rot < 0 || rot % 2 || rot > D / num_heads ||
      reinterpret_cast<uintptr_t>(qkv) % 16 || D % 4 ||
      (q_out == nullptr) != (k_out == nullptr) ||
      (q_out == nullptr) != (v_out == nullptr) ||
      reinterpret_cast<uintptr_t>(v_out) % 16)
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(qkv);
  const float* f = static_cast<const float*>(freqs);
  float* o = static_cast<float*>(out);
  float* qo = static_cast<float*>(q_out);
  float* ko = static_cast<float*>(k_out);
  float* vo = static_cast<float*>(v_out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch_f32<32>(q, f, o, n_frames, S, D, rot, qo, ko, vo, st);
    case 64:
      return launch_f32<64>(q, f, o, n_frames, S, D, rot, qo, ko, vo, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
