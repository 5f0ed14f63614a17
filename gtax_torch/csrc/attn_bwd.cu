// Attention backward of the DiT branches, from the emitted post-rope q/k and
// cast v (the emit_train residuals): per-frame spatial attention
// (attn_frame_bwd) and causal temporal attention at each site
// (attn_temporal_bwd). Each recomputes the probabilities P, writes the
// attention output O = P V that the out-projection's weight gradient needs,
// and writes dq, dk (rope adjoint applied) and dv into one (rows, 3D) bf16
// buffer laid out as the qkv projection's output.
//
// Replaces the attention parts of gtax/kernels/backward.py
// _spatial_bwd_kernel (the per-head recompute and backward loops and
// _rope_transpose_rows) and _temporal_bwd_kernel (the causal frame-pair
// loops with the additive slot bias of temporal_preamble: causal, a key
// slot open when valid or on the diagonal, -1e30 when closed).
// Math and rounding as the TPU kernels: fp32 scores and softmax,
//   dV = bf16(P)^T dO, dP = dO V^T, dS = bf16(P * (dP - rowsum(dP * P)) / sqrt(d)),
//   dQ = dS K, dK = dS^T Q  (fp32 sums), rope adjoint in fp32, one bf16
// rounding of each output. The temporal scores sum q*k in fp32 where the
// TPU kernel rounds each product to bf16, as the port's forward does.
// Bound: bytes for both. The spatial kernel at B=16 (80 frames of 144
// tokens, D = 1024) reads q, k, v, dO and writes dq/dk/dv and O: 189 MB,
// 0.056 ms at 3.35 TB/s, against 0.021 ms for its six 144 x 144 x 64
// products a (frame, head) at the bf16 tensor-core peak; the temporal one
// has T <= 8 keys a query.
// Design. attn_frame_bwd runs its six products (the scores, O = P V, dP, dQ,
// dK, dV) as mma.sync m16n8k16 on the tensor cores, operands from shared memory
// by ldmatrix (attn_frame.cuh). A block takes one (head, frame) and stages its
// Q, K, V and dO (padded to a whole 16-row tile with zeros) by cp.async, V and
// dO landing while the scores are formed; it has one warp per 16-row tile (9 at
// the DiT's S = 144), which takes that tile of query rows in phase A and of key
// rows in phase B. The register arrays of a row's scores are sized for 9 tiles,
// or for as many as fit the shared memory (S <= 176 at hd 64, 192 at hd 32)
// past that. Phase A: the warp's 16 x S scores, p32 and dP stay in registers in
// the accumulator layout (row sums by quad shuffles); P goes to O from
// registers, and to shared memory as bf16; dP = dO V^T is formed twice (once
// for rowsum(dP * p32), once for dS), and dS goes to shared memory and, from
// registers, into dQ = dS K. Phase B reads the columns of P and dS for its keys
// as A operands transposed by ldmatrix.trans: dK = dS^T Q and dV = P^T dO.
// Shared memory: Q, K, V, dO and the S x S bf16 P and dS (170 KB at S = 144, hd
// 64), so one block fits on an SM and a (head, frame) is read once. The rope
// adjoint takes the table's fp32 cos and sin (as gtax's kernel and the plain
// version do): a precise sincosf for each element pair had been half the
// kernel's time. attn_temporal_bwd has attn_window's layout (attn_temporal.cuh:
// a lane owns 16 bytes of a row, a head's lanes sum a dot product by a
// butterfly, the window's T a template parameter, every frame's q, k, v and dO
// loaded before the first score), everything in registers but the window's
// cos and sin table (shared memory, formed once a block); it keeps the math
// and rounding points above and the rope adjoint of rope_pair_t. At B=16 it
// moves 188.7 MB (q, k, v, dO in; dq, dk, dv and O out), 0.056 ms at 3.35
// TB/s.
#include <initializer_list>

#include "attn_frame.cuh"
#include "attn_temporal.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kBwdChunks = 9;  // 16-row tiles of the DiT's 144-token frame

// Shared memory of attn_frame_bwd: Q, K, V, dO rows of HD + 8 and P, dS
// rows of SP + 8 bf16 (16-byte pads: ldmatrix's eight rows hit distinct
// banks), SP = S rounded up to 16.
template <int HD>
constexpr size_t frame_bwd_smem(int S) {
  const size_t sp = (size_t)(S + 15) / 16 * 16;
  return (4 * sp * (HD + 8) + 2 * sp * (sp + 8)) * 2;
}

// The most 16-row tiles of a frame whose block fits the shared memory
template <int HD>
constexpr int frame_bwd_max_chunks() {
  int n = 1;
  while (frame_bwd_smem<HD>(16 * (n + 1)) <= kSmemMax) ++n;
  return n;
}

// dP = dO V^T for keys 16 kp .. 16 kp + 15 (two n8 tiles d0, d1) of the
// warp's 16 query rows (dO A fragments of)
template <int HD>
__device__ __forceinline__ void dp_tiles(float (&d0)[4], float (&d1)[4],
                                         const uint32_t (&of)[HD / 16][4],
                                         const bf16* Vs, int kp, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) d0[i] = d1[i] = 0.f;
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    uint32_t b[4];
    ldsm_x4(b, Vs + (size_t)(kp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                   kc * 16 + ((lane >> 3) & 1) * 8);
    mma16816(d0, of[kc], b[0], b[1]);
    mma16816(d1, of[kc], b[2], b[3]);
  }
}

// NP: the 16-row tiles the score registers hold, at least SP / 16
template <int HD, int NP>
__global__ void __launch_bounds__(NP * 32, 1)
    attn_frame_bwd_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ cosb,
                          const float* __restrict__ sinb,
                          bf16* __restrict__ dqkv, bf16* __restrict__ ao,
                          int S, int D, int rot) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = HD + 8, KC = HD / 16, DT = HD / 8, CH = HD / 8;
  const int SP = (S + 15) / 16 * 16, LP = SP + 8, NKC = SP / 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + (size_t)SP * LD;
  bf16* Vs = Ks + (size_t)SP * LD;
  bf16* Os = Vs + (size_t)SP * LD;  // dO
  bf16* Ps = Os + (size_t)SP * LD;  // bf16(P), [query][key]
  bf16* Gs = Ps + (size_t)SP * LP;  // dS, [query][key]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const size_t hc = (size_t)blockIdx.x * HD;
  const size_t row0 = (size_t)blockIdx.y * S;
  const size_t D3 = 3 * (size_t)D;
  // gtax's 1 / sqrt(d): the double quotient, rounded to fp32 once
  const float scale = (float)(1.0 / sqrt((double)HD));

  // stage Q, K, V, dO: 16 bytes a copy, rows past S zero-filled, in two
  // groups: the scores wait for Q and K only, V and dO land meanwhile
  const int per = SP * CH;
  for (int t0 = 0; t0 < 4; t0 += 2) {
    for (int idx = tid; idx < 2 * per; idx += blockDim.x) {
      const int t = t0 + idx / per, r = (idx % per) / CH, c = (idx % CH) * 8;
      const int rr = r < S ? r : S - 1;
      const bf16* src = t == 0 ? q : t == 1 ? k : t == 2 ? v : dout;
      cp_async16(Qs + (size_t)t * SP * LD + (size_t)r * LD + c,
                 src + (row0 + rr) * D + hc + c, r < S ? 16 : 0);
    }
    cp_async_commit();
  }
  if (GTAX_PROBE_STOP == 0) {
    cp_async_wait<0>();
    return;
  }
  cp_async_wait<1>();
  __syncthreads();

  // ---- phase A: query rows r0 .. r0 + 15; this thread holds rows
  // r0 + g (a) and r0 + g + 8 (b) of each accumulator tile
  const int r0 = warp * 16;
  const bool ok_a = r0 + g < S, ok_b = r0 + g + 8 < S;
  float p[2 * NP][4];  // scores, then p32
  {
    uint32_t qf[KC][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      ldsm_x4(qf[kc], Qs + (size_t)(r0 + (lane & 15)) * LD + kc * 16 +
                          (lane >> 4) * 8);
#pragma unroll
    for (int kp = 0; kp < NP; ++kp) {
#pragma unroll
      for (int i = 0; i < 4; ++i) p[2 * kp][i] = p[2 * kp + 1][i] = 0.f;
      if (kp < NKC) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t b[4];
          ldsm_x4(b, Ks + (size_t)(kp * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                              LD + kc * 16 + ((lane >> 3) & 1) * 8);
          mma16816(p[2 * kp], qf[kc], b[0], b[1]);
          mma16816(p[2 * kp + 1], qf[kc], b[2], b[3]);
        }
      }
    }
  }
  float m_a = -INFINITY, m_b = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = nt * 8 + 2 * tq + (i & 1);
      p[nt][i] = key < S ? __fmul_rn(p[nt][i], scale) : -INFINITY;
      if (i < 2)
        m_a = fmaxf(m_a, p[nt][i]);
      else
        m_b = fmaxf(m_b, p[nt][i]);
    }
  m_a = quad_max(m_a);
  m_b = quad_max(m_b);
  float l_a = 0.f, l_b = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[nt][i] = expf(p[nt][i] - (i < 2 ? m_a : m_b));
      if (i < 2)
        l_a += p[nt][i];
      else
        l_b += p[nt][i];
    }
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  // p32 = e / l (rows past S: 0, so they add nothing to dK and dV)
  const float r_a = __frcp_rn(l_a), r_b = __frcp_rn(l_b);
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[nt][i] = (i < 2 ? ok_a : ok_b)
                     ? div_rn_by(p[nt][i], i < 2 ? l_a : l_b,
                                 i < 2 ? r_a : r_b)
                     : 0.f;

  cp_async_wait<0>();
  __syncthreads();  // V and dO are in

  // bf16(P) to shared memory, and O = bf16(P) V from the registers
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
#pragma unroll
  for (int kp = 0; kp < NP; ++kp) {
    if (kp >= NKC) break;
    const uint32_t pf[4] = {pack_bf16(p[2 * kp][0], p[2 * kp][1]),
                            pack_bf16(p[2 * kp][2], p[2 * kp][3]),
                            pack_bf16(p[2 * kp + 1][0], p[2 * kp + 1][1]),
                            pack_bf16(p[2 * kp + 1][2], p[2 * kp + 1][3])};
    bf16* pr = Ps + (size_t)(r0 + g) * LP + kp * 16 + 2 * tq;
    *reinterpret_cast<uint32_t*>(pr) = pf[0];
    *reinterpret_cast<uint32_t*>(pr + 8 * LP) = pf[1];
    *reinterpret_cast<uint32_t*>(pr + 8) = pf[2];
    *reinterpret_cast<uint32_t*>(pr + 8 * LP + 8) = pf[3];
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, Vs + (size_t)(kp * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * LD +
                       dp * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * dp], pf, b[0], b[1]);
      mma16816(acc[2 * dp + 1], pf, b[2], b[3]);
    }
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const size_t c = hc + dt * 8 + 2 * tq;
    if (ok_a) store_pair(ao, (row0 + r0 + g) * D + c, acc[dt][0], acc[dt][1]);
    if (ok_b)
      store_pair(ao, (row0 + r0 + g + 8) * D + c, acc[dt][2], acc[dt][3]);
  }

  uint32_t of[KC][4];  // A fragments of the warp's dO rows
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldsm_x4(of[kc], Os + (size_t)(r0 + (lane & 15)) * LD + kc * 16 +
                        (lane >> 4) * 8);
  // rowsum(dP * p32), dP = dO V^T two n8 tiles of keys at a time
  float s_a = 0.f, s_b = 0.f;
#pragma unroll
  for (int kp = 0; kp < NP; ++kp) {
    if (kp >= NKC) break;
    float d0[4], d1[4];
    dp_tiles<HD>(d0, d1, of, Vs, kp, lane);
    s_a += d0[0] * p[2 * kp][0] + d0[1] * p[2 * kp][1] +
           d1[0] * p[2 * kp + 1][0] + d1[1] * p[2 * kp + 1][1];
    s_b += d0[2] * p[2 * kp][2] + d0[3] * p[2 * kp][3] +
           d1[2] * p[2 * kp + 1][2] + d1[3] * p[2 * kp + 1][3];
  }
  s_a = quad_sum(s_a);
  s_b = quad_sum(s_b);
  // dS = bf16((p32 * (dP - rowsum)) * d^-1/2) to shared memory, and
  // dQ = dS K from the registers
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
#pragma unroll
  for (int kp = 0; kp < NP; ++kp) {
    if (kp >= NKC) break;
    float d0[4], d1[4];
    dp_tiles<HD>(d0, d1, of, Vs, kp, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sub = i < 2 ? s_a : s_b;
      d0[i] = __fmul_rn(__fmul_rn(p[2 * kp][i], __fsub_rn(d0[i], sub)),
                        scale);
      d1[i] = __fmul_rn(__fmul_rn(p[2 * kp + 1][i], __fsub_rn(d1[i], sub)),
                        scale);
    }
    const uint32_t gf[4] = {pack_bf16(d0[0], d0[1]), pack_bf16(d0[2], d0[3]),
                            pack_bf16(d1[0], d1[1]), pack_bf16(d1[2], d1[3])};
    bf16* gr = Gs + (size_t)(r0 + g) * LP + kp * 16 + 2 * tq;
    *reinterpret_cast<uint32_t*>(gr) = gf[0];
    *reinterpret_cast<uint32_t*>(gr + 8 * LP) = gf[1];
    *reinterpret_cast<uint32_t*>(gr + 8) = gf[2];
    *reinterpret_cast<uint32_t*>(gr + 8 * LP + 8) = gf[3];
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, Ks + (size_t)(kp * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * LD +
                       dp * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * dp], gf, b[0], b[1]);
      mma16816(acc[2 * dp + 1], gf, b[2], b[3]);
    }
  }
  // the rope adjoint in fp32, one bf16 rounding
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half;
      if (r >= S) continue;
      float2 u = make_float2(acc[dt][2 * half], acc[dt][2 * half + 1]);
      if (c < rot) u = rope_pair_t_tab(u, cosb, sinb, (size_t)r * rot + c);
      store_pair(dqkv, (row0 + r) * D3 + hc + c, u.x, u.y);
    }
  }
  if (GTAX_PROBE_STOP == 1) return;
  __syncthreads();  // every warp's rows of P and dS are in shared memory

  // ---- phase B: key rows j0 .. j0 + 15; dK = dS^T Q, dV = P^T dO
  const int j0 = warp * 16;
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[dt][i] = dv[dt][i] = 0.f;
  for (int qc = 0; qc < NKC; ++qc) {
    // A fragments of the transposed 16 x 16 blocks (keys j0.., queries
    // 16 qc..) of dS and P
    const size_t at = (size_t)(qc * 16 + ((lane >> 4) << 3) + (lane & 7)) *
                          LP + j0 + ((lane >> 3) & 1) * 8;
    uint32_t ga[4], pa[4];
    ldsm_x4_t(ga, Gs + at);
    ldsm_x4_t(pa, Ps + at);
    const size_t bt = (size_t)(qc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                          LD + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, Qs + bt + dp * 16);
      mma16816(dk[2 * dp], ga, b[0], b[1]);
      mma16816(dk[2 * dp + 1], ga, b[2], b[3]);
      ldsm_x4_t(b, Os + bt + dp * 16);
      mma16816(dv[2 * dp], pa, b[0], b[1]);
      mma16816(dv[2 * dp + 1], pa, b[2], b[3]);
    }
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = j0 + g + 8 * half;
      if (j >= S) continue;
      float2 u = make_float2(dk[dt][2 * half], dk[dt][2 * half + 1]);
      if (c < rot) u = rope_pair_t_tab(u, cosb, sinb, (size_t)j * rot + c);
      const size_t o = (row0 + j) * D3 + hc + c;
      store_pair(dqkv, o + D, u.x, u.y);
      store_pair(dqkv, o + 2 * (size_t)D, dv[dt][2 * half],
                 dv[dt][2 * half + 1]);
    }
  }
}

template <int HD, int NP>
int launch_frame_np(const bf16* q, const bf16* k, const bf16* v,
                    const bf16* dout, const float* cosb, const float* sinb,
                    bf16* dqkv, bf16* ao, int n_frames, int S, int D, int rot,
                    cudaStream_t st) {
  const size_t smem = frame_bwd_smem<HD>(S);
  static size_t opted = 48 * 1024;
  const cudaError_t e =
      opt_in_smem(attn_frame_bwd_kernel<HD, NP>, smem, opted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(D / HD, n_frames);
  attn_frame_bwd_kernel<HD, NP><<<grid, (S + 15) / 16 * 32, smem, st>>>(
      q, k, v, dout, cosb, sinb, dqkv, ao, S, D, rot);
  return (int)cudaGetLastError();
}

// the instantiation whose score registers hold the frame's tiles: nine up
// to the DiT's 144 tokens, else as many as the shared memory takes
template <int HD>
int launch_frame(const bf16* q, const bf16* k, const bf16* v,
                 const bf16* dout, const float* cosb, const float* sinb,
                 bf16* dqkv, bf16* ao, int n_frames, int S, int D, int rot,
                 cudaStream_t st) {
  constexpr int kMax = frame_bwd_max_chunks<HD>();
  const int tiles = (S + 15) / 16;
  if (tiles <= kBwdChunks)
    return launch_frame_np<HD, kBwdChunks>(q, k, v, dout, cosb, sinb, dqkv,
                                           ao, n_frames, S, D, rot, st);
  if (tiles <= kMax)
    return launch_frame_np<HD, kMax>(q, k, v, dout, cosb, sinb, dqkv, ao,
                                     n_frames, S, D, rot, st);
  return (int)cudaErrorInvalidValue;
}

// One lane of attn_temporal_bwd (the layout of attn_window_lane,
// attn_temporal.cuh): its 16 bytes of every frame's q, k, v and dO are
// loaded before the first score. The block first forms the window's cos
// and sin table in shared memory (sincosf, the values rope_pair_t forms).
// Pass 1, query frame i: the scores, P, dP and dS of keys j <= i (each
// score and dP by dot8 and group_sum), O_i, and dq_i = sum over j <= i of
// dS(i, j) k_j through the rope adjoint, both stored; bf16(P) and bf16(dS)
// kept. Pass 2, frame t: dk_t = sum over i >= t of dS(i, t) q_i and dv_t
// = sum over i >= t of bf16(P)(i, t) dO_i, dk_t through the rope adjoint.
// Every sum runs in the order of the warp-per-unit kernel this replaced
// (keys, then queries, ascending); the three 16-byte stores go to dq | dk
// | dv of the row of dqkv.
template <int HD, int T>
__global__ void __launch_bounds__(kWindowThreads)
    attn_temporal_bwd_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ freqs,
                             bf16* __restrict__ dqkv, bf16* __restrict__ ao,
                             int B, int S, int D, int valid_mask) {
  constexpr int L = HD / kLaneDims;
  __shared__ float cos_t[T * HD], sin_t[T * HD];
  for (int i = threadIdx.x; i < T * HD; i += kWindowThreads)
    sincosf(freqs[i], &sin_t[i], &cos_t[i]);
  __syncthreads();
  const WindowLane w = window_lane<HD, T>(
      (long long)blockIdx.x * kWindowThreads + threadIdx.x, B, S, D);
  const float scale = 1.0f / sqrtf((float)HD);
  auto at = [&](int t) { return (w.row + (size_t)t * S) * D + w.col; };
  // row (b, t, s) of dqkv: 3D wide, dq | dk | dv
  auto dqkv_at = [&](int t) {
    return dqkv + (w.row + (size_t)t * S) * 3 * D + w.col;
  };
  auto rope_t = [&](float (&u)[8], int t) {  // rope_pair_t at frame t
    const float* c = cos_t + t * HD + w.hcol;
    const float* s = sin_t + t * HD + w.hcol;
#pragma unroll
    for (int d = 0; d < 8; d += 2) {
      const float2 g = rope_pair_t_cs(make_float2(u[d], u[d + 1]), c[d], s[d],
                                      c[d + 1], s[d + 1]);
      u[d] = g.x;
      u[d + 1] = g.y;
    }
  };
  uint4 qr[T], kr[T], vr[T], gr[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    const size_t o = at(t);
    qr[t] = w.live ? ldg16(q + o) : z;
    kr[t] = w.live ? ldg16(k + o) : z;
    vr[t] = w.live ? ldg16(v + o) : z;
    gr[t] = w.live ? ldg16(dout + o) : z;
  }
  float pb[T][T], ds[T][T];  // bf16(P) and bf16(dS), j <= i
#pragma unroll
  for (int i = 0; i < T; ++i) {
    float qi[8], gi[8], pr[T], dp[T];
    unpack8(qr[i], qi);
    unpack8(gr[i], gi);
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      pr[j] = dot8(qi, kr[j]);
      dp[j] = dot8(gi, vr[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      pr[j] = group_sum<L>(pr[j]) * scale + window_bias(valid_mask, i, j);
      dp[j] = group_sum<L>(dp[j]);
      mx = fmaxf(mx, pr[j]);
    }
    float den = 0.f;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      pr[j] = expf(pr[j] - mx);
      den += pr[j];
    }
    float dsum = 0.f;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      pr[j] = pr[j] / den;
      dsum += dp[j] * pr[j];
    }
    float o[8], dq[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) o[d] = dq[d] = 0.f;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      pb[i][j] = bf16_round(pr[j]);
      ds[i][j] = bf16_round((pr[j] * (dp[j] - dsum)) * scale);
      float f[8];
      unpack8(vr[j], f);
#pragma unroll
      for (int d = 0; d < 8; ++d) o[d] = fmaf(pb[i][j], f[d], o[d]);
      unpack8(kr[j], f);
#pragma unroll
      for (int d = 0; d < 8; ++d) dq[d] = fmaf(ds[i][j], f[d], dq[d]);
    }
    if (w.live) {
      *reinterpret_cast<uint4*>(ao + at(i)) = pack8(o);
      rope_t(dq, i);
      *reinterpret_cast<uint4*>(dqkv_at(i)) = pack8(dq);
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float dk[8], dv[8], f[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) dk[d] = dv[d] = 0.f;
#pragma unroll
    for (int i = t; i < T; ++i) {
      unpack8(qr[i], f);
#pragma unroll
      for (int d = 0; d < 8; ++d) dk[d] = fmaf(ds[i][t], f[d], dk[d]);
      unpack8(gr[i], f);
#pragma unroll
      for (int d = 0; d < 8; ++d) dv[d] = fmaf(pb[i][t], f[d], dv[d]);
    }
    if (!w.live) continue;
    rope_t(dk, t);
    *reinterpret_cast<uint4*>(dqkv_at(t) + D) = pack8(dk);
    *reinterpret_cast<uint4*>(dqkv_at(t) + 2 * (size_t)D) = pack8(dv);
  }
}

template <int HD, int T>
int launch_temporal(const bf16* q, const bf16* k, const bf16* v,
                    const bf16* dout, const float* freqs, bf16* dqkv,
                    bf16* ao, int B, int S, int D, int valid_mask,
                    cudaStream_t st) {
  const long long lanes = (long long)B * S * (D / kLaneDims);
  const long long blocks = (lanes + kWindowThreads - 1) / kWindowThreads;
  attn_temporal_bwd_kernel<HD, T><<<(unsigned)blocks, kWindowThreads, 0,
                                    st>>>(q, k, v, dout, freqs, dqkv, ao, B,
                                          S, D, valid_mask);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_temporal_t(const bf16* q, const bf16* k, const bf16* v,
                      const bf16* dout, const float* freqs, bf16* dqkv,
                      bf16* ao, int B, int T, int S, int D, int valid_mask,
                      cudaStream_t st) {
  switch (T) {
#define GTAX_BWD_CASE(N)                                                    \
  case N:                                                                   \
    return launch_temporal<HD, N>(q, k, v, dout, freqs, dqkv, ao, B, S, D, \
                                  valid_mask, st);
    GTAX_BWD_CASE(1)
    GTAX_BWD_CASE(2)
    GTAX_BWD_CASE(3)
    GTAX_BWD_CASE(4)
    GTAX_BWD_CASE(5)
    GTAX_BWD_CASE(6)
    GTAX_BWD_CASE(7)
    GTAX_BWD_CASE(8)
#undef GTAX_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ fp32
//
// The fp32 branches' attention backwards (gtax's backward kernels at
// x.dtype = float32: every cast a no-op, so P and dS are not rounded), on
// the CUDA cores (fp32 FFMA, no tensor-core instruction: TF32 keeps ten
// mantissa bits). The bf16 frame design keeps Q, K, V, dO and the S x S P
// and dS of a (head, frame) in one block's shared memory; in fp32 that is
// about 313 KB at S = 144, past the 227 KB a block may have. So
// attn_frame_bwd_f32 runs two passes over 48-row tiles (the DiT's 144
// tokens are three, nothing padded):
//   pass 1, a block a (query tile, head, frame): the tile's scores against
//     every key (P, 48 x SP in shared memory, SP = S rounded up to 48),
//     each row's max m and sum l (two threads a row, a fixed order), P =
//     exp(s - m) / l; then per key tile O += P V and dP = dO V^T; rowsum
//     D = sum(dP * P); dS = (P * (dP - D)) * d^-1/2 in place; dQ = dS K
//     through the rope adjoint. It stores O, dQ and (m, l, D) a row. The
//     key tiles (K, V, K again) stream through two buffers by cp.async,
//     the next tile's copies in flight during this one's products;
//   pass 2, a block a (key tile, head, frame): per query tile, the scores
//     and dP again (transposed: K Q^T and V dO^T), P and dS from the
//     stored (m, l, D), then dK += dS^T Q and dV += P^T dO, dK through the
//     rope adjoint.
// A score and a dP are the same fp32 FFMA chains over the head's dims in
// both passes, and the scale, P and dS are formed by the same rounded
// operations, so pass 2's P and dS are pass 1's bit for bit. Bound:
// operations (six S x S x d products a (head, frame): scores, O, dP, dQ,
// dK, dV; the kernel does eight, pass 2 recomputing the scores and dP).
// Every operand is staged as its rows lie (padded by
// four floats), so no copy transposes: a product C = A B^T (scores, dP)
// reads both operands' rows as float4 along the head's dims, a product
// C = A B (O, dQ, dK, dV) A's rows as float4 along the key or query and
// B's rows as float4 along the dims. 96 threads a block, (ty, tx) = (tid /
// 16, tid % 16); a thread holds rows ty + 6 r (r < 8) and, of a 48-wide
// product, columns tx + 16 c (c < 3), of a head-dim-wide one tx * hd/16 ..
// (8 x 4 at hd 64): its rows are one broadcast, and a quarter-warp's
// eight B rows, 4 mod 32 floats apart, cover the banks once. Pass 1 takes
// 106.5 KB at S = 144 (two blocks an SM), pass 2 71.1 KB (three). Frames
// up to 432 tokens at head dim 64 (528 at 32) fit pass 1.
// attn_temporal_bwd_f32 is attn_temporal_bwd with a lane of four fp32
// dims (16 bytes, as attn_window_lane_f32): the same passes and order of
// sums, nothing rounded.

constexpr int kFBTile = 48;     // rows of a query or key tile
constexpr int kFBThreads = 96;  // (ty, tx): 6 x 16
constexpr int kFBLdS = kFBTile + 4;  // pass 2's P^T / dS^T row stride

// a staged row's stride (head dims + 4: rows 4 mod 32 floats apart)
template <int HD>
__host__ __device__ constexpr int fb_ld() {
  return HD + 4;
}
__host__ __device__ constexpr int fb_keys(int S) {  // S rounded up to 48
  return (S + kFBTile - 1) / kFBTile * kFBTile;
}

// pass 1: Q, dO and two key tiles (48 rows each), P and dP / dS (48 x SP)
template <int HD>
__host__ __device__ constexpr size_t frame_bwd_f32_smem1(int S) {
  return (4 * kFBTile * fb_ld<HD>() + 2 * kFBTile * (fb_keys(S) + 4)) *
         sizeof(float);
}
// pass 2: the key tile's K and V, a query tile's Q and dO, its P^T and
// dS^T (key-major) and (m, l, D)
template <int HD>
__host__ __device__ constexpr size_t frame_bwd_f32_smem2() {
  return (4 * kFBTile * fb_ld<HD>() + 2 * kFBTile * kFBLdS + 3 * kFBTile) *
         sizeof(float);
}

// rows p0 .. p0 + 47 of head column hc of src ((rows, D) fp32, frame rows
// from row0) into dst (dst[r * fb_ld + d]) by 16-byte cp.async; rows past
// S zero
template <int HD>
__device__ __forceinline__ void fb_stage(float* dst, const float* src,
                                         size_t row0, int D, size_t hc,
                                         int p0, int S) {
  for (int i = threadIdx.x; i < kFBTile * HD / 4; i += kFBThreads) {
    const int r = i / (HD / 4), d = i % (HD / 4) * 4, p = p0 + r;
    cp_async16(dst + r * fb_ld<HD>() + d,
               src + (row0 + min(p, S - 1)) * D + hc + d, p < S ? 16 : 0);
  }
}

// C = A B^T: acc[r][c] += sum over k < n, in order, of A[(ty + 6 r) lda +
// k] * B[(tx + 16 c) ldb + k] (n a multiple of 4)
template <int RC>
__device__ __forceinline__ void fb_nt(float (&acc)[8][RC], const float* A,
                                      int lda, const float* B, int ldb,
                                      int n) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int k = 0; k < n; k += 4) {
    float a[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 t =
          *reinterpret_cast<const float4*>(A + (ty + 6 * r) * lda + k);
      a[r][0] = t.x, a[r][1] = t.y, a[r][2] = t.z, a[r][3] = t.w;
    }
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const float4 t =
          *reinterpret_cast<const float4*>(B + (tx + 16 * c) * ldb + k);
      const float b[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r][c] = fmaf(a[r][kk], b[kk], acc[r][c]);
    }
  }
}

// C = A B: acc[r][c] += sum over k < n, in order, of A[(ty + 6 r) lda +
// k] * B[k ldb + tx RC + c] (RC 2 or 4, n a multiple of 4)
template <int RC>
__device__ __forceinline__ void fb_nn(float (&acc)[8][RC], const float* A,
                                      int lda, const float* B, int ldb,
                                      int n) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int k = 0; k < n; k += 4) {
    float a[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 t =
          *reinterpret_cast<const float4*>(A + (ty + 6 * r) * lda + k);
      a[r][0] = t.x, a[r][1] = t.y, a[r][2] = t.z, a[r][3] = t.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[RC];
      const float* row = B + (k + kk) * ldb + tx * RC;
      if constexpr (RC == 4) {
        const float4 t = *reinterpret_cast<const float4*>(row);
        b[0] = t.x, b[1] = t.y, b[2] = t.z, b[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(row);
        b[0] = t.x, b[1] = t.y;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < RC; ++c) acc[r][c] = fmaf(a[r][kk], b[c], acc[r][c]);
    }
  }
}

// 1 / sqrt(d) as gtax forms it: the double quotient, rounded once
template <int HD>
__device__ __forceinline__ float attn_scale() {
  return (float)(1.0 / sqrt((double)HD));
}

template <int HD>
__global__ void __launch_bounds__(kFBThreads, 2)
    attn_frame_bwd_f32_q(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ cosb,
                         const float* __restrict__ sinb,
                         float* __restrict__ dqkv, float* __restrict__ ao,
                         float* __restrict__ stats, int S, int D, int rot) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int LD = fb_ld<HD>(), RC = HD / 16, TILE = kFBTile;
  const int SP = fb_keys(S), LP = SP + 4, NT = SP / TILE;
  float* QS = fsm;                // [TILE][LD] Q rows
  float* OS = QS + TILE * LD;     // [TILE][LD] dO rows
  float* XS = OS + TILE * LD;     // [2][TILE][LD] K or V rows of a key tile
  float* PS = XS + 2 * TILE * LD;       // [TILE][LP] P
  float* GS = PS + (size_t)TILE * LP;   // [TILE][LP] dP, then dS
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int H = gridDim.y, h = blockIdx.y, n = blockIdx.z;
  const int q0 = blockIdx.x * TILE;
  const size_t hc = (size_t)h * HD, row0 = (size_t)n * S;
  const size_t D3 = 3 * (size_t)D;
  const float scale = attn_scale<HD>();

  // the key tiles in the order the products take them: K (scores), V (O
  // and dP), K (dQ); tile t into buffer t % 2
  auto fetch = [&](int t) {
    const float* src = t / NT == 1 ? v : k;
    fb_stage<HD>(XS + (t & 1) * TILE * LD, src, row0, D, hc,
                 (t % NT) * TILE, S);
    cp_async_commit();
  };
  fb_stage<HD>(QS, q, row0, D, hc, q0, S);
  fb_stage<HD>(OS, dout, row0, D, hc, q0, S);
  fetch(0);
  float o[8][RC] = {}, dq[8][RC] = {};
  float m = -INFINITY, l = 0.f, dsum = 0.f;
  const int row = tid >> 1, part = tid & 1;  // the row phases: two a row
  for (int t = 0; t < 3 * NT; ++t) {
    if (t + 1 < 3 * NT)
      fetch(t + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t (and Q, dO) landed
    const float* X = XS + (t & 1) * TILE * LD;
    const int j0 = (t % NT) * TILE;
    if (t < NT) {  // the scores, scaled, into P (keys past S: -inf)
      float sc[8][3] = {};
      fb_nt<3>(sc, QS, LD, X, LD, HD);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int key = j0 + tx + 16 * c;
          PS[(ty + 6 * r) * LP + key] =
              key < S ? __fmul_rn(sc[r][c], scale) : -INFINITY;
        }
    } else if (t < 2 * NT) {  // O += P V, dP = dO V^T
      fb_nn<RC>(o, PS + j0, LP, X, LD, TILE);
      float dp[8][3] = {};
      fb_nt<3>(dp, OS, LD, X, LD, HD);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          GS[(ty + 6 * r) * LP + j0 + tx + 16 * c] = dp[r][c];
    } else {  // dQ += dS K
      fb_nn<RC>(dq, GS + j0, LP, X, LD, TILE);
    }
    if (t == NT - 1) {
      // each row's max and sum over keys part, part + 2, ..., then P =
      // exp(s - m) / l (keys past S: 0; exp(s - m) kept between the two)
      __syncthreads();
      float* pr = PS + row * LP;
      for (int key = part; key < S; key += 2) m = fmaxf(m, pr[key]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      for (int key = part; key < S; key += 2) {
        pr[key] = expf(pr[key] - m);
        l += pr[key];
      }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      for (int key = part; key < SP; key += 2)
        pr[key] = key < S ? pr[key] / l : 0.f;
    } else if (t == 2 * NT - 1) {
      // D = rowsum(dP * P), then dS in place (keys past S: 0)
      __syncthreads();
      const float* pr = PS + row * LP;
      float* gr = GS + row * LP;
      for (int key = part; key < S; key += 2)
        dsum = fmaf(gr[key], pr[key], dsum);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      for (int key = part; key < SP; key += 2)
        gr[key] = key < S ? __fmul_rn(__fmul_rn(pr[key],
                                                __fsub_rn(gr[key], dsum)),
                                      scale)
                          : 0.f;
      if (part == 0 && q0 + row < S) {
        float* st = stats + (((size_t)n * H + h) * S + q0 + row) * 3;
        st[0] = m;
        st[1] = l;
        st[2] = dsum;
      }
    }
    __syncthreads();  // every thread is done with buffer t % 2
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int qr = q0 + ty + 6 * r;
    if (qr >= S) continue;
#pragma unroll
    for (int c = 0; c < RC; c += 2) {
      const int dim = tx * RC + c;
      *reinterpret_cast<float2*>(ao + (row0 + qr) * D + hc + dim) =
          make_float2(o[r][c], o[r][c + 1]);
      float2 u = make_float2(dq[r][c], dq[r][c + 1]);
      if (dim < rot) u = rope_pair_t_tab(u, cosb, sinb, (size_t)qr * rot + dim);
      *reinterpret_cast<float2*>(dqkv + (row0 + qr) * D3 + hc + dim) = u;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kFBThreads, 3)
    attn_frame_bwd_f32_k(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ cosb,
                         const float* __restrict__ sinb,
                         float* __restrict__ dqkv,
                         const float* __restrict__ stats, int S, int D,
                         int rot) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int LD = fb_ld<HD>(), RC = HD / 16, TILE = kFBTile;
  constexpr int LS = kFBLdS;
  float* KS = fsm;               // [TILE][LD] K rows of the key tile
  float* VS = KS + TILE * LD;    // [TILE][LD] V rows
  float* QS = VS + TILE * LD;    // [TILE][LD] Q rows of a query tile
  float* OS = QS + TILE * LD;    // [TILE][LD] dO rows
  float* PT = OS + TILE * LD;    // [TILE][LS] P^T, key-major
  float* GT = PT + TILE * LS;    // [TILE][LS] dS^T
  float* ST = GT + TILE * LS;    // [3][TILE] m, l, D
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int H = gridDim.y, h = blockIdx.y, n = blockIdx.z;
  const int k0 = blockIdx.x * TILE;
  const size_t hc = (size_t)h * HD, row0 = (size_t)n * S;
  const size_t D3 = 3 * (size_t)D;
  const float scale = attn_scale<HD>();
  const float* frame_stats = stats + ((size_t)n * H + h) * S * 3;

  fb_stage<HD>(KS, k, row0, D, hc, k0, S);
  fb_stage<HD>(VS, v, row0, D, hc, k0, S);
  float dk[8][RC] = {}, dv[8][RC] = {};
  for (int q0 = 0; q0 < S; q0 += TILE) {
    if (q0) __syncthreads();  // every thread is done with the last tile
    fb_stage<HD>(QS, q, row0, D, hc, q0, S);
    fb_stage<HD>(OS, dout, row0, D, hc, q0, S);
    cp_async_commit();
    for (int i = tid; i < TILE; i += kFBThreads) {
      const bool ok = q0 + i < S;
      const float* st = frame_stats + (size_t)(q0 + i) * 3;
      ST[i] = ok ? st[0] : 0.f;
      ST[TILE + i] = ok ? st[1] : 1.f;
      ST[2 * TILE + i] = ok ? st[2] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    // rows: keys ty + 6 r; columns: queries tx + 16 c
    float sc[8][3] = {}, dp[8][3] = {};
    fb_nt<3>(sc, KS, LD, QS, LD, HD);
    fb_nt<3>(dp, VS, LD, OS, LD, HD);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int qi = tx + 16 * c;
      const bool ok = q0 + qi < S;
      const float m = ST[qi], l = ST[TILE + qi], dsum = ST[2 * TILE + qi];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float p = ok ? expf(__fmul_rn(sc[r][c], scale) - m) / l : 0.f;
        PT[(ty + 6 * r) * LS + qi] = p;
        GT[(ty + 6 * r) * LS + qi] =
            ok ? __fmul_rn(__fmul_rn(p, __fsub_rn(dp[r][c], dsum)), scale)
               : 0.f;
      }
    }
    __syncthreads();
    fb_nn<RC>(dk, GT, LS, QS, LD, TILE);
    fb_nn<RC>(dv, PT, LS, OS, LD, TILE);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = k0 + ty + 6 * r;
    if (j >= S) continue;
#pragma unroll
    for (int c = 0; c < RC; c += 2) {
      const int dim = tx * RC + c;
      float2 u = make_float2(dk[r][c], dk[r][c + 1]);
      if (dim < rot) u = rope_pair_t_tab(u, cosb, sinb, (size_t)j * rot + dim);
      float* o = dqkv + (row0 + j) * D3 + hc + dim;
      *reinterpret_cast<float2*>(o + D) = u;
      *reinterpret_cast<float2*>(o + 2 * (size_t)D) =
          make_float2(dv[r][c], dv[r][c + 1]);
    }
  }
}

template <int HD>
int launch_frame_f32(const float* q, const float* k, const float* v,
                     const float* dout, const float* cosb, const float* sinb,
                     float* dqkv, float* ao, float* stats, int n_frames,
                     int S, int D, int rot, cudaStream_t st) {
  const size_t smem1 = frame_bwd_f32_smem1<HD>(S);
  constexpr size_t smem2 = frame_bwd_f32_smem2<HD>();
  static size_t opted1 = 48 * 1024, opted2 = 48 * 1024;
  cudaError_t e = opt_in_smem(attn_frame_bwd_f32_q<HD>, smem1, opted1);
  if (e == cudaSuccess)
    e = opt_in_smem(attn_frame_bwd_f32_k<HD>, smem2, opted2);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(fb_keys(S) / kFBTile, D / HD, n_frames);
  attn_frame_bwd_f32_q<HD><<<grid, kFBThreads, smem1, st>>>(
      q, k, v, dout, cosb, sinb, dqkv, ao, stats, S, D, rot);
  attn_frame_bwd_f32_k<HD><<<grid, kFBThreads, smem2, st>>>(
      q, k, v, dout, cosb, sinb, dqkv, stats, S, D, rot);
  return (int)cudaGetLastError();
}

// The lane's four products a[i] * b[i], added in order (fp32).
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  float acc = 0.f;
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
  return acc;
}

__device__ __forceinline__ float4 fma4(float s, float4 x, float4 acc) {
  return make_float4(fmaf(s, x.x, acc.x), fmaf(s, x.y, acc.y),
                     fmaf(s, x.z, acc.z), fmaf(s, x.w, acc.w));
}

// attn_temporal_bwd over fp32 q, k, v, dO (a lane: four dims of a site, a
// head's HD / 4 lanes an aligned group of a warp): P and dS not rounded,
// dq, dk, dv and O stored as fp32.
template <int HD, int T>
__global__ void __launch_bounds__(kWindowThreads)
    attn_temporal_bwd_f32_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ freqs,
                                 float* __restrict__ dqkv,
                                 float* __restrict__ ao, int B, int S, int D,
                                 int valid_mask) {
  constexpr int L = HD / kLaneDimsF32;
  __shared__ float cos_t[T * HD], sin_t[T * HD];
  for (int i = threadIdx.x; i < T * HD; i += kWindowThreads)
    sincosf(freqs[i], &sin_t[i], &cos_t[i]);
  __syncthreads();
  const long long gl = (long long)blockIdx.x * kWindowThreads + threadIdx.x;
  const int G = D / kLaneDimsF32;
  const bool live = gl < (long long)B * S * G;
  const long long site = live ? gl / G : 0;
  const int col = (int)(gl - site * G) * kLaneDimsF32, hcol = col % HD;
  const long long b = site / S, s = site - b * S;
  const size_t row = (size_t)(b * T) * S + s;
  const float scale = 1.0f / sqrtf((float)HD);
  auto at = [&](int t) { return (row + (size_t)t * S) * D + col; };
  auto dqkv_at = [&](int t) {
    return dqkv + (row + (size_t)t * S) * 3 * D + col;
  };
  auto rope_t = [&](float4 u, int t) {  // rope_pair_t at frame t
    const float* c = cos_t + t * HD + hcol;
    const float* sn = sin_t + t * HD + hcol;
    const float2 a = rope_pair_t_cs(make_float2(u.x, u.y), c[0], sn[0], c[1],
                                    sn[1]);
    const float2 z = rope_pair_t_cs(make_float2(u.z, u.w), c[2], sn[2], c[3],
                                    sn[3]);
    return make_float4(a.x, a.y, z.x, z.y);
  };
  float4 qr[T], kr[T], vr[T], gr[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const size_t o = at(t);
    qr[t] = live ? __ldg(reinterpret_cast<const float4*>(q + o)) : z;
    kr[t] = live ? __ldg(reinterpret_cast<const float4*>(k + o)) : z;
    vr[t] = live ? __ldg(reinterpret_cast<const float4*>(v + o)) : z;
    gr[t] = live ? __ldg(reinterpret_cast<const float4*>(dout + o)) : z;
  }
  float pb[T][T], ds[T][T];  // P and dS, j <= i
#pragma unroll
  for (int i = 0; i < T; ++i) {
    float pr[T], dp[T];
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      pr[j] = dot4(qr[i], kr[j]);
      dp[j] = dot4(gr[i], vr[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      pr[j] = group_sum<L>(pr[j]) * scale + window_bias(valid_mask, i, j);
      dp[j] = group_sum<L>(dp[j]);
      mx = fmaxf(mx, pr[j]);
    }
    float den = 0.f;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      pr[j] = expf(pr[j] - mx);
      den += pr[j];
    }
    float dsum = 0.f;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      pr[j] = pr[j] / den;
      dsum += dp[j] * pr[j];
    }
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f), dq = o;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      pb[i][j] = pr[j];
      ds[i][j] = (pr[j] * (dp[j] - dsum)) * scale;
      o = fma4(pb[i][j], vr[j], o);
      dq = fma4(ds[i][j], kr[j], dq);
    }
    if (live) {
      *reinterpret_cast<float4*>(ao + at(i)) = o;
      *reinterpret_cast<float4*>(dqkv_at(i)) = rope_t(dq, i);
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float4 dk = make_float4(0.f, 0.f, 0.f, 0.f), dv = dk;
#pragma unroll
    for (int i = t; i < T; ++i) {
      dk = fma4(ds[i][t], qr[i], dk);
      dv = fma4(pb[i][t], gr[i], dv);
    }
    if (!live) continue;
    *reinterpret_cast<float4*>(dqkv_at(t) + D) = rope_t(dk, t);
    *reinterpret_cast<float4*>(dqkv_at(t) + 2 * (size_t)D) = dv;
  }
}

template <int HD>
int launch_temporal_f32(const float* q, const float* k, const float* v,
                        const float* dout, const float* freqs, float* dqkv,
                        float* ao, int B, int T, int S, int D, int valid_mask,
                        cudaStream_t st) {
  const long long lanes = (long long)B * S * (D / kLaneDimsF32);
  const unsigned blocks =
      (unsigned)((lanes + kWindowThreads - 1) / kWindowThreads);
  switch (T) {
#define GTAX_BWD_F32_CASE(N)                                                \
  case N:                                                                   \
    attn_temporal_bwd_f32_kernel<HD, N><<<blocks, kWindowThreads, 0, st>>>( \
        q, k, v, dout, freqs, dqkv, ao, B, S, D, valid_mask);               \
    return (int)cudaGetLastError();
    GTAX_BWD_F32_CASE(1)
    GTAX_BWD_F32_CASE(2)
    GTAX_BWD_F32_CASE(3)
    GTAX_BWD_F32_CASE(4)
    GTAX_BWD_F32_CASE(5)
    GTAX_BWD_F32_CASE(6)
    GTAX_BWD_F32_CASE(7)
    GTAX_BWD_F32_CASE(8)
#undef GTAX_BWD_F32_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace


// q, k, v, dout, ao: (n_frames * S, D) bf16, head h in columns
// [h * hd, (h + 1) * hd); cosb, sinb: (S, rot) fp32, cos and sin of the
// forward's rotary table (rot = 0: no rope); dqkv: (n_frames * S, 3D)
// bf16. S up to the shared memory's limit: 176 at hd 64, 192 at hd 32
// (cudaErrorInvalidValue past it).
GTAX_ENTRY gtax_attn_frame_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const void* cosb,
                               const void* sinb, void* dqkv, void* ao,
                               int n_frames, int S, int D, int num_heads,
                               int rot, void* stream) {
  if (n_frames <= 0 || S <= 0 || num_heads <= 0 || D % num_heads ||
      rot < 0 || rot % 2 || rot > D / num_heads)
    return (int)cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v),
             *gb = static_cast<const bf16*>(dout);
  const float* c = static_cast<const float*>(cosb);
  const float* sn = static_cast<const float*>(sinb);
  bf16* dst = static_cast<bf16*>(dqkv);
  bf16* o = static_cast<bf16*>(ao);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch_frame<32>(qb, kb, vb, gb, c, sn, dst, o, n_frames, S, D,
                              rot, st);
    case 64:
      return launch_frame<64>(qb, kb, vb, gb, c, sn, dst, o, n_frames, S, D,
                              rot, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, dout, ao: (B * T * S, D) bf16, frame-major within each batch
// element; freqs: (T, hd) fp32 temporal rotary table; dqkv: (B * T * S, 3D)
// bf16; T in 1 .. kMaxT; valid_mask: bit j = window slot j holds a real
// frame.
GTAX_ENTRY gtax_attn_temporal_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* freqs,
                                  void* dqkv, void* ao, int B, int T, int S,
                                  int D, int num_heads, int valid_mask,
                                  void* stream) {
  if (B <= 0 || T <= 0 || T > kMaxT || S <= 0 || num_heads <= 0 ||
      D % num_heads)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, dout, (const void*)dqkv, (const void*)ao})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v),
             *gb = static_cast<const bf16*>(dout);
  const float* f = static_cast<const float*>(freqs);
  bf16* dst = static_cast<bf16*>(dqkv);
  bf16* o = static_cast<bf16*>(ao);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch_temporal_t<32>(qb, kb, vb, gb, f, dst, o, B, T, S, D,
                                   valid_mask, st);
    case 64:
      return launch_temporal_t<64>(qb, kb, vb, gb, f, dst, o, B, T, S, D,
                                   valid_mask, st);
    case 128:
      return launch_temporal_t<128>(qb, kb, vb, gb, f, dst, o, B, T, S, D,
                                    valid_mask, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fp32 form of gtax_attn_frame_bwd: q, k, v, dout, ao (n_frames * S,
// D) fp32, dqkv (n_frames * S, 3D) fp32, cos/sin (S, rot) fp32; stats
// (n_frames, num_heads, S, 3) fp32 scratch (each query row's softmax max,
// sum and rowsum(dP * P), pass 1 to pass 2). S up to 432 at head dim 64,
// 528 at 32 (cudaErrorInvalidValue past it).
GTAX_ENTRY gtax_attn_frame_bwd_f32(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* cosb, const void* sinb,
                                   void* dqkv, void* ao, void* stats,
                                   int n_frames, int S, int D, int num_heads,
                                   int rot, void* stream) {
  if (n_frames <= 0 || S <= 0 || num_heads <= 0 || D % num_heads ||
      rot < 0 || rot % 2 || rot > D / num_heads || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, dout, (const void*)dqkv, (const void*)ao})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *gf = static_cast<const float*>(dout);
  const float* c = static_cast<const float*>(cosb);
  const float* sn = static_cast<const float*>(sinb);
  float* dst = static_cast<float*>(dqkv);
  float* o = static_cast<float*>(ao);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch_frame_f32<32>(qf, kf, vf, gf, c, sn, dst, o, st, n_frames,
                                  S, D, rot, s);
    case 64:
      return launch_frame_f32<64>(qf, kf, vf, gf, c, sn, dst, o, st, n_frames,
                                  S, D, rot, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fp32 form of gtax_attn_temporal_bwd: q, k, v, dout, ao (B * T * S,
// D) fp32, dqkv (B * T * S, 3D) fp32, freqs (T, hd) fp32.
GTAX_ENTRY gtax_attn_temporal_bwd_f32(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* freqs, void* dqkv, void* ao,
                                      int B, int T, int S, int D,
                                      int num_heads, int valid_mask,
                                      void* stream) {
  if (B <= 0 || T <= 0 || T > kMaxT || S <= 0 || num_heads <= 0 ||
      D % num_heads || D % kLaneDimsF32)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, dout, (const void*)dqkv, (const void*)ao})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *gf = static_cast<const float*>(dout);
  const float* f = static_cast<const float*>(freqs);
  float* dst = static_cast<float*>(dqkv);
  float* o = static_cast<float*>(ao);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch_temporal_f32<32>(qf, kf, vf, gf, f, dst, o, B, T, S, D,
                                     valid_mask, st);
    case 64:
      return launch_temporal_f32<64>(qf, kf, vf, gf, f, dst, o, B, T, S, D,
                                     valid_mask, st);
    case 128:
      return launch_temporal_f32<128>(qf, kf, vf, gf, f, dst, o, B, T, S, D,
                                      valid_mask, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
