#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gtax_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits nonzero and prints no result line):
  1. environment: torch version, device, `nvidia-smi` name and power limit;
  2. build: nvcc builds gtax_torch/csrc/*.cu for sm_90a (timed); `[sass]`:
     cuobjdump's SASS of the library, where the fp32 kernels (F32_KERNELS)
     must hold FFMAs and no tensor-core instruction (no TF32), and the
     fp32 pairs (F32_PAIRS) the int8 IGMMA and no HMMA / HGMMA but the
     compiler's no-op GMMA (NOOP_GMMA, also in every int8 GEMM); the fp32
     GEMMs' main loops (gemm_f32_fwd_kernel, gemm_f32_bwd_kernel): FFMAs
     of the loop's instructions and how many reuse an operand;
  3. kernels: each of the sixteen kernel wrappers (five bf16 and four
     int8 W8A8 serving wrappers, the two paired int8 half-blocks, the two
     attention kernels of the `pallas` backend, three training backwards)
     at its main-path shapes (DiT-S/2 and ViT-L/20 widths; the B=16
     training step) and at batch 2, and the forward branches' emit_train
     mode, against the plain PyTorch versions on the same inputs (bf16
     both; tolerance 2**-6 of each output's largest magnitude, four bf16
     ulps); CUDA-event times of the kernel, the plain version and a
     library yardstick (for a backward: autograd's backward of the library
     composite forward; for the attention kernels SDPA, with the same bias
     as attn_mask where there is a mask), with the L2 cache flushed before
     every timed call; the bound from bytes and operations (bf16 and int8
     peaks); for each bf16 output the rounding-point figures (the share of
     elements that differ from the plain version's, the largest difference
     over its largest magnitude); whether a second call gives the same
     bits (a failure for the split-K serving kernels, BIT_STABLE). Each
     pair is also held against the two sequential int8
     wrappers on the same inputs (max error and bit equality printed) and
     timed against them at 1-4 frames (`[gate]`). For fused_spatial_branch,
     fused_mlp_branch and fused_temporal_step (144 rows), fused_vae_block
     (decode N=6), fused_mha_token_major (the VAE shape),
     fused_temporal_branch (the prefill's emit_kv, 576 rows, and emit_train
     at B=16), fused_spatial_branch_bwd, fused_temporal_branch_bwd and
     fused_mlp_branch_bwd (B=16) one call is split by launch (`[split]`:
     each launch's CUDA-event ms and share, the gap before it, TFLOP/s for
     each GEMM, the call alone without events; the byte bounds of
     attn_frame_bwd and of the temporal attention launches), and each pair
     at one frame by phase (the probe copy of pair_q: each of its nine
     phases and eight grid barriers, gtax_torch/tools/split.py).
     `[temporal]`: at the B=16 window and the prefill's, the rope
     epilogue's q, k, v bit-equal to the fp32 product through
     attn_temporal's rope, attn_temporal_window and attn_temporal_bwd alone
     against their plain versions (with the rounding figures), and
     fused_temporal_branch_bwd given the forward's mod rows bit-equal to
     it forming them. The int8 wrappers' emit_train mode (#7-#9, the
     forward of int8-forward training) at the B=16 training shape: every
     output against the plain version, the output bit-equal to the call
     without emit_train, timed beside torch._int_mm composites, with the
     int8 GEMMs' K plan at 11,520 rows. The exact GELU (approx_gelu=False)
     of #2 (bf16), #9 and the pairs #10 / #11 at the step's shapes under the
     same 2**-6 rule, each pair bit-equal to its sequential wrappers in
     that mode (each row's "exact_gelu"). Rows 1-5 in fp32 (`[kernel] ...
     fp32`, each row's "fp32"): the fp32 forms at the main shapes against
     their plain versions within F32_TOL (1e-4) of the plain output's
     largest magnitude, timed beside the plain version and the fp32
     library composite (no TF32), the bound from the bytes and 67 TFLOP/s
     of fp32 FFMA; the MLP and the VAE block split by launch. Rows 6-11,
     15 and 16 in fp32: the int8 wrappers and pairs over fp32
     activations within INT8_F32_TOL (2**-6, the int8 rule) of the plain
     output's largest magnitude, with each fp32 output's share of elements
     beyond 1e-4 of it printed, each pair bit-equal to its fp32 sequential
     wrappers in both GELU modes; the fp32 `pallas` attention at the
     model's three shapes within F32_TOL; timed beside the fp32 library
     composites, the bound from the bytes, the int8 ops and fp32 FFMA.
     The fp32 training forms at B=16 (`[kernel] ... fp32` after the bf16
     training rows, each row's "fp32" or its "fp32" "emit_train"): #1-#3
     emit_train and the backwards #12-#14 within F32_TOL of the plain
     version's largest magnitude, #7-#9 emit_train within INT8_F32_TOL,
     the backwards bit-equal across two calls, timed beside the fp32
     library composites (autograd for a backward), bound at 67 TFLOP/s;
     #12-#14 in fp32 split by launch (`[split]`, each product's TFLOP/s;
     for #12 attn_frame_bwd_f32's ms beside its bound and useful
     TFLOP/s), and #2's fp32 emit_train at B=16 (ln_mod, fc1, fc2: each
     launch's ms and share, each GEMM's TFLOP/s; #5's fp32 decode split
     is `[kernel]`'s, with attn_frame_f32's share);
  4. end to end, bf16: VideoGenerator at full DiT-S/2 + ViT-L/20 width,
     B=1, 4 prompt frames + 2 generated, 100 noise steps, random seeded
     weights with nonzero adaLN heads, injected noise. The launch counters
     are zeroed just before this run and read just after it: all five bf16
     kernels must have launched. Then the incremental rollout against the
     full-window rollout on the card, and a depth-2 full-width rollout on
     the card against the port's CPU rollout (plain versions);
     `[e2e fp32]`: the same generate with ServingConfig(dtype="float32")
     (the seeded weights, not cast) under `fused`: the fp32 forms of #1-#5
     launched exactly as often as the bf16 run's, incremental against full
     window and depth-2 card against CPU under `fused`, `fused_all` and
     `xla` within E2E_F32_TOL (1e-3) of the latents' largest magnitude,
     s/frame and encode / decode ms; then fp32 with int8 (`fused` and
     `fused_all`) and under `pallas` (with and without int8), F32_MODES:
     one generate each with the counts f32_mode_expected gives (the bf16
     int8 run's, the bf16 `pallas` run's), s/frame, and a depth-2 rollout
     card vs CPU within E2E_F32_TOL; the fp32 int8 step at B=4 (#6);
  5. end to end, int8: the same run with quantize="int8" (the same bf16
     weights, quantized): every step pairs each half-block, the prefill
     runs the sequential wrappers, and the counts must be the ones the
     code gives (INT8_EXPECTED). Then int8 incremental against int8 full
     window, a depth-2 int8 rollout on the card against the port's CPU
     one, one full-depth step at B=4 (sequential; its counts read alone)
     against the B=1 paired step, and the int8 forward against the bf16
     one (relative L2 error): gated at gtax's 2e-2 at depth 2 on gtax's
     own weight regime carried to full width; reported beside it, that
     regime as written and the smoke's weights at depth 2 and full depth;
     and gtax's gate as gtax writes it, the fp32 int8 forward against the
     fp32 dense one (2e-2, the same regime);
  6. end to end, `pallas` (`[e2e pallas]`): the same generate with
     attention_backend="pallas": full-window rollouts through the unfused
     branches, every attention on fused_mha_token_major (the counts by
     sequence length must be the code's, PALLAS_EXPECTED), the unfused
     VAE; a depth-2 rollout on the card against the port's CPU one and
     against the card's `xla` rollout. `[sdpa]`: the public
     nn.attention.sdpa under `pallas` at the three shapes, which
     fused_sdpa serves, in bf16 and in fp32;
  7. training (`[train]`): a Trainer built from
     configs/train_dit_actions.yaml's values (DiT-S/2 at full width and
     depth, frozen ViT-L/20, B=16, bf16, fused_all, mu_bf16) with the cuts
     TRAIN_CUTS prints, 3 steps through the training loop, with every
     launch count zeroed before and read after: the three backward
     wrappers 16/16/32 times a micro-step. Gates: finite losses and grad
     norms, moved parameters, one B=2 micro-batch's gradients through the
     kernels against the plain path (the xla_* branches under autograd) on
     the card, and a depth-2 model's card gradients against the port's CPU
     gradients (relative L2 per leaf, GRAD_TOL). The step's frozen-VAE
     encode (unfused, as gtax's trainer) is timed beside the fused one.
     Then the training modes, from the same DiT init and VAE:
     `[train int8]` (int8_forward, 3 steps: launches a micro-step #7 16,
     #8 16, #9 32, #12 16, #13 16, #14 32 and none of #1-#3, asserted;
     one micro-step's gradients against the bf16 forward's, GRAD_TOL;
     loss, step time, MFU, device busy and peak memory beside the bf16
     step's), `[train remat]` (remat: true; one B=16 micro-step's loss and
     every gradient bit-equal to remat off, peak memory of each; full
     steps in turns), `[train backends]` (xla, fused, fused_mlp: a B=2
     micro-step each against fused_all's gradients, GRAD_TOL, with the
     launches each backend's path must make; pallas refused before a
     step), `[train fp32]` (compute_dtype float32 under fused_all at full
     width and depth, B=16, 3 steps: launches a micro-step #1 16, #2 32,
     #3 16, #12 16, #13 16, #14 32 (F32_TRAIN_PATH), asserted; finite
     losses, moved parameters, step time, MFU at the fp32 peak, device
     busy, peak memory; one B=2 micro-batch's kernel-path gradients
     against the plain path on the card and the depth-2 card gradients
     against the CPU's within F32_GRAD_TOL (1e-3) relative L2 a leaf,
     median and largest printed; `[train int8] [fp32]`: one B=16
     int8_forward micro-step over fp32 activations, #7 16, #8 16, #9 32
     and none of #1-#3, gradients against the fp32 dense forward's
     (GRAD_TOL); `[train backends] [fp32]`: xla, fused and fused_mlp B=2
     micro-steps against fused_all's within F32_GRAD_TOL) and `[train
     stacked]` (unstack_train: false, B=2, 2 steps: losses within 1e-6 of
     the unstacked run, the masters' largest relative difference
     printed). `[e2e stacked]` (in phase 4): one
     generated frame with ServingConfig(unstack=False), bit-equal to the
     unstacked rollout without the conditioning cache on the same noise.
  8. the approximate serving modes (`[e2e approx]`), at full width cut to
     APPROX_DEPTH blocks of the bf16 weights (the timed rollouts at 16
     blocks took 115-178 s of a 1,200 s budget): the pyramid-pipelined
     rollout (bf16 P=4
     with the conditioning cache and incremental decoding, int8 P=4 and
     P=2) and attention broadcast (K=2: bf16 `fused` and `fused_all`,
     int8), each one generate with every launch count and every DiT call
     kind zeroed before and read after, held to the counts the code gives
     (approx_expected; #6 and #4 at four live rows, #10/#11 at two); its
     s/frame and the exact rollout's in turns in the same process (exact,
     mode, mode, exact, each run printed), DiT evaluations a generated
     frame; from the same starting noise its
     latents against the exact rollout's (PSNR / SSIM of the decoded
     frames), the pipelined incremental rollout against its full window,
     broadcast at K=1 bit-equal to the exact rollout, and at depth 2 every
     mode (and the other backends gtax allows for it) on the card against
     the port's CPU rollout (2**-5 of the latents' largest magnitude).
     `[kernel]` also times #1, #2, #7 and #9 at four frames, #4 and #6 at
     four live rows and #11 at two: the pipelined steps' shapes.
  9. checkpoints, resume, export, the latent cache and the evals
     (`[train resume]`): configs/train_dit_actions.yaml at full width and
     depth with the cuts RESUME_CUTS prints (B=2, 3 steps, a save at step
     2). One trainer runs steps 1-3 and saves the full state and the
     weight export at step 2 (timed, with their bytes); a second trainer
     resumes from that state (timed) and runs step 3 with every training
     launch count zeroed before and read after (#1-#3 with emit_train,
     #12-#14, a micro-step's counts); its loss and every master equal the
     first trainer's within a relative L2 of 1e-6 (bit equality printed).
     The export, read back by the port, is bit-equal to the masters at
     step 2. A latent cache built from the same clips with the trainer's
     VAE gives the pixel step's loss within 1e-6 (bit equality printed);
     the step with and without it is timed in turns. predict_frames (2
     generated frames, cut from 32) and predict_noise run #1-#3 over the
     full window (counts asserted against the DiT calls, every rollout
     latent finite), timed; whether the mp4 and the grid were written, or
     which library is missing, is printed.
 10. more than one process (gtax_torch/parallel/mesh.py), as child ranks of
     this script once the parent has freed its card memory. With one card
     two ranks share it over gloo (NCCL refuses two ranks on one device;
     collectives go through the host), said in the output; with two or
     more, `[dp train]`, `[dp serve]` and `[tp serve]` run over NCCL on two
     cards. `[nccl]`: one rank at world size 1 over NCCL runs the
     one-process B=16 step of configs/train_dit_actions.yaml (TRAIN_CUTS;
     DiT-S/2 at full width cut to DP_DEPTH blocks) that `[dp train]` is
     held against, and times the all-reduce of its gradients (0.62 GB
     fp32) at world size 1 (no link crossed). `[dp train]`: the same
     model, two ranks of B=8 from the same init and the same 16
     clips (rank r rows 8r..8r+7): step 1's loss and grad norm and each
     gradient leaf against the reference (DP_TOL), and each master's
     update there over the elements whose reference gradient is not zero
     within rounding (ZERO_GRAD, DP_TOL), the launches of a micro-step
     (#1, #3, #12 and #13 DP_DEPTH each, #2 and #14 twice that), the
     ranks' masters bit-equal after steps 1 and 3; a
     save at step 2 and a second trainer on each rank resuming into step 3
     (RESUME_TOL, bit equality printed); step_time_s, the all-reduce's ms
     and the peak memory on each rank. `[dp serve]`: ServingConfig(
     mesh_data=2), bf16 and int8, one row a rank, 4 prompt frames + 2
     generated, 100 steps: each rank's latents bit-equal to the one-rank
     rollout of its row with its seed (run before the rank joins the
     group), its launches the single-card path's (INT8_EXPECTED for
     int8), the ranks' latents different, s/frame. `[tp serve]`: mesh_model=2, bf16, `xla`, DiT-S/2 at full width
     cut to TP_DEPTH blocks, nonzero out / fc2 biases: the rollout on
     injected noise against the one-process `xla` rollout (TP_TOL of the
     latents' largest magnitude), which the same rollout with those biases
     doubled (a rank adding them before the sum) must exceed, the ranks'
     latents bit-equal, s/frame of both (its adaLN heads are
     all-gathered: gloo takes CUDA tensors there too). `[tp train]`:
     mesh_model=2, B=2, bf16, DiT-S/2 at full width cut to TP_DEPTH
     blocks, under `xla` and `fused_all`: one step's loss, grad norm and
     every leaf's gradient (gathered whole) against the one-process step
     run before the group (GRAD_TOL), the model ranks' losses bit-equal,
     and each rank's launches of #1-#3 and #12-#14 in the step (the
     blocks' fused trainable branches on gathered weights under
     `fused_all`, none under `xla`);
 11. `[aot]`: child processes of this script, each a VideoGenerator with
     an aot_dir generating one frame from injected noise: "cold" builds
     the kernel library with nvcc into an empty directory and saves it,
     "warm" loads it with nvcc off PATH and CUDA_HOME empty, "corrupt"
     meets a garbage artifact, fails to load it, builds and overwrites it;
     each one's AOT events against gtax's contract, its frame bit-equal to
     the cold one's, and its seconds from start to first frame;
 12. `[http serve]`: gtax_torch.cli.serve at its defaults (int8 on the
     fused kernels) on port 0: /healthz, a /generate with a PNG made by
     zlib (its mp4, headers, and the launches of #5 and #7-#11 in it
     against HTTP_INT8), a 400 and a 404; then a --quantize none server's
     request, which launches #1-#5. Without PIL the request is a 400 and
     the handler's own generate_pixels runs on a decoded frame instead.
Each end-to-end phase also traces one generated frame or train step
(`[profile]`); `[time]` lines give each phase's seconds.
`python -m gtax_torch.tools.step_profile` splits one denoise step into
host and card time; `python -m gtax_torch.tools.gemm_sweep` times the bf16
GEMM against cuBLAS at the main paths' products.

The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {...}}. Needs one GPU; imports nothing of JAX or
gtax.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, data sheet
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak, data sheet
F32_FLOPS_PER_S = 67e12        # fp32 on the CUDA cores (FFMA), data sheet
# the fp32 forms of #1-#5 against their plain versions (both fp32, only
# the summation order and expf / sincosf / erfc's last bits differ): of
# the plain output's largest magnitude; also the fp32 `pallas` attention's
# (#15, #16)
F32_TOL = 1e-4
# the fp32 forms of #6-#11 (the int8 rule, stated before their first run:
# a summation order can flip an int8 rounding of an activation, which
# moves its row's outputs by up to a step of its scale), of the plain
# output's largest magnitude
INT8_F32_TOL = 2.0**-6
# [e2e fp32]: card against CPU and incremental against full window, of
# the latents' largest magnitude (fp32 summation orders through 5-202 DiT
# calls)
E2E_F32_TOL = 1e-3
D, H, HD = 1024, 16, 64
S_DIT, S_VAE = 144, 576


def log(*args):
    print(*args, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ------------------------------------------------------------------ timing

class Timer:
    """Median CUDA-event time of one call, L2 flushed before each call and
    the stream held for `hold_ms` so the host has enqueued the whole call
    before the card reaches it: the events then time the card's work alone,
    not gaps where it waits for the host (a wrapper takes 0.1-0.2 ms of host
    time, a plain version more, a denoise step ~10 ms)."""

    CYCLES_PER_MS = 1.98e6  # the H100's boost clock

    def __init__(self, iters=15, hold_ms=10.0):
        self.iters = iters
        self.hold = int(hold_ms * self.CYCLES_PER_MS)
        self.flush = torch.empty(128 * 2**20, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(self.iters)]
        for start, end in pairs:
            self.flush.zero_()
            torch.cuda._sleep(self.hold)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(n_bytes, n_flops, n_int8_ops=0, flops_per_s=BF16_FLOPS_PER_S):
    """The larger of the bytes over the memory rate and the operations over
    their type's peak (bf16 flops, or fp32 ones at F32_FLOPS_PER_S; int8
    ops)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / flops_per_s + n_int8_ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------------ inputs

def rand(gen, shape, std=1.0, dtype=torch.bfloat16, offset=0.0):
    a = gen.standard_normal(shape).astype(np.float32) * std + offset
    return torch.from_numpy(a).to(device="cuda", dtype=dtype)


def branch_inputs(gen, N, S, dt=torch.bfloat16):
    x = rand(gen, (N, S, D), dtype=dt)
    mods = rand(gen, (N, 6 * D), 0.5, dt)  # (N, D) views as dit_cond gives
    return x, mods[:, :D], mods[:, D:2 * D], mods[:, 2 * D:3 * D]


def library_linear(a, w, b=None):
    """F.linear on (in, out) kernels, cuBLAS bf16."""
    return torch.nn.functional.linear(a, w.t(), b)


def spatial_freqs():
    """The DiT's axial rope table over its 9x16 patch grid, (144, 64)."""
    from gtax_torch.core import rope

    return rope.axial_freqs(rope.pixel_freqs(HD // 2, 256.0), (9, 16),
                            pixel=True).reshape(S_DIT, HD).cuda()


def temporal_freqs(T):
    """The DiT's temporal rope table over T window slots, (T, 64)."""
    from gtax_torch.core import rope

    return rope.temporal_rope_freqs(torch.arange(T),
                                    rope.lang_freqs(HD)).cuda()


def live_keys(n_ctx, n_live):
    """Keys the live query slots of a step attend to (causal): n_ctx +
    i + 1 for live slot i."""
    return n_live * n_ctx + n_live * (n_live + 1) // 2


def live_mask(valid, n_ctx, n_live):
    """SDPA's attn_mask for a step's live query slots over the window
    (causal; a key slot open when valid or on the diagonal), as keywords;
    none at one live slot, where the library composite reads the whole
    window as before."""
    if n_live == 1:
        return {}
    T = n_ctx + n_live
    q = torch.arange(n_ctx, T)[:, None]
    k = torch.arange(T)[None, :]
    allow = (k <= q) & (torch.as_tensor(valid)[None, :] | (k == q))
    return {"attn_mask": allow.cuda()}


# ------------------------------------------------------------ the kernels

def kernel_cases(dt=torch.bfloat16):
    """(name, label, main, builder) per kernel and shape; builder returns
    (kernel_fn, plain_fn, library_fn, library_desc, bytes, flops). dt =
    torch.float32: the fp32 forms of #1-#5 at their main shapes (inputs,
    weights and the library composite in fp32, under strict_matmul)."""
    from gtax_torch.core import rope
    from gtax_torch.kernels import block, vae_block

    F = torch.nn.functional
    sfreqs = spatial_freqs()

    def lib_mod(x, sh, sc):
        ln = F.layer_norm(x, (D,), eps=1e-6)
        return ln * (1 + sc[:, None]) + sh[:, None]

    def lib_rope(t, f):
        f = f.to(t.dtype)
        return t * torch.cos(f) + rope.rotate_half(t) * torch.sin(f)

    def spatial(N):
        gen = np.random.default_rng(N)
        x, sh, sc, g = branch_inputs(gen, N, S_DIT, dt)
        qw, ow = rand(gen, (D, 3 * D), 0.02, dt), rand(gen, (D, D), 0.02, dt)
        ob = rand(gen, (D,), 0.02, dt)
        args = (x, sh, sc, g, qw, ow, ob, sfreqs, H)

        def lib():
            qkv = library_linear(lib_mod(x, sh, sc), qw)
            q, k, v = (t.view(N, S_DIT, H, HD).transpose(1, 2)
                       for t in qkv.split(D, -1))
            f = sfreqs[None, None]
            o = F.scaled_dot_product_attention(lib_rope(q, f), lib_rope(k, f),
                                               v)
            y = library_linear(o.transpose(1, 2).reshape(N, S_DIT, D), ow, ob)
            return x + g[:, None] * y

        by = nbytes(x, sh, sc, g, qw, ow, ob, sfreqs, x)
        fl = 2 * N * S_DIT * D * 4 * D + 4 * N * H * S_DIT * S_DIT * HD
        return (lambda: block.fused_spatial_branch(*args),
                lambda: block.spatial_branch_plain(*args), lib,
                "F.layer_norm+F.linear+SDPA+F.linear (cuBLAS, flash)", by, fl)

    def mlp(N, approx_gelu=True):
        gen = np.random.default_rng(10 + N)
        x, sh, sc, g = branch_inputs(gen, N, S_DIT, dt)
        w1 = rand(gen, (D, 4 * D), 0.02, dt)
        w2 = rand(gen, (4 * D, D), 0.02, dt)
        b1, b2 = rand(gen, (4 * D,), 0.02, dt), rand(gen, (D,), 0.02, dt)
        args = (x, sh, sc, g, w1, b1, w2, b2)
        kw = {"approx_gelu": approx_gelu}

        def lib():
            h = F.gelu(library_linear(lib_mod(x, sh, sc), w1, b1),
                       approximate="tanh" if approx_gelu else "none")
            return x + g[:, None] * library_linear(h, w2, b2)

        by = nbytes(x, sh, sc, g, w1, b1, w2, b2, x)
        fl = 2 * 2 * N * S_DIT * D * 4 * D
        return (lambda: block.fused_mlp_branch(*args, **kw),
                lambda: block.mlp_branch_plain(*args, **kw), lib,
                "F.layer_norm+F.linear+F.gelu+F.linear (cuBLAS)", by, fl)

    def temporal(B, T=4):
        gen = np.random.default_rng(20 + B)
        N = B * T
        x, sh, sc, g = branch_inputs(gen, N, S_DIT, dt)
        qw, ow = rand(gen, (D, 3 * D), 0.02, dt), rand(gen, (D, D), 0.02, dt)
        ob = rand(gen, (D,), 0.02, dt)
        f = temporal_freqs(T)
        valid = [False] + [True] * (T - 1)
        args = (x, sh, sc, g, qw, ow, ob, f, valid, H, T)
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device="cuda"))

        def lib():
            qkv = library_linear(lib_mod(x, sh, sc), qw)
            q, k, v = (t.view(B, T, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
                       for t in qkv.split(D, -1))
            o = F.scaled_dot_product_attention(
                lib_rope(q, f), lib_rope(k, f), v, attn_mask=mask)
            y = library_linear(o.permute(0, 3, 1, 2, 4).reshape(N, S_DIT, D),
                               ow, ob)
            return x + g[:, None] * y

        by = nbytes(x, sh, sc, g, qw, ow, ob, f) + 3 * nbytes(x)
        fl = (2 * N * S_DIT * D * 4 * D
              + 4 * B * S_DIT * H * (T * (T + 1) // 2) * HD)
        return (lambda: block.fused_temporal_branch(*args, emit_kv=True),
                lambda: block.temporal_branch_plain(*args, emit_kv=True),
                lib, "F.layer_norm+F.linear+SDPA(causal mask)+F.linear",
                by, fl)

    def step(B, n_ctx=4, n_live=1):
        gen = np.random.default_rng(30 + B + 10 * (n_live - 1))
        N = B * n_live
        x, sh, sc, g = branch_inputs(gen, N, S_DIT, dt)
        qw, ow = rand(gen, (D, 3 * D), 0.02, dt), rand(gen, (D, D), 0.02, dt)
        ob = rand(gen, (D,), 0.02, dt)
        kc = rand(gen, (B * n_ctx * S_DIT, D), dtype=dt)
        vc = rand(gen, (B * n_ctx * S_DIT, D), dtype=dt)
        T = n_ctx + n_live
        f = temporal_freqs(T)
        valid = torch.tensor([False] + [True] * (T - 1))
        args = (x, sh, sc, g, qw, ow, ob, kc, vc, f, valid, H, n_ctx)
        kw = live_mask(valid, n_ctx, n_live)

        def lib():
            qkv = library_linear(lib_mod(x, sh, sc), qw)
            q, k, v = (t.view(B, n_live, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
                       for t in qkv.split(D, -1))
            ck, cv = (t.view(B, n_ctx, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
                      for t in (kc, vc))
            keys = torch.cat([ck, lib_rope(k, f[n_ctx:])], dim=3)
            vals = torch.cat([cv, v], dim=3)
            o = F.scaled_dot_product_attention(lib_rope(q, f[n_ctx:]), keys,
                                               vals, **kw)
            y = library_linear(o.permute(0, 3, 1, 2, 4).reshape(N, S_DIT, D),
                               ow, ob)
            return x + g[:, None] * y

        by = nbytes(x, sh, sc, g, qw, ow, ob, kc, vc, f, x)
        fl = (2 * N * S_DIT * D * 4 * D
              + 4 * B * S_DIT * H * live_keys(n_ctx, n_live) * HD)
        return (lambda: block.fused_temporal_step(*args, n_live=n_live),
                lambda: block.temporal_step_plain(*args, n_live=n_live), lib,
                "F.layer_norm+F.linear+SDPA over cache+F.linear", by, fl)

    def vae(N):
        gen = np.random.default_rng(40 + N)
        x = rand(gen, (N, S_VAE, D), dtype=dt)
        f32 = torch.float32
        ln = [rand(gen, (D,), 0.1, f32, 1.0), rand(gen, (D,), 0.1, f32)] * 2
        w = [rand(gen, (D, 3 * D), 0.03, dt), rand(gen, (D, D), 0.03, dt),
             rand(gen, (D, 4 * D), 0.03, dt), rand(gen, (4 * D, D), 0.02, dt)]
        b = [rand(gen, (n,), 0.02, f32) for n in (3 * D, D, 4 * D, D)]
        rf = rope.axial_freqs(rope.pixel_freqs(HD // 4, 576.0), (18, 32),
                              pixel=True).reshape(S_VAE, HD // 2).cuda()
        args = (x, ln[0], ln[1], w[0], b[0], w[1], b[1], ln[2], ln[3], w[2],
                b[2], w[3], b[3], rf, H)
        bb = [t.to(dt) for t in b]
        rot = HD // 2

        def lib():
            h = F.layer_norm(x, (D,), ln[0].to(dt), ln[1].to(dt), 1e-6)
            qkv = library_linear(h, w[0], bb[0])
            q, k, v = (t.view(N, S_VAE, H, HD).transpose(1, 2)
                       for t in qkv.split(D, -1))
            q = torch.cat([lib_rope(q[..., :rot], rf), q[..., rot:]], -1)
            k = torch.cat([lib_rope(k[..., :rot], rf), k[..., rot:]], -1)
            o = F.scaled_dot_product_attention(q, k, v)
            xm = x + library_linear(o.transpose(1, 2).reshape(N, S_VAE, D),
                                    w[1], bb[1])
            h = F.layer_norm(xm, (D,), ln[2].to(dt), ln[3].to(dt), 1e-6)
            h = F.gelu(library_linear(h, w[2], bb[2]))
            return xm + library_linear(h, w[3], bb[3])

        by = nbytes(x, *ln, *w, *b, rf, x)
        fl = 2 * N * S_VAE * D * 12 * D + 4 * N * H * S_VAE * S_VAE * HD
        return (lambda: vae_block.fused_vae_block(*args),
                lambda: vae_block.vae_block_plain(*args), lib,
                "F.layer_norm+F.linear+SDPA+F.linear+F.gelu MLP (cuBLAS, "
                "flash)", by, fl)

    if dt == torch.float32:  # the fp32 forms at the main-path shapes
        return [
            ("fused_spatial_branch", "step N=1 (B=1), fp32",
             lambda: spatial(1)),
            ("fused_mlp_branch", "step N=1 (B=1), fp32", lambda: mlp(1)),
            ("fused_temporal_branch", "prefill emit_kv B=1 T=4, fp32",
             lambda: temporal(1)),
            ("fused_temporal_step", "step B=1 n_ctx=4, fp32",
             lambda: step(1)),
            ("fused_vae_block", "decode N=6 (B=1, 6 frames), fp32",
             lambda: vae(6)),
        ]
    return [
        # name, replaces (TPU kernel), shape label, main shape?, builder
        ("fused_spatial_branch", "gtax/kernels/block.py:846",
         "step N=1 (B=1)", True, lambda: spatial(1)),
        ("fused_spatial_branch", "gtax/kernels/block.py:846",
         "step N=2 (B=2)", False, lambda: spatial(2)),
        ("fused_spatial_branch", "gtax/kernels/block.py:846",
         "N=4: prefill, pipelined step P=4", False, lambda: spatial(4)),
        ("fused_mlp_branch", "gtax/kernels/block.py:779",
         "step N=1 (B=1)", True, lambda: mlp(1)),
        ("fused_mlp_branch", "gtax/kernels/block.py:779",
         "step N=2 (B=2)", False, lambda: mlp(2)),
        ("fused_mlp_branch", "gtax/kernels/block.py:779",
         "N=4: prefill, pipelined step P=4", False, lambda: mlp(4)),
        ("fused_mlp_branch", "gtax/kernels/block.py:779",
         "step N=1 (B=1), approx_gelu=False", False,
         lambda: mlp(1, approx_gelu=False)),
        ("fused_temporal_branch", "gtax/kernels/block.py:687",
         "prefill emit_kv B=1 T=4", True, lambda: temporal(1)),
        ("fused_temporal_branch", "gtax/kernels/block.py:687",
         "prefill emit_kv B=2 T=4", False, lambda: temporal(2)),
        ("fused_temporal_step", "gtax/kernels/block.py:518",
         "step B=1 n_ctx=4", True, lambda: step(1)),
        ("fused_temporal_step", "gtax/kernels/block.py:518",
         "step B=2 n_ctx=4", False, lambda: step(2)),
        ("fused_temporal_step", "gtax/kernels/block.py:518",
         "pipelined step P=4: n_live=4 n_ctx=1", False,
         lambda: step(1, 1, 4)),
        ("fused_vae_block", "gtax/kernels/vae_block.py:150",
         "decode N=6 (B=1, 6 frames)", True, lambda: vae(6)),
        ("fused_vae_block", "gtax/kernels/vae_block.py:150",
         "encode N=4 (B=1, 4 prompt frames)", False, lambda: vae(4)),
        ("fused_vae_block", "gtax/kernels/vae_block.py:150",
         "decode N=12 (B=2, 6 frames)", False, lambda: vae(12)),
    ]


def lib_quant(a):
    """Per-row int8 of fp32 rows (M, K) in plain torch ops."""
    s = a.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(a / s).to(torch.int8), s


def col_major(w_q):
    """An (in, out) int8 kernel stored column-major, the layout torch._int_mm
    is commonly fed."""
    return w_q.t().contiguous().t()


def lib_qlinear(a32, w_q, w_s, b=None):
    """int8 linear through torch._int_mm (cuBLASLt int8): rows quantized
    per row; w_q (in, out) int8, column-major, with per-column scales."""
    lead = a32.shape[:-1]
    q, s = lib_quant(a32.reshape(-1, a32.shape[-1]))
    y = torch._int_mm(q, w_q).float() * s * w_s.reshape(-1)
    y = y if b is None else y + b.float()
    return y.reshape(*lead, -1)


def int8_lib_mod(x, sh, sc):
    F = torch.nn.functional
    ln = F.layer_norm(x.float(), (D,), eps=1e-6)
    return ln * (1 + sc.float()[:, None]) + sh.float()[:, None]


def int8_lib_rope(t, f, dt=torch.bfloat16):
    from gtax_torch.core import rope

    return (t * torch.cos(f) + rope.rotate_half(t) * torch.sin(f)).to(dt)


def int8_gated(x, g, y):
    return (x.float() + g.float()[:, None] * y).to(x.dtype)


def lib_int8_spatial(x, sh, sc, g, w, sfreqs):
    """The int8 spatial branch as torch._int_mm + SDPA; w = (qkv_q, qkv_s,
    out_q, out_s, out_b) with the int8 kernels column-major; the attention
    in x's dtype."""
    N, dt = x.shape[0], x.dtype
    qkv = lib_qlinear(int8_lib_mod(x, sh, sc), w[0], w[1])
    q, k, v = (t.view(N, S_DIT, H, HD).transpose(1, 2)
               for t in qkv.split(D, -1))
    f = sfreqs[None, None]
    o = torch.nn.functional.scaled_dot_product_attention(
        int8_lib_rope(q, f, dt), int8_lib_rope(k, f, dt), v.to(dt))
    y = lib_qlinear(o.transpose(1, 2).reshape(N, S_DIT, D).float(), w[2],
                    w[3], w[4])
    return int8_gated(x, g, y)


def lib_int8_temporal(x, sh, sc, g, w, f, B, T):
    """The int8 temporal branch over a causal window of T frames, as
    lib_int8_spatial."""
    N, dt = B * T, x.dtype
    qkv = lib_qlinear(int8_lib_mod(x, sh, sc), w[0], w[1])
    q, k, v = (t.view(B, T, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
               for t in qkv.split(D, -1))
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device="cuda"))
    o = torch.nn.functional.scaled_dot_product_attention(
        int8_lib_rope(q, f, dt), int8_lib_rope(k, f, dt), v.to(dt),
        attn_mask=mask)
    y = lib_qlinear(o.permute(0, 3, 1, 2, 4).reshape(N, S_DIT, D).float(),
                    w[2], w[3], w[4])
    return int8_gated(x, g, y)


def lib_int8_step(x, sh, sc, g, w, kc, vc, f, n_ctx, n_live=1, kw=None):
    """The int8 temporal step over the cached context, as
    lib_int8_spatial; kw: live_mask's keywords."""
    N, dt = x.shape[0], x.dtype
    B = N // n_live
    qkv = lib_qlinear(int8_lib_mod(x, sh, sc), w[0], w[1])
    q, k, v = (t.view(B, n_live, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
               for t in qkv.split(D, -1))
    ck, cv = (t.view(B, n_ctx, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
              for t in (kc, vc))
    keys = torch.cat([ck, int8_lib_rope(k, f[n_ctx:], dt)], dim=3)
    vals = torch.cat([cv, v.to(dt)], dim=3)
    o = torch.nn.functional.scaled_dot_product_attention(
        int8_lib_rope(q, f[n_ctx:], dt), keys, vals, **(kw or {}))
    y = lib_qlinear(o.permute(0, 3, 1, 2, 4).reshape(N, S_DIT, D).float(),
                    w[2], w[3], w[4])
    return int8_gated(x, g, y)


def lib_int8_mlp(x, sh, sc, g, w1_cm, w1_s, b1, w2_cm, w2_s, b2, G=512,
                 approx_gelu=True):
    """The int8 MLP branch, requantized per 512-wide chunk, as
    torch._int_mm calls."""
    N = x.shape[0]
    h = torch.nn.functional.gelu(
        lib_qlinear(int8_lib_mod(x, sh, sc), w1_cm, w1_s, b1),
        approximate="tanh" if approx_gelu else "none").reshape(-1, 4 * D)
    y = 0.0
    for c in range(4 * D // G):
        hq, hs = lib_quant(h[:, c * G:(c + 1) * G])
        y = y + torch._int_mm(hq, w2_cm[c * G:(c + 1) * G]) * hs
    y = y * w2_s.reshape(-1) + b2.float()
    return int8_gated(x, g, y.reshape(N, S_DIT, D))


def qweight(gen, shape):
    from gtax_torch.kernels import quant

    return quant.quantize_weight(rand(gen, shape, 0.02))


def int8_attn_weights(gen, dt=torch.bfloat16):
    """int8 kernels and their fp32 scales, the bias in the compute dtype
    (fp32 serving keeps its params fp32)."""
    return (*qweight(gen, (D, 3 * D)), *qweight(gen, (D, D)),
            rand(gen, (D,), 0.02, dt))


def int8_mlp_weights(gen, dt=torch.bfloat16):
    w1, w2 = qweight(gen, (D, 4 * D)), qweight(gen, (4 * D, D))
    return (*w1, rand(gen, (4 * D,), 0.02, dt), *w2,
            rand(gen, (D,), 0.02, dt))


def col_major_attn(w):
    return (col_major(w[0]), w[1], col_major(w[2]), w[3], w[4])


def col_major_mlp(w):
    return (col_major(w[0]), w[1], w[2], col_major(w[3]), w[4], w[5])


def int8_kernel_cases(dt=torch.bfloat16):
    """The int8 (W8A8) wrappers, as kernel_cases; each case also returns the
    int8 tensor-core operations. dt = torch.float32: the fp32 forms of
    #6-#9 at their main shapes (fp32 activations, biases and context cache;
    the library composite's attention in fp32)."""
    from gtax_torch.kernels import quant

    sfreqs = spatial_freqs()

    def spatial(N):
        gen = np.random.default_rng(50 + N)
        x, sh, sc, g = branch_inputs(gen, N, S_DIT, dt)
        w = int8_attn_weights(gen, dt)
        args = (x, sh, sc, g, *w, sfreqs, H)
        wc = col_major_attn(w)
        M = N * S_DIT
        by = nbytes(x, sh, sc, g, *w, sfreqs, x)
        return (lambda: quant.fused_spatial_branch_q(*args),
                lambda: quant.spatial_branch_q_plain(*args),
                lambda: lib_int8_spatial(x, sh, sc, g, wc, sfreqs),
                "LN+int8 quant+torch._int_mm+SDPA+torch._int_mm", by,
                4 * N * H * S_DIT * S_DIT * HD, 2 * M * D * 4 * D)

    def mlp(N, approx_gelu=True):
        gen = np.random.default_rng(60 + N)
        x, sh, sc, g = branch_inputs(gen, N, S_DIT, dt)
        w = int8_mlp_weights(gen, dt)
        args = (x, sh, sc, g, *w)
        wc = col_major_mlp(w)
        by = nbytes(x, sh, sc, g, *w, x)
        kw = {"approx_gelu": approx_gelu}
        return (lambda: quant.fused_mlp_branch_q(*args, **kw),
                lambda: quant.mlp_branch_q_plain(*args, **kw),
                lambda: lib_int8_mlp(x, sh, sc, g, *wc,
                                     approx_gelu=approx_gelu),
                "LN+int8 quant+torch._int_mm+F.gelu+8 torch._int_mm", by, 0,
                2 * 2 * N * S_DIT * D * 4 * D)

    def temporal(B, T=4):
        gen = np.random.default_rng(70 + B)
        N = B * T
        x, sh, sc, g = branch_inputs(gen, N, S_DIT, dt)
        w = int8_attn_weights(gen, dt)
        f = temporal_freqs(T)
        valid = [False] + [True] * (T - 1)
        args = (x, sh, sc, g, *w, f, valid, H, T)
        wc = col_major_attn(w)
        by = nbytes(x, sh, sc, g, *w, f) + 3 * nbytes(x)
        return (lambda: quant.fused_temporal_branch_q(*args, emit_kv=True),
                lambda: quant.temporal_branch_q_plain(*args, emit_kv=True),
                lambda: lib_int8_temporal(x, sh, sc, g, wc, f, B, T),
                "LN+int8 quant+torch._int_mm+SDPA(causal)+"
                "torch._int_mm", by,
                4 * B * S_DIT * H * (T * (T + 1) // 2) * HD,
                2 * N * S_DIT * D * 4 * D)

    def step(B, n_ctx=4, n_live=1):
        gen = np.random.default_rng(80 + B + 10 * (n_live - 1))
        N = B * n_live
        x, sh, sc, g = branch_inputs(gen, N, S_DIT, dt)
        w = int8_attn_weights(gen, dt)
        kc = rand(gen, (B * n_ctx * S_DIT, D), dtype=dt)
        vc = rand(gen, (B * n_ctx * S_DIT, D), dtype=dt)
        T = n_ctx + n_live
        f = temporal_freqs(T)
        valid = torch.tensor([False] + [True] * (T - 1))
        args = (x, sh, sc, g, *w, kc, vc, f, valid, H, n_ctx)
        wc = col_major_attn(w)
        kw = live_mask(valid, n_ctx, n_live)
        by = nbytes(x, sh, sc, g, *w, kc, vc, f, x)
        return (lambda: quant.fused_temporal_step_q(*args, n_live=n_live),
                lambda: quant.temporal_step_q_plain(*args, n_live=n_live),
                lambda: lib_int8_step(x, sh, sc, g, wc, kc, vc, f, n_ctx,
                                      n_live, kw),
                "LN+int8 quant+torch._int_mm+SDPA over cache+"
                "torch._int_mm", by,
                4 * B * S_DIT * H * live_keys(n_ctx, n_live) * HD,
                2 * N * S_DIT * D * 4 * D)

    if dt == torch.float32:  # the fp32 forms at the main-path shapes
        return [
            ("fused_spatial_branch_q", "step N=1 (B=1), fp32",
             lambda: spatial(1)),
            ("fused_mlp_branch_q", "step 144 rows (B=1), fp32",
             lambda: mlp(1)),
            ("fused_mlp_branch_q", "step 144 rows (B=1), approx_gelu=False, "
             "fp32", lambda: mlp(1, approx_gelu=False)),
            ("fused_temporal_branch_q", "prefill emit_kv B=1 T=4, fp32",
             lambda: temporal(1)),
            ("fused_temporal_step_q", "step B=1 n_ctx=4, fp32",
             lambda: step(1)),
        ]
    return [
        ("fused_spatial_branch_q", "gtax/kernels/quant.py:368",
         "step N=1 (B=1)", True, lambda: spatial(1)),
        ("fused_spatial_branch_q", "gtax/kernels/quant.py:368",
         "step N=2 (B=2)", False, lambda: spatial(2)),
        ("fused_spatial_branch_q", "gtax/kernels/quant.py:368",
         "N=4: prefill, pipelined step P=4", False, lambda: spatial(4)),
        ("fused_mlp_branch_q", "gtax/kernels/quant.py:530",
         "step 144 rows (B=1)", True, lambda: mlp(1)),
        ("fused_mlp_branch_q", "gtax/kernels/quant.py:530",
         "step 288 rows (B=2)", False, lambda: mlp(2)),
        ("fused_mlp_branch_q", "gtax/kernels/quant.py:530",
         "576 rows: prefill, pipelined step P=4", False, lambda: mlp(4)),
        ("fused_mlp_branch_q", "gtax/kernels/quant.py:530",
         "step 144 rows (B=1), approx_gelu=False", False,
         lambda: mlp(1, approx_gelu=False)),
        ("fused_temporal_branch_q", "gtax/kernels/quant.py:427",
         "prefill emit_kv B=1 T=4", True, lambda: temporal(1)),
        ("fused_temporal_branch_q", "gtax/kernels/quant.py:427",
         "prefill emit_kv B=2 T=4", False, lambda: temporal(2)),
        ("fused_temporal_step_q", "gtax/kernels/quant.py:216",
         "step B=1 n_ctx=4", True, lambda: step(1)),
        ("fused_temporal_step_q", "gtax/kernels/quant.py:216",
         "step B=2 n_ctx=4", False, lambda: step(2)),
        ("fused_temporal_step_q", "gtax/kernels/quant.py:216",
         "pipelined step P=4: n_live=4 n_ctx=1", False,
         lambda: step(1, 1, 4)),
    ]


def pair_inputs(gen, N, dt=torch.bfloat16):
    """x and the six per-frame vectors of a half-block, (N, D) views of one
    (N, 6D) adaLN row as dit_cond gives them."""
    x = rand(gen, (N, S_DIT, D), dtype=dt)
    mods = rand(gen, (N, 6 * D), 0.5, dt)
    return (x, *(mods[:, i * D:(i + 1) * D] for i in range(6)))


def pair_case(kind, N, seed, n_live=1, approx_gelu=True, dt=torch.bfloat16):
    """(kernel_fn, plain_fn, library_fn, library_desc, bytes, flops, int8
    ops, sequential_fn) of one paired half-block: kind "spatial" over N
    frames, "temporal" the step of N live rows, B = N / n_live elements
    of n_live live slots each over a (5 - n_live)-frame cache (4 at one
    live slot) with slot 0 padded ("temporal-valid": every slot real);
    approx_gelu: the MLP's GELU (tanh, or the exact one); dt: the
    activations' dtype (fp32: the fp32 pairs of csrc/pair_q_f32.cu)."""
    from gtax_torch.kernels import pair, quant

    kw = {"approx_gelu": approx_gelu}
    gen = np.random.default_rng(seed)
    x, sh1, sc1, g1, sh2, sc2, g2 = vec = pair_inputs(gen, N, dt)
    wa, wm = int8_attn_weights(gen, dt), int8_mlp_weights(gen, dt)
    wac, wmc = col_major_attn(wa), col_major_mlp(wm)
    M = N * S_DIT
    i8 = 2 * M * D * (3 * D + D + 2 * 4 * D)
    if kind == "spatial":
        f = spatial_freqs()
        args = (*vec, *wa, *wm, f, H)
        by = nbytes(*vec, *wa, *wm, f, x)

        def seq():
            h = quant.fused_spatial_branch_q(x, sh1, sc1, g1, *wa, f, H)
            return quant.fused_mlp_branch_q(h, sh2, sc2, g2, *wm, **kw)

        def lib():
            h = lib_int8_spatial(x, sh1, sc1, g1, wac, f)
            return lib_int8_mlp(h, sh2, sc2, g2, *wmc, **kw)

        return (lambda: pair.fused_spatial_pair_q(*args, **kw),
                lambda: pair.spatial_pair_q_plain(*args, **kw), lib,
                "the int8 spatial + MLP composites (torch._int_mm, SDPA)",
                by, 4 * N * H * S_DIT * S_DIT * HD, i8, seq)
    B, n_ctx = N // n_live, 4 if n_live == 1 else 5 - n_live
    kc = rand(gen, (B * n_ctx * S_DIT, D), dtype=dt)
    vc = rand(gen, (B * n_ctx * S_DIT, D), dtype=dt)
    f = temporal_freqs(n_ctx + n_live)
    valid = [kind == "temporal-valid"] + [True] * (n_ctx + n_live - 1)
    tail = (kc, vc, f, valid, H, n_ctx)
    args = (*vec, *wa, *wm, *tail)
    by = nbytes(*vec, *wa, *wm, kc, vc, f, x)

    mask = live_mask(valid, n_ctx, n_live)

    def seq():
        h = quant.fused_temporal_step_q(x, sh1, sc1, g1, *wa, *tail,
                                        n_live=n_live)
        return quant.fused_mlp_branch_q(h, sh2, sc2, g2, *wm, **kw)

    def lib():
        h = lib_int8_step(x, sh1, sc1, g1, wac, kc, vc, f, n_ctx, n_live,
                          mask)
        return lib_int8_mlp(h, sh2, sc2, g2, *wmc, **kw)

    return (lambda: pair.fused_temporal_pair_q(*args, n_live=n_live, **kw),
            lambda: pair.temporal_pair_q_plain(*args, n_live=n_live, **kw),
            lib,
            "the int8 step + MLP composites (torch._int_mm, SDPA)", by,
            4 * B * S_DIT * H * live_keys(n_ctx, n_live) * HD, i8, seq)


PAIR_CASES = [
    # name, replaces, label, main?, (kind, N, seed)
    ("fused_spatial_pair_q", "gtax/kernels/pair.py:227", "step N=1 (B=1)",
     True, ("spatial", 1, 90)),
    ("fused_spatial_pair_q", "gtax/kernels/pair.py:227", "step N=2 (B=2)",
     False, ("spatial", 2, 91)),
    ("fused_temporal_pair_q", "gtax/kernels/pair.py:303",
     "step B=1 n_ctx=4, slot 0 padded", True, ("temporal", 1, 92)),
    ("fused_temporal_pair_q", "gtax/kernels/pair.py:303",
     "step B=1 n_ctx=4, slot 0 valid", False, ("temporal-valid", 1, 93)),
    ("fused_temporal_pair_q", "gtax/kernels/pair.py:303",
     "step B=2 n_ctx=4, slot 0 padded", False, ("temporal", 2, 94)),
    ("fused_temporal_pair_q", "gtax/kernels/pair.py:303",
     "pipelined step P=2: n_live=2 n_ctx=3", False, ("temporal", 2, 95, 2)),
    ("fused_spatial_pair_q", "gtax/kernels/pair.py:227",
     "step N=1 (B=1), approx_gelu=False", False, ("spatial", 1, 96, 1, False)),
    ("fused_temporal_pair_q", "gtax/kernels/pair.py:303",
     "step B=1 n_ctx=4, slot 0 padded, approx_gelu=False", False,
     ("temporal", 1, 97, 1, False)),
]


def pair_phase(timer, rows):
    """Rows 10-11: each pair against its plain version (via measure), then
    against the two sequential int8 wrappers on the same inputs (the same
    device code, so equal is expected; the max error and the equality are
    printed, and the error is held to the same tolerance), timed beside
    them. Then the pair against the sequential pair at N = 1..4 frames (B
    = 1..4 for the temporal step): the numbers for choosing Hopper's gate
    (gtax's is 2)."""
    from gtax_torch.kernels import pair

    grids = {kind: pair.grid_blocks(kind == "temporal", HD, S_DIT, D)
             for kind in ("spatial", "temporal")}
    log(f"[kernel] pair kernels' cooperative grids (blocks of 256 threads "
        f"co-resident on {torch.cuda.get_device_properties(0).multi_processor_count}"
        f" SMs): {json.dumps(grids)}")
    for name, replaces, label, main, spec in PAIR_CASES:
        kern, plain, lib, lib_desc, by, fl, i8, seq = pair_case(*spec)
        m = measure(timer, name, label, kern, plain, lib, by, fl, i8)
        got, ref = kern(), seq()
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        equal = bool(torch.equal(got, ref))
        seq_ms = timer(seq)
        log(f"[kernel] {name:25s} {label:36s} vs the sequential wrappers: "
            f"max_abs_err={err:.3g} bit_equal={equal}; pair ms={m['ms']:.4f}"
            f" sequential ms={seq_ms:.4f}")
        if not err <= m["tolerance"]:
            fail(f"{name} [{label}] disagrees with the sequential wrappers")
        if "pipelined" in label:
            rows[name].setdefault("pipelined", {})[label] = dict(
                m, sequential_ms=seq_ms, sequential_bit_equal=equal)
        if "approx_gelu=False" in label:  # the exact GELU: bit-equal too
            if not equal:
                fail(f"{name} [{label}] is not bit-equal to the sequential "
                     "wrappers")
            rows[name]["exact_gelu"] = dict(
                m, sequential_ms=seq_ms, sequential_bit_equal=equal)
        if main:
            rows[name] = {"name": name, "route": "cuda",
                          "source": "gtax_torch/kernels/pair.py",
                          "replaces": replaces, "launches": None, **m,
                          "library": lib_desc, "sequential_ms": seq_ms,
                          "sequential_max_abs_err": err,
                          "sequential_bit_equal": equal}
        del kern, plain, lib, seq
    sweep = {}
    for kind, name in (("spatial", "fused_spatial_pair_q"),
                       ("temporal", "fused_temporal_pair_q")):
        for N in (1, 2, 3, 4):
            kern, *_, seq = pair_case(kind, N, 100 + N)
            p1, s1, s2, p2 = timer(kern), timer(seq), timer(seq), timer(kern)
            pms, sms = (p1 + p2) / 2, (s1 + s2) / 2
            sweep.setdefault(name, {})[N] = {"pair_ms": pms,
                                             "sequential_ms": sms}
            log(f"[gate] {name} N={N}: pair {pms:.4f} ms, sequential "
                f"{sms:.4f} ms (pair/sequential {pms / sms:.3f}; turns "
                f"{p1:.4f} {s1:.4f} {s2:.4f} {p2:.4f})")
            del kern, seq
    for name, by_n in sweep.items():
        rows[name]["pair_vs_sequential"] = by_n
    from gtax_torch.tools.split import pair_phases

    for kind, name in (("spatial", "fused_spatial_pair_q"),
                       ("temporal", "fused_temporal_pair_q")):
        rows[name]["phase_split"] = pair_phases(kind, 1, log=log)


def attention_cases(dt=torch.bfloat16):
    """(name, replaces, label, main, make) of the `pallas` backend's two
    kernels at the three attention shapes of the model; make returns
    (kernel_fn, plain_fn, library_fn, library_desc, bytes, flops). With a
    mask or causality the kernel reads the additive (S, S) bias, and the
    library call is SDPA with the same bias as attn_mask; without, the
    kernel reads none (the bias would be all zeros), so the bytes count
    none and SDPA gets no mask. dt = torch.float32: the fp32 form, its q,
    k, v and SDPA's in fp32."""
    from gtax_torch.kernels import attention as kattn

    F = torch.nn.functional

    def temporal_mask(T=5):
        valid = torch.tensor([False] + [True] * (T - 1))
        return torch.tril(torch.ones(T, T, dtype=torch.bool)) & (
            valid[None, :] | torch.eye(T, dtype=torch.bool))

    def biased(S, mask, causal):
        """(the bias the kernel reads, as a tuple, SDPA's keywords)"""
        if mask is None and not causal:
            return (), {}
        bias = kattn.build_bias(S, mask, causal, "cuda")
        return (bias,), {"attn_mask": bias.to(dt)}

    def sdpa(N, S, mask=None, causal=False):
        gen = np.random.default_rng(500 + S)
        q, k, v = (rand(gen, (N, S, HD), dtype=dt) for _ in range(3))
        bias = kattn.build_bias(S, mask, causal, "cuda")
        read, kw = biased(S, mask, causal)
        return (lambda: kattn.fused_sdpa(q, k, v, mask, causal),
                lambda: kattn.sdpa_plain(q, k, v, bias),
                lambda: F.scaled_dot_product_attention(q, k, v, **kw),
                "SDPA(attn_mask=bias)" if kw else "SDPA",
                nbytes(q, k, v, *read, q), 4 * N * S * S * HD)

    def mha(N, S, mask=None):
        gen = np.random.default_rng(600 + S)
        q, k, v = (rand(gen, (N, S, D), dtype=dt) for _ in range(3))
        bias = kattn.build_bias(S, mask, False, "cuda")
        read, kw = biased(S, mask, False)

        def heads(t):
            return t.view(N, S, H, HD).transpose(1, 2)

        return (lambda: kattn.fused_mha_token_major(q, k, v, H, mask),
                lambda: kattn.mha_token_major_plain(q, k, v, bias, H),
                lambda: F.scaled_dot_product_attention(
                    heads(q), heads(k), heads(v), **kw),
                ("SDPA(attn_mask=bias)" if kw else "SDPA")
                + " on (N, h, S, d) views",
                nbytes(q, k, v, *read, q), 4 * N * H * S * S * HD)

    sd, mh = "gtax/kernels/attention.py:90", "gtax/kernels/attention.py:198"
    return [
        ("fused_sdpa", sd, "S=144 d=64, 80 rows (5 frames x 16 heads)",
         True, lambda: sdpa(80, S_DIT)),
        ("fused_sdpa", sd, "S=5 causal+keys, 2304 rows (144 sites x 16)",
         False, lambda: sdpa(2304, 5, [False] + [True] * 4, True)),
        ("fused_sdpa", sd, "S=576 d=64, 96 rows (6 frames x 16 heads)",
         False, lambda: sdpa(96, S_VAE)),
        ("fused_mha_token_major", mh, "spatial (5, 144, 1024), B=1", True,
         lambda: mha(5, S_DIT)),
        ("fused_mha_token_major", mh, "temporal (144, 5, 1024), causal",
         False, lambda: mha(S_DIT, 5, temporal_mask())),
        ("fused_mha_token_major", mh, "VAE decode (6, 576, 1024)", False,
         lambda: mha(6, S_VAE)),
    ]


SOURCES = {
    "fused_sdpa": "gtax_torch/kernels/attention.py",
    "fused_mha_token_major": "gtax_torch/kernels/attention.py",
    "fused_spatial_branch": "gtax_torch/kernels/block.py",
    "fused_mlp_branch": "gtax_torch/kernels/block.py",
    "fused_temporal_branch": "gtax_torch/kernels/block.py",
    "fused_temporal_step": "gtax_torch/kernels/block.py",
    "fused_vae_block": "gtax_torch/kernels/vae_block.py",
    "fused_spatial_branch_q": "gtax_torch/kernels/quant.py",
    "fused_mlp_branch_q": "gtax_torch/kernels/quant.py",
    "fused_temporal_branch_q": "gtax_torch/kernels/quant.py",
    "fused_temporal_step_q": "gtax_torch/kernels/quant.py",
}


# the kernels whose split-K sums must add in a fixed order: two calls on
# the same inputs give the same bits
BIT_STABLE = ("fused_mlp_branch", "fused_spatial_branch",
              "fused_temporal_branch", "fused_temporal_step",
              "fused_spatial_branch_q",
              "fused_mlp_branch_q", "fused_temporal_branch_q",
              "fused_temporal_step_q", "fused_spatial_pair_q",
              "fused_temporal_pair_q")


def measure(timer, name, label, kern, plain, lib, by, fl, *i8, rel_tol=None,
            flops_per_s=BF16_FLOPS_PER_S):
    """Run the kernel and its plain version on the same inputs, hold every
    output against the plain one (2**-6 of its largest magnitude, at least
    2**-6; rel_tol: that share of its largest magnitude), time the kernel,
    the plain version and the library yardstick, and compute the bound (by:
    bytes, fl: flops at flops_per_s, i8: int8 ops)."""
    from gtax_torch.utils.profiling import bf16_differences

    got, ref, again = kern(), plain(), kern()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    again = again if isinstance(again, tuple) else (again,)
    stable = all(torch.equal(a, b) for a, b in zip(got, again))
    err, tol, ratio = 0.0, 0.0, 0.0  # tol: that of the worst output
    share, rel = 0.0, 0.0  # the rounding-point figures of the worst output
    beyond = 0.0  # fp32 outputs: the share of elements beyond F32_TOL
    for a, b in zip(got, ref):
        if not torch.isfinite(a.float()).all():
            fail(f"{name} [{label}]: non-finite output")
        e = (a.float() - b.float()).abs().max().item()
        t = (2.0**-6 * max(1.0, b.float().abs().max().item())
             if rel_tol is None else rel_tol * b.float().abs().max().item())
        err = max(err, e)
        if e / t >= ratio:
            ratio, tol = e / t, t
        if a.dtype == torch.bfloat16:
            sh, rl = bf16_differences(a, b)
            share, rel = max(share, sh), max(rel, rl)
        elif a.dtype == torch.float32:
            beyond = max(beyond, ((a - b).abs() > F32_TOL * b.abs().max())
                         .float().mean().item())
    ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(lib)
    bms, by_what = bound_ms(by, fl, *i8, flops_per_s=flops_per_s)
    ops = f"{fl / 1e9:.2f} GFLOP" + (f", {i8[0] / 1e9:.2f} int8 GOP"
                                      if i8 else "")
    log(f"[kernel] {name:25s} {label:36s} max_abs_err={err:.3g} "
        f"(worst output err/tol {ratio:.3g}, its tol {tol:.3g}; bf16 "
        f"outputs: {share:.3e} of elements differ, max diff {rel:.3e} of "
        f"the largest magnitude) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by_what}; "
        f"{by / 1e6:.1f} MB, {ops}); two calls bit-equal: {stable}"
        + (f"; fp32 outputs: {beyond:.3e} of elements beyond {F32_TOL:g} of "
           "the largest magnitude" if any(a.dtype == torch.float32
                                          for a in got) else ""))
    if not ratio <= 1.0:
        fail(f"{name} [{label}] disagrees with its plain version: an output "
             f"is off by {ratio:.3g} times its tolerance")
    if not stable and name in BIT_STABLE:
        fail(f"{name} [{label}]: two calls on the same inputs differ")
    return {"two_calls_bit_equal": stable,
            "max_abs_err": err, "tolerance": tol, "err_over_tol": ratio,
            "bf16_differ": share, "max_diff_over_max": rel,
            "f32_beyond_1e-4": beyond, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by_what,
            "library_ms": lib_ms, "shape": label}


def kernel_phase():
    timer = Timer()
    rows = {}
    for name, replaces, label, main, make in (kernel_cases()
                                              + int8_kernel_cases()
                                              + attention_cases()):
        kern, plain, lib, lib_desc, *rest = make()
        m = measure(timer, name, label, kern, plain, lib, *rest)
        if "pipelined" in label:  # the main row comes first
            rows[name].setdefault("pipelined", {})[label] = m
        if "approx_gelu=False" in label:  # the exact-GELU epilogues
            rows[name]["exact_gelu"] = m
        if name == "fused_mha_token_major" and "VAE" in label:
            check_attn_dispatch()
            split = launch_split(kern, f"{name} [{label}]", [])
            rows[name]["vae_launch_split"] = split
        if main:
            rows[name] = {"name": name, "route": "cuda",
                          "source": SOURCES[name], "replaces": replaces,
                          "launches": None, **m, "library": lib_desc}
            if name == "fused_vae_block":  # qkv, out-proj, fc1, fc2
                M = 6 * S_VAE
                rows[name]["launch_split"] = launch_split(
                    kern, f"{name} [{label}]",
                    [2 * M * D * n for n in (3 * D, D, 4 * D, 4 * D)])
            if name == "fused_mlp_branch":  # ln_mod, fc1, fc2
                rows[name]["launch_split"] = launch_split(
                    kern, f"{name} [{label}]", [2 * S_DIT * D * 4 * D] * 2)
            if name in ("fused_spatial_branch", "fused_temporal_step"):
                # ln_mod, qkv, the attention, the out-projection
                rows[name]["launch_split"] = launch_split(
                    kern, f"{name} [{label}]",
                    [2 * S_DIT * D * 3 * D, 2 * S_DIT * D * D])
            if name == "fused_temporal_branch":  # the prefill's 576 rows
                M = 4 * S_DIT
                split = launch_split(kern, f"{name} [{label}]",
                                     [2 * M * D * 3 * D, 2 * M * D * D])
                rows[name]["launch_split"] = split
                rows[name]["attention_bound"] = temporal_attention_bound(
                    split, M, 2)
    pair_phase(timer, rows)
    f32_phase(timer, rows)
    return rows


def f32_phase(timer, rows):
    """Rows 1-5 in fp32 (`[kernel] ... fp32`): each fp32 form at its main
    shape against its plain version (F32_TOL of the plain output's largest
    magnitude), timed beside the plain version and the fp32 library
    composite (cuBLAS SGEMM under strict_matmul: no TF32; SDPA in fp32),
    the bound from the bytes and the fp32 FFMA peak. Recorded in each
    row's "fp32"; its launches come from `[e2e fp32]`."""
    # the GEMMs' flops by launch, for the split of the VAE block and the MLP
    gemms = {"fused_vae_block": [2 * 6 * S_VAE * D * n
                                 for n in (3 * D, D, 4 * D, 4 * D)],
             "fused_mlp_branch": [2 * S_DIT * D * 4 * D] * 2}
    for name, label, make in kernel_cases(torch.float32):
        kern, plain, lib, lib_desc, by, fl = make()
        m = measure(timer, name, label, kern, plain, lib, by, fl,
                    rel_tol=F32_TOL, flops_per_s=F32_FLOPS_PER_S)
        rows[name]["fp32"] = dict(m, launches=None,
                                  library=lib_desc + ", fp32")
        if name in gemms:  # each launch's ms and the GEMMs' TFLOP/s
            split = launch_split(kern, f"{name} [{label}]", gemms[name])
            rows[name]["fp32"]["launch_split"] = split
            if name == "fused_vae_block":
                att = [e for e in split
                       if e.get("kernel") == "gtax_attn_frame_f32"]
                share = sum(e["share"] for e in att)
                log(f"[split]   attn_frame_f32's share of #5 fp32: "
                    f"{100 * share:.1f}% ({sum(e['ms'] for e in att):.4f} ms)")
                rows[name]["fp32"]["attn_frame_f32_share"] = share
        del kern, plain, lib
    f32_int8_phase(timer, rows)


# the fp32 pairs at the step's shapes, in both GELU modes: (name, label,
# main, pair_case's spec)
PAIR_F32_CASES = [
    ("fused_spatial_pair_q", "step N=1 (B=1), fp32", True, ("spatial", 1, 90)),
    ("fused_spatial_pair_q", "step N=1 (B=1), approx_gelu=False, fp32",
     False, ("spatial", 1, 96, 1, False)),
    ("fused_temporal_pair_q", "step B=1 n_ctx=4, slot 0 padded, fp32", True,
     ("temporal", 1, 92)),
    ("fused_temporal_pair_q", "step B=1 n_ctx=4, slot 0 padded, "
     "approx_gelu=False, fp32", False, ("temporal", 1, 97, 1, False)),
]


def f32_record(rows, name, label, main, rec):
    """A row's fp32 figures: the main shape's in "fp32", the others (and
    the exact GELU's) beside them."""
    if main:
        rows[name]["fp32"] = {**rec, **{k: v for k, v in rows[name].get(
            "fp32", {}).items() if k in ("exact_gelu", "other_shapes")}}
    elif "approx_gelu=False" in label:
        rows[name].setdefault("fp32", {})["exact_gelu"] = rec
    else:
        rows[name].setdefault("fp32", {}).setdefault("other_shapes",
                                                      {})[label] = rec


def f32_int8_phase(timer, rows):
    """Rows 6-11, 15 and 16 in fp32 (`[kernel] ... fp32`): the int8
    wrappers and the pairs at x.dtype = float32 (fp32 activations, biases
    and context cache) within INT8_F32_TOL of the plain output's largest
    magnitude (the int8 rule; each output's share of elements beyond
    F32_TOL of it printed), each pair bit-equal to its fp32 sequential
    wrappers in both GELU modes; the fp32 `pallas` attention within F32_TOL
    at the model's three attention shapes. Timed beside the plain version
    and the library composite in fp32 (torch._int_mm, SDPA in fp32, no
    TF32), the bound from the bytes (int8 weights, fp32 activations), the
    int8 operations and the fp32 attention's FFMA."""
    f32 = torch.float32
    for name, label, make in int8_kernel_cases(f32):
        kern, plain, lib, lib_desc, by, fl, i8 = make()
        m = measure(timer, name, label, kern, plain, lib, by, fl, i8,
                    rel_tol=INT8_F32_TOL, flops_per_s=F32_FLOPS_PER_S)
        f32_record(rows, name, label, "approx_gelu" not in label,
                   dict(m, launches=None, library=lib_desc + ", fp32"))
        del kern, plain, lib
    for name, label, main, spec in PAIR_F32_CASES:
        kern, plain, lib, lib_desc, by, fl, i8, seq = pair_case(*spec, dt=f32)
        m = measure(timer, name, label, kern, plain, lib, by, fl, i8,
                    rel_tol=INT8_F32_TOL, flops_per_s=F32_FLOPS_PER_S)
        got, ref = kern(), seq()
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, ref))
        seq_ms = timer(seq)
        log(f"[kernel] {name:25s} {label:36s} vs the fp32 sequential "
            f"wrappers: bit_equal={equal}; pair ms={m['ms']:.4f} sequential "
            f"ms={seq_ms:.4f}")
        if not equal:
            fail(f"{name} [{label}] is not bit-equal to the fp32 sequential "
                 "wrappers")
        f32_record(rows, name, label, main, dict(
            m, launches=None, library=lib_desc + ", fp32",
            sequential_ms=seq_ms, sequential_bit_equal=equal))
        del kern, plain, lib, seq
    for name, replaces, label, main, make in attention_cases(f32):
        kern, plain, lib, lib_desc, by, fl = make()
        m = measure(timer, name, label + ", fp32", kern, plain, lib, by, fl,
                    rel_tol=F32_TOL, flops_per_s=F32_FLOPS_PER_S)
        rec = dict(m, launches=None, library=lib_desc + ", fp32")
        if name == "fused_mha_token_major" and "temporal" not in label:
            rec["launch_split"] = attn_sdpa_f32_split(kern, label, fl, m)
        f32_record(rows, name, label, main, rec)
        del kern, plain, lib


def attn_sdpa_f32_split(kern, label, fl, m):
    """#16 fp32 by launch (`[split]`): its one attn_sdpa_f32 launch's ms and
    FFMA TFLOP/s (4 S^2 d a head), beside the row's bound and fp32 SDPA's
    time from `measure`."""
    split = launch_split(kern, f"fused_mha_token_major [{label}, fp32]", [])
    ms = next(e["ms"] for e in split
              if e.get("kernel") == "gtax_attn_sdpa_f32")
    log(f"[split]   #16 fp32 {label}: gtax_attn_sdpa_f32 {ms:.4f} ms, "
        f"{fl / 1e9:.2f} GFLOP at {fl / ms / 1e9:.1f} TFLOP/s; bound "
        f"{m['bound_ms']:.4f} ms ({m['bound_by']}), fp32 SDPA "
        f"{m['library_ms']:.4f} ms")
    return split


F32_KERNELS = ("attn_frame_f32_kernel", "attn_window_f32_kernel",
               "attn_temporal_f32_kernel", "ln_mod_kernelIf",
               "attn_sdpa_rows_f32_kernel", "attn_sdpa_f32_tile_kernel",
               "attn_sdpa_f32_wide_kernel", "attn_frame_bwd_f32_q",
               "attn_frame_bwd_f32_k", "attn_temporal_bwd_f32_kernel",
               "gate_bwd_kernelIfE", "ln_mod_bwd_kernelILi16EfE",
               "gemm_f32_bwd_kernel", "gemm_f32_fwd_kernel",
               "gemm_f32_serve_kernel")
# the fp32 kernels whose main loop [sass] reads (FFMA share, operand
# reuse): the GEMMs' forms and the `pallas` attention's tiled body
F32_GEMMS = ("gemm_f32_fwd_kernel", "gemm_f32_bwd_kernel",
             "gemm_f32_serve_kernel", "attn_sdpa_f32_tile_kernel",
             "attn_sdpa_f32_wide_kernel")
# the fp32 pairs, pair_q_kernel<hd, temporal, exact, float>: 2 x 2 x 2
F32_PAIRS = re.compile(r"pair_q_kernelILi\d+ELb\dELb\dEfE")
# the compiler's no-op GMMA: where ptxas injects a warpgroup.arrive before
# a wgmma (its C7519 note) it emits an HGMMA into RZ from a zero descriptor
# with the accumulate predicate off, which reads no operand and writes no
# register; every int8 GEMM of the library (gemm_s8_kernel) holds one
NOOP_GMMA = re.compile(r"HGMMA\.\S+ RZ, gdesc\[URZ\], RZ, !UPT")


def tensor_ops(func):
    """A SASS function's bf16 / fp16 / TF32 tensor-core instructions that
    compute: HMMA and HGMMA lines other than the no-op GMMA."""
    return [line for line in func.splitlines()
            if ("HMMA" in line or "HGMMA" in line)
            and not NOOP_GMMA.search(line)]


def main_loop(func):
    """The SASS loop of a function that holds the most FFMAs (the body
    between a backward branch and its target, cuobjdump's addresses):
    (FFMAs, instructions but NOPs, FFMAs with a .reuse operand), or None
    where the function has no loop."""
    ins = []
    for line in func.splitlines():
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    best = None
    for addr, text in ins:
        m = re.search(r"BRA\s+(?:`\()?(0x[0-9a-f]+)", text)
        if not m or int(m.group(1), 16) > addr:
            continue
        body = [t for a, t in ins
                if int(m.group(1), 16) <= a <= addr and not t.startswith("NOP")]
        ffma = [t for t in body if "FFMA" in t]
        if best is None or len(ffma) > best[0]:
            best = (len(ffma), len(body),
                    sum(1 for t in ffma if ".reuse" in t))
    return best


def sass_check(lib_path):
    """`[sass]`: cuobjdump's SASS of the built library. The fp32 kernels
    (F32_KERNELS, each found by name) must hold no tensor-core instruction
    (HMMA, HGMMA: no TF32 products), and FFMAs; the fp32 pairs (F32_PAIRS) the int8 tensor
    cores' IGMMA and no HMMA / HGMMA but the compiler's no-op GMMA, which
    the int8 GEMM holds as well; the bf16 GEMM's HGMMA is the control."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    funcs = sass.split("Function : ")[1:]
    head = [f.split("\n", 1)[0] for f in funcs]
    f32 = [f for f, h in zip(funcs, head) if any(k in h for k in F32_KERNELS)]
    missing = [k for k in F32_KERNELS if not any(k in h for h in head)]
    by_name = {k: sum(f.count("FFMA") for f, h in zip(funcs, head) if k in h)
               for k in F32_KERNELS}
    pairs = [f for f, h in zip(funcs, head) if F32_PAIRS.search(h)]
    s8 = [f for f, h in zip(funcs, head) if "gemm_s8_kernel" in h]
    tensor = [f.split("\n", 1)[0] for f in f32 + pairs if tensor_ops(f)]
    ffma = sum(f.count("FFMA") for f in f32 + pairs)
    igmma = [f.count("IGMMA") for f in pairs]
    noop = {"fp32_pairs": [len(NOOP_GMMA.findall(f)) for f in pairs],
            "gemm_s8": [len(NOOP_GMMA.findall(f)) for f in s8]}
    control = sum(len(tensor_ops(f)) for f in funcs)
    loops = {}  # each fp32 GEMM instantiation's main loop
    for f, h in zip(funcs, head):
        for k in F32_GEMMS:
            if k in h and main_loop(f):
                n_f, n_i, n_r = main_loop(f)
                loops.setdefault(k, []).append(
                    {"ffma": n_f, "instructions": n_i, "reuse": n_r,
                     "ffma_share": n_f / n_i})
    for k, ls in loops.items():
        sh = [x["ffma_share"] for x in ls]
        top = max(ls, key=lambda x: x["ffma"])
        log(f"[sass] {k} main loop ({len(ls)} instantiations): FFMA share "
            f"{min(sh):.3f}-{max(sh):.3f}; the largest loop "
            f"{top['ffma']} FFMA of {top['instructions']} instructions, "
            f"{top['reuse']} FFMA reusing an operand")
    log(f"[sass] FFMA by fp32 kernel: {json.dumps(by_name)}")
    log(f"[sass] {len(f32)} fp32 kernels and {len(pairs)} fp32 pairs: {ffma} "
        f"FFMA, IGMMA in each pair {igmma}, computing tensor-core "
        f"instructions (HMMA, HGMMA) in {len(tensor)} of them; the "
        f"compiler's no-op GMMA {json.dumps(noop)}; the library's computing "
        f"HMMA / HGMMA (the bf16 kernels, the control): {control}")
    if (missing or len(pairs) != 8 or tensor or not all(by_name.values())
            or not all(igmma) or not control):
        fail(f"fp32 kernels' SASS: {len(f32)} found ({missing} missing), "
             f"{len(pairs)} pairs, computing tensor-core instructions in "
             f"{tensor}, FFMA by name {by_name}")
    if set(loops) != set(F32_GEMMS):
        fail(f"[sass] no main loop found in {set(F32_GEMMS) - set(loops)}")
    return {"fp32_kernels": len(f32), "fp32_pairs": len(pairs), "ffma": ffma,
            "pair_igmma": igmma, "noop_gmma": noop,
            "tensor_core_in": tensor, "hgmma_in_library": control,
            "main_loops": loops}


def check_attn_dispatch():
    """attn_sdpa's body by S: the tensor cores at the model's S = 144 and
    576, the warp rows at the temporal S = 5 (the split of one call into
    its phases is gtax_torch/tools/attn_sweep.py's, on a probe build)."""
    from gtax_torch.kernels import attention as kattn

    if not (kattn.sdpa_tensor_cores(S_VAE) and kattn.sdpa_tensor_cores(S_DIT)
            and not kattn.sdpa_tensor_cores(5)):
        fail("attn_sdpa's dispatch: S=144 and 576 must take the tensor "
             "cores, S=5 the warp rows")


def temporal_checks():
    """`[temporal]`: the temporal branch's full window at the B=16 training
    step's and the prefill's shapes (T=5 / 4, slot 0 padded). q, k, v of
    the qkv GEMM's rope epilogue against the fp32 product through
    attn_temporal's own rope and rounding (the path it replaced; bit-equal,
    else the share of elements that differ is printed and the run fails);
    attn_temporal_window and attn_temporal_bwd alone against their plain
    versions on the same bf16 rows (2**-6 of the largest magnitude, with
    the rounding figures), and attn_temporal_window against attn_temporal's
    output on the same product."""
    from gtax_torch.kernels import backward, block, build
    from gtax_torch.utils.profiling import bf16_differences

    def held(what, got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        tol = 2.0**-6 * max(1.0, ref.float().abs().max().item())
        share, rel = bf16_differences(got, ref)
        log(f"[temporal]   {what}: max_abs_err={err:.3g} (tol {tol:.3g}); "
            f"{share:.3e} of elements differ, max diff {rel:.3e} of the "
            "largest magnitude")
        if not (torch.isfinite(got.float()).all() and err <= tol):
            fail(f"[temporal] {what}: off by {err} > {tol}")
        return {"max_abs_err": err, "tolerance": tol, "bf16_differ": share,
                "max_diff_over_max": rel}

    out = {}
    for label, B, T in (("train B=16 T=5", 16, 5), ("prefill B=1 T=4", 1, 4)):
        gen = np.random.default_rng(600 + B)
        M = B * T * S_DIT
        mod, w = rand(gen, (M, D)), rand(gen, (D, 3 * D), 0.02)
        f = temporal_freqs(T)
        bits = block.valid_bits([False] + [True] * (T - 1), T)
        q, k, v, att, att0, pq, pk, pv = (
            torch.empty((M, D), dtype=torch.bfloat16, device="cuda")
            for _ in range(8))
        block.launch_gemm_rope_qkv(mod, w, q, k, v, f, S_DIT, T, 0, HD)
        qkv = torch.empty((M, 3 * D), dtype=torch.float32, device="cuda")
        block.launch_gemm(mod, w, qkv, M, 3 * D, D, block.EPI_F32)
        block.launch_attn_temporal(qkv, f, att0, B, T, 0, S_DIT, D, H, bits,
                                   kv_out=(pk, pv), q_out=pq)
        block.launch_attn_window(q, k, v, att, B, T, S_DIT, D, H, bits)
        torch.cuda.synchronize()
        differ = {n: (a != b).float().mean().item()
                  for n, a, b in zip("qkv", (q, k, v), (pq, pk, pv))}
        log(f"[temporal] {label}: rope epilogue q, k, v against the fp32 "
            f"product through attn_temporal's rope: share of elements that "
            f"differ {differ}")
        shape = (B, T, S_DIT, H, HD)
        q5, k5, v5 = (t.reshape(shape) for t in (q, k, v))
        bias = block.temporal_bias([False] + [True] * (T - 1), T, "cuda")
        res = {"qkv_differ": differ,
               "window_vs_plain": held(
                   "attn_temporal_window vs block.attend_temporal", att,
                   block.attend_temporal(q5, k5, v5, bias, torch.bfloat16)
                   .reshape(M, D)),
               "window_vs_attn_temporal": held(
                   "attn_temporal_window vs attn_temporal (same product)",
                   att, att0)}
        dout = rand(gen, (M, D))
        dqkv = torch.empty((M, 3 * D), dtype=torch.bfloat16, device="cuda")
        ao = torch.empty_like(dout)
        build.launch("gtax_attn_temporal_bwd", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), dout.data_ptr(), f.data_ptr(),
                     dqkv.data_ptr(), ao.data_ptr(), B, T, S_DIT, D, H, bits,
                     torch.cuda.current_stream().cuda_stream)
        pao, dq, dk, dv = backward._attention_bwd_plain(
            q5, k5, v5, dout.reshape(shape), bias, torch.bfloat16,
            1.0 / HD**0.5, ("bishd", "bjshd", "bshij"))
        f5 = f[None, :, None, None, :]
        pd = torch.cat([backward.rope_transpose32(f5, dq).reshape(M, D),
                        backward.rope_transpose32(f5, dk).reshape(M, D),
                        dv.reshape(M, D).float()], -1).bfloat16()
        res["bwd_o_vs_plain"] = held("attn_temporal_bwd O vs plain", ao,
                                     pao.reshape(M, D))
        res["bwd_dqkv_vs_plain"] = held("attn_temporal_bwd dq|dk|dv vs plain",
                                        dqkv, pd)
        out[label] = res
        if any(differ.values()):
            fail(f"[temporal] {label}: the rope epilogue's q, k, v are not "
                 "the bits of the fp32 product through attn_temporal")
        del qkv, dqkv
    return out


# ------------------------------------------------------ training kernels

BWD_SOURCE = "gtax_torch/kernels/backward.py"
BWD_REPLACES = {
    "fused_spatial_branch_bwd": "gtax/kernels/backward.py:386",
    "fused_temporal_branch_bwd": "gtax/kernels/backward.py:632",
    "fused_mlp_branch_bwd": "gtax/kernels/backward.py:709",
}
LIB_BWD = ("torch.autograd.grad (backward only) through F.layer_norm + "
           "F.linear + {} + F.linear")


def _leaves_grad(*tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def train_kernel_cases(dt=torch.bfloat16):
    """(name, label, main, builder) for the three backward wrappers and the
    forward wrappers' emit_train mode (bf16 and int8), at the training
    step's shapes (B=16: 80 frames of 144 tokens) and at B=2; builder
    returns (kernel_fn, plain_fn, library_fn, bytes, flops[, int8 ops]).
    A backward's inputs are its forward's emit_train residuals, made once
    by the kernel forward; its library yardstick is autograd's backward of
    the library composite forward, timed alone (the forward runs once,
    outside the timing). dt = torch.float32: the fp32 training forms at
    B=16 only (fp32 inputs, weights and residuals; the library composites
    in fp32, no TF32)."""
    from gtax_torch.kernels import backward, block

    F = torch.nn.functional
    sfreqs = spatial_freqs()
    esz = torch.finfo(dt).bits // 8  # bytes of a compute-dtype element

    def lib_mod(x, sh, sc):
        ln = F.layer_norm(x, (D,), eps=1e-6)
        return ln * (1 + sc[:, None]) + sh[:, None]

    def lib_rope(t, f):
        from gtax_torch.core import rope

        f = f.to(t.dtype)
        return t * torch.cos(f) + rope.rotate_half(t) * torch.sin(f)

    def lib_backward(fwd, tensors, ct):
        leaves = _leaves_grad(*tensors)
        with torch.enable_grad():
            out = fwd(*leaves)
        return lambda: torch.autograd.grad(out, leaves, ct,
                                           retain_graph=True)

    def attn_inputs(seed, N, freqs_rows):
        gen = np.random.default_rng(seed)
        x, sh, sc, g = branch_inputs(gen, N, S_DIT, dt)
        qw = rand(gen, (D, 3 * D), 0.02, dt)
        ow = rand(gen, (D, D), 0.02, dt)
        ob = rand(gen, (D,), 0.02, torch.float32)
        return (x, sh, sc, g, qw, ow, ob), rand(gen, (N, S_DIT, D), dtype=dt)

    def attn_bytes(N, args):
        x, sh, sc, g, qw, ow, ob = args
        # in: x, ct, y, q, k, v, weights, per-frame vectors; out: dx, fp32
        # dshift/dscale/dg, dW_qkv, dW_out, db
        return (7 * nbytes(x) + nbytes(sh, sc, g, qw, ow)
                + 3 * N * D * 4 + 4 * D * D * 4 + D * 4)

    def spatial_bwd(N):
        args, ct = attn_inputs(100 + N, N, S_DIT)
        _, *res = block.fused_spatial_branch(*args, sfreqs, H,
                                             emit_train=True)
        bargs = (*args[:6], sfreqs, *res, ct, H)
        x, sh, sc, g, qw, ow, ob = args

        def fwd(x, sh, sc, g, qw, ow, ob):
            qkv = library_linear(lib_mod(x, sh, sc), qw)
            q, k, v = (t.view(N, S_DIT, H, HD).transpose(1, 2)
                       for t in qkv.split(D, -1))
            f = sfreqs[None, None]
            o = F.scaled_dot_product_attention(lib_rope(q, f),
                                               lib_rope(k, f), v)
            y = library_linear(o.transpose(1, 2).reshape(N, S_DIT, D), ow,
                               ob.to(dt))
            return x + g[:, None] * y

        M = N * S_DIT
        fl = 16 * M * D * D + 12 * N * H * S_DIT * S_DIT * HD
        return (lambda: backward.fused_spatial_branch_bwd(*bargs),
                lambda: backward.spatial_branch_bwd_plain(*bargs),
                lib_backward(fwd, args, ct), attn_bytes(N, args), fl)

    def temporal_bwd(B, valid, T=5):
        N = B * T
        args, ct = attn_inputs(200 + B, N, T)
        f = temporal_freqs(T)
        _, *res, mod = block.fused_temporal_branch(
            *args, f, valid, H, T, emit_train=True, emit_mod=True)
        bargs = (*args[:6], f, valid, *res, ct, H, T)
        # the trainer's backward takes the forward's mod rows: the same bits
        # as forming them again
        same = all(torch.equal(a, b) for a, b in zip(
            backward.fused_temporal_branch_bwd(*bargs, mod=mod),
            backward.fused_temporal_branch_bwd(*bargs)))
        log(f"[temporal] fused_temporal_branch_bwd B={B} T=5 valid={valid}: "
            f"given mod vs forming it, bit-equal: {same}")
        if not same:
            fail("fused_temporal_branch_bwd: the gradients with the "
                 "forward's mod differ from those without")
        bias = block.temporal_bias(valid, T, "cuda").to(dt)

        def fwd(x, sh, sc, g, qw, ow, ob):
            qkv = library_linear(lib_mod(x, sh, sc), qw)
            q, k, v = (t.view(B, T, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
                       for t in qkv.split(D, -1))
            o = F.scaled_dot_product_attention(
                lib_rope(q, f), lib_rope(k, f), v, attn_mask=bias)
            y = library_linear(o.permute(0, 3, 1, 2, 4).reshape(N, S_DIT, D),
                               ow, ob.to(dt))
            return x + g[:, None] * y

        M = N * S_DIT
        fl = 16 * M * D * D + 12 * B * S_DIT * H * (T * (T + 1) // 2) * HD
        return (lambda: backward.fused_temporal_branch_bwd(*bargs, mod=mod),
                lambda: backward.temporal_branch_bwd_plain(*bargs),
                lib_backward(fwd, args, ct), attn_bytes(N, args) + nbytes(mod),
                fl)

    def mlp_bwd(N):
        gen = np.random.default_rng(300 + N)
        x, sh, sc, g = branch_inputs(gen, N, S_DIT, dt)
        w1 = rand(gen, (D, 4 * D), 0.02, dt)
        w2 = rand(gen, (4 * D, D), 0.02, dt)
        b1 = rand(gen, (4 * D,), 0.02, torch.float32)
        b2 = rand(gen, (D,), 0.02, torch.float32)
        ct = rand(gen, (N, S_DIT, D), dtype=dt)
        _, h1, y = block.fused_mlp_branch(x, sh, sc, g, w1, b1, w2, b2,
                                          emit_train=True)
        bargs = (x, sh, sc, g, w1, w2, h1, y, ct)

        def fwd(x, sh, sc, g, w1, b1, w2, b2):
            h = F.gelu(library_linear(lib_mod(x, sh, sc), w1, b1.to(dt)),
                       approximate="tanh")
            return x + g[:, None] * library_linear(h, w2, b2.to(dt))

        M = N * S_DIT
        by = (4 * nbytes(x) + nbytes(h1, sh, sc, g, w1, w2) + 3 * N * D * 4
              + 2 * D * 4 * D * 4 + 5 * D * 4)
        return (lambda: backward.fused_mlp_branch_bwd(*bargs),
                lambda: backward.mlp_branch_bwd_plain(*bargs),
                lib_backward(fwd, (x, sh, sc, g, w1, b1, w2, b2), ct), by,
                8 * M * D * 4 * D)

    def emit(kind, N):
        gen = np.random.default_rng(400 + N)
        x, sh, sc, g = branch_inputs(gen, N, S_DIT, dt)
        M = N * S_DIT
        if kind == "fused_mlp_branch":
            w1 = rand(gen, (D, 4 * D), 0.02, dt)
            w2 = rand(gen, (4 * D, D), 0.02, dt)
            b1, b2 = rand(gen, (4 * D,), 0.02, dt), rand(gen, (D,), 0.02, dt)
            args = (x, sh, sc, g, w1, b1, w2, b2)

            def lib():
                h = F.gelu(library_linear(lib_mod(x, sh, sc), w1, b1),
                           approximate="tanh")
                return x + g[:, None] * library_linear(h, w2, b2)

            return (lambda: block.fused_mlp_branch(*args, emit_train=True),
                    lambda: block.mlp_branch_plain(*args, emit_train=True),
                    lib, nbytes(*args) + 2 * nbytes(x) + M * 4 * D * esz,
                    4 * M * D * 4 * D)
        qw = rand(gen, (D, 3 * D), 0.02, dt)
        ow = rand(gen, (D, D), 0.02, dt)
        ob = rand(gen, (D,), 0.02, dt)
        by = nbytes(x, sh, sc, g, qw, ow, ob) + 5 * nbytes(x)
        if kind == "fused_spatial_branch":
            args = (x, sh, sc, g, qw, ow, ob, sfreqs, H)

            def lib():
                qkv = library_linear(lib_mod(x, sh, sc), qw)
                q, k, v = (t.view(N, S_DIT, H, HD).transpose(1, 2)
                           for t in qkv.split(D, -1))
                f = sfreqs[None, None]
                o = F.scaled_dot_product_attention(
                    lib_rope(q, f), lib_rope(k, f), v)
                return x + g[:, None] * library_linear(
                    o.transpose(1, 2).reshape(N, S_DIT, D), ow, ob)

            return (
                lambda: block.fused_spatial_branch(*args, emit_train=True),
                lambda: block.spatial_branch_plain(*args, emit_train=True),
                lib, by, 8 * M * D * D + 4 * N * H * S_DIT * S_DIT * HD)
        T = 5
        B = N // T
        f = temporal_freqs(T)
        valid = [False] + [True] * (T - 1)
        args = (x, sh, sc, g, qw, ow, ob, f, valid, H, T)
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device="cuda"))

        def lib():
            qkv = library_linear(lib_mod(x, sh, sc), qw)
            q, k, v = (t.view(B, T, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
                       for t in qkv.split(D, -1))
            o = F.scaled_dot_product_attention(
                lib_rope(q, f), lib_rope(k, f), v, attn_mask=mask)
            return x + g[:, None] * library_linear(
                o.permute(0, 3, 1, 2, 4).reshape(N, S_DIT, D), ow, ob)

        return (lambda: block.fused_temporal_branch(*args, emit_train=True),
                lambda: block.temporal_branch_plain(*args, emit_train=True),
                lib, by,
                8 * M * D * D + 4 * B * S_DIT * H * (T * (T + 1) // 2) * HD)

    def emit_q(kind, N):
        """The int8 wrappers' emit_train mode (int8-forward training):
        also returns the int8 tensor-core operations, and checks the
        output bit-equal to the call without emit_train."""
        from gtax_torch.kernels import quant

        gen = np.random.default_rng(500 + N)
        x, sh, sc, g = branch_inputs(gen, N, S_DIT, dt)
        M = N * S_DIT
        if kind == "mlp":
            w = int8_mlp_weights(gen, dt)
            wc = col_major_mlp(w)
            args = (x, sh, sc, g, *w)
            fn, plain = quant.fused_mlp_branch_q, quant.mlp_branch_q_plain
            lib = lambda: lib_int8_mlp(x, sh, sc, g, *wc)  # noqa: E731
            by = nbytes(x, sh, sc, g, *w) + 2 * nbytes(x) + M * 4 * D * esz
            fl, i8 = 0, 2 * 2 * M * D * 4 * D
        else:
            w = int8_attn_weights(gen, dt)
            wc = col_major_attn(w)
            by = nbytes(x, sh, sc, g, *w) + 5 * nbytes(x)
            i8 = 2 * M * D * 4 * D
            if kind == "spatial":
                args = (x, sh, sc, g, *w, sfreqs, H)
                fn = quant.fused_spatial_branch_q
                plain = quant.spatial_branch_q_plain
                lib = lambda: lib_int8_spatial(  # noqa: E731
                    x, sh, sc, g, wc, sfreqs)
                fl = 4 * N * H * S_DIT * S_DIT * HD
            else:
                T = 5
                f = temporal_freqs(T)
                args = (x, sh, sc, g, *w, f, [False] + [True] * (T - 1), H,
                        T)
                fn = quant.fused_temporal_branch_q
                plain = quant.temporal_branch_q_plain
                lib = lambda: lib_int8_temporal(  # noqa: E731
                    x, sh, sc, g, wc, f, N // T, T)
                fl = 4 * (N // T) * S_DIT * H * (T * (T + 1) // 2) * HD
                by += nbytes(f)
        same = torch.equal(fn(*args), fn(*args, emit_train=True)[0])
        log(f"[kernel] {fn.__name__} emit_train N={N}: output bit-equal to "
            f"the call without emit_train: {same}")
        if not same:
            fail(f"{fn.__name__}: emit_train changes the output")
        return (lambda: fn(*args, emit_train=True),
                lambda: plain(*args, emit_train=True), lib, by, fl, i8)

    pad = [False, True, True, True, True]
    cases = [
        ("fused_spatial_branch_q", "emit_train B=16 (N=80)", True,
         lambda: emit_q("spatial", 80)),
        ("fused_temporal_branch_q", "emit_train B=16 T=5, slot 0 padded",
         True, lambda: emit_q("temporal", 80)),
        ("fused_mlp_branch_q", "emit_train B=16 (11520 rows)", True,
         lambda: emit_q("mlp", 80)),
        ("fused_spatial_branch_bwd", "train B=16 (N=80)", True,
         lambda: spatial_bwd(80)),
        ("fused_spatial_branch_bwd", "B=2 (N=10)", False,
         lambda: spatial_bwd(10)),
        ("fused_temporal_branch_bwd", "train B=16 T=5, valid all", True,
         lambda: temporal_bwd(16, None)),
        ("fused_temporal_branch_bwd", "B=16 T=5, slot 0 padded", False,
         lambda: temporal_bwd(16, pad)),
        ("fused_temporal_branch_bwd", "B=2 T=5, valid all", False,
         lambda: temporal_bwd(2, None)),
        ("fused_temporal_branch_bwd", "B=2 T=5, slot 0 padded", False,
         lambda: temporal_bwd(2, pad)),
        ("fused_mlp_branch_bwd", "train B=16 (11520 rows)", True,
         lambda: mlp_bwd(80)),
        ("fused_mlp_branch_bwd", "B=2 (1440 rows)", False,
         lambda: mlp_bwd(10)),
        ("fused_spatial_branch", "emit_train B=16 (N=80)", True,
         lambda: emit("fused_spatial_branch", 80)),
        ("fused_mlp_branch", "emit_train B=16 (11520 rows)", True,
         lambda: emit("fused_mlp_branch", 80)),
        ("fused_temporal_branch", "emit_train B=16 T=5, slot 0 padded",
         True, lambda: emit("fused_temporal_branch", 80)),
        ("fused_spatial_branch", "emit_train B=2 (N=10)", False,
         lambda: emit("fused_spatial_branch", 10)),
    ]
    if dt == torch.float32:  # the main shapes only
        return [(name, label + ", fp32", main, make)
                for name, label, main, make in cases if main]
    return cases


def s8_plans(name, M):
    """{product: (K chunk, K chunks, int32 partial MB)} of the int8 GEMMs of
    an int8 wrapper at M rows, as quant.s8_chunk plans them (logged)."""
    from gtax_torch.kernels import block, quant

    sms = block.sm_count(torch.device("cuda"))
    gemms = ({"fc1": (4 * D, D, D), "fc2": (D, 4 * D, 512)}
             if "mlp" in name else
             {"qkv": (3 * D, D, D), "out": (D, D, D)})
    plans = {}
    for what, (N, K, group) in gemms.items():
        chunk = quant.s8_chunk(M, N, K, group, sms)
        splits = -(-K // chunk)
        plans[what] = {"k_chunk": chunk, "splits": splits,
                       "partials_mb": (splits * M * N * 4 / 1e6
                                       if splits > 1 else 0.0)}
    log(f"[kernel] {name} s8 plan at M={M}: {json.dumps(plans)}")
    return plans


def train_kernel_phase(rows, dt=torch.bfloat16):
    """The backward wrappers' rows, and the emit_train mode of the forward
    rows, bf16 (#1-#3) and int8 (#7-#9), kept as emit_train_* keys of
    those rows; the int8 rows also get the int8 GEMMs' plan at training
    rows (quant.s8_chunk). dt = torch.float32: the fp32 training forms at
    B=16 (`[kernel] ... fp32`), under the gates stated before their first
    run: #1-#3 and #12-#14 within F32_TOL of the plain output's largest
    magnitude, #7-#9 within INT8_F32_TOL (the int8 rule), the backwards
    bit-equal across two calls; the bound at 67 TFLOP/s of fp32 FFMA (and
    1,979 TOP/s of int8); kept in each row's "fp32" (the backwards) or its
    "fp32" "emit_train" (the forwards)."""
    timer = Timer()
    f32 = dt == torch.float32
    M = 80 * S_DIT
    # the backwards' GEMMs in launch order: dy W_out^T, dW_out, dW_qkv,
    # dqkv W_qkv^T; the MLP's four products of 96.6 GFLOP
    attn_flops = [2 * M * D * D] * 2 + [2 * M * D * 3 * D] * 2
    bwd_flops = {"fused_spatial_branch_bwd": attn_flops,
                 "fused_temporal_branch_bwd": attn_flops,
                 "fused_mlp_branch_bwd": [2 * M * D * 4 * D] * 4}
    for name, label, main, make in train_kernel_cases(dt):
        kern, plain, lib, by, fl, *i8 = make()
        tol = {}
        if f32:
            tol = {"rel_tol": INT8_F32_TOL if name.endswith("_q")
                   else F32_TOL, "flops_per_s": F32_FLOPS_PER_S}
        with torch.no_grad():
            m = measure(timer, name, label, kern, plain, lib, by, fl, *i8,
                        **tol)
        if f32 and name in BWD_REPLACES and not m["two_calls_bit_equal"]:
            fail(f"{name} [{label}]: two calls on the same inputs differ")
        if not main:
            continue
        if f32:
            lib_desc = (LIB_BWD.format(
                {"fused_mlp_branch_bwd": "F.gelu"}.get(
                    name, "SDPA" if "spatial" in name else "SDPA(mask)"))
                if name in BWD_REPLACES else "library composite")
            rec = dict(m, launches=None, library=lib_desc + ", fp32")
            if name in BWD_REPLACES:
                rows[name]["fp32"] = rec
                with torch.no_grad():
                    rec["launch_split"] = launch_split(
                        kern, f"{name} [{label}]", bwd_flops[name])
                if name == "fused_spatial_branch_bwd":
                    rec["attn_frame_bwd_f32"] = attn_f32_split(
                        rec["launch_split"], M)
            else:
                rows[name].setdefault("fp32", {})["emit_train"] = rec
                if name == "fused_mlp_branch":  # ln_mod, fc1, fc2
                    with torch.no_grad():
                        rec["launch_split"] = launch_split(
                            kern, f"{name} [{label}]",
                            [2 * M * D * 4 * D] * 2)
        elif name in BWD_REPLACES:
            what = {"fused_mlp_branch_bwd": "F.gelu"}.get(
                name, "SDPA" if "spatial" in name else "SDPA(mask)")
            rows[name] = {"name": name, "route": "cuda",
                          "source": BWD_SOURCE,
                          "replaces": BWD_REPLACES[name], "launches": None,
                          **m, "library": LIB_BWD.format(what)}
            with torch.no_grad():
                rows[name]["launch_split"] = launch_split(
                    kern, f"{name} [{label}]", bwd_flops[name])
            if name == "fused_temporal_branch_bwd":
                rows[name]["attention_bound"] = temporal_attention_bound(
                    rows[name]["launch_split"], M)
            if name == "fused_spatial_branch_bwd":
                # attn_frame_bwd alone: q, k, v, dO read, dq/dk/dv and O
                # written; six S x S x d products a (frame, head)
                bms, by_what = bound_ms(M * D * 2 * 8,
                                        12 * 80 * H * S_DIT**2 * HD)
                rows[name]["attn_frame_bwd_bound_ms"] = bms
                log(f"[split]   attn_frame_bwd bound {bms:.4f} ms "
                    f"({by_what}; {M * D * 16 / 1e6:.1f} MB, "
                    f"{12 * 80 * H * S_DIT**2 * HD / 1e9:.1f} GFLOP)")
        else:
            rows[name].update({f"emit_train_{k}": m[k] for k in (
                "ms", "max_abs_err", "plain_ms", "bound_ms", "library_ms",
                "shape")})
            if name.endswith("_q"):
                rows[name]["emit_train_s8_plan"] = s8_plans(name, 80 * S_DIT)
            if name == "fused_temporal_branch":  # ln_mod, qkv, attn, out
                with torch.no_grad():
                    split = launch_split(kern, f"{name} [{label}]",
                                         [2 * M * D * 3 * D, 2 * M * D * D])
                rows[name]["emit_train_launch_split"] = split
                rows[name]["emit_train_attention_bound"] = (
                    temporal_attention_bound(split, M, 3))
        del kern, plain, lib
        torch.cuda.empty_cache()


# -------------------------------------------------------------- end to end

def nonzero_adaln(params, seed):
    """dit_init zeroes every adaLN head (each block starts as the
    identity); fill them so the rollout exercises every branch."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for bp in params["blocks"]:
        for k in ("s_adaln", "t_adaln"):
            bp[k]["kernel"].normal_(0.0, 0.02, generator=gen)
            bp[k]["bias"].normal_(0.0, 0.2, generator=gen)


def gtax_regime(cfg, seed, width_scaled):
    """Params in the regime of gtax's quantization gate (tests/test_quant.py
    random_dit_params): every floating leaf of dit_init drawn as
    normal * 0.05, there on DiT-S/2's shape at D=128 (4 heads, depth 2).
    At full width, width_scaled=True scales each kernel's std by
    sqrt(fan-in at D=128 / fan-in here), so every activation, the adaLN
    gates among them, keeps the scale it has in gtax's test; False keeps
    0.05 as written, which makes those activations several times larger."""
    from gtax_torch.models import dit as dit_mod

    small = dataclasses.replace(cfg, hidden_size=128, num_heads=4)
    fan_in = {}
    dit_mod._map_params(dit_mod.dit_init(small, torch.Generator()),
                        lambda p, leaf: fan_in.__setitem__(p, leaf.shape[0]))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(path, leaf):
        std = 0.05
        if width_scaled and path[-1] == "kernel":
            std *= math.sqrt(fan_in[path] / leaf.shape[0])
        return torch.randn(leaf.shape, generator=gen, device="cuda") * std

    return dit_mod._map_params(
        dit_mod.dit_init(cfg, gen, device="cuda"), draw)


BF16_PATH = ("fused_spatial_branch", "fused_mlp_branch",
             "fused_temporal_branch", "fused_temporal_step", "fused_vae_block")
# the int8 path at B=1: every denoise step pairs each half-block (gtax's
# gate: int8 and at most 2 live frames); the 4-frame prefill stays
# sequential. Expected launches per generate of 2 frames (16 blocks, 101
# steps a frame, one prefill a frame), from the code:
INT8_EXPECTED = {"fused_spatial_branch_q": 32, "fused_mlp_branch_q": 64,
                 "fused_temporal_branch_q": 32, "fused_temporal_step_q": 0,
                 "fused_spatial_pair_q": 3232, "fused_temporal_pair_q": 3232,
                 "fused_vae_block": 18}
INT8_PATH = tuple(n for n, c in INT8_EXPECTED.items() if c)
# the `pallas` path: full-window rollouts through the unfused branches, every
# attention on the token-major kernel: per generate 16 blocks x 202 window
# evaluations for the spatial (S=144) and temporal (S=5) attentions, and the
# 6 encoder + 12 decoder VAE blocks (S=576)
PALLAS_EXPECTED = {144: 3232, 5: 3232, 576: 18}
WRAPPER_MODULES = {"block": BF16_PATH[:4],
                   "quant": ("fused_spatial_branch_q", "fused_mlp_branch_q",
                             "fused_temporal_branch_q",
                             "fused_temporal_step_q"),
                   "pair": ("fused_spatial_pair_q", "fused_temporal_pair_q"),
                   "attention": ("fused_sdpa", "fused_mha_token_major"),
                   "vae_block": ("fused_vae_block",)}


def kernel_wrappers():
    """name -> wrapper; each wrapper counts its launches in `.launches`."""
    import importlib

    return {name: getattr(importlib.import_module(
        f"gtax_torch.kernels.{mod}"), name)
        for mod, names in WRAPPER_MODULES.items() for name in names}


def profile_device(fn, label, top=12):
    """torch.profiler over one call of fn (warmed up first): device time by
    kernel and the device's busy share of the wall time. Informational: a
    trace without device events prints "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}  # device-side events only: kernels, memcpy, memset
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            by_kernel[ev.key] = (us, ev.count)
    if not by_kernel:
        log(f"[profile] {label}: device time not measured (no CUDA events "
            "traced)")
        return None
    busy = sum(us for us, _ in by_kernel.values()) / 1e6
    log(f"[profile] {label}: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%)")
    for key, (us, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[
            :top]:
        log(f"[profile]   {us / 1e3:9.3f} ms {n:6d}x  {key[:90]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3}


def launch_split(fn, label, gemm_flops):
    """gtax_torch/tools/split.py's launch split (each launch's CUDA-event
    ms, share and GEMM TFLOP/s), printed here."""
    from gtax_torch.tools.split import launch_split as split

    return split(fn, label, gemm_flops, log=log)


def attn_f32_split(split, M):
    """attn_frame_bwd_f32's launch in the fp32 #12 `split`: its ms beside
    its bound (the six S x S x d products a (frame, head) that the
    function needs, as #12's bound counts them: scores, O = P V, dP, dQ,
    dK and dV, over 67 TFLOP/s of fp32 FFMA, or q, k, v, dO read and O,
    dq/dk/dv written over 3.35 TB/s) and its useful TFLOP/s, printed (the
    kernel's second pass recomputes the scores and dP: not counted)."""
    fl = 12 * (M // S_DIT) * H * S_DIT**2 * HD
    bms, by_what = bound_ms(M * D * 4 * 8, fl, flops_per_s=F32_FLOPS_PER_S)
    ms = next(e["ms"] for e in split
              if e.get("kernel") == "gtax_attn_frame_bwd_f32")
    log(f"[split]   attn_frame_bwd_f32 {ms:.4f} ms, bound {bms:.4f} ms "
        f"({by_what}; {fl / 1e9:.1f} GFLOP at {fl / ms / 1e9:.1f} TFLOP/s)")
    return {"ms": ms, "bound_ms": bms, "gflop": fl / 1e9,
            "tflops": fl / ms / 1e9}


def temporal_attention_bound(split, M, emitted=0):
    """The byte bound of #3's or #13's attention launch in `split`
    (gtax_torch/tools/split.py), printed here."""
    from gtax_torch.tools.split import temporal_attention_bound as bound

    return bound(split, M, emitted, log=log)


def profile_frame(gen, lat0, acts, nz, steps=4):
    """The device profile of one generated frame at full depth (prefill +
    steps + 1 denoise steps)."""
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.sampling.diffusion import SamplerConfig, make_rollout

    bf = torch.bfloat16
    roll = make_rollout(None, gen.dit_cfg.max_frames,
                        SamplerConfig(ddim_noise_steps=steps),
                        cond=dit_mod.make_cond_fns(gen.dit_cfg, bf),
                        incremental=dit_mod.make_incremental_fns(gen.dit_cfg,
                                                                 bf))
    with torch.inference_mode():
        profile_device(lambda: roll(gen.dit_params, lat0, acts, None, 1, nz),
                       f"{gen.cfg.quantize}: one frame, {steps + 1} steps, "
                       f"depth {gen.dit_cfg.depth}")


def drive_path(gen, label, path, rows, record, inputs, expect=None):
    """One generate call with every launch count zeroed just before it and
    read just after: each kernel of `path` must have launched, and exactly
    as often as `expect` says where it names the kernel. Records the
    counts of the `record` kernels in their rows."""
    prompt, actions, noise = inputs
    n_frames, vc = actions.shape[1], gen.vae_cfg
    n_gen = noise.shape[1]
    fns = kernel_wrappers()
    for fn in fns.values():
        fn.launches = 0
    pixels = gen.generate(prompt, actions, num_frames=n_frames, noise=noise)
    counts = {name: fns[name].launches for name in (*path, *(expect or ()))}
    tm = gen.last_timings
    log(f"[e2e {label}] generate: pixels {pixels.shape} {pixels.dtype}; "
        f"encode {tm['encode_s'] * 1e3:.1f} ms, rollout "
        f"{tm['rollout_s'] / n_gen:.3f} s/frame "
        f"({gen.cfg.noise_steps + 1} steps), decode "
        f"{tm['decode_s'] * 1e3:.1f} ms ({n_frames} frames)")
    log(f"[e2e {label}] launches on the main path: {json.dumps(counts)}")
    if pixels.shape != (1, n_frames, vc.input_height, vc.input_width, 3) \
            or pixels.dtype != np.uint8:
        fail(f"{label} generate returned {pixels.shape} {pixels.dtype}")
    for name in path:
        if counts[name] <= 0:
            fail(f"{name} was not launched on the {label} main path")
    for name, n in (expect or {}).items():
        if counts[name] != n:
            fail(f"{name}: {counts[name]} launches on the {label} path, the "
                 f"code gives {n}")
    for name in record:
        rows[name]["launches"] = counts[name]
    return counts


def check_rollouts(gen, label, lat0, acts, nz):
    """Incremental against full-window rollout on the card, and a depth-2
    full-width rollout on the card against the port's CPU rollout (plain
    versions); tolerance 2**-5 of the latents' largest magnitude (fp32:
    E2E_F32_TOL of it)."""
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.sampling.diffusion import SamplerConfig, make_rollout
    from gtax_torch.serving import VideoGenerator

    n_gen = nz.shape[1]
    with torch.inference_mode():
        full = VideoGenerator(gen.dit_params, gen.vae_params,
                              dataclasses.replace(gen.cfg, incremental=False))
        t1 = time.perf_counter()
        lat_inc = gen._rollout(gen.dit_params, lat0, acts, None, n_gen, nz)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lat_full = full._rollout(full.dit_params, lat0, acts, None, n_gen,
                                 nz)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    if not (torch.isfinite(lat_inc).all() and torch.isfinite(lat_full).all()):
        fail(f"{label}: non-finite latents")
    dt = gen._dtype
    rel = 2.0**-5 if dt == torch.bfloat16 else E2E_F32_TOL
    scale = max(1.0, lat_full.abs().max().item())
    err = (lat_inc - lat_full).abs().max().item()
    tol = rel * scale
    log(f"[e2e {label}] incremental {(t2 - t1) / n_gen:.3f} s/frame vs "
        f"full-window {(t3 - t2) / n_gen:.3f} s/frame; latents "
        f"max_abs_err={err:.4g} (tol {tol:.4g}, max|lat| {scale:.3g})")
    if not err <= tol:
        fail(f"{label} incremental rollout disagrees with full window: "
             f"{err} > {tol}")

    cfg2 = dataclasses.replace(gen.dit_cfg, depth=2)
    params2 = dict(gen.dit_params, blocks=gen.dit_params["blocks"][:2])
    roll = make_rollout(None, cfg2.max_frames, SamplerConfig(
        ddim_noise_steps=4), cond=dit_mod.make_cond_fns(cfg2, dt),
        incremental=dit_mod.make_incremental_fns(cfg2, dt))
    with torch.inference_mode():
        on_card = roll(params2, lat0, acts, None, n_gen, nz)
        on_cpu = roll(dit_mod.params_to(params2, "cpu"), lat0.cpu(),
                      acts.cpu(), None, n_gen, nz.cpu())
    scale = max(1.0, on_cpu.abs().max().item())
    err = (on_card.cpu() - on_cpu).abs().max().item()
    tol = rel * scale
    log(f"[e2e {label}] depth-2 rollout card vs CPU: max_abs_err={err:.4g} "
        f"(tol {tol:.4g})")
    if not err <= tol:
        fail(f"{label} card rollout disagrees with CPU rollout: {err} > {tol}")


def stacked_rollout(gen, lat0, acts, nz):
    """`[e2e stacked]`: one generated frame with ServingConfig(
    unstack=False) (the stacked layout: full-window steps, no conditioning
    cache, no incremental decoding), bit-equal to the unstacked rollout
    without the conditioning cache on the same noise, with the launches of
    each counted."""
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.serving import VideoGenerator

    stacked = VideoGenerator(gen.dit_params, gen.vae_params,
                             dataclasses.replace(gen.cfg, unstack=False))
    flat = VideoGenerator(gen.dit_params, gen.vae_params,
                          dataclasses.replace(gen.cfg, cond_cache=False))
    if not dit_mod.is_stacked(stacked.dit_params):
        fail("[e2e stacked] unstack=False did not keep the stacked layout")
    fns = kernel_wrappers()
    out, counts, secs = {}, {}, {}
    with torch.inference_mode():
        for label, g in (("stacked", stacked), ("unstacked", flat)):
            for fn in fns.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            out[label] = g._rollout(g.dit_params, lat0, acts, None, 1,
                                    nz[:, :1])
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t
            counts[label] = {n: fn.launches for n, fn in fns.items()
                             if fn.launches}
    same = torch.equal(out["stacked"], out["unstacked"])
    log(f"[e2e stacked] one frame, stacked {secs['stacked']:.3f} s vs "
        f"unstacked without the conditioning cache {secs['unstacked']:.3f} "
        f"s; latents bit-equal: {same}; launches {json.dumps(counts)}")
    if not same or counts["stacked"] != counts["unstacked"]:
        fail("[e2e stacked] the stacked rollout differs from the unstacked "
             "full-window one")
    if "fused_temporal_step" in counts["stacked"] or not {
            "fused_spatial_branch", "fused_temporal_branch"} <= set(
                counts["stacked"]):
        fail(f"[e2e stacked] launches {counts['stacked']}: want the full "
             "window's fused branches and no step kernel")
    del stacked, flat
    torch.cuda.empty_cache()


def int8_vs_bf16(gen, gen8):
    """The int8 forward against the bf16 one on one window, as relative L2
    error. Gated at gtax's 2e-2 (tests/test_quant.py, depth 2) in gtax's
    weight regime carried to full width (gtax_regime, width_scaled) at
    depth 2. Reported, not gated: that regime as written, and the smoke's
    own weights at depth 2 and full depth."""
    from gtax_torch.models import dit as dit_mod

    bf = torch.bfloat16
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 5, 16, 18, 32)).astype(
        np.float32)).cuda()
    t = torch.full((1, 5), 10, device="cuda")
    a = torch.from_numpy(rng.standard_normal((1, 5, 25)).astype(
        np.float32)).cuda()
    cfg2 = dataclasses.replace(gen.dit_cfg, depth=2)
    cases = {}  # label -> (cfg, bf16 params, int8 params)
    for label, scaled in (("gtax regime, width-scaled", True),
                          ("gtax regime, 0.05 as written", False)):
        p = dit_mod.cast_params_for_inference(gtax_regime(cfg2, 7, scaled),
                                              bf)
        cases[label] = (cfg2, p, dit_mod.quantize_for_inference(p))
    for depth in (2, gen.dit_cfg.depth):
        cases[f"smoke weights, depth {depth}"] = (
            dataclasses.replace(gen.dit_cfg, depth=depth),
            *(dict(g.dit_params, blocks=g.dit_params["blocks"][:depth])
              for g in (gen, gen8)))
    rel = {}
    for label, (cfg, p16, p8) in cases.items():
        with torch.inference_mode():
            ref, out = (dit_mod.dit_apply(p, cfg, x, t, a) for p in (p16, p8))
        if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
            fail(f"int8 vs bf16 forward ({label}) is not finite")
        rel[label] = ((out - ref).norm() / ref.norm()).item()
        log(f"[e2e int8] int8 vs bf16 forward, relative L2 error, {label}: "
            f"{rel[label]:.4g}")
    gated = rel["gtax regime, width-scaled"]
    log(f"[e2e int8] gate: gtax regime, width-scaled, depth 2: {gated:.4g} "
        f"(gate 2e-2)")
    if not gated < 2e-2:
        fail(f"int8 forward off the bf16 one at depth 2: {gated} >= 2e-2")
    # gtax's own gate as gtax writes it (tests/test_quant.py:136-153): the
    # fp32 int8 forward against the fp32 dense one, on the card
    f32, rel32 = torch.float32, {}
    for label, scaled in (("gtax regime, width-scaled", True),
                          ("gtax regime, 0.05 as written", False)):
        p32 = gtax_regime(cfg2, 7, scaled)
        with torch.inference_mode():
            ref, out = (dit_mod.dit_apply(p, cfg2, x, t, a,
                                          compute_dtype=f32)
                        for p in (p32, dit_mod.quantize_for_inference(p32)))
        if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
            fail(f"fp32 int8 vs fp32 forward ({label}) is not finite")
        rel32[label] = ((out - ref).norm() / ref.norm()).item()
        log(f"[e2e int8] fp32 int8 vs fp32 forward, relative L2 error, "
            f"{label}: {rel32[label]:.4g}")
    gated = rel32["gtax regime, width-scaled"]
    log(f"[e2e int8] gtax's gate, fp32: gtax regime, width-scaled, depth 2: "
        f"{gated:.4g} (gate 2e-2)")
    if not gated < 2e-2:
        fail(f"fp32 int8 forward off the fp32 one at depth 2: {gated} >= "
             "2e-2")


def window_rows(mods, sl):
    return {"blocks": [{k: m[:, sl] for k, m in b.items()}
                       for b in mods["blocks"]],
            "final": mods["final"][:, sl]}


def int8_batched_step(gen8, rows, bf=torch.bfloat16):
    """One full-depth int8 dit_apply_step at B=4: N=4 live rows exceed the
    pair's gate, so each half-block runs the two sequential wrappers
    (fused_temporal_step_q among them), with every count zeroed just before
    the step and read just after. Its batch element 0 is held against the
    same element's B=1 step, which pairs (2**-6 of the largest output).
    bf: the compute dtype (fp32: the fp32 forms, recorded in the rows'
    "fp32")."""
    from gtax_torch.models import dit as dit_mod

    cfg, params = gen8.dit_cfg, gen8.dit_params
    tag = "" if bf == torch.bfloat16 else " fp32"
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((4, 5, 16, 18, 32)).astype(
        np.float32)).cuda()
    t = torch.from_numpy(rng.integers(0, 1000, (4, 5))).cuda()
    a = torch.from_numpy(rng.standard_normal((4, 5, 25)).astype(
        np.float32)).cuda()
    valid = [False] + [True] * 4
    fns = kernel_wrappers()

    def step(B):
        with torch.inference_mode():
            mods = dit_mod.dit_cond(params, cfg, t[:B], a[:B], bf)
            kv = dit_mod.dit_prefill(params, cfg, x[:B, :4],
                                     window_rows(mods, slice(0, 4)),
                                     valid[:4], bf)
            torch.cuda.synchronize()
            for fn in fns.values():
                fn.launches = 0
            out = dit_mod.dit_apply_step(params, cfg, x[:B, 4:], kv,
                                         window_rows(mods, slice(4, 5)),
                                         valid, bf)
            torch.cuda.synchronize()
        return out, {n: fn.launches for n, fn in fns.items() if fn.launches}

    out4, counts4 = step(4)
    out1, counts1 = step(1)
    log(f"[e2e int8{tag}] one step at B=4, launches: {json.dumps(counts4)}; "
        f"at B=1: {json.dumps(counts1)}")
    want4 = {"fused_spatial_branch_q": 16, "fused_mlp_branch_q": 32,
             "fused_temporal_step_q": 16}
    if counts4 != want4 or counts1 != {"fused_spatial_pair_q": 16,
                                       "fused_temporal_pair_q": 16}:
        fail(f"int8 step routing: B=4 {counts4}, B=1 {counts1}")
    row = (rows["fused_temporal_step_q"] if not tag
           else rows["fused_temporal_step_q"]["fp32"])
    row["launches"] = counts4["fused_temporal_step_q"]
    row["launches_on"] = (f"one int8{tag} dit_apply_step at B=4 (B=1 steps "
                          "pair)")
    ref = out1[0].float()
    err = (out4[0].float() - ref).abs().max().item()
    tol = 2.0**-6 * max(1.0, ref.abs().max().item())
    log(f"[e2e int8{tag}] B=4 sequential step, element 0, vs the B=1 paired "
        f"step: max_abs_err={err:.4g} (tol {tol:.4g}), bit_equal="
        f"{bool(torch.equal(out4[:1], out1))}")
    if not (torch.isfinite(out4).all() and err <= tol):
        fail(f"int8 B=4 step disagrees with the B=1 step: {err} > {tol}")


def pallas_path(gen, rows, inputs, lat0, acts, nz):
    """`[e2e pallas]`: VideoGenerator(attention_backend="pallas") over the
    bf16 generator's weights: full-window rollouts through the unfused
    branches, every attention on fused_mha_token_major, counted by sequence
    length (spatial 144, temporal 5, VAE 576). Then a depth-2 rollout on
    the card against the port's CPU one, and the card's `pallas` rollout
    against its `xla` rollout (2**-5 of the latents' largest magnitude)."""
    from gtax_torch.kernels import attention as kattn
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.sampling.diffusion import SamplerConfig, make_rollout
    from gtax_torch.serving import VideoGenerator

    genp = VideoGenerator(gen.dit_params, gen.vae_params,
                          dataclasses.replace(gen.cfg,
                                              attention_backend="pallas"))
    kernel_wrappers()  # resolved before the tally wraps the module's name
    wrapped, by_len = kattn.fused_mha_token_major, {}

    def tally(q, *args, **kw):
        out = wrapped(q, *args, **kw)
        if out is not None:
            by_len[q.shape[-2]] = by_len.get(q.shape[-2], 0) + 1
        return out

    kattn.fused_mha_token_major = tally
    try:
        drive_path(genp, "pallas", ("fused_mha_token_major",), rows,
                   ("fused_mha_token_major",), inputs,
                   {"fused_mha_token_major": sum(PALLAS_EXPECTED.values())})
    finally:
        kattn.fused_mha_token_major = wrapped
    log(f"[e2e pallas] fused_mha_token_major calls by sequence length: "
        f"{json.dumps(by_len)} (the code gives {PALLAS_EXPECTED})")
    if by_len != PALLAS_EXPECTED:
        fail(f"pallas path attention calls {by_len} != {PALLAS_EXPECTED}")
    rows["fused_mha_token_major"]["launches_by_sequence_length"] = by_len
    t = torch.full((1, 5), 10, device="cuda")
    window = torch.cat([lat0, nz[:, :1]], dim=1)  # the first window
    with torch.inference_mode():
        mods = dit_mod.dit_cond(genp.dit_params, genp.dit_cfg, t, acts[:, :5],
                                torch.bfloat16)
        profile_device(lambda: dit_mod.dit_apply(
            genp.dit_params, genp.dit_cfg, window, mods=mods,
            backend="pallas"), "pallas: one full-window evaluation (one "
            "denoise step), depth 16")

    n_gen = nz.shape[1]
    cfg2 = dataclasses.replace(gen.dit_cfg, depth=2)
    params2 = dict(gen.dit_params, blocks=gen.dit_params["blocks"][:2])
    bf = torch.bfloat16

    def roll(backend, params, *args):
        r = make_rollout(None, cfg2.max_frames,
                         SamplerConfig(ddim_noise_steps=4),
                         cond=dit_mod.make_cond_fns(cfg2, bf, backend))
        with torch.inference_mode():
            return r(params, *args[:2], None, n_gen, args[2])

    card = roll("pallas", params2, lat0, acts, nz)
    on_cpu = roll("pallas", dit_mod.params_to(params2, "cpu"), lat0.cpu(),
                  acts.cpu(), nz.cpu())
    xla = roll("xla", params2, lat0, acts, nz)
    for what, ref in (("card vs CPU", on_cpu), ("pallas vs xla on the card",
                                                 xla.cpu())):
        scale = max(1.0, ref.abs().max().item())
        err = (card.cpu() - ref).abs().max().item()
        tol = 2.0**-5 * scale
        log(f"[e2e pallas] depth-2 rollout {what}: max_abs_err={err:.4g} "
            f"(tol {tol:.4g})")
        if not (torch.isfinite(card).all() and err <= tol):
            fail(f"pallas depth-2 rollout, {what}: {err} > {tol}")


def sdpa_path(rows, dt=torch.bfloat16):
    """`[sdpa]`: gtax_torch.nn.attention.sdpa, the public entry point that
    fused_sdpa serves under `pallas` (no model calls it, in gtax or here),
    at the three attention shapes of the model, counts zeroed just before
    and read just after; each output against the `xla` path's (2**-6 of its
    largest magnitude; fp32, dt = torch.float32: F32_TOL, recorded in the
    row's "fp32")."""
    from gtax_torch.kernels import attention as kattn
    from gtax_torch.nn import attention as attn

    gen = np.random.default_rng(700)
    cases = [((2304, 5), [False] + [True] * 4, True), ((80, S_DIT), None,
                                                       False),
             ((96, S_VAE), None, False)]
    inputs = [([rand(gen, (*lead, HD), dtype=dt) for _ in range(3)], m, c)
              for lead, m, c in cases]
    kattn.fused_sdpa.launches = 0
    with torch.inference_mode():
        outs = [attn.sdpa(*qkv, mask=m, causal=c, backend="pallas")
                for qkv, m, c in inputs]
        torch.cuda.synchronize()
        n = kattn.fused_sdpa.launches
        refs = [attn.sdpa(*qkv, mask=m, causal=c, backend="xla")
                for qkv, m, c in inputs]
    errs = [(o.float() - r.float()).abs().max().item()
            for o, r in zip(outs, refs)]
    f32 = dt == torch.float32
    log(f"[sdpa] nn.attention.sdpa(backend='pallas') at S=5 (causal+keys), "
        f"144, 576, {'fp32' if f32 else 'bf16'}: fused_sdpa launches {n}; "
        f"max_abs_err vs xla {errs}")
    if n != len(cases):
        fail(f"fused_sdpa launched {n} times for {len(cases)} sdpa calls")
    for e, r in zip(errs, refs):
        bound = (F32_TOL * r.abs().max().item() if f32
                 else 2.0**-6 * max(1.0, r.float().abs().max().item()))
        if not e <= bound:
            fail(f"sdpa pallas vs xla: {errs}")
    row = rows["fused_sdpa"]["fp32"] if f32 else rows["fused_sdpa"]
    row["launches"] = n
    row["launches_on"] = (
        f"three nn.attention.sdpa(backend='pallas') calls"
        f"{', fp32' if f32 else ''}")


# the approximate serving modes at full width, APPROX_DEPTH blocks
# (`[e2e approx]`):
# label, the ServingConfig fields that differ from the exact generator's
APPROX_MODES = [
    ("bf16 pipelined P=4", dict(pipeline_depth=4)),
    ("int8 pipelined P=4", dict(pipeline_depth=4, quantize="int8")),
    ("int8 pipelined P=2", dict(pipeline_depth=2, quantize="int8")),
    ("bf16 broadcast K=2", dict(attn_broadcast=2)),
    ("bf16 broadcast K=2, fused_all",
     dict(attn_broadcast=2, attention_backend="fused_all")),
    ("int8 broadcast K=2", dict(attn_broadcast=2, quantize="int8")),
]
# and at depth 2 on the card against the port's CPU rollout, 4 noise steps:
# the modes above and the other backends gtax allows for them
APPROX_DEPTH2 = APPROX_MODES + [
    ("bf16 pipelined P=2 + broadcast K=2 (full window)",
     dict(pipeline_depth=2, attn_broadcast=2)),
    ("bf16 pipelined P=3, fused_mlp (full window)",
     dict(pipeline_depth=3, attention_backend="fused_mlp")),
    ("bf16 broadcast K=2, xla", dict(attn_broadcast=2,
                                     attention_backend="xla")),
    ("bf16 broadcast K=2, pallas", dict(attn_broadcast=2,
                                        attention_backend="pallas")),
]


APPROX_DEPTH = 4  # [e2e approx]'s depth cut (full width): its timed
#                  rollouts at 16 blocks took 115-178 s of the smoke
APPROX_MODEL = f"DiT-S/2 depth {APPROX_DEPTH}"


def approx_generator(gen):
    """The bf16 generator's first APPROX_DEPTH blocks at full width (its
    VAE whole), registered as APPROX_MODEL, for `[e2e approx]`."""
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.serving import VideoGenerator

    cut = dataclasses.replace(gen.dit_cfg, depth=APPROX_DEPTH)
    dit_mod.DiT_MODELS[APPROX_MODEL] = lambda: cut
    return VideoGenerator(
        dict(gen.dit_params, blocks=gen.dit_params["blocks"][:APPROX_DEPTH]),
        gen.vae_params, dataclasses.replace(gen.cfg, dit_model=APPROX_MODEL))


def approx_expected(cfg, dit_cfg, vae_cfg, n_gen):
    """(kernel launches, DiT calls) of one B=1 generate of n_gen frames in
    an approximate mode, from the code. Broadcast (exact rollout, full
    window): step k of a frame's steps + 1 collects when k % K == 0 or at
    the last, else reuses; a collect launches each block's two attention
    branches, every call its two MLP branches (fused under int8,
    `fused_mlp` and `fused_all`). Pipelined (incremental under `fused`):
    n_gen + P - 1 cycles of one prefill over W - P context rows and stride
    = ceil((steps + 1) / P) steps over P live rows; an int8 half-block over
    at most PAIR_MAX_FRAMES rows is one paired launch. The VAE: one
    encode and one decode through its fused blocks."""
    from gtax_torch.kernels.pair import PAIR_MAX_FRAMES

    L, W, steps = dit_cfg.depth, dit_cfg.max_frames, cfg.noise_steps
    P, K, q8 = cfg.pipeline_depth, cfg.attn_broadcast, cfg.quantize == "int8"
    n = {"fused_vae_block": vae_cfg.enc_depth + vae_cfg.dec_depth}

    def add(name, k):
        n[name] = n.get(name, 0) + k

    if K > 1:
        collect = n_gen * sum(1 for k in range(steps + 1)
                              if k % K == 0 or k == steps)
        calls = n_gen * (steps + 1)
        sfx = "_q" if q8 else ""
        add("fused_spatial_branch" + sfx, L * collect)
        add("fused_temporal_branch" + sfx, L * collect)
        if q8 or cfg.attention_backend in ("fused_mlp", "fused_all"):
            add("fused_mlp_branch" + sfx, 2 * L * calls)
        return n, {"collect": collect, "reuse": calls - collect}
    stride = -(-(steps + 1) // P)
    cycles = n_gen + P - 1
    calls = cycles * stride
    for rows, k, temporal in ((W - P, cycles, "fused_temporal_branch"),
                              (P, calls, "fused_temporal_step")):
        if not q8:
            add("fused_spatial_branch", L * k)
            add("fused_mlp_branch", 2 * L * k)
            add(temporal, L * k)
        elif rows <= PAIR_MAX_FRAMES:
            add("fused_spatial_pair_q", L * k)
            if temporal == "fused_temporal_step":
                add("fused_temporal_pair_q", L * k)
            else:
                add("fused_temporal_branch_q", L * k)
                add("fused_mlp_branch_q", L * k)
        else:
            add("fused_spatial_branch_q", L * k)
            add("fused_mlp_branch_q", 2 * L * k)
            add(temporal + "_q", L * k)
    return n, {"prefill": cycles, "step": calls}


def count_dit_calls():
    """Wrap gtax_torch.models.dit's forwards to count calls by kind (the
    rollouts' pab and incremental fns resolve them at call time); returns
    (counts, restore)."""
    from gtax_torch.models import dit as dit_mod

    counts = dict.fromkeys(("collect", "reuse", "plain", "prefill", "step"),
                           0)
    real = {n: getattr(dit_mod, n) for n in ("dit_apply", "dit_prefill",
                                             "dit_apply_step")}

    def apply(*a, **kw):
        kind = ("collect" if kw.get("collect_cache") else "reuse"
                if kw.get("attn_cache") is not None else "plain")
        counts[kind] += 1
        return real["dit_apply"](*a, **kw)

    def prefill(*a, **kw):
        counts["prefill"] += 1
        return real["dit_prefill"](*a, **kw)

    def step(*a, **kw):
        counts["step"] += 1
        return real["dit_apply_step"](*a, **kw)

    dit_mod.dit_apply, dit_mod.dit_prefill = apply, prefill
    dit_mod.dit_apply_step = step

    def restore():
        for name, fn in real.items():
            setattr(dit_mod, name, fn)

    return counts, restore


def latents_close(label, what, got, ref):
    """Gate: within 2**-5 of the reference latents' largest magnitude."""
    scale = max(1.0, ref.abs().max().item())
    err = (got.cpu().float() - ref.cpu().float()).abs().max().item()
    tol = 2.0**-5 * scale
    log(f"[e2e approx] {label}: {what}: max_abs_err={err:.4g} "
        f"(tol {tol:.4g})")
    if not (torch.isfinite(got).all() and err <= tol):
        fail(f"{label}: {what}: {err} > {tol}")
    return err


def approx_path(gen, rows, inputs, lat0, acts):
    """`[e2e approx]`: each APPROX_MODES generator over the weights of
    `gen` (approx_generator's cut of the bf16 generator; int8: quantized
    by the serving path), one seeded
    generate with every launch count and every DiT call kind zeroed just
    before it and read just after (both must be approx_expected's), then
    its s/frame and the exact generator's in turns in this process (exact,
    mode, mode, exact; every run printed); then from the
    same starting noise (frame s of a pipelined rollout starts from draw s)
    its latents against the exact rollout's (PSNR / SSIM of the decoded
    frames), the pipelined incremental rollout against its full window,
    and the broadcast rollout at K=1 against the exact one (bit-equal).
    Last, every APPROX_DEPTH2 mode at depth 2 on the card against the
    port's CPU rollout."""
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.sampling.diffusion import SamplerConfig, make_rollout
    from gtax_torch.serving import VideoGenerator, build_rollout
    from gtax_torch.utils import metrics

    prompt, actions, noise = inputs
    n_prompt, n_frames = prompt.shape[1], actions.shape[1]
    n_gen, steps, bf = n_frames - n_prompt, gen.cfg.noise_steps, torch.bfloat16
    draws = torch.cat([torch.from_numpy(noise), torch.from_numpy(np.clip(
        np.random.default_rng(11).standard_normal((1, 3, *noise.shape[2:])),
        -20, 20).astype(np.float32))], dim=1).cuda()  # one a cycle, P <= 4
    fns = kernel_wrappers()
    summary = {}
    exact = {"bf16": gen, "int8": VideoGenerator(
        gen.dit_params, gen.vae_params,
        dataclasses.replace(gen.cfg, quantize="int8"))}

    def s_per_frame(g):
        """The rollout's s/frame of one seeded generate."""
        g.generate(prompt, actions, num_frames=n_frames, seed=1)
        return g.last_timings["rollout_s"] / n_gen

    def in_turns(g, ref_g):
        """s/frame of four generates in turns, A B B A: the exact
        generator, the mode's, the mode's, the exact one (the first
        generate of each, which forms its host-side caches, is done)."""
        runs = {"exact": [], "mode": []}
        for who in ("exact", "mode", "mode", "exact"):
            runs[who].append(s_per_frame(ref_g if who == "exact" else g))
        return runs

    ref = {}
    for kind, g in exact.items():
        g.generate(prompt, actions, num_frames=n_frames, seed=0)
        first = g.last_timings["rollout_s"] / n_gen
        with torch.inference_mode():
            lat = g._rollout(g.dit_params, lat0, acts, None, n_gen,
                             draws[:, :n_gen])
            pix = g._decode(lat).cpu().numpy()[0, n_prompt:]
        ref[kind] = (g, lat, pix)
        log(f"[e2e approx] exact {kind} (incremental, fused): first "
            f"generate {first:.3f} s/frame, {steps + 1} DiT evaluations a "
            "generated frame")
    with torch.inference_mode():  # broadcast at K=1: the exact rollout
        k1 = make_rollout(None, gen.dit_cfg.max_frames, SamplerConfig(
            ddim_noise_steps=steps, attn_broadcast=1),
            pab=dit_mod.make_pab_fns(gen.dit_cfg, bf, "fused"),
            cond=dit_mod.make_cond_fns(gen.dit_cfg, bf, "fused"),
            incremental=dit_mod.make_incremental_fns(gen.dit_cfg, bf))(
            gen.dit_params, lat0, acts, None, n_gen, draws[:, :n_gen])
    equal = bool(torch.equal(k1, ref["bf16"][1]))
    log(f"[e2e approx] bf16 broadcast K=1 vs the exact rollout: "
        f"bit_equal={equal}")
    if not equal:
        fail("attention broadcast at K=1 differs from the exact rollout")

    for label, changes in APPROX_MODES:
        cfg = dataclasses.replace(gen.cfg, **changes)
        kind = "int8" if cfg.quantize == "int8" else "bf16"
        g = VideoGenerator(gen.dit_params, gen.vae_params, cfg)
        want, want_calls = approx_expected(cfg, gen.dit_cfg, gen.vae_cfg,
                                           n_gen)
        for fn in fns.values():
            fn.launches = 0
        calls, restore = count_dit_calls()
        try:
            pixels = g.generate(prompt, actions, num_frames=n_frames, seed=0)
        finally:
            restore()
        counts = {n: fn.launches for n, fn in fns.items() if fn.launches}
        calls = {k: v for k, v in calls.items() if v}
        first = g.last_timings["rollout_s"] / n_gen
        runs = in_turns(g, ref[kind][0])
        ratio = np.mean(runs["mode"]) / np.mean(runs["exact"])
        evals = sum(calls.get(k, 0) for k in ("collect", "reuse", "plain",
                                               "step")) / n_gen
        log(f"[e2e approx] {label}: s/frame in turns exact, mode, mode, "
            f"exact: {runs['exact'][0]:.3f} {runs['mode'][0]:.3f} "
            f"{runs['mode'][1]:.3f} {runs['exact'][1]:.3f} (mode / exact "
            f"{ratio:.3f}; first generate {first:.3f}); DiT evaluations a "
            f"generated frame {evals:.1f} (exact {steps + 1}); calls "
            f"{json.dumps(calls)}; launches {json.dumps(counts)}")
        if pixels.shape != (1, n_frames, *ref[kind][2].shape[1:]):
            fail(f"{label} generate returned {pixels.shape}")
        if counts != want:
            fail(f"{label}: launches {counts}, the code gives {want}")
        if calls != want_calls:
            fail(f"{label}: DiT calls {calls}, the code gives {want_calls}")
        for name, n in counts.items():
            rows[name].setdefault("launches_approx", {})[label] = n
        P = cfg.pipeline_depth
        with torch.inference_mode():
            lat = g._rollout(g.dit_params, lat0, acts, None, n_gen,
                             draws[:, :n_gen + P - 1])
            pix = g._decode(lat).cpu().numpy()[0, n_prompt:]
            if P > 1:  # the incremental rollout against its full window
                full = VideoGenerator(g.dit_params, g.vae_params,
                                      dataclasses.replace(cfg,
                                                          incremental=False))
                latents_close(label, "incremental vs full window",
                              lat, full._rollout(full.dit_params, lat0, acts,
                                                 None, n_gen,
                                                 draws[:, :n_gen + P - 1]))
                del full
        if not torch.isfinite(lat).all():
            fail(f"{label}: non-finite latents")
        move = (lat - ref[kind][1]).abs().max().item()
        q = {"psnr_db": float(np.mean(metrics.per_frame_psnr(
            pix, ref[kind][2]))), "ssim": float(np.mean(
                metrics.per_frame_ssim(pix, ref[kind][2])))}
        log(f"[e2e approx] {label}: vs the exact {kind} rollout from the "
            f"same noise: latents max_abs_diff={move:.4g}, decoded frames "
            f"PSNR {q['psnr_db']:.2f} dB, SSIM {q['ssim']:.4f} (random "
            "weights: how far the mode moves the output)")
        summary[label] = {"s_per_frame": runs["mode"],
                          "exact_s_per_frame": runs["exact"],
                          "mode_over_exact": ratio,
                          "first_s_per_frame": first,
                          "dit_calls": calls,
                          "dit_evaluations_per_frame": evals,
                          "latents_max_abs_diff_vs_exact": move, **q}
        del g
        torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(gen.dit_cfg, depth=2)
    for label, changes in APPROX_DEPTH2:
        cfg = dataclasses.replace(gen.cfg, noise_steps=4, **changes)
        params2 = dit_mod.cast_params_for_inference(dict(
            gen.dit_params, blocks=gen.dit_params["blocks"][:2]), bf)
        if cfg.quantize == "int8":
            params2 = dit_mod.quantize_for_inference(params2)
        roll = build_rollout(cfg2, cfg, bf)
        nz = draws[:, :n_gen + cfg.pipeline_depth - 1]
        with torch.inference_mode():
            card = roll(params2, lat0, acts, None, n_gen, nz)
            on_cpu = roll(dit_mod.params_to(params2, "cpu"), lat0.cpu(),
                          acts.cpu(), None, n_gen, nz.cpu())
        err = latents_close(label, "depth-2 rollout card vs CPU", card,
                            on_cpu)
        summary.setdefault("depth2_card_vs_cpu", {})[label] = err
    return summary


def e2e_fp32(rows, inputs, expect):
    """`[e2e fp32]`: VideoGenerator(dtype="float32") at full width and
    depth under `fused` (the fp32 forms of #1-#5), the same prompt, actions
    and injected noise as the bf16 run, with every launch count zeroed
    before and read after: each kernel launched exactly as often as in the
    bf16 rollout (`expect`). Then incremental against full window, and a
    depth-2 rollout on the card against the port's CPU one (plain versions,
    fp32) under `fused`, `fused_all` and `xla` (E2E_F32_TOL of the
    latents' largest magnitude). The same seeded weights as the bf16
    generator's, not cast (gtax serves fp32 so)."""
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.serving import ServingConfig, VideoGenerator, build_rollout
    from gtax_torch.sampling.diffusion import SamplerConfig
    from gtax_torch.train.trainer import encode_frames

    t0 = time.perf_counter()
    cfg = ServingConfig(noise_steps=100, dtype="float32")
    gen = VideoGenerator.load("", "", cfg)
    nonzero_adaln(gen.dit_params, 2)
    prompt, actions, noise = inputs
    counts = drive_path(gen, "fp32", BF16_PATH, rows, (), inputs, expect)
    for name in BF16_PATH:
        rows[name]["fp32"]["launches"] = counts[name]
    f32 = torch.float32
    with torch.inference_mode():
        lat0 = encode_frames(gen.vae_params, gen.vae_cfg,
                             torch.from_numpy(prompt).cuda(), f32, fused=True)
    acts = torch.from_numpy(actions).cuda()
    nz = torch.from_numpy(noise).cuda()
    check_rollouts(gen, "fp32", lat0, acts, nz)
    # depth 2 under the other backends that serve fp32 on the card
    cfg2 = dataclasses.replace(gen.dit_cfg, depth=2)
    params2 = dict(gen.dit_params, blocks=gen.dit_params["blocks"][:2])
    cpu2 = dit_mod.params_to(params2, "cpu")
    errs = {}
    for backend in ("fused_all", "xla"):
        roll = build_rollout(cfg2, dataclasses.replace(
            cfg, attention_backend=backend, noise_steps=4), f32)
        with torch.inference_mode():
            on_card = roll(params2, lat0, acts, None, nz.shape[1], nz)
            on_cpu = roll(cpu2, lat0.cpu(), acts.cpu(), None, nz.shape[1],
                          nz.cpu())
        scale = max(1.0, on_cpu.abs().max().item())
        err = (on_card.cpu() - on_cpu).abs().max().item()
        errs[backend] = err / scale
        log(f"[e2e fp32] depth-2 {backend} rollout card vs CPU: "
            f"max_abs_err={err:.4g} (tol {E2E_F32_TOL * scale:.4g})")
        if not err <= E2E_F32_TOL * scale:
            fail(f"fp32 {backend} card rollout disagrees with the CPU one")
    tm = gen.last_timings
    n_gen = noise.shape[1]
    out = {"s_per_frame": tm["rollout_s"] / n_gen,
           "encode_ms": tm["encode_s"] * 1e3,
           "decode_ms": tm["decode_s"] * 1e3, "launches": counts,
           "depth2_err_over_max": errs}
    t1 = time.perf_counter()
    out["modes"] = f32_serving_modes(gen, rows, inputs, lat0, acts, nz)
    log(f"[time] e2e fp32 int8 / pallas: {time.perf_counter() - t1:.1f} s")
    out["seconds"] = time.perf_counter() - t0
    log(f"[time] e2e fp32: {out['seconds']:.1f} s")
    del gen, params2, cpu2
    gc.collect()
    torch.cuda.empty_cache()
    return out


# [e2e fp32]'s int8 and `pallas` generators (label, the ServingConfig fields
# that differ from the fp32 `fused` generator's) and the launches each
# generate must make: the bf16 int8 path's counts (INT8_EXPECTED) under
# `fused` and `fused_all` (the int8 blocks run the int8 wrappers and pairs
# under both), the bf16 `pallas` path's (PALLAS_EXPECTED, by sequence
# length), and under `pallas` with int8 the int8 wrappers over the full
# window (16 blocks x 202 window evaluations; two MLP branches a block)
# with the unfused VAE's 18 token-major attentions
F32_MODES = [
    ("int8 fused", dict(quantize="int8")),
    ("int8 fused_all", dict(quantize="int8", attention_backend="fused_all")),
    ("pallas", dict(attention_backend="pallas")),
    ("pallas int8", dict(attention_backend="pallas", quantize="int8")),
]
PALLAS_INT8_EXPECTED = {"fused_spatial_branch_q": 3232,
                        "fused_temporal_branch_q": 3232,
                        "fused_mlp_branch_q": 6464}


def f32_mode_expected(label):
    """(launch counts by wrapper, fused_mha_token_major calls by sequence
    length) of one F32_MODES generate."""
    if label.startswith("int8"):
        return {k: v for k, v in INT8_EXPECTED.items() if v}, {}
    if label == "pallas":
        return ({"fused_mha_token_major": sum(PALLAS_EXPECTED.values())},
                PALLAS_EXPECTED)
    return ({**PALLAS_INT8_EXPECTED, "fused_mha_token_major": 18},
            {S_VAE: 18})


def f32_serving_modes(gen, rows, inputs, lat0, acts, nz):
    """`[e2e fp32]`, int8 and `pallas`: each F32_MODES generator over the
    fp32 generator's weights (not cast; int8: quantized from them, as gtax
    serves fp32 with int8), one generate of the same prompt, actions and
    noise with every launch count zeroed before and read after: exactly
    f32_mode_expected's counts, so the fused int8 rollout launches the fp32
    forms of #7-#11 at the bf16 int8 counts and the `pallas` one the fp32
    #16 at the bf16 `pallas` counts; s/frame. Then each mode's depth-2
    rollout on the card against the port's CPU one (plain versions, fp32),
    within E2E_F32_TOL of the latents' largest magnitude."""
    from gtax_torch.kernels import attention as kattn
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.serving import VideoGenerator, build_rollout

    f32, n_gen = torch.float32, nz.shape[1]
    kernel_wrappers()  # resolved before the tally wraps the module's name
    wrapped, by_len = kattn.fused_mha_token_major, {}

    def tally(q, *args, **kw):
        out = wrapped(q, *args, **kw)
        if out is not None:
            by_len[q.shape[-2]] = by_len.get(q.shape[-2], 0) + 1
        return out

    cfg2 = dataclasses.replace(gen.dit_cfg, depth=2)
    params2 = dict(gen.dit_params, blocks=gen.dit_params["blocks"][:2])
    summary = {}
    for label, changes in F32_MODES:
        cfg = dataclasses.replace(gen.cfg, **changes)
        g = VideoGenerator(gen.dit_params, gen.vae_params, cfg)
        want, want_len = f32_mode_expected(label)
        by_len.clear()
        kattn.fused_mha_token_major = tally
        try:  # the wrapper counts on its module's name: the tally's
            fns = kernel_wrappers()
            for fn in fns.values():
                fn.launches = 0
            pixels = g.generate(*inputs[:2], num_frames=inputs[1].shape[1],
                                noise=inputs[2])
            counts = {n: fn.launches for n, fn in fns.items() if fn.launches}
        finally:
            kattn.fused_mha_token_major = wrapped
        s_frame = g.last_timings["rollout_s"] / n_gen
        log(f"[e2e fp32] {label}: generate {s_frame:.3f} s/frame; launches "
            f"{json.dumps(counts)}; fused_mha_token_major by sequence length "
            f"{json.dumps(by_len)}")
        if pixels.shape[:2] != (1, inputs[1].shape[1]):
            fail(f"fp32 {label} generate returned {pixels.shape}")
        if counts != want or by_len != want_len:
            fail(f"fp32 {label}: launches {counts} (by length {by_len}), the "
                 f"code gives {want} ({want_len})")
        for name, n in counts.items():
            rows[name].setdefault("fp32", {}).setdefault(
                "launches_by_mode", {})[label] = n
            if label in ("int8 fused", "pallas"):
                rows[name]["fp32"]["launches"] = n
        p2 = (dit_mod.quantize_for_inference(params2)
              if cfg.quantize == "int8" else params2)
        roll = build_rollout(cfg2, dataclasses.replace(cfg, noise_steps=4),
                             f32)
        with torch.inference_mode():
            card = roll(p2, lat0, acts, None, n_gen, nz)
            on_cpu = roll(dit_mod.params_to(p2, "cpu"), lat0.cpu(),
                          acts.cpu(), None, n_gen, nz.cpu())
        scale = max(1.0, on_cpu.abs().max().item())
        err = (card.cpu() - on_cpu).abs().max().item()
        log(f"[e2e fp32] {label}: depth-2 rollout card vs CPU: "
            f"max_abs_err={err:.4g} (tol {E2E_F32_TOL * scale:.4g})")
        if not (torch.isfinite(card).all() and err <= E2E_F32_TOL * scale):
            fail(f"fp32 {label} card rollout disagrees with the CPU one")
        summary[label] = {"s_per_frame": s_frame, "launches": counts,
                          "mha_by_length": dict(by_len),
                          "depth2_err_over_max": err / scale}
        if label == "int8 fused":  # #6 in fp32: the sequential B=4 step
            int8_batched_step(g, rows, f32)
        del g, p2
        torch.cuda.empty_cache()
    return summary


def end_to_end(rows):
    from gtax_torch.data.actions import forward_actions
    from gtax_torch.serving import ServingConfig, VideoGenerator
    from gtax_torch.train.trainer import encode_frames

    n_prompt, n_frames, steps = 4, 6, 100
    cfg = ServingConfig(noise_steps=steps)
    t0 = time.perf_counter()
    gen = VideoGenerator.load("", "", cfg)
    nonzero_adaln(gen.dit_params, 2)
    torch.cuda.synchronize()
    log(f"[e2e] DiT-S/2 ({gen.dit_cfg.depth} blocks, D={D}) + ViT-L/20 "
        f"random weights on {gen.device}: {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    vc = gen.vae_cfg
    prompt = rng.random((1, n_prompt, 3, vc.input_height, vc.input_width),
                        np.float32)
    noise = np.clip(rng.standard_normal((1, n_frames - n_prompt, 16, 18, 32)),
                    -20, 20).astype(np.float32)
    actions = forward_actions(1, n_frames)
    inputs = (prompt, actions, noise)
    with torch.inference_mode():
        lat0 = encode_frames(gen.vae_params, vc, torch.from_numpy(
            prompt).cuda(), torch.bfloat16, fused=True)
    acts = torch.from_numpy(actions).cuda()
    nz = torch.from_numpy(noise).cuda()

    bf16_counts = drive_path(gen, "bf16", BF16_PATH, rows, BF16_PATH, inputs)
    check_rollouts(gen, "bf16", lat0, acts, nz)
    stacked_rollout(gen, lat0, acts, nz)
    profile_frame(gen, lat0, acts, nz)
    fp32 = e2e_fp32(rows, inputs, bf16_counts)

    # the same bf16 weights, quantized by the serving path
    gen8 = VideoGenerator(gen.dit_params, gen.vae_params,
                          dataclasses.replace(cfg, quantize="int8"))
    drive_path(gen8, "int8", INT8_PATH, rows, INT8_PATH[:5], inputs,
               INT8_EXPECTED)
    check_rollouts(gen8, "int8", lat0, acts, nz)
    profile_frame(gen8, lat0, acts, nz)
    int8_batched_step(gen8, rows)
    int8_vs_bf16(gen, gen8)
    del gen8
    torch.cuda.empty_cache()

    pallas_path(gen, rows, inputs, lat0, acts, nz)
    sdpa_path(rows)
    sdpa_path(rows, torch.float32)
    t0 = time.perf_counter()
    summary = approx_path(approx_generator(gen), rows, inputs, lat0, acts)
    log(f"[time] e2e approx: {time.perf_counter() - t0:.1f} s")
    return {"approx": summary, "fp32": fp32}


# ------------------------------------------------------------- training

TRAIN_CONFIG = "configs/train_dit_actions.yaml"
# what the smoke changes in that config, and why
TRAIN_CUTS = {
    "dataset_type": ("dummy", "the GTA V clips are not in the repository; "
                     "gtax's synthetic clips at 360x640"),
    "vae_checkpoint": ("", "checkpoint not in the repository: random VAE"),
    "pretrained_model": (None, "checkpoint not in the repository: random "
                         "DiT, adaLN heads drawn nonzero"),
    "max_steps": (3, "a few steps"),
    "validation_steps": (0, "no validation run"),
    "save_every": (0, "checkpoints are timed in [train resume]"),
    "use_wandb": (False, "no network"),
}
BWD_PATH = {"fused_spatial_branch_bwd": 16, "fused_temporal_branch_bwd": 16,
            "fused_mlp_branch_bwd": 32}  # launches per micro-step
# the frozen VAE encodes unfused (gtax's trainer: encode_frames' default),
# its attention on the plain path under fused_all: no kernel of its own
TRAIN_PATH = ("fused_spatial_branch", "fused_mlp_branch",
              "fused_temporal_branch", *BWD_PATH)
GRAD_TOL = 5e-2  # relative L2 per gradient leaf
# fp32 training's gradients, kernel path against plain path and card
# against CPU, relative L2 per leaf (stated before the first fp32 training
# run): fp32 has no rounding points, only summation orders differ
F32_GRAD_TOL = 1e-3


def read_flat_yaml(path):
    """The `key: value` lines of a flat YAML config (PyYAML may be missing
    on the card's machine): ints, floats, true/false, null, strings."""
    out = {}
    for line in open(path):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        key, value = (part.strip() for part in line.split(":", 1))
        low = value.lower()
        if low in ("true", "false"):
            out[key] = low == "true"
        elif low in ("null", "~", ""):
            out[key] = None
        else:
            for cast in (int, float, str):
                try:
                    out[key] = cast(value)
                    break
                except ValueError:
                    continue
    return out


def train_wrappers():
    from gtax_torch.kernels import backward, block

    return {name: getattr(backward if name in BWD_PATH else block, name)
            for name in TRAIN_PATH}


def leaf_grads(params):
    from gtax_torch.train.optim import leaves

    return {path: p.grad.detach().float().clone()
            for path, p in leaves(params) if p.grad is not None}


def compare_grads(label, got, ref, tol=GRAD_TOL):
    """Relative L2 error of every gradient leaf; fails above tol."""
    rel = {path: ((got[path].cpu() - g).norm() / g.norm()).item()
           for path, g in ((p, r.cpu()) for p, r in ref.items())
           if g.norm() > 0}
    if set(got) != set(ref):
        fail(f"{label}: gradient leaves differ")
    worst = max(rel, key=rel.get)
    vals = sorted(rel.values())
    log(f"[train] {label}: {len(rel)} leaves, relative L2 median "
        f"{vals[len(vals) // 2]:.3g}, max {rel[worst]:.3g} at "
        f"{'/'.join(map(str, worst))} (tol {tol})")
    if not (all(math.isfinite(v) for v in vals) and rel[worst] <= tol):
        fail(f"{label}: gradients disagree ({rel[worst]} > {tol})")
    return {"median": vals[len(vals) // 2], "max": rel[worst],
            "leaves": len(rel)}


def micro_grads(params, cfg, latents, acts, draws, loss_cfg, abar,
                noise_range, with_loss=False, **dit_kw):
    """Gradients of one micro-batch's summed loss, for fixed draws (and
    that loss, with_loss); dit_kw: dit_apply's plain_branches, backend,
    int8_fwd."""
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.sampling.diffusion import diffusion_forcing_loss
    from gtax_torch.train.optim import leaves

    for _, p in leaves(params):
        p.grad = None

    def fn(x, t, a, valid):
        return dit_mod.dit_apply(params, cfg, x, t, a, valid, **dit_kw)

    _, total = diffusion_forcing_loss(fn, latents, acts, None, loss_cfg,
                                      abar, noise_range, draws=draws)
    total.backward()
    grads = leaf_grads(params)
    return (total.detach(), grads) if with_loss else grads


def latent_cache_turns(trainer, clips, cache_dir, tag):
    """The same clips as a pixel batch and as a latent-cache batch (the
    cache built with the trainer's VAE, backend and batch): a train step
    of each timed in turns (pixel, latent, latent, pixel) and profiled
    once. Returns (pixel batch, latent batch, step times, build seconds)."""
    from gtax_torch.data.latents import LatentCacheDataset
    from gtax_torch.data.loader import DataLoader

    B = trainer.config.batch_size
    t = time.perf_counter()
    cache = LatentCacheDataset.build(
        clips, trainer.vae_params, trainer.vae_cfg, cache_dir,
        encode_batch=B, compute_dtype=trainer.compute_dtype,
        backend=trainer.config.attention_backend, progress_every=0)
    build_s = time.perf_counter() - t
    pix = next(trainer.iter_device_batches(DataLoader(clips, B,
                                                      shuffle=False)))
    lat = next(trainer.iter_device_batches(DataLoader(cache, B,
                                                      shuffle=False)))
    if not lat.is_latents:
        fail(f"[{tag}] the latent cache gave pixel batches")
    turns = {"pixel": [], "latent": []}
    for kind in ("pixel", "latent", "latent", "pixel"):
        m = trainer.train_step_sync(pix if kind == "pixel" else lat)
        turns[kind].append(m["step_time_s"])
    log(f"[{tag}] step_time_s at B={B} in turns pixel, latent, latent, "
        f"pixel: {turns['pixel'][0]:.4f} {turns['latent'][0]:.4f} "
        f"{turns['latent'][1]:.4f} {turns['pixel'][1]:.4f} (cache of {B} "
        f"clips built in {build_s:.2f} s)")
    for kind, b in (("pixel", pix), ("latent-cache", lat)):
        profile_device(lambda b=b: trainer.train_step_sync(b),
                       f"one train step, B={B}, {kind} batch", top=4)
    return pix, lat, turns, build_s


def train_phase(rows):
    from gtax_torch.data.dummy import DummyDataset
    from gtax_torch.data.loader import DataLoader
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.sampling.diffusion import draw_loss_noise
    from gtax_torch.train.config import TrainingConfig
    from gtax_torch.train.optim import decays, leaves
    from gtax_torch.train.trainer import Trainer, encode_frames

    raw = read_flat_yaml(TRAIN_CONFIG)
    for key, (value, why) in TRAIN_CUTS.items():
        log(f"[train] cut {key}: {raw.get(key)!r} -> {value!r} ({why})")
        raw[key] = value
    cfg = TrainingConfig.from_dict(raw)
    steps, B = cfg.max_steps, cfg.batch_size
    dcfg = dit_mod.DiT_MODELS[cfg.dit_model]()
    params = dit_mod.dit_init(dcfg, torch.Generator(device="cuda")
                              .manual_seed(cfg.seed), "cuda")
    nonzero_adaln(params, 4)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, total_dataset_size=B * steps, dit_params=params)
    log(f"[train] {cfg.dit_model} ({dcfg.depth} blocks, D={dcfg.hidden_size})"
        f" + {cfg.vae_model}, B={B}, accumulation "
        f"{cfg.gradient_accumulation_steps}, {cfg.compute_dtype}, "
        f"{cfg.attention_backend}, mu_bf16={cfg.mu_bf16}: trainer ready in "
        f"{time.perf_counter() - t0:.1f} s")
    watch = [path for path, _ in leaves(trainer.dit_params)
             if decays(path)][::23]
    before = {path: p.detach().clone() for path, p in
              leaves(trainer.dit_params) if path in watch}
    loader = DataLoader(DummyDataset("train", return_actions=True,
                                     size=B * steps), B, seed=cfg.seed)
    records = []

    def report(tr, m):
        mem = torch.cuda.max_memory_allocated() / 2**30
        records.append(m)
        log(f"[train] step {m['step']}: train_loss={m['train_loss']:.5g} "
            f"grad_norm={m['grad_norm']:.5g} step_time_s="
            f"{m['step_time_s']:.4f} mfu={m['mfu']:.4f} lr="
            f"{m['learning_rate']:.3g} peak_memory={mem:.2f} GiB")

    fns = train_wrappers()
    micro_steps = cfg.gradient_accumulation_steps * steps
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    for fn in fns.values():
        fn.launches = 0
    trainer.training_loop(loader, None, callbacks=[report])
    counts = {name: fn.launches for name, fn in fns.items()}
    log(f"[train] launches over {steps} steps: {json.dumps(counts)}")
    log("[train] backward launches per micro-step: " + ", ".join(
        f"{name} {counts[name] // micro_steps}" for name in BWD_PATH))
    if len(records) != steps or trainer.global_step != steps:
        fail(f"train: {len(records)} records for {steps} steps")
    for m in records:
        if not (math.isfinite(m["train_loss"])
                and math.isfinite(m["grad_norm"])):
            fail(f"train: non-finite metrics {m}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"{name} was not launched on the train path")
    for name, n in BWD_PATH.items():
        if counts[name] != n * micro_steps:
            fail(f"{name}: {counts[name]} launches, want {n} per micro-step")
        rows[name]["launches"] = counts[name] // steps
    for name in TRAIN_PATH[:3]:
        rows[name]["train_launches"] = counts[name] // steps
    moved = [not torch.equal(before[path], p) for path, p in
             leaves(trainer.dit_params) if path in before]
    log(f"[train] parameters moved: {sum(moved)} of {len(moved)} watched "
        "leaves")
    if not all(moved):
        fail("train: parameters did not move")
    batch = next(trainer.iter_device_batches(loader))
    prof = profile_device(lambda: trainer.train_step_sync(batch),
                          f"one train step, B={B}, batch already on the card")
    rows["train"] = {"step_time_s": [m["step_time_s"] for m in records],
                     "mfu": [m["mfu"] for m in records],
                     "train_loss": [m["train_loss"] for m in records],
                     "peak_memory_gib":
                         torch.cuda.max_memory_allocated() / 2**30,
                     "resident_gib": resident, "profile": prof}
    log(f"[train] peak memory {rows['train']['peak_memory_gib']:.2f} GiB, "
        f"{rows['train']['peak_memory_gib'] - resident:.2f} above the "
        f"{resident:.2f} GiB resident when the steps began (the trainer's "
        "state, the VAE and the DiT init the training modes reuse)")

    # the step's frozen-VAE encode, unfused as gtax's trainer runs it,
    # against the fused VAE block kernels on the same B=16 clips
    v16 = torch.from_numpy(next(iter(DataLoader(DummyDataset(
        "train", return_actions=True, size=B), B, shuffle=False))).video)
    v16 = v16.cuda()
    timer = Timer(iters=3)
    with torch.no_grad():
        def fused():
            return encode_frames(trainer.vae_params, trainer.vae_cfg, v16,
                                 trainer.compute_dtype, fused=True)

        unfused_ms, fused_ms = timer(lambda: trainer.encode(v16)), timer(fused)
        a, f = trainer.encode(v16), fused()
    err = (a - f).abs().max().item()
    log(f"[train] frozen-VAE encode of B={B} clips ({v16.shape[1]} frames "
        f"each): unfused (the step's) {unfused_ms:.2f} ms, fused block "
        f"kernels {fused_ms:.2f} ms; latents max_abs_err {err:.4g} "
        f"(max|lat| {f.abs().max().item():.3g})")
    rows["train"]["vae_encode_ms"] = {"unfused": unfused_ms,
                                      "fused": fused_ms}
    del v16, a, f
    import shutil

    try:
        rows["train"]["latent_cache_step_time_s"] = latent_cache_turns(
            trainer, DummyDataset("train", return_actions=True, size=B),
            f"{RESUME_DIR}/latents", "train")[2]
    finally:
        shutil.rmtree(RESUME_DIR, ignore_errors=True)

    # one B=2 micro-batch: the kernel path against the plain path (xla_*
    # branches under autograd) on the card, at full width and depth
    gen = torch.Generator(device="cuda").manual_seed(5)
    b = next(iter(DataLoader(DummyDataset("train", return_actions=True,
                                          size=2), 2, shuffle=False)))
    lat = trainer.encode(torch.from_numpy(b.video).cuda())
    acts = torch.from_numpy(b.actions).cuda()
    draws = draw_loss_noise(lat, trainer.loss_cfg, gen)
    consts = (trainer.loss_cfg, trainer.alphas_cumprod, trainer.noise_range)
    p = trainer.dit_params
    t1 = time.perf_counter()
    g_kernel = micro_grads(p, dcfg, lat, acts, draws, *consts)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    g_plain = micro_grads(p, dcfg, lat, acts, draws, *consts,
                          plain_branches=True)
    torch.cuda.synchronize()
    log(f"[train] B=2 micro-batch gradients: kernel path {t2 - t1:.3f} s, "
        f"plain path {time.perf_counter() - t2:.3f} s")
    compare_grads("B=2 kernel path vs plain path, full depth", g_kernel,
                  g_plain)
    del g_plain

    # depth 2: the card's gradients against the port's CPU gradients
    cfg2 = dataclasses.replace(dcfg, depth=2)
    p2 = dict(p, blocks=p["blocks"][:2])
    g_card = micro_grads(p2, cfg2, lat, acts, draws, *consts)
    p2_cpu = dit_mod._map_params(
        p2, lambda _, a: a.detach().cpu().requires_grad_(a.requires_grad))
    g_cpu = micro_grads(p2_cpu, cfg2, lat.cpu(), acts.cpu(),
                        {k: v.cpu() for k, v in draws.items()},
                        consts[0], *(c.cpu() for c in consts[1:]))
    compare_grads("depth 2, card vs CPU (plain versions)", g_card, g_cpu)
    for _, q in leaves(p):
        q.grad = None
    # what the training modes' phases share: the config, the DiT init, the
    # VAE, one B=16 device batch, and this trainer (the bf16 path)
    return {"raw": raw, "params": params, "vae": trainer.vae_params,
            "batch": batch, "trainer": trainer}


# `[train int8]`, `[train remat]`, `[train backends]`, `[train stacked]`:
# the training modes of configs/train_dit_actions.yaml beside `[train]`'s
# bf16 `fused_all` step (its cuts, one DiT init and one VAE)
INT8_TRAIN_PATH = {"fused_spatial_branch_q": 16, "fused_temporal_branch_q": 16,
                   "fused_mlp_branch_q": 32, **BWD_PATH}  # a micro-step
# the launches a backend's micro-step must make (True: some, False: none)
BACKEND_PATH = {
    "xla": {},
    "fused": {"fused_spatial_branch": True, "fused_temporal_branch": True,
              "fused_spatial_branch_bwd": True,
              "fused_temporal_branch_bwd": True},
    "fused_mlp": {"fused_mlp_branch": True, "fused_mlp_branch_bwd": True},
}


def mode_wrappers():
    """The training path's wrappers, bf16 and int8 forwards and the three
    backwards."""
    from gtax_torch.kernels import quant

    return {**train_wrappers(),
            **{name: getattr(quant, name) for name in INT8_TRAIN_PATH
               if name.endswith("_q")}}


def mode_trainer(ctx, tag, **overrides):
    """A Trainer of the shared config and init, with overrides (printed)."""
    from gtax_torch.train.config import TrainingConfig
    from gtax_torch.train.trainer import Trainer

    raw = dict(ctx["raw"], **overrides)
    log(f"[{tag}] config: {json.dumps(overrides)} over [train]'s")
    cfg = TrainingConfig.from_dict(raw)
    return Trainer(cfg, total_dataset_size=cfg.batch_size * cfg.max_steps,
                   dit_params=ctx["params"], vae_params=ctx["vae"])


def step_figures(trainer, batch, label):
    """A synced train step's metrics, its peak memory and its profile."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m = trainer.train_step_sync(batch)
    m["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    m["profile"] = profile_device(lambda: trainer.train_step_sync(batch),
                                  label, top=6)
    return m


def micro_batch(ctx, B, seed, tr=None):
    """(latents, actions, draws) of one micro-batch of B clips, encoded by
    the [train] trainer (or tr), with its loss noise drawn once."""
    from gtax_torch.data.dummy import DummyDataset
    from gtax_torch.data.loader import DataLoader
    from gtax_torch.sampling.diffusion import draw_loss_noise

    tr = tr or ctx["trainer"]
    b = next(iter(DataLoader(DummyDataset("train", return_actions=True,
                                          size=B), B, shuffle=False)))
    with torch.no_grad():
        lat = tr.encode(torch.from_numpy(b.video).cuda())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (lat, torch.from_numpy(b.actions).cuda(),
            draw_loss_noise(lat, tr.loss_cfg, gen))


def train_int8_phase(ctx, rows):
    """`[train int8]`: int8_forward under fused_all at B=16, 3 steps (the
    trainer's train_step on the loader's batches, no evals) with every
    count zeroed before and read after; one micro-step's gradients
    against the bf16 path's."""
    from gtax_torch.data.dummy import DummyDataset
    from gtax_torch.data.loader import DataLoader

    tag = "train int8"
    tr = mode_trainer(ctx, tag, int8_forward=True)
    fns = mode_wrappers()
    cfg = tr.config
    steps = cfg.max_steps
    micro = cfg.gradient_accumulation_steps * steps
    batches = list(tr.iter_device_batches(DataLoader(
        DummyDataset("train", return_actions=True,
                     size=cfg.batch_size * steps),
        cfg.batch_size, seed=cfg.seed)))
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    for fn in fns.values():
        fn.launches = 0
    records = []
    for i, b in enumerate(batches):
        records.append(dict(tr.train_step_sync(b), step=i + 1))
    counts = {name: fn.launches for name, fn in fns.items()}
    per = {name: n // micro for name, n in counts.items()}
    log(f"[{tag}] launches per micro-step: {json.dumps(per)}")
    want = {name: INT8_TRAIN_PATH.get(name, 0) for name in fns}
    if counts != {name: n * micro for name, n in want.items()}:
        fail(f"[{tag}] launches {per} a micro-step, the code gives {want}")
    for name in ("fused_spatial_branch_q", "fused_temporal_branch_q",
                 "fused_mlp_branch_q"):
        rows[name]["train_launches"] = counts[name] // steps
    for m in records:
        log(f"[{tag}] step {m['step']}: train_loss={m['train_loss']:.5g} "
            f"grad_norm={m['grad_norm']:.5g} step_time_s="
            f"{m['step_time_s']:.4f} mfu={m['mfu']:.4f}")
        if not (math.isfinite(m["train_loss"])
                and math.isfinite(m["grad_norm"])):
            fail(f"[{tag}] non-finite metrics {m}")
    if len(records) != steps:
        fail(f"[{tag}] {len(records)} records for {steps} steps")
    peak = torch.cuda.max_memory_allocated() / 2**30
    fig = step_figures(tr, ctx["batch"], f"one int8-forward train step, "
                       f"B={cfg.batch_size}")
    bf = rows["train"]
    log(f"[{tag}] int8 vs bf16 ([train]): loss {records[-1]['train_loss']:.5g}"
        f" vs {bf['train_loss'][-1]:.5g}; step_time_s "
        f"{[round(m['step_time_s'], 4) for m in records]} vs "
        f"{[round(t, 4) for t in bf['step_time_s']]}; mfu "
        f"{[round(m['mfu'], 4) for m in records]} vs "
        f"{[round(t, 4) for t in bf['mfu']]}; device busy "
        f"{(fig['profile'] or {}).get('device_busy_ms')} vs "
        f"{(bf['profile'] or {}).get('device_busy_ms')} ms; peak memory "
        f"{peak - resident:.2f} vs "
        f"{bf['peak_memory_gib'] - bf['resident_gib']:.2f} GiB above the "
        f"resident {resident:.2f} vs {bf['resident_gib']:.2f} GiB (here the "
        "[train] trainer is resident too)")

    # one B=16 micro-step on the int8 trainer's masters, int8 forward
    # against the bf16 one, the same batch and noise
    lat, acts, draws = micro_batch(ctx, cfg.batch_size, 6)
    consts = (tr.loss_cfg, tr.alphas_cumprod, tr.noise_range)
    l8, g8 = micro_grads(tr.dit_params, tr.dit_cfg, lat, acts, draws,
                         *consts, with_loss=True, int8_fwd=True)
    lb, gb = micro_grads(tr.dit_params, tr.dit_cfg, lat, acts, draws,
                         *consts, with_loss=True)
    log(f"[{tag}] micro-step loss (summed) int8 {l8.item():.6g} vs bf16 "
        f"{lb.item():.6g}")
    compare_grads(f"[{tag}] B={cfg.batch_size} micro-step, int8 forward vs "
                  "bf16 forward", g8, gb)
    rows["train"]["int8"] = {
        "step_time_s": [m["step_time_s"] for m in records],
        "mfu": [m["mfu"] for m in records],
        "train_loss": [m["train_loss"] for m in records],
        "peak_memory_gib": peak, "resident_gib": resident,
        "profile": fig["profile"],
        "launches_per_micro_step": per}
    del tr, g8, gb
    torch.cuda.empty_cache()


def train_remat_phase(ctx, rows):
    """`[train remat]`: remat: true at B=16. One micro-step's loss and
    every gradient bit-equal to remat: false on the same masters, batch
    and noise, each micro-step's peak memory; full steps in turns."""
    import dataclasses as dc

    from gtax_torch.train.optim import leaves

    tag = "train remat"
    tr = mode_trainer(ctx, tag, remat=True)
    lat, acts, draws = micro_batch(ctx, tr.config.batch_size, 7)
    consts = (tr.loss_cfg, tr.alphas_cumprod, tr.noise_range)
    out = {}
    for remat in (False, True):
        cfg = dc.replace(tr.dit_cfg, block_remat=remat)
        for _, p in leaves(tr.dit_params):
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out[remat] = micro_grads(tr.dit_params, cfg, lat, acts, draws,
                                 *consts, with_loss=True)
        torch.cuda.synchronize()
        out[remat] += (time.perf_counter() - t,
                       (torch.cuda.max_memory_allocated() - resident)
                       / 2**30)
    (l0, g0, s0, m0), (l1, g1, s1, m1) = out[False], out[True]
    same = torch.equal(l0, l1) and all(torch.equal(g0[k], g1[k]) for k in g0)
    log(f"[{tag}] micro-step B={tr.config.batch_size}: loss {l0.item():.7g} "
        f"(remat off) vs {l1.item():.7g} (on); loss and all {len(g0)} "
        f"gradient leaves bit-equal: {same}; peak memory above the "
        f"resident {m0:.2f} vs {m1:.2f} GiB (the gradients' 2.4 GB "
        f"included); forward + backward {s0:.3f} vs {s1:.3f} s")
    if not same or set(g0) != set(g1):
        fail(f"[{tag}] remat changes the loss or a gradient")
    del g0, g1
    figs = {}
    base = ctx["trainer"]
    for kind in ("plain", "remat", "remat", "plain"):
        t = tr if kind == "remat" else base
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        m = t.train_step_sync(ctx["batch"])
        figs.setdefault(kind, []).append(
            (round(m["step_time_s"], 4), round(
                (torch.cuda.max_memory_allocated() - resident) / 2**30, 3)))
    log(f"[{tag}] full B=16 steps in turns (step_time_s, peak GiB above the "
        f"resident {resident / 2**30:.2f} GiB of both trainers): remat off "
        f"{figs['plain']}, on {figs['remat']}")
    prof = profile_device(lambda: tr.train_step_sync(ctx["batch"]),
                          f"one remat train step, B={tr.config.batch_size}",
                          top=6)
    rows["train"]["remat"] = {
        "micro_step_peak_gib": {"off": m0, "on": m1},
        "micro_step_s": {"off": s0, "on": s1},
        "steps_in_turns": figs, "profile": prof}
    del tr
    torch.cuda.empty_cache()


def train_backends_phase(ctx, rows):
    """`[train backends]`: xla, fused and fused_mlp at full width and
    depth, one B=2 micro-step each on the [train] masters, gradients
    against fused_all's on the same batch and noise, each with its
    launches counted; `pallas` refused before a step."""
    from gtax_torch.train.config import TrainingConfig
    from gtax_torch.train.optim import leaves
    from gtax_torch.train.trainer import check_slice

    tag = "train backends"
    tr = ctx["trainer"]
    lat, acts, draws = micro_batch(ctx, 2, 8)
    consts = (tr.loss_cfg, tr.alphas_cumprod, tr.noise_range)
    fns = mode_wrappers()
    grads, counts, secs = {}, {}, {}
    for backend in ("fused_all", *BACKEND_PATH):
        for fn in fns.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        grads[backend] = micro_grads(tr.dit_params, tr.dit_cfg, lat, acts,
                                     draws, *consts, backend=backend)
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t
        counts[backend] = {n: fn.launches for n, fn in fns.items()
                           if fn.launches}
        log(f"[{tag}] {backend}: B=2 micro-step {secs[backend]:.3f} s, "
            f"launches {json.dumps(counts[backend])}")
    for backend, need in BACKEND_PATH.items():
        got = counts[backend]
        if set(got) != {n for n, on in need.items() if on}:
            fail(f"[{tag}] {backend} launched {sorted(got)}, its path is "
                 f"{sorted(need)}")
        compare_grads(f"[{tag}] {backend} vs fused_all, B=2, full depth",
                      grads[backend], grads["fused_all"])
    try:
        check_slice(TrainingConfig.from_dict(dict(
            ctx["raw"], attention_backend="pallas")))
    except ValueError as e:
        log(f"[{tag}] pallas refused before a step: {e}")
    else:
        fail(f"[{tag}] a pallas trainer was not refused")
    rows["train"]["backends"] = {"micro_step_s": secs, "launches": counts}
    del grads
    for _, p in leaves(tr.dit_params):
        p.grad = None
    torch.cuda.empty_cache()


def train_stacked_phase(ctx, rows):
    """`[train stacked]`: unstack_train: false at B=2, 2 steps, against
    the unstacked layout on the same batch and noise: losses within 1e-6
    relative (gtax's bar), the masters' largest relative difference
    printed."""
    from gtax_torch.data.dummy import DummyDataset
    from gtax_torch.data.loader import DataLoader
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.train.optim import leaves

    tag = "train stacked"
    runs = {}
    for unstack in (True, False):
        tr = mode_trainer(ctx, tag, batch_size=2, max_steps=2,
                          unstack_train=unstack)
        if dit_mod.is_stacked(tr.dit_params) == unstack:
            fail(f"[{tag}] unstack_train={unstack} gave the other layout")
        b = next(tr.iter_device_batches(DataLoader(DummyDataset(
            "train", return_actions=True, size=2), 2, shuffle=False)))
        ms = [tr.train_step_sync(b) for _ in range(2)]
        masters = dit_mod.unstack_for_inference(tr.dit_params, tr.dit_cfg)
        runs[unstack] = ([m["train_loss"] for m in ms],
                         [m["step_time_s"] for m in ms],
                         {k: v.detach().clone() for k, v in
                          leaves(masters)})
        del tr, masters
        torch.cuda.empty_cache()
    (lu, tu, mu), (ls, ts, ms_) = runs[True], runs[False]
    rel = max((rel_l2(ms_[k], mu[k]), k) for k in mu)
    worst = max(((ms_[k] - mu[k]).abs().max() / mu[k].abs().max().clamp_min(
        1e-30)).item() for k in mu)
    log(f"[{tag}] losses stacked {ls} vs unstacked {lu}; step_time_s "
        f"{ts} vs {tu}; masters' largest relative difference {worst:.3e} "
        f"(largest relative L2 {rel[0]:.3e} at {'/'.join(map(str, rel[1]))})")
    if not np.allclose(ls, lu, rtol=1e-6, atol=0):
        fail(f"[{tag}] the layouts' losses differ beyond 1e-6")
    rows["train"]["stacked"] = {"loss": ls, "unstacked_loss": lu,
                                "masters_max_rel_diff": worst}


# `[train fp32]`'s launches a micro-step: the fp32 forms of #1-#3 and
# #12-#14, at the bf16 counts
F32_TRAIN_PATH = {"fused_spatial_branch": 16, "fused_mlp_branch": 32,
                  "fused_temporal_branch": 16, **BWD_PATH}


def launch_counts(fns, want, micro, label):
    """Every wrapper's launches a micro-step against want (0 where absent);
    fails on any difference."""
    counts = {name: fn.launches for name, fn in fns.items()}
    per = {name: n // micro for name, n in counts.items()}
    log(f"[{label}] launches per micro-step: {json.dumps(per)}")
    if counts != {name: want.get(name, 0) * micro for name in fns}:
        fail(f"[{label}] launches {per} a micro-step, the code gives "
             f"{ {name: want.get(name, 0) for name in fns} }")
    return per


def train_fp32_phase(ctx, rows):
    """`[train fp32]`: [train]'s config with compute_dtype float32 under
    fused_all at full width and depth (B=16, the same cuts), 3 steps with
    every count zeroed before and read after (the fp32 forms of #1 16, #2
    32, #3 16, #12 16, #13 16, #14 32 a micro-step); finite losses, moved
    parameters; step time, MFU at the fp32 rate (67 TFLOP/s), device busy
    and peak memory; one B=2 micro-batch's kernel-path gradients against
    the plain path on the card, and the depth-2 card gradients against the
    CPU's, both within F32_GRAD_TOL relative L2 a leaf. Then `[train int8]
    fp32`: one B=16 int8_forward micro-step over fp32 activations (#7 16,
    #8 16, #9 32, none of #1-#3), its gradients against the fp32 dense
    forward's (GRAD_TOL); and `[train backends] fp32`: xla, fused and
    fused_mlp B=2 micro-steps against fused_all's (F32_GRAD_TOL), with
    their launches."""
    from gtax_torch.data.dummy import DummyDataset
    from gtax_torch.data.loader import DataLoader
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.train.optim import decays, leaves

    tag, f32 = "train fp32", torch.float32
    tr = mode_trainer(ctx, tag, compute_dtype="float32")
    fns = mode_wrappers()
    cfg, dcfg = tr.config, tr.dit_cfg
    steps, B = cfg.max_steps, cfg.batch_size
    micro = cfg.gradient_accumulation_steps * steps
    batches = list(tr.iter_device_batches(DataLoader(
        DummyDataset("train", return_actions=True, size=B * steps), B,
        seed=cfg.seed)))
    watch = [path for path, _ in leaves(tr.dit_params) if decays(path)][::23]
    before = {path: p.detach().clone() for path, p in
              leaves(tr.dit_params) if path in watch}
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    for fn in fns.values():
        fn.launches = 0
    records = [dict(tr.train_step_sync(b), step=i + 1)
               for i, b in enumerate(batches)]
    per = launch_counts(fns, F32_TRAIN_PATH, micro, tag)
    for name in F32_TRAIN_PATH:
        rows[name].setdefault("fp32", {})["train_launches"] = (
            per[name] * cfg.gradient_accumulation_steps)
        if name in BWD_PATH:
            rows[name]["fp32"]["launches"] = rows[name]["fp32"][
                "train_launches"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    for m in records:
        m["mfu_fp32"] = m["mfu"] * BF16_FLOPS_PER_S / F32_FLOPS_PER_S
        log(f"[{tag}] step {m['step']}: train_loss={m['train_loss']:.5g} "
            f"grad_norm={m['grad_norm']:.5g} step_time_s="
            f"{m['step_time_s']:.4f} mfu (fp32 peak)={m['mfu_fp32']:.4f}")
        if not (math.isfinite(m["train_loss"])
                and math.isfinite(m["grad_norm"])):
            fail(f"[{tag}] non-finite metrics {m}")
    if len(records) != steps:
        fail(f"[{tag}] {len(records)} records for {steps} steps")
    moved = [not torch.equal(before[path], p) for path, p in
             leaves(tr.dit_params) if path in before]
    log(f"[{tag}] parameters moved: {sum(moved)} of {len(moved)} watched "
        "leaves")
    if not all(moved):
        fail(f"[{tag}] parameters did not move")
    fig = step_figures(tr, batches[0], f"one fp32 train step, B={B}")
    log(f"[{tag}] peak memory {peak:.2f} GiB ({peak - resident:.2f} above "
        f"the {resident:.2f} GiB resident, the [train] trainer included); "
        f"device busy {(fig['profile'] or {}).get('device_busy_ms')} ms "
        f"(bf16 {(rows['train']['profile'] or {}).get('device_busy_ms')})")
    out = {"step_time_s": [m["step_time_s"] for m in records],
           "mfu_fp32": [m["mfu_fp32"] for m in records],
           "train_loss": [m["train_loss"] for m in records],
           "peak_memory_gib": peak, "resident_gib": resident,
           "profile": fig["profile"], "launches_per_micro_step": per}

    # one B=2 micro-batch: the kernel path against the plain path, full depth
    lat, acts, draws = micro_batch(ctx, 2, 9, tr)
    consts = (tr.loss_cfg, tr.alphas_cumprod, tr.noise_range)
    p = tr.dit_params
    t1 = time.perf_counter()
    g_kernel = micro_grads(p, dcfg, lat, acts, draws, *consts,
                           compute_dtype=f32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    g_plain = micro_grads(p, dcfg, lat, acts, draws, *consts,
                          compute_dtype=f32, plain_branches=True)
    torch.cuda.synchronize()
    log(f"[{tag}] B=2 micro-batch gradients: kernel path {t2 - t1:.3f} s, "
        f"plain path {time.perf_counter() - t2:.3f} s")
    out["kernel_vs_plain"] = compare_grads(
        f"[{tag}] B=2 kernel path vs plain path, full depth", g_kernel,
        g_plain, F32_GRAD_TOL)
    del g_plain
    # depth 2: the card's gradients against the port's CPU gradients
    cfg2 = dataclasses.replace(dcfg, depth=2)
    p2 = dict(p, blocks=p["blocks"][:2])
    g_card = micro_grads(p2, cfg2, lat, acts, draws, *consts,
                         compute_dtype=f32)
    p2_cpu = dit_mod._map_params(
        p2, lambda _, a: a.detach().cpu().requires_grad_(a.requires_grad))
    g_cpu = micro_grads(p2_cpu, cfg2, lat.cpu(), acts.cpu(),
                        {k: v.cpu() for k, v in draws.items()},
                        consts[0], *(c.cpu() for c in consts[1:]),
                        compute_dtype=f32)
    out["card_vs_cpu"] = compare_grads(
        f"[{tag}] depth 2, card vs CPU (plain versions)", g_card, g_cpu,
        F32_GRAD_TOL)
    del g_card, g_cpu, p2_cpu

    # [train int8] fp32: one int8_forward micro-step over fp32 activations
    lab = "train int8] [fp32"
    lat, acts, draws = micro_batch(ctx, B, 10, tr)
    for fn in fns.values():
        fn.launches = 0
    l8, g8 = micro_grads(p, dcfg, lat, acts, draws, *consts, with_loss=True,
                         compute_dtype=f32, int8_fwd=True)
    torch.cuda.synchronize()
    per8 = launch_counts(fns, INT8_TRAIN_PATH, 1, lab)
    for name in ("fused_spatial_branch_q", "fused_temporal_branch_q",
                 "fused_mlp_branch_q"):
        rows[name].setdefault("fp32", {})["train_launches"] = per8[name]
    ld, gd = micro_grads(p, dcfg, lat, acts, draws, *consts, with_loss=True,
                         compute_dtype=f32)
    log(f"[{lab}] micro-step loss (summed) int8 {l8.item():.6g} vs fp32 "
        f"dense {ld.item():.6g}")
    out["int8"] = compare_grads(
        f"[{lab}] B={B} micro-step, int8 forward vs fp32 dense forward", g8,
        gd)
    out["int8"]["launches_per_micro_step"] = per8
    del g8, gd

    # [train backends] fp32: each backend's B=2 micro-step
    lab = "train backends] [fp32"
    lat, acts, draws = micro_batch(ctx, 2, 11, tr)
    grads, counts = {}, {}
    for backend in ("fused_all", *BACKEND_PATH):
        for fn in fns.values():
            fn.launches = 0
        grads[backend] = micro_grads(p, dcfg, lat, acts, draws, *consts,
                                     compute_dtype=f32, backend=backend)
        counts[backend] = {n: fn.launches for n, fn in fns.items()
                           if fn.launches}
        log(f"[{lab}] {backend}: launches {json.dumps(counts[backend])}")
    out["backends"] = {"launches": counts}
    for backend, need in BACKEND_PATH.items():
        if set(counts[backend]) != {n for n, on in need.items() if on}:
            fail(f"[{lab}] {backend} launched {sorted(counts[backend])}, "
                 f"its path is {sorted(need)}")
        out["backends"][backend] = compare_grads(
            f"[{lab}] {backend} vs fused_all, B=2, full depth",
            grads[backend], grads["fused_all"], F32_GRAD_TOL)
    rows["train"]["fp32"] = out
    del grads, tr
    for _, q in leaves(p):
        q.grad = None
    torch.cuda.empty_cache()


def train_modes_phase(ctx, rows):
    for label, fn in (("train int8", train_int8_phase),
                      ("train remat", train_remat_phase),
                      ("train backends", train_backends_phase),
                      ("train fp32", train_fp32_phase),
                      ("train stacked", train_stacked_phase)):
        t = time.perf_counter()
        fn(ctx, rows)
        log(f"[time] {label}: {time.perf_counter() - t:.1f} s")


# `[train resume]`: checkpoints, resume, export, latent cache, evals
RESUME_DIR = "_smoke_train"  # in the checkout; removed when the phase ends
RESUME_CUTS = {
    "dataset_type": ("dummy", "the GTA V clips are not in the repository; "
                     "gtax's synthetic clips at 360x640"),
    "vae_checkpoint": ("", "checkpoint not in the repository: random VAE"),
    "pretrained_model": (None, "checkpoint not in the repository: random "
                         "DiT, adaLN heads drawn nonzero"),
    "batch_size": (2, "two full-size trainers, one after the other, and a "
                   "latent cache in one phase"),
    "max_steps": (3, "steps 1-2, a save, step 3 before and after resume"),
    "save_every": (2, "one full checkpoint and one export, at step 2"),
    "validation_steps": (0, "the evals are called directly, at 2 "
                         "generated frames"),
    "use_wandb": (False, "no network"),
    "output_dir": (RESUME_DIR, "inside the checkout, removed at the end"),
}
RESUME_TOL = 1e-6  # relative L2 of the loss and of every master leaf


def rel_l2(got, ref):
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return ((got - ref).norm() / max(ref.norm().item(), 1e-30)).item()


def train_resume_phase(rows):
    import shutil

    raw = read_flat_yaml(TRAIN_CONFIG)
    for key, (value, why) in RESUME_CUTS.items():
        log(f"[train resume] cut {key}: {raw.get(key)!r} -> {value!r} "
            f"({why})")
        raw[key] = value
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    try:
        return resume_checks(raw, rows)
    finally:
        shutil.rmtree(RESUME_DIR, ignore_errors=True)


def resume_checks(raw, rows):
    import os

    from gtax_torch.data.dummy import DummyDataset
    from gtax_torch.data.loader import Batch, DataLoader
    from gtax_torch.io import safetensors_port as port
    from gtax_torch.io.video import write_video
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.models import vae as vae_mod
    from gtax_torch.train import checkpoint as ckpt
    from gtax_torch.train import trainer as trainer_mod
    from gtax_torch.train.config import TrainingConfig

    cfg = TrainingConfig.from_dict(raw)
    dcfg = dit_mod.DiT_MODELS[cfg.dit_model]()
    vcfg = vae_mod.VAE_MODELS[cfg.vae_model]()
    B, steps, L = cfg.batch_size, cfg.max_steps, dcfg.depth
    fns = train_wrappers()
    seconds, out = {}, {}

    def clips(n):
        return DummyDataset("train", return_actions=True, size=n,
                            height=vcfg.input_height, width=vcfg.input_width)

    def make():
        params = dit_mod.dit_init(dcfg, torch.Generator(device="cuda")
                                  .manual_seed(cfg.seed), "cuda")
        nonzero_adaln(params, 4)
        return trainer_mod.Trainer(cfg, total_dataset_size=B * steps,
                                   dit_params=params)

    def loader():
        return DataLoader(clips(B * steps), B, seed=cfg.seed)

    def timed(name, fn):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = fn(*args)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
            return result
        return call

    # the uninterrupted run: steps 1-3, the full state and export at 2
    first = make()
    first.save_checkpoint = timed("checkpoint_write_s", first.save_checkpoint)
    first.save_model = timed("export_write_s", first.save_model)
    rec_a, at_save = {}, {}

    def keep(tr, m):
        rec_a[m["step"]] = m
        if m["step"] == 2:  # flushed: the state about to be saved
            at_save.update({k: v.detach().cpu().clone() for k, v in
                            ckpt.flat(tr.dit_params).items()})

    first.training_loop(loader(), None, callbacks=[keep])
    final_a = {k: v.detach().cpu().clone()
               for k, v in ckpt.flat(first.dit_params).items()}
    del first
    torch.cuda.empty_cache()
    state_dir = os.path.join(ckpt.ckpt_dir(RESUME_DIR, cfg.model_name),
                             "state_2")
    out["checkpoint_bytes"] = sum(
        os.path.getsize(os.path.join(state_dir, f)) for f in
        os.listdir(state_dir))
    export = os.path.join(RESUME_DIR,
                          f"{cfg.model_name}_epoch_1_2.safetensors")
    out["export_bytes"] = os.path.getsize(export)

    # a new trainer resumes from step 2 and runs step 3
    second = make()
    second.try_resume = timed("checkpoint_read_s", second.try_resume)
    rec_b = {}
    for fn in fns.values():
        fn.launches = 0
    second.training_loop(loader(), None,
                         callbacks=[lambda tr, m: rec_b.update(
                             {m["step"]: m})])
    counts = {name: fn.launches for name, fn in fns.items()}
    log(f"[train resume] resumed run (step 3) launches: "
        f"{json.dumps(counts)}")
    want = {"fused_spatial_branch": L, "fused_mlp_branch": 2 * L,
            "fused_temporal_branch": L, "fused_spatial_branch_bwd": L,
            "fused_temporal_branch_bwd": L, "fused_mlp_branch_bwd": 2 * L}
    if counts != want:
        fail(f"[train resume] launches {counts}, one micro-step gives {want}")
    for name, n in counts.items():
        rows[name]["launches_resume_step"] = n
    if sorted(rec_b) != [3] or second.skip_batches != 2:
        fail(f"[train resume] resumed steps {sorted(rec_b)}, skipped "
             f"{second.skip_batches} batches (want [3] after 2)")
    loss_err = abs(rec_b[3]["train_loss"] - rec_a[3]["train_loss"]) / abs(
        rec_a[3]["train_loss"])
    final_b = ckpt.flat(second.dit_params)
    errs = {k: rel_l2(final_b[k], v) for k, v in final_a.items()}
    worst = max(errs, key=errs.get)
    bit_equal = (rec_b[3]["train_loss"] == rec_a[3]["train_loss"] and all(
        torch.equal(final_b[k].detach().cpu(), v)
        for k, v in final_a.items()))
    log(f"[train resume] step 3 after resume vs uninterrupted: loss "
        f"{rec_b[3]['train_loss']:.7g} vs {rec_a[3]['train_loss']:.7g} "
        f"(relative {loss_err:.3g}), masters worst relative L2 "
        f"{errs[worst]:.3g} at {worst} (tol {RESUME_TOL}); bit_equal="
        f"{bit_equal}")
    if not (loss_err <= RESUME_TOL and errs[worst] <= RESUME_TOL):
        fail("[train resume] the resumed step differs from the "
             "uninterrupted one")
    del final_a, final_b
    t = time.perf_counter()
    exported = ckpt.flat(port.load_dit(export, dcfg, verbose=False))
    seconds["export_read_s"] = time.perf_counter() - t
    same = set(exported) == set(at_save) and all(
        torch.equal(exported[k], v) for k, v in at_save.items())
    log(f"[train resume] export ({out['export_bytes']} bytes) read by "
        f"load_dit: bit-equal to the masters at step 2: {same}")
    if not same:
        fail("[train resume] the export differs from the masters")
    del exported, at_save
    log(f"[train resume] full state {out['checkpoint_bytes']} bytes: write "
        f"{seconds['checkpoint_write_s']:.2f} s, read (resume) "
        f"{seconds['checkpoint_read_s']:.2f} s; export write "
        f"{seconds['export_write_s']:.2f} s, read "
        f"{seconds['export_read_s']:.2f} s")

    # the latent cache: the same clips encoded once, then stepped on
    pix, lat, turns, seconds["latent_cache_build_s"] = latent_cache_turns(
        second, clips(B), os.path.join(RESUME_DIR, "latents"),
        "train resume")
    out["step_time_s"] = turns
    with torch.no_grad():
        losses = [second.loss(second.dit_params, b.video[0], b.actions[0],
                              torch.Generator(device="cuda").manual_seed(9),
                              b.is_latents)[0].item() for b in (pix, lat)]
    cache_err = abs(losses[1] - losses[0]) / abs(losses[0])
    log(f"[train resume] latent-cache loss {losses[1]:.7g} vs pixel "
        f"{losses[0]:.7g} on the same clips and draws (relative "
        f"{cache_err:.3g}, tol {RESUME_TOL}); bit_equal="
        f"{losses[0] == losses[1]}")
    if not cache_err <= RESUME_TOL:
        fail("[train resume] cached latents change the loss")

    # the evals: the rollout eval and the renoise eval on the card
    batch = Batch(pix.video[0], pix.actions[0])
    n_frames = cfg.n_prompt_frames + 2
    calls, restore = count_dit_calls()
    real_decode = trainer_mod.decode_frames
    finite = []

    def decode(params, vcfg, latents, *args, **kw):
        finite.append(bool(torch.isfinite(latents).all()))
        return real_decode(params, vcfg, latents, *args, **kw)

    trainer_mod.decode_frames = decode
    try:
        for name, call in (
                ("predict_frames",
                 lambda: second.predict_frames(batch, n_frames)),
                ("predict_noise", lambda: second.predict_noise(batch))):
            for fn in fns.values():
                fn.launches = 0
            for k in calls:
                calls[k] = 0
            result = timed(f"{name}_s", call)()
            n = {k: fns[k].launches for k in TRAIN_PATH[:3]}
            dit = calls["plain"]
            log(f"[train resume] {name}: {seconds[name + '_s']:.2f} s, "
                f"{dit} DiT calls, launches {json.dumps(n)}")
            if dit <= 0 or n != {"fused_spatial_branch": L * dit,
                                 "fused_mlp_branch": 2 * L * dit,
                                 "fused_temporal_branch": L * dit}:
                fail(f"[train resume] {name}: launches {n} for {dit} calls")
            for k, v in n.items():
                rows[k].setdefault("launches_evals", {})[name] = v
            if name == "predict_frames":
                shape = (n_frames, second.vae_cfg.input_height,
                         second.vae_cfg.input_width, 3)
                if result.shape != shape or result.dtype != np.uint8:
                    fail(f"[train resume] predict_frames gave "
                         f"{result.shape} {result.dtype}, want {shape}")
                frames = result
            elif not (result.shape == (1,) + lat.video.shape[2:]
                      and torch.isfinite(result).all()):
                fail(f"[train resume] predict_noise gave {result.shape}")
    finally:
        restore()
        trainer_mod.decode_frames = real_decode
    if not (finite and all(finite)):
        fail("[train resume] non-finite rollout latents")
    try:
        path = os.path.join(RESUME_DIR, "predict.mp4")
        write_video(path, frames, fps=10)
        log(f"[train resume] mp4 written ({os.path.getsize(path)} bytes)")
    except RuntimeError as e:
        log(f"[train resume] mp4 not written, no writer here: {e}")
    grid = os.path.join("debug_visualizations", f"{cfg.model_name}_noise_"
                        f"gs_{second.global_step}.png")
    log(f"[train resume] renoise grid written: {os.path.exists(grid)}"
        + ("" if os.path.exists(grid) else " (matplotlib: " + (
            "present" if _importable("matplotlib") else "missing") + ")"))
    out["seconds"] = seconds
    out["bit_equal"] = {"resume": bit_equal, "latent_cache":
                        losses[0] == losses[1]}
    rows["train_resume"] = out


# ------------------------------------------------ more than one process
# `[nccl]`, `[dp train]`, `[dp serve]`, `[tp serve]` run as child processes
# of this script, one a rank (`python3 chip_smoke.py --rank <phase> <rank>
# <world> <dir> <backend>`), once the parent has freed its card memory.
# With one card both ranks of a phase share it over gloo (NCCL refuses two
# ranks on one device: "Duplicate GPU detected"), whose collectives on
# CUDA tensors go through the host; with two cards or more, [dp train],
# [dp serve] and [tp serve] run over NCCL on two cards.
MULTI_DIR = "_smoke_multi"  # in the checkout; removed when the phases end
DP_GLOBAL_B = 16  # [dp train]'s global batch: B=8 a rank on two ranks
DP_DEPTH = 4  # [nccl] / [dp train]'s depth cut: with one card the 16
#               blocks' 2.43 GB of gradients went through the host over
#               gloo, most of the phase's 236 s
DP_TOL = GRAD_TOL  # [dp train] step 1 against the one-process step: the
#                    loss, the grad norm, each gradient leaf and each
#                    master's update over the elements ZERO_GRAD keeps,
#                    relative (L2 for the leaves). The update there carries
#                    the gradient's error (AdamW's first moment is bf16:
#                    mu_bf16), so it takes the gradient's gate
ZERO_GRAD = GRAD_TOL  # [dp train]: a reference gradient element within
#                       this of its leaf's RMS is zero within the rounding
#                       the gradient gate admits; AdamW's first step moves
#                       it ±lr with either sign, so its update is not
#                       compared
TP_DEPTH = 2  # [tp serve]'s depth cut: 100 steps of the unfused `xla`
#               rollout with four collectives a block through the host
TP_MODEL = f"DiT-S/2 depth {TP_DEPTH}"
TP_TOL = 1e-3  # [tp serve], of the latents' largest magnitude (the bf16
#                readings in PERF.md section 6)
ROW_BIAS_STD = 0.1  # [tp serve]'s out-projection and fc2 biases (dit_init
#                     zeroes them): a rank that added them before the sum
#                     would show


def multi_config(**overrides):
    """configs/train_dit_actions.yaml with TRAIN_CUTS, its output under
    MULTI_DIR, and overrides."""
    raw = read_flat_yaml(TRAIN_CONFIG)
    for key, (value, _) in TRAIN_CUTS.items():
        raw[key] = value
    raw.update(output_dir=os.path.join(MULTI_DIR, "out"), **overrides)
    return raw


def multi_trainer(raw):
    """A Trainer of `raw` from [train]'s DiT init (seeded, nonzero adaLN
    heads) cut to DP_DEPTH blocks, and its seeded random VAE."""
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.train.config import TrainingConfig
    from gtax_torch.train.trainer import Trainer

    cfg = TrainingConfig.from_dict(raw)
    dcfg = dataclasses.replace(dit_mod.DiT_MODELS[cfg.dit_model](),
                               depth=DP_DEPTH)
    params = dit_mod.dit_init(dcfg, torch.Generator(device="cuda")
                              .manual_seed(cfg.seed), "cuda")
    nonzero_adaln(params, 4)
    return Trainer(cfg, total_dataset_size=DP_GLOBAL_B * 3, dit_cfg=dcfg,
                   dit_params=params)


def global_batch(rows):
    """`rows` of one global batch of DP_GLOBAL_B dummy clips (the same clips
    in every process), on the card with the accumulation axis."""
    from gtax_torch.data.dummy import DummyDataset
    from gtax_torch.data.loader import Batch, DataLoader

    b = next(iter(DataLoader(DummyDataset("train", return_actions=True,
                                          size=DP_GLOBAL_B), DP_GLOBAL_B,
                             shuffle=False)))
    return Batch(torch.from_numpy(b.video[rows])[None].cuda(),
                 torch.from_numpy(b.actions[rows])[None].cuda())


def masters_cpu(trainer):
    from gtax_torch.train import checkpoint as ckpt

    return {k: v.detach().cpu().clone()
            for k, v in ckpt.flat(trainer.dit_params).items()}


def step_grads_cpu(trainer):
    """The gradients the last step's optimizer read: each leaf's .grad
    (summed over the ranks by the step's all-reduce) / (accumulation x
    world), the one-process gradient at the global batch."""
    from gtax_torch.train import checkpoint as ckpt

    scale = trainer.config.gradient_accumulation_steps * trainer.world
    return {k: (v.grad / scale).cpu() for k, v in
            ckpt.flat(trainer.dit_params).items() if v.grad is not None}


def digest(tensors):
    """sha256 over the tensors' bytes, in key order (bit equality across
    processes)."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(tensors[k].detach().cpu().contiguous().view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def time_reduce(grads, axis, reps=3):
    """ms of all_reduce_grads over the gradients (one all-reduce a leaf,
    the trainer's) and of one dist.all_reduce of a flat fp32 tensor of
    their size, each synced."""
    import torch.distributed as dist

    from gtax_torch.parallel import mesh

    flat = torch.zeros(sum(g.numel() for g in grads), device="cuda")
    out = {}
    for name, fn in (("per_leaf", lambda: mesh.all_reduce_grads(grads, axis)),
                     ("flat", lambda: dist.all_reduce(flat))):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            dist.barrier()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        out[name] = ms
    del flat
    return out


def rank_nccl(rank, world, backend):
    """The one-process B=16 step over NCCL at world size 1: [dp train]'s
    reference (its step-1 loss, grad norm, gradients and masters, saved
    for the ranks; the digest of the masters before it) and the
    all-reduce of its gradients."""
    from gtax_torch.train.optim import leaves

    tr = multi_trainer(multi_config())
    before = digest(masters_cpu(tr))
    batch = global_batch(slice(0, DP_GLOBAL_B))
    m1 = tr.train_step_sync(batch)
    torch.save({"masters": masters_cpu(tr), "grads": step_grads_cpu(tr)},
               os.path.join(MULTI_DIR, "reference.pt"))
    m2 = tr.train_step_sync(batch)
    grads = [p.grad for _, p in leaves(tr.dit_params) if p.grad is not None]
    return {"loss": m1["train_loss"], "grad_norm": m1["grad_norm"],
            "digest_0": before,
            "step_time_s": [m1["step_time_s"], m2["step_time_s"]],
            "grad_bytes": sum(g.numel() * g.element_size() for g in grads),
            "grad_leaves": len(grads),
            "all_reduce_ms": time_reduce(grads, tr.mesh.data),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def rank_dp_train(rank, world, backend):
    """Two ranks of B=8: step 1 against the reference, the launches of a
    micro-step, steps 2-3 with a save at step 2, and a second trainer that
    resumes from it into step 3."""
    from gtax_torch.train.optim import leaves

    B = DP_GLOBAL_B // world
    raw = multi_config(batch_size=B, mesh_data=world)
    tr = multi_trainer(raw)
    before = masters_cpu(tr)  # the reference's too: the same seeded init
    batch = global_batch(slice(rank * B, (rank + 1) * B))
    fns = train_wrappers()
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    m1 = tr.train_step_sync(batch)
    counts = {name: fn.launches for name, fn in fns.items()}
    after, grads1 = masters_cpu(tr), step_grads_cpu(tr)
    out = {"loss": m1["train_loss"], "grad_norm": m1["grad_norm"],
           "launches": counts, "digest_0": digest(before),
           "digest_1": digest(after)}
    if rank > 0:  # rank 0 holds them against the reference after step 3
        del after, before, grads1
    m2 = tr.train_step_sync(batch)
    tr.global_step = 2
    t = time.perf_counter()
    tr.save_checkpoint(0)
    out["save_s"] = time.perf_counter() - t
    m3 = tr.train_step_sync(batch)
    out["step_time_s"] = [m["step_time_s"] for m in (m1, m2, m3)]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    grads = [p.grad for _, p in leaves(tr.dit_params) if p.grad is not None]
    out["all_reduce_ms"] = time_reduce(grads, tr.mesh.data)
    final = masters_cpu(tr)
    out["digest_3"] = digest(final)
    del tr, grads, batch
    torch.cuda.empty_cache()
    if rank == 0:  # step 1's gradients and masters' update vs the reference
        ref = torch.load(os.path.join(MULTI_DIR, "reference.pt"))
        g_ref = ref["grads"]
        out["grad_rel_l2"] = {k: rel_l2(g, g_ref[k])
                              for k, g in grads1.items()
                              if g_ref[k].norm() > 0}
        out["grad_leaves_match"] = set(grads1) == set(g_ref)
        ref = ref["masters"]
        moved = [k for k in after if not torch.equal(ref[k], before[k])]
        out["update_all_rel_l2"] = {
            k: rel_l2(after[k] - before[k], ref[k] - before[k])
            for k in moved}
        out["update_rel_l2"], out["update_dropped"] = {}, 0
        for k in moved:
            keep = torch.ones_like(before[k], dtype=torch.bool)
            if k in g_ref:
                g = g_ref[k]
                keep = g.abs() > ZERO_GRAD * g.square().mean().sqrt()
            out["update_rel_l2"][k] = rel_l2((after[k] - before[k])[keep],
                                             (ref[k] - before[k])[keep])
            out["update_dropped"] += int((~keep).sum())
        out["update_elements"] = sum(before[k].numel() for k in moved)
        out["master_rel_l2"] = max(rel_l2(after[k], ref[k]) for k in after)
        del ref, g_ref, after, before, grads1

    second = multi_trainer(raw)
    t = time.perf_counter()
    second.try_resume()
    out["resume_s"] = time.perf_counter() - t
    out["resumed_at"] = second.global_step
    m3b = second.train_step_sync(global_batch(slice(rank * B,
                                                    (rank + 1) * B)))
    again = masters_cpu(second)
    out["resume_loss"] = [m3["train_loss"], m3b["train_loss"]]
    out["resume_rel_l2"] = max(rel_l2(again[k], v) for k, v in final.items())
    out["resume_bit_equal"] = (m3b["train_loss"] == m3["train_loss"]
                               and digest(again) == out["digest_3"])
    return out


def serving_inputs(B, n_prompt=4, n_frames=6):
    """[e2e]'s prompt (one clip, repeated over B rows) and actions."""
    from gtax_torch.data.actions import forward_actions

    rng = np.random.default_rng(0)
    prompt = rng.random((1, n_prompt, 3, 360, 640), np.float32)
    return (np.repeat(prompt, B, axis=0), forward_actions(B, n_frames),
            n_frames)


def capture_rollout(gen):
    """Keep every rollout output of `gen` (the latents before decode)."""
    seen, inner = [], gen._rollout

    def roll(*args, **kw):
        seen.append(inner(*args, **kw))
        return seen[-1]

    gen._rollout = roll
    return seen


def rank_dp_serve_one(rank, world):
    """Before the group: [dp serve]'s random weights and, bf16 and int8,
    the one-rank generate of this rank's row with its seed (the latents
    and the launches)."""
    from gtax_torch.parallel import mesh
    from gtax_torch.serving import ServingConfig, VideoGenerator

    cfg = ServingConfig(noise_steps=100)
    gen = VideoGenerator.load("", "", cfg)
    nonzero_adaln(gen.dit_params, 2)
    prompt, actions, n_frames = serving_inputs(world)
    row = slice(rank, rank + 1)  # one row a rank
    fns = kernel_wrappers()
    out = {"weights": (gen.dit_params, gen.vae_params)}
    for label, q in (("bf16", "none"), ("int8", "int8")):
        one = VideoGenerator(gen.dit_params, gen.vae_params,
                             dataclasses.replace(cfg, quantize=q))
        seen = capture_rollout(one)
        for fn in fns.values():
            fn.launches = 0
        one.generate(prompt[row], actions[row], n_frames,
                     seed=mesh.rank_seed(7, rank))
        out[label] = {"latents": seen[-1],
                      "launches": {n: fns[n].launches for n in fns}}
        del one, seen
        torch.cuda.empty_cache()
    return out


def rank_dp_serve(rank, world, backend, one):
    """ServingConfig(mesh_data=world), one row a rank, bf16 and int8: the
    launches of each generate, its latents against `one`
    (rank_dp_serve_one), s/frame."""
    from gtax_torch.serving import ServingConfig, VideoGenerator

    cfg = ServingConfig(noise_steps=100, mesh_data=world)
    dit_params, vae_params = one["weights"]
    prompt, actions, n_frames = serving_inputs(world)
    fns = kernel_wrappers()
    out = {}
    for label, q, path, expect in (("bf16", "none", BF16_PATH, None),
                                   ("int8", "int8", INT8_PATH,
                                    INT8_EXPECTED)):
        dp = VideoGenerator(dit_params, vae_params,
                            dataclasses.replace(cfg, quantize=q))
        seen = capture_rollout(dp)
        for fn in fns.values():
            fn.launches = 0
        pixels = dp.generate(prompt, actions, n_frames, seed=7)
        counts = {n: fns[n].launches for n in fns}
        n_gen = n_frames - prompt.shape[1]
        out[label] = {
            "launches": {n: counts[n] for n in path},
            "launches_match_one_rank": counts == one[label]["launches"],
            "expected_ok": all(counts[n] == c
                               for n, c in (expect or {}).items()),
            "all_launched": all(counts[n] > 0 for n in path),
            "bit_equal": torch.equal(seen[-1], one[label]["latents"]),
            "pixels": list(pixels.shape), "digest": digest({"l": seen[-1]}),
            "s_per_frame": dp.last_timings["rollout_s"] / n_gen}
        del dp, seen
        torch.cuda.empty_cache()
    return out


def row_biases(params):
    """The out-projections' and fc2's biases of every block: added once,
    after the model axis's sum."""
    return [bp[branch][name]["bias"] for bp in params["blocks"]
            for branch, name in (("s_attn", "out"), ("t_attn", "out"),
                                 ("s_mlp", "fc2"), ("t_mlp", "fc2"))]


def tp_rollout(g, one):
    """g's rollout on `one`'s prompt latents, actions and injected noise;
    (latents, s/frame)."""
    n = one["noise"].shape[1]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        lat = g._rollout(g.dit_params, one["lat0"], one["acts"], None,
                         num_gen_frames=n, noise=one["noise"])
        torch.cuda.synchronize()
    return lat, (time.perf_counter() - t) / n


def rank_tp_serve_one(rank, world):
    """Before the group: DiT-S/2 at full width cut to TP_DEPTH blocks, with
    nonzero adaLN heads and out / fc2 biases, the prompt's latents, the
    injected noise, and the one-process `xla` rollout on them; also that
    rollout with the out / fc2 biases doubled, which is what two ranks
    that each added them before the sum would give (the fault TP_TOL must
    see)."""
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.models import vae as vae_mod
    from gtax_torch.serving import ServingConfig, VideoGenerator
    from gtax_torch.train.trainer import encode_frames

    cut = dataclasses.replace(dit_mod.DiT_S_2(), depth=TP_DEPTH)
    dit_mod.DiT_MODELS[TP_MODEL] = lambda: cut
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = dit_mod.dit_init(cut, gen, "cuda")
    nonzero_adaln(params, 2)
    for b in row_biases(params):
        b.normal_(0.0, ROW_BIAS_STD, generator=gen)
    vcfg = vae_mod.VAE_MODELS["vit-l-20-shallow-encoder"]()
    vae = vae_mod.vae_init(vcfg, torch.Generator(device="cuda")
                           .manual_seed(1), "cuda")
    g = VideoGenerator(params, vae, ServingConfig(
        noise_steps=100, dit_model=TP_MODEL, attention_backend="xla"))
    prompt, actions, n_frames = serving_inputs(1)
    rng = np.random.default_rng(1)
    one = {"params": params, "vae": vae,
           "acts": torch.from_numpy(actions).cuda(),
           "noise": torch.from_numpy(np.clip(rng.standard_normal(
               (1, n_frames - prompt.shape[1], 16, 18, 32)), -20, 20)
               .astype(np.float32)).cuda()}
    with torch.inference_mode():
        one["lat0"] = encode_frames(vae, vcfg, torch.from_numpy(prompt)
                                    .cuda(), torch.bfloat16)
    one["one"], one["one_s_per_frame"] = tp_rollout(g, one)
    with torch.no_grad():  # g's own bf16 copies; x2 and back are exact
        for b in row_biases(g.dit_params):
            b.mul_(2)
        one["doubled"], _ = tp_rollout(g, one)
        for b in row_biases(g.dit_params):
            b.mul_(0.5)
    return one


def rank_tp_serve(rank, world, backend, one):
    """ServingConfig(mesh_model=world), bf16, `xla`, on `one`'s weights
    (rank_tp_serve_one): its rollout against the one-process rollout."""
    from gtax_torch.serving import ServingConfig, VideoGenerator

    tp = VideoGenerator(one["params"], one["vae"], ServingConfig(
        noise_steps=100, mesh_model=world, dit_model=TP_MODEL))
    fns = kernel_wrappers()
    for fn in fns.values():
        fn.launches = 0
    lat, s_per_frame = tp_rollout(tp, one)
    ref = one["one"].float()
    return {"attention_backend": tp._backend,
            "qkv_cols": tp.dit_params["blocks"][0]["s_attn"]["qkv"][
                "kernel"].shape[-1],
            "max_abs_err": (lat.float() - ref).abs().max().item(),
            "doubled_abs_err": (one["doubled"].float() - ref).abs().max()
            .item(),
            "max_abs_ref": ref.abs().max().item(),
            "finite": bool(torch.isfinite(lat).all()),
            "digest": digest({"l": lat}), "s_per_frame": s_per_frame,
            "one_s_per_frame": one["one_s_per_frame"],
            "launches": sum(fn.launches for fn in fns.values())}


# ------------------------------------------- tensor-parallel training
TP_TRAIN_B = 2  # [tp train]'s rows: one data index, the model ranks share them
TP_TRAIN_BACKENDS = ("xla", "fused_all")


def tp_trainer(backend, model, vae=None):
    """A Trainer of configs/train_dit_actions.yaml (TRAIN_CUTS) at B =
    TP_TRAIN_B, DiT-S/2 at full width cut to TP_DEPTH blocks (seeded,
    nonzero adaLN heads), on `model` model ranks, and its latent batch (a
    seeded draw on the card: the same in every process, so the VAE stays
    out of the step)."""
    from gtax_torch.data.loader import Batch
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.train.config import TrainingConfig
    from gtax_torch.train.trainer import Trainer

    cut = dataclasses.replace(dit_mod.DiT_S_2(), depth=TP_DEPTH)
    params = dit_mod.dit_init(cut, torch.Generator(device="cuda")
                              .manual_seed(0), "cuda")
    nonzero_adaln(params, 5)
    cfg = TrainingConfig.from_dict(multi_config(
        batch_size=TP_TRAIN_B, attention_backend=backend, mesh_data=1,
        mesh_model=model))
    tr = Trainer(cfg, total_dataset_size=TP_TRAIN_B * 3, dit_cfg=cut,
                 dit_params=params, vae_params=vae)
    g = torch.Generator(device="cuda").manual_seed(6)
    lat = torch.randn((1, TP_TRAIN_B, cut.max_frames, 16, 18, 32),
                      generator=g, device="cuda")
    acts = torch.rand((1, TP_TRAIN_B, cut.max_frames, 25), generator=g,
                      device="cuda")
    return tr, Batch(lat, acts, is_latents=True)


def whole_grads_cpu(trainer):
    """step_grads_cpu with each cut leaf gathered whole over the model axis
    (collective)."""
    from gtax_torch.parallel import mesh
    from gtax_torch.train.optim import leaves

    scale = trainer.config.gradient_accumulation_steps * trainer.world
    return {"/".join(map(str, path)): mesh.gather_leaf(
        path, p.grad / scale, trainer.tp).cpu()
        for path, p in leaves(trainer.dit_params) if p.grad is not None}


def rank_tp_train_one(rank, world):
    """Before the group, on rank 0: the one-process step of each backend
    (its loss, grad norm and every leaf's gradient)."""
    if rank > 0:
        return None
    out = {}
    for backend in TP_TRAIN_BACKENDS:
        tr, batch = tp_trainer(backend, 1)
        m = tr.train_step_sync(batch)
        out[backend] = {"loss": m["train_loss"], "grad_norm": m["grad_norm"],
                        "grads": step_grads_cpu(tr)}
        del tr, batch
        torch.cuda.empty_cache()
    return out


def rank_tp_train(rank, world, backend, one):
    """mesh_model=world under each backend: one step's loss, grad norm and
    every leaf's gradient (gathered whole) against the one-process step
    (rank 0 holds them against `one`), the training kernels' launches in
    the step, its step_time_s and the peak memory."""
    fns = train_wrappers()
    out = {}
    for b in TP_TRAIN_BACKENDS:
        tr, batch = tp_trainer(b, world)
        torch.cuda.reset_peak_memory_stats()
        for fn in fns.values():
            fn.launches = 0
        m = tr.train_step_sync(batch)
        o = {"loss": m["train_loss"], "grad_norm": m["grad_norm"],
             "step_time_s": m["step_time_s"],
             "launches": {n: fn.launches for n, fn in fns.items()},
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "qkv_cols": tr.dit_params["blocks"][0]["s_attn"]["qkv"][
                 "kernel"].shape[-1]}
        grads = whole_grads_cpu(tr)
        if rank == 0:
            ref = one[b]["grads"]
            o["grad_rel_l2"] = {k: rel_l2(g, ref[k]) for k, g in grads.items()
                                if ref[k].norm() > 0}
            o["grad_leaves_match"] = set(grads) == set(ref)
            o["ref_loss"], o["ref_grad_norm"] = (one[b]["loss"],
                                                 one[b]["grad_norm"])
        out[b] = o
        del tr, batch, grads
        torch.cuda.empty_cache()
    return out


RANK_PHASES = {"nccl": rank_nccl, "dp_train": rank_dp_train,
               "dp_serve": rank_dp_serve, "tp_serve": rank_tp_serve,
               "tp_train": rank_tp_train}
# a phase's one-process reference, run before the rank joins the group
# (inside it, VideoGenerator and Trainer refuse a mesh that does not fill
# the group)
BEFORE_GROUP = {"dp_serve": rank_dp_serve_one, "tp_serve": rank_tp_serve_one,
                "tp_train": rank_tp_train_one}


def rank_main(argv):
    """A child rank: join the phase's group (a file:// store in MULTI_DIR),
    run it, write its JSON result for the parent."""
    import torch.distributed as dist

    from gtax_torch.kernels import build
    from gtax_torch.parallel import mesh
    from gtax_torch.utils.platform import strict_matmul

    phase, rank, world, backend = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    strict_matmul()
    build.library()  # the parent built it
    extra = ((BEFORE_GROUP[phase](rank, world),) if phase in BEFORE_GROUP
             else ())
    store = f"file://{os.path.abspath(MULTI_DIR)}/{phase}.store"
    if world > 1:
        mesh.initialize_distributed(store, world, rank, backend=backend,
                                    device="cuda", timeout_s=600)
    else:  # one process in a group of its own (initialize_distributed's
        #    no-op case)
        dist.init_process_group(backend, init_method=store, world_size=1,
                                rank=0)
    out = RANK_PHASES[phase](rank, world, backend, *extra)
    del extra
    out["backend"] = dist.get_backend()
    with open(os.path.join(MULTI_DIR, f"{phase}_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def launch(phase, world, backend, timeout_s):
    """Run `phase` on `world` child ranks; each rank's log is printed when
    they end. Fails if a rank fails (the others are killed) or the phase
    runs past timeout_s. Returns the ranks' results."""
    two_cards = torch.cuda.device_count() >= world > 1
    procs, logs = [], []
    try:
        for r in range(world):
            env = dict(os.environ, LOCAL_RANK=str(r if two_cards else 0),
                       PYTHONUNBUFFERED="1")
            logs.append(open(os.path.join(MULTI_DIR, f"{phase}_{r}.log"),
                             "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", phase,
                 str(r), str(world), backend], env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or (
                    time.monotonic() > deadline):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        text = open(os.path.join(MULTI_DIR, f"{phase}_{r}.log")).read()
        for line in text.splitlines():
            if line.startswith("["):
                log(f"[{phase} rank {r}] {line}")
        if p.returncode != 0:
            log(text[-3000:])
            fail(f"[{phase}] rank {r} exited {p.returncode}")
    return [json.load(open(os.path.join(MULTI_DIR, f"{phase}_{r}.json")))
            for r in range(world)]


def multi_card_phase(rows):
    import shutil

    shutil.rmtree(MULTI_DIR, ignore_errors=True)
    os.makedirs(MULTI_DIR)
    try:
        return multi_card_checks(rows)
    finally:
        shutil.rmtree(MULTI_DIR, ignore_errors=True)


def multi_card_checks(rows):
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    share = "two ranks on two cards" if cards >= 2 else (
        "two ranks share one card")
    where = ("over NCCL on two cards" if cards >= 2 else
             "two ranks share one card over gloo (NCCL refuses two ranks on "
             "one device): collectives go through the host, not a "
             "card-to-card link; times are not speed figures")
    log(f"[multi] {cards} card(s): {where}; the parent holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    out = {"cards": cards, "backend": backend}

    t = time.perf_counter()
    ref, = launch("nccl", 1, "nccl", 600)
    ar = ref["all_reduce_ms"]
    log(f"[nccl] world size 1 over {ref['backend']}: the one-process B="
        f"{DP_GLOBAL_B} step (the [dp train] reference): loss "
        f"{ref['loss']:.7g}, grad_norm {ref['grad_norm']:.7g}, step_time_s "
        f"{ref['step_time_s']}, peak {ref['peak_gib']:.2f} GiB; all-reduce "
        f"of the gradients ({ref['grad_bytes']} bytes fp32 in "
        f"{ref['grad_leaves']} leaves) ms: one a leaf "
        f"{ar['per_leaf']}, one flat tensor {ar['flat']} (one rank crosses "
        f"no link: this shows the path runs, not a link's speed) "
        f"({time.perf_counter() - t:.1f} s)")
    out["nccl"] = ref

    t = time.perf_counter()
    ranks = launch("dp_train", 2, backend, 900)
    L = DP_DEPTH
    want = {"fused_spatial_branch": L, "fused_mlp_branch": 2 * L,
            "fused_temporal_branch": L, "fused_spatial_branch_bwd": L,
            "fused_temporal_branch_bwd": L, "fused_mlp_branch_bwd": 2 * L}
    for r, o in enumerate(ranks):
        loss_err = abs(o["loss"] - ref["loss"]) / abs(ref["loss"])
        norm_err = abs(o["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        log(f"[dp train] rank {r} ({o['backend']}): step 1 loss "
            f"{o['loss']:.7g} (relative {loss_err:.3g} of the one-process "
            f"step's), grad_norm {o['grad_norm']:.7g} ({norm_err:.3g}); "
            f"step_time_s {o['step_time_s']}; all-reduce of the gradients "
            f"ms ({o['backend']}): one a leaf {o['all_reduce_ms']['per_leaf']}"
            f", one flat tensor {o['all_reduce_ms']['flat']}; peak "
            f"{o['peak_gib']:.2f} GiB; save {o['save_s']:.2f} s, resume "
            f"{o['resume_s']:.2f} s; launches in step 1 "
            f"{json.dumps(o['launches'])}")
        if not (loss_err <= DP_TOL and norm_err <= DP_TOL):
            fail(f"[dp train] rank {r}: step 1 differs from the one-process "
                 f"step ({loss_err}, {norm_err} > {DP_TOL})")
        if o["launches"] != want:
            fail(f"[dp train] rank {r}: launches {o['launches']}, a "
                 f"micro-step gives {want}")
        if o["resumed_at"] != 2 or not (o["resume_rel_l2"] <= RESUME_TOL
                                        and abs(o["resume_loss"][1]
                                                - o["resume_loss"][0])
                                        <= RESUME_TOL * abs(
                                            o["resume_loss"][0])):
            fail(f"[dp train] rank {r}: the resumed step 3 differs "
                 f"({o['resume_loss']}, masters {o['resume_rel_l2']})")
        log(f"[dp train] rank {r}: resumed at step {o['resumed_at']}, step "
            f"3 loss {o['resume_loss'][1]:.7g} vs {o['resume_loss'][0]:.7g}"
            f" uninterrupted, masters relative L2 {o['resume_rel_l2']:.3g} "
            f"(tol {RESUME_TOL}); bit_equal={o['resume_bit_equal']}")
    r0 = ranks[0]
    for what, key, tol in (
            ("gradient", "grad_rel_l2", DP_TOL),
            ("update (every element; not gated)", "update_all_rel_l2", None),
            (f"update ({r0['update_dropped']} of {r0['update_elements']} "
             f"elements whose gradient is within {ZERO_GRAD} of its leaf's "
             "RMS left out)", "update_rel_l2", DP_TOL)):
        rel = r0[key]
        worst = max(rel, key=rel.get)
        vals = sorted(rel.values())
        log(f"[dp train] step 1's {what} of each master against the "
            f"one-process step's: {len(rel)} leaves, relative L2 median "
            f"{vals[len(vals) // 2]:.3g}, max {rel[worst]:.3g} at {worst} "
            f"(tol {tol})")
        if tol is not None and not rel[worst] <= tol:
            fail(f"[dp train] step 1's {what} differs ({rel[worst]} > "
                 f"{tol})")
    if not ranks[0]["grad_leaves_match"]:
        fail("[dp train] step 1's gradient leaves differ from the "
             "reference's")
    log(f"[dp train] masters after step 1, relative L2 max "
        f"{ranks[0]['master_rel_l2']:.3g} (a zero-initialized bias is its "
        "update: AdamW's first step is ±lr an element, so a gradient "
        "element near zero that changes sign moves it by 2 lr)")
    if ranks[0]["digest_0"] != ref["digest_0"]:
        fail("[dp train] rank 0 started from other masters than the "
             "reference")
    for step in ("digest_1", "digest_3"):
        if ranks[0][step] != ranks[1][step]:
            fail(f"[dp train] the ranks' masters differ ({step})")
    log("[dp train] the two ranks' masters bit-equal after steps 1 and 3 "
        f"({time.perf_counter() - t:.1f} s)")
    for name, n in ranks[0]["launches"].items():
        rows.setdefault(name, {})["launches_dp_train"] = n
    out["dp_train"] = [{k: v for k, v in o.items()
                        if not k.endswith("_rel_l2")}
                       for o in ranks]

    t = time.perf_counter()
    ranks = launch("dp_serve", 2, backend, 900)
    for label in ("bf16", "int8"):
        for r, o in enumerate(ranks):
            s = o[label]
            log(f"[dp serve] {label} rank {r}: pixels {s['pixels']}, "
                f"{s['s_per_frame']:.3f} s/frame ({share}), "
                f"launches {json.dumps(s['launches'])}; latents bit-equal "
                f"to the one-rank rollout of its row with its seed: "
                f"{s['bit_equal']}")
            if not (s["bit_equal"] and s["all_launched"]
                    and s["launches_match_one_rank"] and s["expected_ok"]):
                fail(f"[dp serve] {label} rank {r}: {s}")
        if ranks[0][label]["digest"] == ranks[1][label]["digest"]:
            fail(f"[dp serve] {label}: the ranks drew the same noise")
        for name, n in ranks[0][label]["launches"].items():
            rows.setdefault(name, {})["launches_dp_serve"] = n
    log(f"[dp serve] the ranks' latents differ (their generators do) "
        f"({time.perf_counter() - t:.1f} s)")
    out["dp_serve"] = ranks

    t = time.perf_counter()
    ranks = launch("tp_serve", 2, backend, 600)
    for r, o in enumerate(ranks):
        log(f"[tp serve] rank {r} ({o['backend']}, {o['qkv_cols']} qkv "
            f"columns a rank, `{o['attention_backend']}`): depth {TP_DEPTH}, "
            f"max_abs_err {o['max_abs_err']:.4g} against the one-process "
            f"`xla` rollout (max |latent| {o['max_abs_ref']:.4g}, tol "
            f"{TP_TOL} of it; with the out / fc2 biases counted twice the "
            f"one process is off by {o['doubled_abs_err']:.4g}); "
            f"{o['s_per_frame']:.3f} s/frame, one process "
            f"{o['one_s_per_frame']:.3f} ({share}); kernel "
            f"launches {o['launches']}")
        bound = TP_TOL * o["max_abs_ref"]
        if not (o["finite"] and o["max_abs_err"] <= bound):
            fail(f"[tp serve] rank {r}: the rollout differs")
        if not o["doubled_abs_err"] > bound:
            fail(f"[tp serve] rank {r}: the gate cannot see a bias added "
                 "on every rank")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        fail("[tp serve] the ranks' latents differ")
    log(f"[tp serve] the ranks' latents bit-equal "
        f"({time.perf_counter() - t:.1f} s)")
    out["tp_serve"] = ranks
    out["tp_train"] = tp_train_checks(rows, backend, share)
    return out


def tp_train_checks(rows, backend, share):
    """[tp train]: two model ranks against the one-process step (GRAD_TOL on
    the loss, the grad norm and every leaf's gradient), and under fused_all
    the launches a rank of #1-#3 and #12-#14 (the blocks' fused trainable
    branches on gathered weights: a one-card micro-step's)."""
    t = time.perf_counter()
    ranks = launch("tp_train", 2, backend, 600)
    L = TP_DEPTH
    want = {"fused_spatial_branch": L, "fused_mlp_branch": 2 * L,
            "fused_temporal_branch": L, "fused_spatial_branch_bwd": L,
            "fused_temporal_branch_bwd": L, "fused_mlp_branch_bwd": 2 * L}
    for b in TP_TRAIN_BACKENDS:
        r0 = ranks[0][b]
        loss_err = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
        norm_err = (abs(r0["grad_norm"] - r0["ref_grad_norm"])
                    / r0["ref_grad_norm"])
        rel = r0["grad_rel_l2"]
        worst = max(rel, key=rel.get)
        vals = sorted(rel.values())
        log(f"[tp train] {b}: mesh_model=2 ({share}, {r0['qkv_cols']} qkv "
            f"columns a rank), DiT-S/2 width, depth {TP_DEPTH}, B="
            f"{TP_TRAIN_B}, bf16: step loss {r0['loss']:.7g} against the one"
            f"-process {r0['ref_loss']:.7g} (relative {loss_err:.3g}), grad_"
            f"norm {r0['grad_norm']:.7g} against {r0['ref_grad_norm']:.7g} "
            f"({norm_err:.3g}); {len(rel)} gradient leaves gathered whole, "
            f"relative L2 median {vals[len(vals) // 2]:.3g}, max "
            f"{rel[worst]:.3g} at {worst} (tol {GRAD_TOL} on each)")
        if not (loss_err <= GRAD_TOL and norm_err <= GRAD_TOL
                and rel[worst] <= GRAD_TOL and r0["grad_leaves_match"]):
            fail(f"[tp train] {b}: the two-rank step differs from the "
                 f"one-process step ({loss_err}, {norm_err}, {rel[worst]})")
        for r, o in enumerate(ranks):
            o = o[b]
            counts = {n: o["launches"][n] for n in want}
            log(f"[tp train] {b} rank {r}: step_time_s "
                f"{o['step_time_s']:.3f} ({share}), peak "
                f"{o['peak_gib']:.2f} GiB, launches in the step "
                f"{json.dumps(counts)}")
            if o["loss"] != ranks[0][b]["loss"]:
                fail(f"[tp train] {b}: the model ranks' losses differ")
            expect = want if b == "fused_all" else dict.fromkeys(want, 0)
            if counts != expect:
                fail(f"[tp train] {b} rank {r}: launches {counts}, want "
                     f"{expect}")
    for name, n in ranks[0]["fused_all"]["launches"].items():
        rows.setdefault(name, {})["launches_tp_train"] = n
    log(f"[tp train] ({time.perf_counter() - t:.1f} s)")
    return [{b: {k: v for k, v in o[b].items() if k != "grad_rel_l2"}
             for b in TP_TRAIN_BACKENDS} for o in ranks]


# ------------------------------------------------- the AOT kernel cache
# `[aot]` runs child processes of this script (`python3 chip_smoke.py
# --aot <role> <dir> <result>`), each a fresh process that starts a
# VideoGenerator(aot_dir=<dir>) and generates one frame from injected
# noise: "cold" into an empty directory (it builds the library with nvcc
# and saves it), "warm" from that directory with nvcc's directory off PATH
# and CUDA_HOME pointing at an empty one (it must load, and cannot build),
# and "corrupt" into a directory whose artifact the parent overwrote with
# garbage (it must fail to load it, build again and overwrite it); warm
# and corrupt run side by side. The seconds to the first frame are the
# parent's clock from the child's start to the child's first frame.
AOT_SCRATCH = "_smoke_aot"  # in the checkout; removed when [aot] ends
AOT_ROLES = {"cold": ["compile", "save"], "warm": ["load"],
             "corrupt": ["load_failed", "compile", "save"]}


def aot_child(role, cache_dir, result):
    from gtax_torch.kernels import build
    from gtax_torch.serving import ServingConfig, VideoGenerator
    from gtax_torch.utils.platform import strict_matmul

    strict_matmul()
    gen = VideoGenerator.load("", "", ServingConfig(aot_dir=cache_dir))
    nonzero_adaln(gen.dit_params, 2)
    prompt, actions, n_frames = serving_inputs(1, n_prompt=1, n_frames=2)
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 1, 16, 18, 32)).astype(np.float32))
    seen = capture_rollout(gen)
    pixels = gen.generate(prompt, actions, n_frames, seed=0, noise=noise)
    first = time.time()
    with open(result, "w") as f:
        json.dump({"first_frame_at": first, "nvcc": build.find_nvcc(),
                   "events": [kind for kind, _ in gen._aot.events],
                   "artifacts": sorted(os.listdir(cache_dir)),
                   "pixels": list(pixels.shape),
                   "digest": digest({"pixels": torch.from_numpy(pixels),
                                     "latents": seen[-1]})}, f)
    return 0


def aot_phase():
    import shutil

    from gtax_torch.aot import AotCache

    root = os.path.abspath(AOT_SCRATCH)
    shutil.rmtree(root, ignore_errors=True)
    dirs = {role: os.path.join(root, role) for role in ("cold", "corrupt")}
    dirs["warm"] = dirs["cold"]
    os.makedirs(os.path.join(root, "no_cuda"))
    bad = AotCache(dirs["corrupt"]).path()
    with open(bad, "wb") as f:
        f.write(b"\x7fELF truncated")
    path = os.pathsep.join(
        p for p in os.environ.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(p, "nvcc")))
    envs = {"cold": {}, "corrupt": {},
            "warm": {"PATH": path,
                     "CUDA_HOME": os.path.join(root, "no_cuda")}}

    def start(role):
        out = os.path.join(root, f"{role}.json")
        log_f = open(os.path.join(root, f"{role}.log"), "w")
        t0 = time.time()
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--aot", role,
             dirs[role], out], env=dict(os.environ, **envs[role],
                                        PYTHONUNBUFFERED="1"),
            stdout=log_f, stderr=subprocess.STDOUT)
        return role, proc, log_f, t0, out

    def finish(jobs, timeout_s=600):
        res = {}
        try:
            deadline = time.monotonic() + timeout_s
            while any(p.poll() is None for _, p, _, _, _ in jobs):
                if time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for role, p, f, t0, out in jobs:
                if p.poll() is None:
                    p.kill()
                p.wait()
                f.close()
                if p.returncode != 0:
                    log(open(f.name).read()[-3000:])
                    fail(f"[aot] the {role} process exited {p.returncode}")
                res[role] = json.load(open(out))
                res[role]["seconds"] = res[role]["first_frame_at"] - t0
        return res

    try:
        got = finish([start("cold")])
        got.update(finish([start("warm"), start("corrupt")]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for role, want in AOT_ROLES.items():
        o = got[role]
        log(f"[aot] {role}: events {o['events']}, nvcc "
            f"{o['nvcc'] or 'not found'}, artifacts {o['artifacts']}, "
            f"{o['seconds']:.1f} s from the process's start to its first "
            f"frame (pixels {o['pixels']})"
            + ("; beside the corrupt process's build" if role == "warm"
               else "; beside the warm process" if role == "corrupt"
               else ""))
        if o["events"] != want:
            fail(f"[aot] {role}: events {o['events']}, want {want}")
        if o["digest"] != got["cold"]["digest"]:
            fail(f"[aot] {role}: its frame differs from the cold process's")
    if got["warm"]["nvcc"] is not None:
        fail("[aot] the warm process could find nvcc")
    log("[aot] every process's latents and pixels bit-equal to the cold "
        "one's, from the same injected noise")
    return {role: {k: got[role][k] for k in ("events", "seconds")}
            for role in AOT_ROLES}


# ------------------------------------------------------ the HTTP server
def png_bytes(rgb):
    """A (H, W, 3) uint8 image as PNG bytes (zlib and struct: the request
    is made without an image library)."""
    import struct
    import zlib

    h, w, _ = rgb.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def http_request(url, body=None):
    """(status, content type, body bytes) of a GET (body None) or a JSON
    POST."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data),
                                    timeout=600) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


# the int8 path of one request (B=1, one prompt frame, one generated
# frame): a 4-slot prefill (sequential wrappers) and 101 paired steps over
# 16 blocks; the VAE's 6 + 12 blocks
HTTP_INT8 = {"fused_spatial_branch_q": 16, "fused_mlp_branch_q": 32,
             "fused_temporal_branch_q": 16, "fused_temporal_step_q": 0,
             "fused_spatial_pair_q": 1616, "fused_temporal_pair_q": 1616,
             "fused_vae_block": 18}
# --quantize none: every one of the 101 steps and the prefill runs each
# block's spatial branch and both MLPs (16 x 102, twice that); the prefill
# runs the temporal branch, the steps the temporal step (16 x 101)
HTTP_BF16 = {"fused_spatial_branch": 1632, "fused_mlp_branch": 3264,
             "fused_temporal_branch": 16, "fused_temporal_step": 1616,
             "fused_vae_block": 18}


def http_phase(rows):
    """[http serve]: gtax_torch.cli.serve on port 0 in a thread at its
    defaults (DiT-S/2 + ViT-L/20, int8 on the fused kernels, 100 steps,
    random weights), driven through urllib: /healthz, one /generate (its
    mp4 and headers, and the launches of #5-#11 in it against the code's
    counts), a 400 and a 404; then a --quantize none server's request,
    which runs #1-#5. The served weights' adaLN heads are filled before
    the server quantizes them (dit_init zeroes them, and every block would
    be the identity), so the video depends on every branch's kernel."""
    import base64
    import hashlib
    import threading

    from gtax_torch.cli import serve
    from gtax_torch.models import dit as dit_mod

    dit_init = dit_mod.dit_init

    def dit_init_nonzero(*a, **k):
        params = dit_init(*a, **k)
        nonzero_adaln(params, 2)
        return params

    decoders = {m: _importable(m) for m in ("PIL", "cv2", "imageio")}
    fns = kernel_wrappers()
    frame = (np.random.default_rng(4).random((360, 640, 3)) * 255).astype(
        np.uint8)
    body = {"image": base64.b64encode(png_bytes(frame)).decode(),
            "num_frames": 2, "seed": 7}
    out = {"decoders": decoders}
    for quantize, path in (("int8", HTTP_INT8), ("none", HTTP_BF16)):
        t = time.perf_counter()
        args = serve.build_parser().parse_args(
            ["--port", "0", "--dit_model_path", "", "--vae_model_path", "",
             "--quantize", quantize])
        dit_mod.dit_init = dit_init_nonzero
        try:
            server = serve.make_server(args)
        finally:
            dit_mod.dit_init = dit_init
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            code, kind, data = http_request(url + "/healthz")
            health = json.loads(data)
            if code != 200 or health["config"] != {
                    "quantize": quantize, "noise_steps": 100,
                    "backend": "fused", "dtype": "bfloat16"}:
                fail(f"[http serve] /healthz: {code} {health}")
            for fn in fns.values():
                fn.launches = 0
            code, kind, data = http_request(url + "/generate", body)
            counts = {n: fn.launches for n, fn in fns.items()}
            wrote = code == 200 and kind == "video/mp4" and data[4:8] == (
                b"ftyp")
            if not decoders["PIL"]:
                # the start frame cannot decode here: the request is a 400;
                # the handler's own path from a decoded frame instead
                if code != 400 or "bad request" not in json.loads(data)[
                        "error"]:
                    fail(f"[http serve] without PIL: {code} {data[:200]}")
                for fn in fns.values():
                    fn.launches = 0
                pixels = serve.generate_pixels(
                    server.generator, server.lock,
                    frame.transpose(2, 0, 1).astype(np.float32) / 255, None,
                    2, 7)
                counts = {n: fn.launches for n, fn in fns.items()}
                log(f"[http serve] no PIL on this machine: the request's "
                    f"decode failed (400, as stated); the handler's "
                    f"generate_pixels gave {pixels.shape} uint8, and the mp4 "
                    f"was not written on this machine")
            elif not wrote and not (decoders["cv2"] or decoders["imageio"]):
                if code != 500:
                    fail(f"[http serve] without a video writer: {code}")
                log("[http serve] no cv2 or imageio: the generation ran and "
                    "the mp4 write failed (500); the mp4 was not written on "
                    "this machine")
            elif not wrote:
                fail(f"[http serve] /generate: {code} {kind} {data[:200]}")
            bad = http_request(url + "/generate", {**body, "num_frames": 999})
            missing = http_request(url + "/nope")
            if bad[0] != 400 or missing[0] != 404:
                fail(f"[http serve] status codes {bad[0]}, {missing[0]}")
        finally:
            server.shutdown()
            server.server_close()
        ok = all(counts[n] == c for n, c in path.items())
        log(f"[http serve] --quantize {quantize}: /healthz 200, /generate "
            f"{code} {kind} ({len(data)} bytes, X-Seed 7), a bad num_frames "
            f"400, an unknown path 404; launches in the request "
            f"{json.dumps({n: counts[n] for n in path})} "
            f"({time.perf_counter() - t:.1f} s; image libraries {decoders})")
        if not ok:
            fail(f"[http serve] --quantize {quantize}: launches {counts}, "
                 f"want {path}")
        for name in path:
            rows.setdefault(name, {})[f"launches_http_{quantize}"] = counts[
                name]
        out[quantize] = {"status": code, "mp4_bytes": len(data) if wrote
                         else 0, "launches": {n: counts[n] for n in path},
                         "mp4_sha256": hashlib.sha256(data).hexdigest()
                         if wrote else None}
        del server
        gc.collect()
        torch.cuda.empty_cache()
    if out["int8"]["mp4_sha256"] and (out["int8"]["mp4_sha256"]
                                      == out["none"]["mp4_sha256"]):
        fail("[http serve] the int8 and bf16 servers gave the same mp4: "
             "the blocks did not move the video")
    return out


def _importable(name):
    try:
        __import__(name)
        return True
    except ImportError:
        return False


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from gtax_torch.kernels import build
    from gtax_torch.utils.platform import strict_matmul

    strict_matmul()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    start = time.perf_counter()
    log(f"[env] torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"device {name}; count {torch.cuda.device_count()}")
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"[build] {lib.relative_to(build.BUILD_DIR.parent.parent)} in "
        f"{time.perf_counter() - t0:.1f} s")
    sass = sass_check(lib)
    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"[time] {label}: {time.perf_counter() - t:.1f} s")
        return out

    with torch.inference_mode():
        rows = timed("kernels", kernel_phase)
        temporal = timed("temporal", temporal_checks)
    timed("train kernels", train_kernel_phase, rows)
    timed("train kernels fp32", train_kernel_phase, rows, torch.float32)
    e2e = timed("end to end", end_to_end, rows)
    ctx = timed("train", train_phase, rows)
    timed("train modes", train_modes_phase, ctx, rows)
    del ctx
    torch.cuda.empty_cache()
    timed("train resume", train_resume_phase, rows)
    gc.collect()  # what cycles keep of the earlier phases' trainers
    torch.cuda.empty_cache()  # the ranks' phases take the card after this
    multi = timed("multi-card", multi_card_phase, rows)
    multi["aot"] = timed("aot", aot_phase)
    multi["http_serve"] = timed("http serve", http_phase, rows)
    train = rows.pop("train")
    train["resume"] = rows.pop("train_resume")
    if len(rows) != 16:
        fail(f"the kernel table has {len(rows)} rows, not 16")
    for row in rows.values():
        if not isinstance(row["launches"], int):
            fail(f"{row['name']}: no launch count from a main-path run")
        for k, v in row.items():
            if isinstance(v, float) and not math.isfinite(v):
                fail(f"{row['name']}: {k} is not finite")
    log(f"[time] the whole smoke: {time.perf_counter() - start:.1f} s")
    log(json.dumps({"kernels": list(rows.values()), "train": train,
                    "temporal": temporal, "approx": e2e["approx"],
                    "e2e_fp32": e2e["fp32"], "sass": sass, "multi": multi,
                    "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--aot"]:
        sys.exit(aot_child(*sys.argv[2:5]))
    sys.exit(main())
