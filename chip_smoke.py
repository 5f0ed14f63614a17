#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gtax_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits nonzero and prints no result line):
  1. environment: torch version, device, `nvidia-smi` name and power limit;
  2. build: nvcc builds gtax_torch/csrc/*.cu for sm_90a (timed);
  3. kernels: each of the nine kernel wrappers (five bf16, four int8
     W8A8) at its main-path shapes (DiT-S/2 and ViT-L/20 widths) and at
     batch 2, against its plain PyTorch version on the same inputs (bf16
     both; tolerance 2**-6 of the output's largest magnitude, four bf16
     ulps); CUDA-event times of the kernel, the plain version and a
     library yardstick, with the L2 cache flushed before every timed call;
     the bound from bytes and operations (bf16 and int8 peaks);
  4. end to end, bf16: VideoGenerator at full DiT-S/2 + ViT-L/20 width,
     B=1, 4 prompt frames + 2 generated, 100 noise steps, random seeded
     weights with nonzero adaLN heads, injected noise. The launch counters
     are zeroed just before this run and read just after it: all five bf16
     kernels must have launched. Then the incremental rollout against the
     full-window rollout on the card, and a depth-2 full-width rollout on
     the card against the port's CPU rollout (plain versions);
  5. end to end, int8: the same run with quantize="int8" (the same bf16
     weights, quantized); the four int8 wrappers and the VAE block must
     have launched. Then int8 incremental against int8 full window, a
     depth-2 int8 rollout on the card against the port's CPU one, and the
     int8 forward against the bf16 one (relative L2 error): gated at
     gtax's 2e-2 at depth 2 on gtax's own weight regime carried to full
     width; reported beside it, that regime as written and the smoke's
     weights at depth 2 and full depth.
Each end-to-end phase also traces one generated frame (`[profile]`).
`python -m gtax_torch.tools.step_profile` splits one denoise step into
host and card time.

The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {...}}. Needs one GPU; imports nothing of JAX or
gtax.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, data sheet
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak, data sheet
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


def bound_ms(n_bytes, n_flops, n_int8_ops=0):
    """The larger of the bytes over the memory rate and the operations over
    their type's peak (bf16 flops, int8 ops)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / BF16_FLOPS_PER_S + n_int8_ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------------ inputs

def rand(gen, shape, std=1.0, dtype=torch.bfloat16, offset=0.0):
    a = gen.standard_normal(shape).astype(np.float32) * std + offset
    return torch.from_numpy(a).to(device="cuda", dtype=dtype)


def branch_inputs(gen, N, S):
    x = rand(gen, (N, S, D))
    mods = rand(gen, (N, 6 * D), 0.5)  # (N, D) views as dit_cond gives
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


# ------------------------------------------------------------ the kernels

def kernel_cases():
    """(name, label, main, builder) per kernel and shape; builder returns
    (kernel_fn, plain_fn, library_fn, library_desc, bytes, flops)."""
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
        x, sh, sc, g = branch_inputs(gen, N, S_DIT)
        qw, ow = rand(gen, (D, 3 * D), 0.02), rand(gen, (D, D), 0.02)
        ob = rand(gen, (D,), 0.02)
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

    def mlp(N):
        gen = np.random.default_rng(10 + N)
        x, sh, sc, g = branch_inputs(gen, N, S_DIT)
        w1, w2 = rand(gen, (D, 4 * D), 0.02), rand(gen, (4 * D, D), 0.02)
        b1, b2 = rand(gen, (4 * D,), 0.02), rand(gen, (D,), 0.02)
        args = (x, sh, sc, g, w1, b1, w2, b2)

        def lib():
            h = F.gelu(library_linear(lib_mod(x, sh, sc), w1, b1),
                       approximate="tanh")
            return x + g[:, None] * library_linear(h, w2, b2)

        by = nbytes(x, sh, sc, g, w1, b1, w2, b2, x)
        fl = 2 * 2 * N * S_DIT * D * 4 * D
        return (lambda: block.fused_mlp_branch(*args),
                lambda: block.mlp_branch_plain(*args), lib,
                "F.layer_norm+F.linear+F.gelu+F.linear (cuBLAS)", by, fl)

    def temporal(B, T=4):
        gen = np.random.default_rng(20 + B)
        N = B * T
        x, sh, sc, g = branch_inputs(gen, N, S_DIT)
        qw, ow = rand(gen, (D, 3 * D), 0.02), rand(gen, (D, D), 0.02)
        ob = rand(gen, (D,), 0.02)
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

    def step(B, n_ctx=4):
        gen = np.random.default_rng(30 + B)
        x, sh, sc, g = branch_inputs(gen, B, S_DIT)
        qw, ow = rand(gen, (D, 3 * D), 0.02), rand(gen, (D, D), 0.02)
        ob = rand(gen, (D,), 0.02)
        kc = rand(gen, (B * n_ctx * S_DIT, D))
        vc = rand(gen, (B * n_ctx * S_DIT, D))
        T = n_ctx + 1
        f = temporal_freqs(T)
        valid = torch.tensor([False] + [True] * n_ctx)
        args = (x, sh, sc, g, qw, ow, ob, kc, vc, f, valid, H, n_ctx)

        def lib():
            qkv = library_linear(lib_mod(x, sh, sc), qw)
            q, k, v = (t.view(B, 1, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
                       for t in qkv.split(D, -1))
            ck, cv = (t.view(B, n_ctx, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
                      for t in (kc, vc))
            keys = torch.cat([ck, lib_rope(k, f[n_ctx:])], dim=3)
            vals = torch.cat([cv, v], dim=3)
            o = F.scaled_dot_product_attention(lib_rope(q, f[n_ctx:]), keys,
                                               vals)
            y = library_linear(o.permute(0, 3, 1, 2, 4).reshape(B, S_DIT, D),
                               ow, ob)
            return x + g[:, None] * y

        by = nbytes(x, sh, sc, g, qw, ow, ob, kc, vc, f, x)
        fl = 2 * B * S_DIT * D * 4 * D + 4 * B * S_DIT * H * T * HD
        return (lambda: block.fused_temporal_step(*args),
                lambda: block.temporal_step_plain(*args), lib,
                "F.layer_norm+F.linear+SDPA over cache+F.linear", by, fl)

    def vae(N):
        gen = np.random.default_rng(40 + N)
        x = rand(gen, (N, S_VAE, D))
        f32 = torch.float32
        ln = [rand(gen, (D,), 0.1, f32, 1.0), rand(gen, (D,), 0.1, f32)] * 2
        w = [rand(gen, (D, 3 * D), 0.03), rand(gen, (D, D), 0.03),
             rand(gen, (D, 4 * D), 0.03), rand(gen, (4 * D, D), 0.02)]
        b = [rand(gen, (n,), 0.02, f32) for n in (3 * D, D, 4 * D, D)]
        rf = rope.axial_freqs(rope.pixel_freqs(HD // 4, 576.0), (18, 32),
                              pixel=True).reshape(S_VAE, HD // 2).cuda()
        args = (x, ln[0], ln[1], w[0], b[0], w[1], b[1], ln[2], ln[3], w[2],
                b[2], w[3], b[3], rf, H)
        bb = [t.bfloat16() for t in b]
        rot = HD // 2

        def lib():
            h = F.layer_norm(x, (D,), ln[0].bfloat16(), ln[1].bfloat16(),
                             1e-6)
            qkv = library_linear(h, w[0], bb[0])
            q, k, v = (t.view(N, S_VAE, H, HD).transpose(1, 2)
                       for t in qkv.split(D, -1))
            q = torch.cat([lib_rope(q[..., :rot], rf), q[..., rot:]], -1)
            k = torch.cat([lib_rope(k[..., :rot], rf), k[..., rot:]], -1)
            o = F.scaled_dot_product_attention(q, k, v)
            xm = x + library_linear(o.transpose(1, 2).reshape(N, S_VAE, D),
                                    w[1], bb[1])
            h = F.layer_norm(xm, (D,), ln[2].bfloat16(), ln[3].bfloat16(),
                             1e-6)
            h = F.gelu(library_linear(h, w[2], bb[2]))
            return xm + library_linear(h, w[3], bb[3])

        by = nbytes(x, *ln, *w, *b, rf, x)
        fl = 2 * N * S_VAE * D * 12 * D + 4 * N * H * S_VAE * S_VAE * HD
        return (lambda: vae_block.fused_vae_block(*args),
                lambda: vae_block.vae_block_plain(*args), lib,
                "F.layer_norm+F.linear+SDPA+F.linear+F.gelu MLP (cuBLAS, "
                "flash)", by, fl)

    return [
        # name, replaces (TPU kernel), shape label, main shape?, builder
        ("fused_spatial_branch", "gtax/kernels/block.py:846",
         "step N=1 (B=1)", True, lambda: spatial(1)),
        ("fused_spatial_branch", "gtax/kernels/block.py:846",
         "step N=2 (B=2)", False, lambda: spatial(2)),
        ("fused_spatial_branch", "gtax/kernels/block.py:846",
         "prefill N=4 (B=1)", False, lambda: spatial(4)),
        ("fused_mlp_branch", "gtax/kernels/block.py:779",
         "step N=1 (B=1)", True, lambda: mlp(1)),
        ("fused_mlp_branch", "gtax/kernels/block.py:779",
         "step N=2 (B=2)", False, lambda: mlp(2)),
        ("fused_mlp_branch", "gtax/kernels/block.py:779",
         "prefill N=4 (B=1)", False, lambda: mlp(4)),
        ("fused_temporal_branch", "gtax/kernels/block.py:687",
         "prefill emit_kv B=1 T=4", True, lambda: temporal(1)),
        ("fused_temporal_branch", "gtax/kernels/block.py:687",
         "prefill emit_kv B=2 T=4", False, lambda: temporal(2)),
        ("fused_temporal_step", "gtax/kernels/block.py:518",
         "step B=1 n_ctx=4", True, lambda: step(1)),
        ("fused_temporal_step", "gtax/kernels/block.py:518",
         "step B=2 n_ctx=4", False, lambda: step(2)),
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


def int8_kernel_cases():
    """The int8 (W8A8) wrappers, as kernel_cases; builders also return the
    int8 tensor-core operations."""
    from gtax_torch.core import rope
    from gtax_torch.kernels import quant

    F = torch.nn.functional
    sfreqs = spatial_freqs()

    def lib_mod(x, sh, sc):
        ln = F.layer_norm(x.float(), (D,), eps=1e-6)
        return ln * (1 + sc.float()[:, None]) + sh.float()[:, None]

    def lib_rope(t, f):
        return (t * torch.cos(f) + rope.rotate_half(t) * torch.sin(f)).to(
            torch.bfloat16)

    def qw(gen, shape):
        return quant.quantize_weight(rand(gen, shape, 0.02))

    def attn_weights(gen):
        return (*qw(gen, (D, 3 * D)), *qw(gen, (D, D)),
                rand(gen, (D,), 0.02))

    def gated(x, g, y):
        return (x.float() + g.float()[:, None] * y).to(torch.bfloat16)

    def spatial(N):
        gen = np.random.default_rng(50 + N)
        x, sh, sc, g = branch_inputs(gen, N, S_DIT)
        w = attn_weights(gen)
        args = (x, sh, sc, g, *w, sfreqs, H)
        qkv_cm, out_cm = col_major(w[0]), col_major(w[2])

        def lib():
            qkv = lib_qlinear(lib_mod(x, sh, sc), qkv_cm, w[1])
            q, k, v = (t.view(N, S_DIT, H, HD).transpose(1, 2)
                       for t in qkv.split(D, -1))
            f = sfreqs[None, None]
            o = F.scaled_dot_product_attention(
                lib_rope(q, f), lib_rope(k, f), v.to(torch.bfloat16))
            y = lib_qlinear(o.transpose(1, 2).reshape(N, S_DIT, D).float(),
                            out_cm, w[3], w[4])
            return gated(x, g, y)

        M = N * S_DIT
        by = nbytes(x, sh, sc, g, *w, sfreqs, x)
        return (lambda: quant.fused_spatial_branch_q(*args),
                lambda: quant.spatial_branch_q_plain(*args), lib,
                "LN+int8 quant+torch._int_mm+SDPA+torch._int_mm", by,
                4 * N * H * S_DIT * S_DIT * HD, 2 * M * D * 4 * D)

    def mlp(N):
        gen = np.random.default_rng(60 + N)
        x, sh, sc, g = branch_inputs(gen, N, S_DIT)
        w1, w2 = qw(gen, (D, 4 * D)), qw(gen, (4 * D, D))
        b1, b2 = rand(gen, (4 * D,), 0.02), rand(gen, (D,), 0.02)
        args = (x, sh, sc, g, *w1, b1, *w2, b2)
        G = 512
        w1_cm, w2_cm = col_major(w1[0]), col_major(w2[0])

        def lib():
            h = F.gelu(lib_qlinear(lib_mod(x, sh, sc), w1_cm, w1[1], b1),
                       approximate="tanh").reshape(-1, 4 * D)
            y = 0.0
            for c in range(4 * D // G):  # requantized per 512-wide chunk
                hq, hs = lib_quant(h[:, c * G:(c + 1) * G])
                y = y + torch._int_mm(hq, w2_cm[c * G:(c + 1) * G]) * hs
            y = y * w2[1].reshape(-1) + b2.float()
            return gated(x, g, y.reshape(N, S_DIT, D))

        by = nbytes(x, sh, sc, g, *w1, b1, *w2, b2, x)
        return (lambda: quant.fused_mlp_branch_q(*args),
                lambda: quant.mlp_branch_q_plain(*args), lib,
                "LN+int8 quant+torch._int_mm+F.gelu+8 torch._int_mm", by, 0,
                2 * 2 * N * S_DIT * D * 4 * D)

    def temporal(B, T=4):
        gen = np.random.default_rng(70 + B)
        N = B * T
        x, sh, sc, g = branch_inputs(gen, N, S_DIT)
        w = attn_weights(gen)
        f = temporal_freqs(T)
        valid = [False] + [True] * (T - 1)
        args = (x, sh, sc, g, *w, f, valid, H, T)
        qkv_cm, out_cm = col_major(w[0]), col_major(w[2])
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device="cuda"))

        def lib():
            qkv = lib_qlinear(lib_mod(x, sh, sc), qkv_cm, w[1])
            q, k, v = (t.view(B, T, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
                       for t in qkv.split(D, -1))
            o = F.scaled_dot_product_attention(
                lib_rope(q, f), lib_rope(k, f), v.to(torch.bfloat16),
                attn_mask=mask)
            y = lib_qlinear(o.permute(0, 3, 1, 2, 4).reshape(N, S_DIT, D)
                            .float(), out_cm, w[3], w[4])
            return gated(x, g, y)

        by = nbytes(x, sh, sc, g, *w, f) + 3 * nbytes(x)
        return (lambda: quant.fused_temporal_branch_q(*args, emit_kv=True),
                lambda: quant.temporal_branch_q_plain(*args, emit_kv=True),
                lib, "LN+int8 quant+torch._int_mm+SDPA(causal)+"
                "torch._int_mm", by,
                4 * B * S_DIT * H * (T * (T + 1) // 2) * HD,
                2 * N * S_DIT * D * 4 * D)

    def step(B, n_ctx=4):
        gen = np.random.default_rng(80 + B)
        x, sh, sc, g = branch_inputs(gen, B, S_DIT)
        w = attn_weights(gen)
        kc = rand(gen, (B * n_ctx * S_DIT, D))
        vc = rand(gen, (B * n_ctx * S_DIT, D))
        T = n_ctx + 1
        f = temporal_freqs(T)
        valid = torch.tensor([False] + [True] * n_ctx)
        args = (x, sh, sc, g, *w, kc, vc, f, valid, H, n_ctx)
        qkv_cm, out_cm = col_major(w[0]), col_major(w[2])

        def lib():
            qkv = lib_qlinear(lib_mod(x, sh, sc), qkv_cm, w[1])
            q, k, v = (t.view(B, 1, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
                       for t in qkv.split(D, -1))
            ck, cv = (t.view(B, n_ctx, S_DIT, H, HD).permute(0, 2, 3, 1, 4)
                      for t in (kc, vc))
            keys = torch.cat([ck, lib_rope(k, f[n_ctx:])], dim=3)
            vals = torch.cat([cv, v.to(torch.bfloat16)], dim=3)
            o = F.scaled_dot_product_attention(lib_rope(q, f[n_ctx:]), keys,
                                               vals)
            y = lib_qlinear(o.permute(0, 3, 1, 2, 4).reshape(B, S_DIT, D)
                            .float(), out_cm, w[3], w[4])
            return gated(x, g, y)

        by = nbytes(x, sh, sc, g, *w, kc, vc, f, x)
        return (lambda: quant.fused_temporal_step_q(*args),
                lambda: quant.temporal_step_q_plain(*args), lib,
                "LN+int8 quant+torch._int_mm+SDPA over cache+"
                "torch._int_mm", by, 4 * B * S_DIT * H * T * HD,
                2 * B * S_DIT * D * 4 * D)

    return [
        ("fused_spatial_branch_q", "gtax/kernels/quant.py:368",
         "step N=1 (B=1)", True, lambda: spatial(1)),
        ("fused_spatial_branch_q", "gtax/kernels/quant.py:368",
         "step N=2 (B=2)", False, lambda: spatial(2)),
        ("fused_spatial_branch_q", "gtax/kernels/quant.py:368",
         "prefill N=4 (B=1)", False, lambda: spatial(4)),
        ("fused_mlp_branch_q", "gtax/kernels/quant.py:530",
         "step 144 rows (B=1)", True, lambda: mlp(1)),
        ("fused_mlp_branch_q", "gtax/kernels/quant.py:530",
         "step 288 rows (B=2)", False, lambda: mlp(2)),
        ("fused_mlp_branch_q", "gtax/kernels/quant.py:530",
         "prefill 576 rows (B=1)", False, lambda: mlp(4)),
        ("fused_temporal_branch_q", "gtax/kernels/quant.py:427",
         "prefill emit_kv B=1 T=4", True, lambda: temporal(1)),
        ("fused_temporal_branch_q", "gtax/kernels/quant.py:427",
         "prefill emit_kv B=2 T=4", False, lambda: temporal(2)),
        ("fused_temporal_step_q", "gtax/kernels/quant.py:216",
         "step B=1 n_ctx=4", True, lambda: step(1)),
        ("fused_temporal_step_q", "gtax/kernels/quant.py:216",
         "step B=2 n_ctx=4", False, lambda: step(2)),
    ]


SOURCES = {
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


def kernel_phase():
    timer = Timer()
    rows = {}
    for name, replaces, label, main, make in (kernel_cases()
                                              + int8_kernel_cases()):
        # by: bytes, fl: bf16 flops, i8: int8 ops (int8 wrappers only)
        kern, plain, lib, lib_desc, by, fl, *i8 = make()
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err, tol = 0.0, 0.0
        for a, b in zip(got, ref):
            if not torch.isfinite(a.float()).all():
                fail(f"{name} [{label}]: non-finite output")
            err = max(err, (a.float() - b.float()).abs().max().item())
            tol = max(tol, 2.0**-6 * max(1.0, b.float().abs().max().item()))
        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(lib)
        bms, by_what = bound_ms(by, fl, *i8)
        ops = f"{fl / 1e9:.2f} GFLOP" + (f", {i8[0] / 1e9:.2f} int8 GOP"
                                          if i8 else "")
        log(f"[kernel] {name:23s} {label:34s} max_abs_err={err:.3g} "
            f"(tol {tol:.3g}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by_what}; "
            f"{by / 1e6:.1f} MB, {ops})")
        if not err <= tol:
            fail(f"{name} [{label}] disagrees with its plain version: "
                 f"{err} > {tol}")
        if main:
            rows[name] = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": replaces, "launches": None, "max_abs_err": err,
                "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by_what, "library_ms": lib_ms,
                "library": lib_desc, "shape": label,
            }
    return rows


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
INT8_PATH = ("fused_spatial_branch_q", "fused_mlp_branch_q",
             "fused_temporal_branch_q", "fused_temporal_step_q",
             "fused_vae_block")


def kernel_wrappers():
    """name -> wrapper; each wrapper counts its launches in `.launches`."""
    from gtax_torch.kernels import block, quant, vae_block

    return {name: getattr(mod, name) for name, mod in (
        *((n, block) for n in BF16_PATH[:4]),
        *((n, quant) for n in INT8_PATH[:4]),
        ("fused_vae_block", vae_block))}


def profile_frame(gen, lat0, acts, nz, steps=4):
    """torch.profiler over one generated frame at full depth (prefill +
    steps + 1 denoise steps): device time by kernel and the device's busy
    share of the wall time. Informational: a trace without device events
    prints "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    from gtax_torch.models import dit as dit_mod
    from gtax_torch.sampling.diffusion import SamplerConfig, make_rollout

    bf = torch.bfloat16
    roll = make_rollout(None, gen.dit_cfg.max_frames,
                        SamplerConfig(ddim_noise_steps=steps),
                        cond=dit_mod.make_cond_fns(gen.dit_cfg, bf),
                        incremental=dit_mod.make_incremental_fns(gen.dit_cfg,
                                                                 bf))
    with torch.inference_mode():
        roll(gen.dit_params, lat0, acts, None, 1, nz)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            roll(gen.dit_params, lat0, acts, None, 1, nz)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    by_kernel = {}  # device-side events only: kernels, memcpy, memset
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            by_kernel[ev.key] = (us, ev.count)
    busy = sum(us for us, _ in by_kernel.values()) / 1e6
    if not by_kernel:
        log("[profile] device time not measured (no CUDA events traced)")
        return
    log(f"[profile] {gen.cfg.quantize}: one frame, {steps + 1} steps, depth "
        f"{gen.dit_cfg.depth}: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%)")
    for key, (us, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[
            :12]:
        log(f"[profile]   {us / 1e3:9.3f} ms {n:6d}x  {key[:90]}")


def drive_path(gen, label, path, rows, record, inputs):
    """One generate call with every launch count zeroed just before it and
    read just after: each kernel of `path` must have launched. Records the
    counts of the `record` kernels in their rows."""
    prompt, actions, noise = inputs
    n_frames, vc = actions.shape[1], gen.vae_cfg
    n_gen = noise.shape[1]
    fns = kernel_wrappers()
    for fn in fns.values():
        fn.launches = 0
    pixels = gen.generate(prompt, actions, num_frames=n_frames, noise=noise)
    counts = {name: fns[name].launches for name in path}
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
    for name, n in counts.items():
        if n <= 0:
            fail(f"{name} was not launched on the {label} main path")
    for name in record:
        rows[name]["launches"] = counts[name]


def check_rollouts(gen, label, lat0, acts, nz):
    """Incremental against full-window rollout on the card, and a depth-2
    full-width rollout on the card against the port's CPU rollout (plain
    versions); tolerance 2**-5 of the latents' largest magnitude."""
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
    scale = max(1.0, lat_full.abs().max().item())
    err = (lat_inc - lat_full).abs().max().item()
    tol = 2.0**-5 * scale
    log(f"[e2e {label}] incremental {(t2 - t1) / n_gen:.3f} s/frame vs "
        f"full-window {(t3 - t2) / n_gen:.3f} s/frame; latents "
        f"max_abs_err={err:.4g} (tol {tol:.4g}, max|lat| {scale:.3g})")
    if not err <= tol:
        fail(f"{label} incremental rollout disagrees with full window: "
             f"{err} > {tol}")

    cfg2 = dataclasses.replace(gen.dit_cfg, depth=2)
    params2 = dict(gen.dit_params, blocks=gen.dit_params["blocks"][:2])
    bf = torch.bfloat16
    roll = make_rollout(None, cfg2.max_frames, SamplerConfig(
        ddim_noise_steps=4), cond=dit_mod.make_cond_fns(cfg2, bf),
        incremental=dit_mod.make_incremental_fns(cfg2, bf))
    with torch.inference_mode():
        on_card = roll(params2, lat0, acts, None, n_gen, nz)
        on_cpu = roll(dit_mod.params_to(params2, "cpu"), lat0.cpu(),
                      acts.cpu(), None, n_gen, nz.cpu())
    scale = max(1.0, on_cpu.abs().max().item())
    err = (on_card.cpu() - on_cpu).abs().max().item()
    tol = 2.0**-5 * scale
    log(f"[e2e {label}] depth-2 rollout card vs CPU: max_abs_err={err:.4g} "
        f"(tol {tol:.4g})")
    if not err <= tol:
        fail(f"{label} card rollout disagrees with CPU rollout: {err} > {tol}")


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
            prompt).cuda(), torch.bfloat16)
    acts = torch.from_numpy(actions).cuda()
    nz = torch.from_numpy(noise).cuda()

    drive_path(gen, "bf16", BF16_PATH, rows, BF16_PATH, inputs)
    check_rollouts(gen, "bf16", lat0, acts, nz)
    profile_frame(gen, lat0, acts, nz)

    # the same bf16 weights, quantized by the serving path
    gen8 = VideoGenerator(gen.dit_params, gen.vae_params,
                          dataclasses.replace(cfg, quantize="int8"))
    drive_path(gen8, "int8", INT8_PATH, rows, INT8_PATH[:4], inputs)
    check_rollouts(gen8, "int8", lat0, acts, nz)
    profile_frame(gen8, lat0, acts, nz)
    int8_vs_bf16(gen, gen8)


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
    log(f"[env] torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"device {name}; count {torch.cuda.device_count()}")
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"[build] {lib.relative_to(build.BUILD_DIR.parent.parent)} in "
        f"{time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        rows = kernel_phase()
    end_to_end(rows)
    for row in rows.values():
        for k, v in row.items():
            if isinstance(v, float) and not math.isfinite(v):
                fail(f"{row['name']}: {k} is not finite")
    log(json.dumps({"kernels": list(rows.values()),
                    "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
