#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gtax_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits nonzero and prints no result line):
  1. environment: torch version, device, `nvidia-smi` name and power limit;
  2. build: nvcc builds gtax_torch/csrc/*.cu for sm_90a (timed);
  3. kernels: each of the five kernels at its main-path shapes (DiT-S/2
     and ViT-L/20 widths) and at batch 2, against its plain PyTorch version
     on the same inputs (bf16 both; tolerance 2**-6 of the output's largest
     magnitude, four bf16 ulps); CUDA-event times of the kernel, the plain
     version and a library yardstick, with the L2 cache flushed before
     every timed call; the bound from bytes and operations;
  4. end to end: VideoGenerator at full DiT-S/2 + ViT-L/20 width, bf16,
     B=1, 4 prompt frames + 2 generated, 100 noise steps, random seeded
     weights with nonzero adaLN heads, injected noise. The launch counters
     are zeroed just before this run and read just after it: all five
     kernels must have launched. Then the incremental rollout against the
     full-window rollout on the card, and a depth-2 full-width rollout on
     the card against the port's CPU rollout (plain versions).

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
D, H, HD = 1024, 16, 64
S_DIT, S_VAE = 144, 576


def log(*args):
    print(*args, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ------------------------------------------------------------------ timing

class Timer:
    """Median CUDA-event time of one call, L2 flushed before each call and
    the stream held for ~50 us so the host can enqueue the whole call."""

    def __init__(self, iters=15):
        self.iters = iters
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
            torch.cuda._sleep(100_000)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / BF16_FLOPS_PER_S
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


# ------------------------------------------------------------ the kernels

def kernel_cases():
    """(name, label, main, builder) per kernel and shape; builder returns
    (kernel_fn, plain_fn, library_fn, library_desc, bytes, flops)."""
    from gtax_torch.core import rope
    from gtax_torch.kernels import block, vae_block

    F = torch.nn.functional
    sfreqs = rope.axial_freqs(rope.pixel_freqs(HD // 2, 256.0), (9, 16),
                              pixel=True).reshape(S_DIT, HD).cuda()

    def tfreqs(T):
        return rope.temporal_rope_freqs(torch.arange(T),
                                        rope.lang_freqs(HD)).cuda()

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
        f = tfreqs(T)
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
        f = tfreqs(T)
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


SOURCES = {
    "fused_spatial_branch": "gtax_torch/kernels/block.py",
    "fused_mlp_branch": "gtax_torch/kernels/block.py",
    "fused_temporal_branch": "gtax_torch/kernels/block.py",
    "fused_temporal_step": "gtax_torch/kernels/block.py",
    "fused_vae_block": "gtax_torch/kernels/vae_block.py",
}


def kernel_phase():
    timer = Timer()
    rows = {}
    for name, replaces, label, main, make in kernel_cases():
        kern, plain, lib, lib_desc, by, fl = make()
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
        bms, by_what = bound_ms(by, fl)
        log(f"[kernel] {name:22s} {label:34s} max_abs_err={err:.3g} "
            f"(tol {tol:.3g}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by_what}; "
            f"{by / 1e6:.1f} MB, {fl / 1e9:.2f} GFLOP)")
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


def kernel_wrappers():
    """name -> wrapper; each wrapper counts its launches in `.launches`."""
    from gtax_torch.kernels import block, vae_block

    return {"fused_spatial_branch": block.fused_spatial_branch,
            "fused_mlp_branch": block.fused_mlp_branch,
            "fused_temporal_branch": block.fused_temporal_branch,
            "fused_temporal_step": block.fused_temporal_step,
            "fused_vae_block": vae_block.fused_vae_block}


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
    log(f"[profile] one frame, {steps + 1} steps, depth "
        f"{gen.dit_cfg.depth}: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%)")
    for key, (us, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[
            :12]:
        log(f"[profile]   {us / 1e3:9.3f} ms {n:6d}x  {key[:90]}")


def end_to_end(rows):
    from gtax_torch.data.actions import forward_actions
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.sampling.diffusion import SamplerConfig, make_rollout
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

    fns = kernel_wrappers()
    for fn in fns.values():
        fn.launches = 0
    pixels = gen.generate(prompt, actions, num_frames=n_frames, noise=noise)
    counts = {name: fn.launches for name, fn in fns.items()}
    tm = gen.last_timings
    n_gen = n_frames - n_prompt
    log(f"[e2e] generate: pixels {pixels.shape} {pixels.dtype}; "
        f"encode {tm['encode_s'] * 1e3:.1f} ms, rollout "
        f"{tm['rollout_s'] / n_gen:.3f} s/frame ({steps + 1} steps), decode "
        f"{tm['decode_s'] * 1e3:.1f} ms ({n_frames} frames)")
    log(f"[e2e] launches on the main path: {json.dumps(counts)}")
    if pixels.shape != (1, n_frames, vc.input_height, vc.input_width, 3) \
            or pixels.dtype != np.uint8:
        fail(f"generate returned {pixels.shape} {pixels.dtype}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"{name} was not launched on the main path")
        rows[name]["launches"] = n

    # incremental vs full-window rollout on the card, same inputs
    with torch.inference_mode():
        lat0 = encode_frames(gen.vae_params, vc, torch.from_numpy(
            prompt).cuda(), torch.bfloat16)
        acts = torch.from_numpy(actions).cuda()
        nz = torch.from_numpy(noise).cuda()
        full = VideoGenerator(gen.dit_params, gen.vae_params,
                              dataclasses.replace(cfg, incremental=False))
        t1 = time.perf_counter()
        lat_inc = gen._rollout(gen.dit_params, lat0, acts, None, n_gen, nz)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lat_full = full._rollout(full.dit_params, lat0, acts, None, n_gen,
                                 nz)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    if not (torch.isfinite(lat_inc).all() and torch.isfinite(lat_full).all()):
        fail("non-finite latents")
    scale = max(1.0, lat_full.abs().max().item())
    err = (lat_inc - lat_full).abs().max().item()
    tol = 2.0**-5 * scale
    log(f"[e2e] incremental {(t2 - t1) / n_gen:.3f} s/frame vs full-window "
        f"{(t3 - t2) / n_gen:.3f} s/frame; latents max_abs_err={err:.4g} "
        f"(tol {tol:.4g}, max|lat| {scale:.3g})")
    if not err <= tol:
        fail(f"incremental rollout disagrees with full window: {err} > {tol}")

    profile_frame(gen, lat0, acts, nz)

    # depth-2 full-width rollout: card (kernels) against CPU (plain)
    cfg2 = dataclasses.replace(gen.dit_cfg, depth=2)
    params2 = dict(gen.dit_params, blocks=gen.dit_params["blocks"][:2])
    sampler = SamplerConfig(ddim_noise_steps=4)
    bf = torch.bfloat16
    roll = make_rollout(None, cfg2.max_frames, sampler,
                        cond=dit_mod.make_cond_fns(cfg2, bf),
                        incremental=dit_mod.make_incremental_fns(cfg2, bf))
    with torch.inference_mode():
        on_card = roll(params2, lat0, acts, None, n_gen, nz)
        params_cpu = dit_mod.params_to(params2, "cpu")
        on_cpu = roll(params_cpu, lat0.cpu(), acts.cpu(), None, n_gen,
                      nz.cpu())
    scale = max(1.0, on_cpu.abs().max().item())
    err = (on_card.cpu() - on_cpu).abs().max().item()
    tol = 2.0**-5 * scale
    log(f"[e2e] depth-2 rollout card vs CPU: max_abs_err={err:.4g} "
        f"(tol {tol:.4g})")
    if not err <= tol:
        fail(f"card rollout disagrees with CPU rollout: {err} > {tol}")
    return tm


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
