"""Hold two checkouts' serving kernels against each other on one card: the
bf16 step branches (`fused_spatial_branch`, `fused_mlp_branch`,
`fused_temporal_step`), the bf16 prefill's `fused_temporal_branch` (and its
emit_train mode at B=4, T=5, the training step's window), and the int8
wrappers and pairs
(`gtax_torch.kernels.quant`, `gtax_torch.kernels.pair`; the three
int8 wrappers #7-#9 also in their emit_train mode at the B=2 and B=16
training steps' 1,440 and 11,520 rows, in bf16 and fp32), on fixed seeded
inputs; and every serving call again at x.dtype = float32
(its bf16 inputs, biases and context cache cast to fp32: the fp32 forms
of #1-#4 and #6-#11), named "... fp32", and the fp32 emit_train forwards
of #1-#3 at B=4, T=5 (the fp32 training step's forward products); the
ViT-VAE block `fused_vae_block` (#5) at the encode's 4 frames and the
decode's 6 of 576 tokens, in bf16 and fp32; the `pallas` attention
`fused_mha_token_major` (#16) at the spatial (5, 144, 1024), VAE (6, 576,
1024) and masked temporal (144, 5, 1024) shapes, in bf16 and fp32; and #2
`fused_mlp_branch`'s fp32 emit_train at the fp32 training step's B=16 (80
frames, 11,520 rows).

    PYTHONPATH=<checkout> python <this file> --save FILE   # outputs
    python <this file> --compare FILE_A FILE_B             # bits
    PYTHONPATH=<checkout> python <this file> --time        # ms

The inputs are DiT-S/2's widths at 1-4 frames of 144 tokens (the
prefill's int8 and bf16 temporal branches at windows of 4 frames), made
with numpy from fixed seeds; int8 weights are quantized on the card by
the checkout's own `quant.quantize_weight`, so each checkout stores them
as its kernels read them. --save writes every output to FILE; --compare prints, for each
output (each of a call's outputs: the prefill's K/V cache, emit_train's
q, k, v apart from the branch output), whether the two files hold the same
bits (for an output that differs, the share of elements and the largest
difference, alone and over the first file's largest magnitude: a split-K
sum adds in another order), then whether every int8, bf16 and fp32
output is bit-equal (naming the fp32 ones that differ; the fp32 forms of
the int8 wrappers are fp32 outputs), and exits 1 if an int8 output
differs; --time
prints each call's CUDA-event median (L2 flushed and the stream held 10 ms
before each call) and, last, a JSON object of them. To compare speed, run
--time for each checkout in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

D, H, HD, S = 1024, 16, 64, 144
CYCLES_PER_MS = 1.98e6  # the H100's boost clock (torch.cuda._sleep counts)


def _rand(gen, shape, std=1.0):
    return torch.from_numpy(gen.standard_normal(shape).astype(
        np.float32) * std).to("cuda", torch.bfloat16)


def cases():
    """name -> a call of one wrapper on its inputs."""
    from gtax_torch.core import rope
    from gtax_torch.kernels import attention as kattn
    from gtax_torch.kernels import block, pair, quant, vae_block

    sf = rope.axial_freqs(rope.pixel_freqs(HD // 2, 256.0), (9, 16),
                          pixel=True).reshape(S, HD).cuda()
    tf = rope.temporal_rope_freqs(torch.arange(5), rope.lang_freqs(HD)).cuda()
    valid = [False, True, True, True, True]
    out = {}
    for N in (1, 2, 3, 4):
        gen = np.random.default_rng(700 + N)
        x = _rand(gen, (N, S, D))
        mods = _rand(gen, (N, 6 * D), 0.5)
        v = [mods[:, i * D:(i + 1) * D] for i in range(6)]

        def qw(shape):
            return quant.quantize_weight(_rand(gen, shape, 0.02))

        wa = (*qw((D, 3 * D)), *qw((D, D)), _rand(gen, (D,), 0.02))
        wm = (*qw((D, 4 * D)), _rand(gen, (4 * D,), 0.02), *qw((4 * D, D)),
              _rand(gen, (D,), 0.02))
        kc, vc = (_rand(gen, (N * 4 * S, D)) for _ in range(2))
        tail = (kc, vc, tf, valid, H, 4)
        if N <= 2:  # the bf16 step branches
            ba = (_rand(gen, (D, 3 * D), 0.02), _rand(gen, (D, D), 0.02),
                  _rand(gen, (D,), 0.02))
            bm = (_rand(gen, (D, 4 * D), 0.02), _rand(gen, (4 * D,), 0.02),
                  _rand(gen, (4 * D, D), 0.02), _rand(gen, (D,), 0.02))
            out[f"spatial_branch N={N}"] = (
                block.fused_spatial_branch, (x, *v[:3], *ba, sf, H))
            out[f"mlp_branch N={N}"] = (block.fused_mlp_branch,
                                        (x, *v[3:], *bm))
            out[f"temporal_step B={N}"] = (block.fused_temporal_step,
                                           (x, *v[:3], *ba, *tail))
        out[f"spatial_branch_q N={N}"] = (quant.fused_spatial_branch_q,
                                          (x, *v[:3], *wa, sf, H))
        out[f"mlp_branch_q N={N}"] = (quant.fused_mlp_branch_q,
                                      (x, *v[3:], *wm))
        out[f"temporal_step_q B={N}"] = (quant.fused_temporal_step_q,
                                         (x, *v[:3], *wa, *tail))
        out[f"spatial_pair_q N={N}"] = (pair.fused_spatial_pair_q,
                                        (x, *v, *wa, *wm, sf, H))
        out[f"temporal_pair_q B={N}"] = (pair.fused_temporal_pair_q,
                                         (x, *v, *wa, *wm, *tail))
        if N <= 2:  # the int8 prefill: windows of 4 frames
            T = 4
            xt = _rand(gen, (N * T, S, D))
            mt = _rand(gen, (N * T, 3 * D), 0.5)
            out[f"temporal_branch_q B={N}"] = (
                lambda *a: quant.fused_temporal_branch_q(*a, emit_kv=True),
                (xt, mt[:, :D], mt[:, D:2 * D], mt[:, 2 * D:], *wa, tf[:T],
                 valid[:T], H, T))
            out[f"temporal_branch B={N}"] = (
                lambda *a: block.fused_temporal_branch(*a, emit_kv=True),
                (xt, mt[:, :D], mt[:, D:2 * D], mt[:, 2 * D:], *ba, tf[:T],
                 valid[:T], H, T))
    gen = np.random.default_rng(710)
    B, T = 4, 5  # emit_train: (out, q, k, v, y)
    xt = _rand(gen, (B * T, S, D))
    mt = _rand(gen, (B * T, 3 * D), 0.5)
    ba = (_rand(gen, (D, 3 * D), 0.02), _rand(gen, (D, D), 0.02),
          _rand(gen, (D,), 0.02))
    out[f"temporal_branch emit_train B={B} T={T}"] = (
        lambda *a: block.fused_temporal_branch(*a, emit_train=True),
        (xt, mt[:, :D], mt[:, D:2 * D], mt[:, 2 * D:], *ba, tf, valid, H, T))
    gen = np.random.default_rng(711)
    N = 80  # int8-forward training: B=16 x T=5 frames, (out, h1, y)
    xt = _rand(gen, (N, S, D))
    mt = _rand(gen, (N, 3 * D), 0.5)
    wm = (*quant.quantize_weight(_rand(gen, (D, 4 * D), 0.02)),
          _rand(gen, (4 * D,), 0.02),
          *quant.quantize_weight(_rand(gen, (4 * D, D), 0.02)),
          _rand(gen, (D,), 0.02))
    out[f"mlp_branch_q emit_train N={N}"] = (
        lambda *a: quant.fused_mlp_branch_q(*a, emit_train=True),
        (xt, mt[:, :D], mt[:, D:2 * D], mt[:, 2 * D:], *wm))
    gen = np.random.default_rng(716)
    wa = (*quant.quantize_weight(_rand(gen, (D, 3 * D), 0.02)),
          *quant.quantize_weight(_rand(gen, (D, D), 0.02)),
          _rand(gen, (D,), 0.02))
    for N in (10, 80):  # #7 and #8 at B=2 and B=16 (T=5), #9 at B=2
        xt = _rand(gen, (N, S, D))
        mt = _rand(gen, (N, 3 * D), 0.5)
        head = (xt, mt[:, :D], mt[:, D:2 * D], mt[:, 2 * D:])
        out[f"spatial_branch_q emit_train N={N}"] = (
            lambda *a: quant.fused_spatial_branch_q(*a, emit_train=True),
            (*head, *wa, sf, H))
        out[f"temporal_branch_q emit_train B={N // 5} T=5"] = (
            lambda *a: quant.fused_temporal_branch_q(*a, emit_train=True),
            (*head, *wa, tf, valid, H, 5))
        if N == 10:
            out[f"mlp_branch_q emit_train N={N}"] = (
                lambda *a: quant.fused_mlp_branch_q(*a, emit_train=True),
                (*head, *wm))
    for k, (fn, a) in list(out.items()):  # int8-forward training in fp32
        if "_q emit_train" in k:
            out[f"{k} fp32"] = (fn, tuple(_f32(a)))
    gen = np.random.default_rng(713)  # the VAE block: encode, decode
    vf = rope.axial_freqs(rope.pixel_freqs(HD // 4, 576.0), (18, 32),
                          pixel=True).reshape(576, HD // 2).cuda()
    ln = [(torch.ones(D, device="cuda") + _rand(gen, (D,), 0.1).float(),
           _rand(gen, (D,), 0.1).float()) for _ in range(2)]
    vw = (_rand(gen, (D, 3 * D), 0.03), _rand(gen, (3 * D,), 0.02),
          _rand(gen, (D, D), 0.03), _rand(gen, (D,), 0.02))
    vm = (_rand(gen, (D, 4 * D), 0.03), _rand(gen, (4 * D,), 0.02),
          _rand(gen, (4 * D, D), 0.02), _rand(gen, (D,), 0.02))
    for N in (4, 6):
        out[f"vae_block N={N}"] = (vae_block.fused_vae_block, (
            _rand(gen, (N, 576, D)), *ln[0], *vw, *ln[1], *vm, vf, H))
    gen = np.random.default_rng(715)  # the `pallas` attention (#15, #16)
    for n, S_, mask in ((5, S, None), (6, 576, None), (S, 5, valid)):
        qkv = [_rand(gen, (n, S_, D)) for _ in range(3)]
        out[f"mha_token_major S={S_}"] = (kattn.fused_mha_token_major,
                                           (*qkv, H, mask))
    for k, (fn, a) in list(out.items()):  # the serving calls in fp32
        if "emit_train" not in k:
            out[f"{k} fp32"] = (fn, tuple(_f32(a)))
    gen = np.random.default_rng(712)
    N = B * T  # the fp32 emit_train forwards of #1-#3 (fp32 training)
    xt, mt = _rand(gen, (N, S, D)).float(), _rand(gen, (N, 3 * D), 0.5)
    mods = tuple(_f32((mt[:, :D], mt[:, D:2 * D], mt[:, 2 * D:])))
    ba = (_rand(gen, (D, 3 * D), 0.02), _rand(gen, (D, D), 0.02),
          _rand(gen, (D,), 0.02))
    bm = (_rand(gen, (D, 4 * D), 0.02), _rand(gen, (4 * D,), 0.02),
          _rand(gen, (4 * D, D), 0.02), _rand(gen, (D,), 0.02))
    out[f"spatial_branch emit_train N={N} fp32"] = (
        lambda *a: block.fused_spatial_branch(*a, emit_train=True),
        (xt, *mods, *_f32(ba), sf, H))
    out[f"mlp_branch emit_train N={N} fp32"] = (
        lambda *a: block.fused_mlp_branch(*a, emit_train=True),
        (xt, *mods, *_f32(bm)))
    out[f"temporal_branch emit_train B={B} T={T} fp32"] = (
        lambda *a: block.fused_temporal_branch(*a, emit_train=True),
        (xt, *mods, *_f32(ba), tf, valid, H, T))
    gen = np.random.default_rng(714)
    N = 80  # #2 emit_train at the fp32 training step's B=16 (11,520 rows)
    xt, mt = _rand(gen, (N, S, D)).float(), _rand(gen, (N, 3 * D), 0.5)
    mods = tuple(_f32((mt[:, :D], mt[:, D:2 * D], mt[:, 2 * D:])))
    bm = (_rand(gen, (D, 4 * D), 0.02), _rand(gen, (4 * D,), 0.02),
          _rand(gen, (4 * D, D), 0.02), _rand(gen, (D,), 0.02))
    out[f"mlp_branch emit_train N={N} fp32"] = (
        lambda *a: block.fused_mlp_branch(*a, emit_train=True),
        (xt, *mods, *_f32(bm)))
    return out


def _f32(args):
    """args with every bf16 tensor cast to fp32."""
    return [t.float() if isinstance(t, torch.Tensor)
            and t.dtype == torch.bfloat16 else t for t in args]


def median_ms(fn, iters=15):
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        flush.zero_()
        torch.cuda._sleep(int(10 * CYCLES_PER_MS))
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", help="write the outputs here")
    mode.add_argument("--compare", nargs=2, help="two saved files")
    mode.add_argument("--time", action="store_true", help="time each call")
    args = ap.parse_args()
    if args.compare:
        a, b = (torch.load(f) for f in args.compare)
        same = {"int8": True, "bf16": True, "fp32": True}
        moved = []  # the fp32 outputs that differ
        for k in sorted(set(a) | set(b)):
            # the fp32 forms of the int8 wrappers count as fp32 outputs
            kind = ("fp32" if k.endswith("fp32") else "int8" if "_q " in k
                    else "bf16")
            if k not in a or k not in b:
                same[kind] = False
                print(f"[bits] {k}: in one file only")
                continue
            for i, (x, y) in enumerate(zip(a[k], b[k])):
                eq = torch.equal(x, y)
                same[kind] &= eq
                note = ""
                if not eq:
                    x, y = x.float(), y.float()
                    d = (x - y).abs().max().item()
                    note = (f" ({(x != y).float().mean().item():.3%} of "
                            f"elements, max |diff| {d:.3g}, "
                            f"{d / x.abs().max().item():.3g} of the largest "
                            f"magnitude)")
                name = k if len(a[k]) == 1 else f"{k} [{i}]"
                if not eq and kind == "fp32":
                    moved.append(name)
                print(f"[bits] {name}: {'bit-equal' if eq else 'DIFFERENT'}"
                      f"{note}")
        print(f"[bits] int8 outputs all bit-equal: {same['int8']}; bf16 "
              f"outputs all bit-equal: {same['bf16']}; fp32 outputs all "
              f"bit-equal: {same['fp32']} (differing: {moved})")
        return 0 if same["int8"] else 1
    if not torch.cuda.is_available():
        raise SystemExit("serve_ab: needs a CUDA device")
    from gtax_torch.utils.platform import strict_matmul

    strict_matmul()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with torch.inference_mode():
        calls = cases()
        if args.save:
            res = {}
            for k, (fn, a) in calls.items():
                got = fn(*a)
                res[k] = [t.cpu() for t in (got if isinstance(got, tuple)
                                            else (got,))]
            torch.save(res, args.save)
            print(f"[bits] {len(res)} outputs saved to {args.save}")
            return 0
        times = {}
        for k, (fn, a) in calls.items():
            times[k] = median_ms(lambda: fn(*a))
            print(f"[ab] {k:26s} {times[k]:.4f} ms", flush=True)
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
