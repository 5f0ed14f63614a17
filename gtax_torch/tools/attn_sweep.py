"""Time the two bodies of the `pallas` backend's attention kernel
(gtax_torch/csrc/attn_sdpa.cu: warp rows and tensor cores) at every row
length S of the sweep, in both layouts, beside one SDPA call of the same
attention, on one NVIDIA GPU; then split one tensor-core call at the VAE
shape, and one call of the spatial attention backward (attn_frame_bwd,
gtax_torch/csrc/attn_bwd.cu) at the B=16 training shape, into their
phases; and the fp32 attention backward (attn_frame_bwd_f32) at the same
shape, whole and by kernel (its two passes, from a torch.profiler trace),
with its useful TFLOP/s (the six S x S x d products a (frame, head)
that the function needs: scores, O = P V, dP, dQ, dK, dV; the kernel's
recompute of the scores and dP in its second pass is not counted)
beside autograd's backward of one fp32 SDPA call (no TF32). --f32-bwd
runs that part alone; it uses only launch_attn_frame_bwd's arguments,
which every version of the port has, so two checkouts' tiles are
compared in turns: `PYTHONPATH=<checkout> python <this file> --f32-bwd`.

    python -m gtax_torch.tools.attn_sweep [--f32-bwd] [--out FILE]

The layouts are fused_sdpa's heads-first (N * 16 rows of (S, 64)) and
fused_mha_token_major's token-major ((N, S, 1024), 16 heads of 64), with N
rows of S tokens where N * S is about the 720 tokens of one B=1 window (5
frames of 144; S = 576: the 6 frames of the VAE decode). Both bodies get
the same inputs and no mask (no bias, as the wrappers pass for an
unmasked call); their outputs are compared; SDPA gets no mask either, as
in chip_smoke.py. The kernel's dispatch
(`gtax_torch.kernels.attention.sdpa_tensor_cores`) is the rule this sweep
sets: its pick at each S is marked. The phase splits run the probe copy of
the two kernels (`gtax_torch.kernels.build.probe_library`, built here at
first use): the tensor-core body stopped before its first pass over the
keys (staging Q and K) and after it (max and sum), beside the library's
whole call; the backward stopped after staging and after phase A, beside
the whole. Times are CUDA-event medians with the L2 cache flushed and the
stream held 10 ms before each call. The last line of its output is a JSON
object of every row.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from gtax_torch.tools.gemm_sweep import median_ms

LENGTHS = (5, 8, 16, 32, 64, 144, 576)
H, HD = 16, 64


def rows_of(S):
    return 6 if S == 576 else max(1, round(720 / S))


def _inputs(gen, layout, S):
    N = rows_of(S)
    shape = (N * H, S, HD) if layout == "heads_first" else (N, S, H * HD)
    return N, [torch.from_numpy(gen.standard_normal(shape).astype(
        np.float32)).to("cuda", torch.bfloat16) for _ in range(3)]


def _probe(stop):
    """The library (stop 2) or its probe copy stopping after phase `stop`."""
    from gtax_torch.kernels import build

    return build.library() if stop == 2 else build.probe_library(stop)


def _call(q, k, v, out, S, heads, tensor_cores, stop=2):
    """One launch of gtax_attn_sdpa on dense rows with no bias."""
    from gtax_torch.kernels import build

    N = q.numel() // (S * heads * HD)
    ld = heads * HD
    build.launch("gtax_attn_sdpa", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None, out.data_ptr(), N, S, heads, HD, ld, ld, ld, ld,
                 tensor_cores, 1.0 / HD**0.5,
                 torch.cuda.current_stream().cuda_stream, lib=_probe(stop))
    return out


def sweep():
    from gtax_torch.kernels import attention as kattn

    F = torch.nn.functional
    gen = np.random.default_rng(9)
    rows = []
    for layout in ("heads_first", "token_major"):
        heads = 1 if layout == "heads_first" else H
        for S in LENGTHS:
            N, (q, k, v) = _inputs(gen, layout, S)
            outs = [torch.empty_like(q) for _ in range(2)]
            ms = {}
            for tc, name in ((0, "warp_rows"), (1, "tensor_cores")):
                fn = (lambda tc=tc: _call(q, k, v, outs[tc], S, heads, tc))
                fn()
                ms[name] = median_ms(fn)
            torch.cuda.synchronize()
            diff = float((outs[0].float() - outs[1].float()).abs().max())
            if layout == "heads_first":
                lib = (q, k, v)
            else:
                lib = tuple(t.view(N, S, H, HD).transpose(1, 2)
                            for t in (q, k, v))
            ms["sdpa"] = median_ms(
                lambda: F.scaled_dot_product_attention(*lib))
            pick = ("tensor_cores" if kattn.sdpa_tensor_cores(S)
                    else "warp_rows")
            n_rows = q.numel() // (S * HD)
            print(f"[attn] {layout:11s} S={S:3d} rows={n_rows:5d}: warp rows "
                  f"{ms['warp_rows']:.4f} ms, tensor cores "
                  f"{ms['tensor_cores']:.4f} ms, SDPA {ms['sdpa']:.4f} ms; "
                  f"max|diff| of the bodies {diff:.3g}; dispatch: {pick}",
                  flush=True)
            rows.append({"layout": layout, "S": S, "N": N, **ms,
                         "bodies_max_abs_diff": diff, "dispatch": pick})
    return rows


def phases(S=576, N=6):
    """The tensor-core body at the VAE shape, stopped before pass 1, after
    it and whole: the time of staging, of pass 1 and of pass 2."""
    gen = np.random.default_rng(10)
    _, (q, k, v) = _inputs(gen, "token_major", S)
    out = torch.empty_like(q)
    ms = [median_ms(lambda p=p: _call(q, k, v, out, S, H, 1, p))
          for p in (0, 1, 2)]
    split = {"stage_q_k": ms[0], "pass_1": ms[1] - ms[0],
             "pass_2": ms[2] - ms[1], "whole": ms[2]}
    print(f"[attn] phases of the tensor-core body at ({N}, {S}, {H * HD}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()),
          flush=True)
    return split


def bwd_phases(n_frames=80, S=144, rot=HD):
    """attn_frame_bwd at the B=16 training shape (80 frames of the DiT's 144
    tokens, 16 heads of 64, its spatial rope table on the first rot dims of
    a head; rot = 0: no rope adjoint), stopped after staging, after phase A
    and whole: the time of staging, of phase A (scores, P, O, dP, dS, dQ)
    and of phase B (dK, dV)."""
    from gtax_torch.core import rope
    from gtax_torch.kernels import backward, build

    gen = np.random.default_rng(11)
    D = H * HD
    q, k, v, dout = (torch.from_numpy(gen.standard_normal(
        (n_frames * S, D)).astype(np.float32)).to("cuda", torch.bfloat16)
        for _ in range(4))
    freqs = rope.axial_freqs(rope.pixel_freqs(HD // 2, 256.0), (9, 16),
                             pixel=True).reshape(S, HD).cuda()
    dqkv = torch.empty((n_frames * S, 3 * D), dtype=torch.bfloat16,
                       device="cuda")
    ao = torch.empty_like(q)

    cos, sin = backward.rope_tables(freqs[:, :rot])

    def call(stop):
        build.launch("gtax_attn_frame_bwd", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), dout.data_ptr(), cos.data_ptr(),
                     sin.data_ptr(), dqkv.data_ptr(), ao.data_ptr(),
                     n_frames, S, D, H, rot,
                     torch.cuda.current_stream().cuda_stream,
                     lib=_probe(stop))

    ms = [median_ms(lambda p=p: call(p)) for p in (0, 1, 2)]
    split = {"stage": ms[0], "phase_a": ms[1] - ms[0],
             "phase_b": ms[2] - ms[1], "whole": ms[2]}
    print(f"[attn] phases of attn_frame_bwd at {n_frames} frames of {S}, "
          f"rope on {rot} dims: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()),
          flush=True)
    return split


def bwd_f32(n_frames=80, S=144, rot=HD):
    """attn_frame_bwd_f32 at the B=16 training shape (as bwd_phases, fp32):
    the whole call's ms and useful TFLOP/s, each kernel's device ms, and
    autograd's backward of one fp32 SDPA call (heads-first, no mask)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gtax_torch.core import rope
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(12)
    D = H * HD
    q, k, v, dout = (torch.from_numpy(gen.standard_normal(
        (n_frames * S, D)).astype(np.float32)).cuda() for _ in range(4))
    freqs = rope.axial_freqs(rope.pixel_freqs(HD // 2, 256.0), (9, 16),
                             pixel=True).reshape(S, HD).cuda()
    cos, sin = backward.rope_tables(freqs[:, :rot])
    dqkv = torch.empty((n_frames * S, 3 * D), device="cuda")
    ao = torch.empty_like(q)

    def call():
        backward.launch_attn_frame_bwd(q, k, v, dout, cos, sin, dqkv, ao,
                                       n_frames, S, D, H, rot)

    ms = median_ms(call)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = {ev.key[:60]: getattr(ev, "self_device_time_total", 0.0) / 1e3
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA}
    heads = [t.reshape(n_frames, S, H, HD).transpose(1, 2).requires_grad_()
             for t in (q, k, v)]
    do = dout.reshape(n_frames, S, H, HD).transpose(1, 2)

    def lib():
        out = torch.nn.functional.scaled_dot_product_attention(*heads)
        torch.autograd.grad(out, heads, do)

    lib_ms = median_ms(lib)
    gf = 12 * n_frames * H * S * S * HD / 1e9
    print(f"[attn f32 bwd] {n_frames} frames of {S}, rope on {rot} dims: "
          f"{ms:.4f} ms ({gf / ms:.1f} TFLOP/s useful of {gf:.1f} GFLOP); "
          f"by kernel {json.dumps(kernels)}; autograd of fp32 SDPA "
          f"{lib_ms:.4f} ms", flush=True)
    return {"ms": ms, "tflops": gf / ms, "kernels_ms": kernels,
            "library_ms": lib_ms}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f32-bwd", action="store_true",
                    help="time the fp32 attention backward alone")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_sweep: needs a CUDA device")
    from gtax_torch.utils.platform import strict_matmul

    strict_matmul()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.f32_bwd:
        result = {"card": card, "bwd_f32": bwd_f32()}
    else:
        result = {"card": card, "rows": sweep(), "phases": phases(),
                  "bwd_phases": bwd_phases(), "bwd_phases_no_rope":
                  bwd_phases(rot=0), "bwd_f32": bwd_f32()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
