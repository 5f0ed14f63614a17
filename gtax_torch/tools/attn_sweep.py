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
--f32 times the fp32 forward alone: the `pallas` attention's fp32 form
(fused_sdpa / fused_mha_token_major on fp32 tensors: its tiled SIMT body
from 32 tokens) at S = 32 .. 577 in both layouts, with its FFMA TFLOP/s
(4 S^2 d a head), beside one fp32 SDPA call (no TF32) and its bound at
67 TFLOP/s; it calls only the public wrappers, so `PYTHONPATH=<checkout>
python <this file> --f32` times another checkout's body in turns.
--f32-bodies times the fp32 forward's two tiled bodies (48- and 128-row
tiles) against each other, in turns, at S = 32 .. 577 token-major, and
prints the length from which the 128-row body gives the least summed
time over those lengths: the threshold `attention.SDPA_F32_WIDE_MIN_S`
holds. --f32-frame times the fp32 frame attention alone
(`block.launch_attn_frame_f32`: its rope pass and its attention, two
launches) at the main path's shapes, (frames, S) = (1, 144), (2, 144),
(4, 144), (80, 144) and (6, 576) (DiT-S/2's spatial rope, full-d; the
VAE's, on half of a head), with each launch's device ms from a trace and
its error against the plain fp32 attention on the roped
q/k/v and whether two calls give the same bits, beside one fp32 SDPA call
on the same roped q/k/v (no TF32) and the bound; it calls only the public
wrapper, so `PYTHONPATH=<checkout> python <this file> --f32-frame` times
another checkout in turns. Where the wrapper takes a query tile (`shape`),
every tile of S's kind is timed too, each output held bit-equal to the
rule's, and the fp32 spatial pair (#10, `pair._launch`) at one and two
frames at each tile it takes, beside the rule's pick.

    python -m gtax_torch.tools.attn_sweep [--f32 | --f32-bodies |
                                           --f32-bwd | --f32-frame]
                                          [--out FILE]

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


F32_LENGTHS = (32, 48, 64, 96, 143, 144, 145, 288, 576, 577)
F32_PEAK = 67e12  # fp32 FFMA, H100 SXM


def f32_sweep():
    """The fp32 forward by S in both layouts (no mask): the wrapper's
    CUDA-event ms, its useful TFLOP/s, its error against the plain fp32
    version (over its largest magnitude), fp32 SDPA's ms and the bound."""
    from gtax_torch.kernels import attention as kattn

    F = torch.nn.functional
    gen = np.random.default_rng(14)
    rows = []
    for layout in ("heads_first", "token_major"):
        for S in F32_LENGTHS:
            N = rows_of(S)
            shape = (N * H, S, HD) if layout == "heads_first" else (
                N, S, H * HD)
            q, k, v = (torch.from_numpy(gen.standard_normal(shape).astype(
                np.float32)).cuda() for _ in range(3))
            bias = kattn.build_bias(S, None, False, "cuda")
            if layout == "heads_first":
                def fn():
                    return kattn.fused_sdpa(q, k, v)
                ref = kattn.sdpa_plain(q, k, v, bias)
                lib = (q, k, v)
            else:
                def fn():
                    return kattn.fused_mha_token_major(q, k, v, H)
                ref = kattn.mha_token_major_plain(q, k, v, bias, H)
                lib = tuple(t.view(N, S, H, HD).transpose(1, 2)
                            for t in (q, k, v))
            got = fn()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max() / ref.abs().max())
            ms = median_ms(fn)
            lib_ms = median_ms(lambda: F.scaled_dot_product_attention(*lib))
            flops = 4 * N * H * S * S * HD
            bound = flops / F32_PEAK * 1e3
            print(f"[attn f32] {layout:11s} S={S:3d} rows={N * H:4d}: "
                  f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), fp32 "
                  f"SDPA {lib_ms:.4f} ms, bound {bound:.4f} ms; max|err| / "
                  f"max|ref| {err:.3g}", flush=True)
            rows.append({"layout": layout, "S": S, "N": N, "ms": ms,
                         "tflops": flops / ms / 1e9, "library_ms": lib_ms,
                         "bound_ms": bound, "rel_err": err})
    return rows


FORM_LENGTHS = (32, 48, 64, 96, 128, 143, 144, 145, 160, 176, 191, 192, 240,
                288, 384, 576, 577)


def f32_bodies():
    """The fp32 forward's two tiled bodies against each other at each S of
    FORM_LENGTHS, token-major (the main path's layout, no mask): the
    48-row body (1) and the 128-row body (2) by direct launches of
    gtax_attn_sdpa_f32, in turns (1, 2, 2, 1; each body's time the mean of
    its two). Prints the faster at each S and the threshold the times
    set: the measured S from which body 2 gives the least summed time over
    the measured lengths (kernels.attention.SDPA_F32_WIDE_MIN_S holds
    it)."""
    from gtax_torch.kernels import attention as kattn
    from gtax_torch.kernels import build

    gen = np.random.default_rng(16)
    rows = []
    for S in FORM_LENGTHS:
        N = rows_of(S)
        q, k, v = (torch.from_numpy(gen.standard_normal(
            (N, S, H * HD)).astype(np.float32)).cuda() for _ in range(3))
        out = torch.empty_like(q)
        ref = kattn.mha_token_major_plain(
            q, k, v, kattn.build_bias(S, None, False, "cuda"), H)

        def call(body):
            def fn():
                build.launch("gtax_attn_sdpa_f32", q.data_ptr(),
                             k.data_ptr(), v.data_ptr(), None,
                             out.data_ptr(), N, S, H, HD, H * HD, H * HD,
                             H * HD, H * HD, body, 1.0 / HD**0.5,
                             torch.cuda.current_stream().cuda_stream)
                return out
            return fn

        errs = [float((call(b)() - ref).abs().max() / ref.abs().max())
                for b in (1, 2)]
        a1 = median_ms(call(1))
        b1 = median_ms(call(2))
        b2 = median_ms(call(2))
        a2 = median_ms(call(1))
        tile, wide = (a1 + a2) / 2, (b1 + b2) / 2
        pick = kattn.sdpa_f32_body(S)
        print(f"[attn f32 bodies] S={S:3d} rows={N * H:4d}: 48-row "
              f"{a1:.4f} / {a2:.4f} ms, 128-row {b1:.4f} / {b2:.4f} ms: "
              f"{'128-row' if wide < tile else '48-row'} "
              f"{max(tile, wide) / min(tile, wide):.3f}x (the rule's body "
              f"{pick}); max|err| / max|ref| {errs[0]:.3g} / {errs[1]:.3g}",
              flush=True)
        rows.append({"S": S, "N": N, "tile_ms": [a1, a2],
                     "wide_ms": [b1, b2], "body": pick, "rel_err": errs})
    def total(T):
        return sum(sum(r["wide_ms"] if T is not None and r["S"] >= T
                       else r["tile_ms"]) for r in rows)

    threshold = min([*FORM_LENGTHS, None], key=total)
    print(f"[attn f32 bodies] threshold: the 128-row body from "
          f"{threshold if threshold else 'none of these'} tokens "
          f"(SDPA_F32_WIDE_MIN_S {kattn.SDPA_F32_WIDE_MIN_S})", flush=True)
    return rows


FRAME_CALLS = ((1, 144), (2, 144), (4, 144), (80, 144), (6, 576))


def kernel_ms(fn, reps=5):
    """Device ms of each kernel one call of fn launches, from a
    torch.profiler trace of `reps` calls (L2 warm), by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:48]: getattr(ev, "self_device_time_total", 0.0) / 1e3
            / reps for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}
HBM_BYTES_PER_S = 3.35e12


def frame_freqs(S):
    """The model's rope table at S: DiT-S/2's spatial one (S = 144, every
    dim of a head), else the VAE's (S = 576, the first half of a head)."""
    from gtax_torch.core import rope

    if S == 144:
        return rope.axial_freqs(rope.pixel_freqs(HD // 2, 256.0), (9, 16),
                                pixel=True).reshape(S, HD).cuda()
    return rope.axial_freqs(rope.pixel_freqs(HD // 4, 576.0), (18, 32),
                            pixel=True).reshape(S, HD // 2).cuda()


def f32_frame():
    """attn_frame_f32 alone at FRAME_CALLS (module docstring): each call's
    CUDA-event ms, FFMA TFLOP/s (4 S^2 d a head), error, bit stability,
    bound (the larger of its bytes, qkv read and the output written, at
    3.35 TB/s and its FLOPs at 67 TFLOP/s) and fp32 SDPA's ms on the roped
    q/k/v; then, where the tree has query tiles, each tile's ms and the
    fp32 spatial pair's by tile."""
    import inspect

    from gtax_torch.core.rope import apply_rotary_emb
    from gtax_torch.kernels import block

    F = torch.nn.functional
    D = H * HD
    shaped = "shape" in inspect.signature(
        block.launch_attn_frame_f32).parameters
    gen = np.random.default_rng(18)
    rows = []
    for N, S in FRAME_CALLS:
        f = frame_freqs(S)
        rot = f.shape[-1]
        qkv = torch.from_numpy(gen.standard_normal((N * S, 3 * D)).astype(
            np.float32)).cuda()
        out = torch.empty((N * S, D), dtype=torch.float32, device="cuda")

        def call(shape=None):
            kw = {} if shape is None else {"shape": shape}
            block.launch_attn_frame_f32(qkv, f, out, N, S, D, H, rot, **kw)
            return out

        q, k, v = (t.reshape(N, S, H, HD) for t in qkv.split(D, -1))

        def roped(t):
            return torch.cat([apply_rotary_emb(f[:, None, :], t[..., :rot]),
                              t[..., rot:]], -1)

        qr, kr = roped(q), roped(k)
        ref = block.attend_frames(qr, kr, v, torch.float32).reshape(N * S, D)
        got = call().clone()
        again = call().clone()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max() / ref.abs().max())
        lib = tuple(t.transpose(1, 2).contiguous() for t in (qr, kr, v))
        ms = median_ms(call)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(*lib))
        flops = 4 * N * H * S * S * HD
        by = (N * S * 3 * D + N * S * D + S * rot) * 4
        bound = max(flops / F32_PEAK, by / HBM_BYTES_PER_S) * 1e3
        kernels = kernel_ms(call)
        row = {"frames": N, "S": S, "rot": rot, "ms": ms,
               "tflops": flops / ms / 1e9, "library_ms": lib_ms,
               "bound_ms": bound, "rel_err": err,
               "two_calls_bit_equal": bool(torch.equal(got, again)),
               "kernels": kernels}
        print(f"[attn f32 frame] ({N}, {S}, {D}) rot {rot}: {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), fp32 SDPA on the roped "
              f"q/k/v {lib_ms:.4f} ms, bound {bound:.4f} ms; max|err| / "
              f"max|ref| {err:.3g}; two calls bit-equal "
              f"{row['two_calls_bit_equal']}; by kernel (a trace, L2 "
              "warm): " + ", ".join(f"{k} {v:.4f} ms"
                                    for k, v in kernels.items()),
              flush=True)
        if shaped:
            pick = block.f32_frame_shape(S, H, N,
                                       block.f32_frame_slots(qkv.device))
            row["shape"] = pick
            row["by_shape"] = {}
            for i, (whole, _, _) in enumerate(block.F32_FRAME_SHAPES):
                if whole != (S <= block.F32_WHOLE_KEYS):
                    continue
                t = median_ms(lambda i=i: call(i))
                same = bool(torch.equal(call(i), got))
                row["by_shape"][i] = {"ms": t, "bit_equal": same}
                print(f"[attn f32 frame]   tile {i} "
                      f"({block.f32_frame_rows(i)} rows, "
                      f"{-(-S // block.f32_frame_rows(i)) * H * N} units): "
                      f"{t:.4f} ms, bit-equal to the rule's tile {pick}: "
                      f"{same}", flush=True)
        rows.append(row)
        del qkv, out, q, k, v, qr, kr, ref, lib
    result = {"calls": rows}
    if shaped:
        result["pair"] = f32_pair_shapes()
    return result


def f32_pair_shapes():
    """The fp32 spatial pair (#10) at one and two frames at each query tile
    it takes (whole pair calls, CUDA-event medians), outputs bit-equal
    across tiles, beside the rule's pick on its cooperative grid."""
    from gtax_torch.kernels import block, pair
    from gtax_torch.tools.split import pair_args

    rows = {}
    for N in (1, 2):
        temporal, args = pair_args("spatial", N, dt=torch.float32)
        x = args[0]
        S, D = x.shape[1], x.shape[2]
        blocks = pair.grid_blocks(False, HD, S, D, torch.float32)
        pick = pair.attn_shape(False, torch.float32, S, H, N, blocks)
        ref = pair._launch(temporal, *args)[0]
        by = {}
        for i, (whole, _, _) in enumerate(block.F32_FRAME_SHAPES):
            if whole != (S <= block.F32_WHOLE_KEYS):
                continue

            def fn(i=i):
                return pair._launch(temporal, *args, shape=i)[0]

            t = median_ms(fn)
            same = bool(torch.equal(fn(), ref))
            by[i] = {"ms": t, "bit_equal": same}
            print(f"[attn f32 pair] N={N} tile {i} "
                  f"({block.f32_frame_rows(i)} rows, "
                  f"{-(-S // block.f32_frame_rows(i)) * H * N} units on "
                  f"{blocks} blocks): {t:.4f} ms, bit-equal to the rule's "
                  f"tile {pick}: {same}", flush=True)
        rows[N] = {"shape": pick, "blocks": blocks, "by_shape": by}
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--f32", action="store_true",
                      help="time the fp32 forward alone")
    mode.add_argument("--f32-bodies", action="store_true",
                      help="time the fp32 forward's two tiled bodies "
                      "against each other by S")
    mode.add_argument("--f32-bwd", action="store_true",
                      help="time the fp32 attention backward alone")
    mode.add_argument("--f32-frame", action="store_true",
                      help="time the fp32 frame attention alone")
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
    if args.f32:
        result = {"card": card, "f32": f32_sweep()}
    elif args.f32_bodies:
        result = {"card": card, "f32_bodies": f32_bodies()}
    elif args.f32_bwd:
        result = {"card": card, "bwd_f32": bwd_f32()}
    elif args.f32_frame:
        result = {"card": card, "f32_frame": f32_frame()}
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
