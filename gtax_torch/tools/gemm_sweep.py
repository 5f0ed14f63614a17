"""Time the port's bf16 GEMM (`gtax_torch.kernels.block.launch_gemm`) at the
main paths' products and row counts, beside one cuBLAS call of the same
product, on one NVIDIA GPU; or, with --wgrad-splits, the B=16 training
step's four weight gradients (`gtax_torch.kernels.backward.wgrad`) at every
row-chunk count from 1 to 8, the plan's count marked; or, with --small,
the serving step's four bf16 products at 144 and 288 rows on the small-M
path at every K chunk count (1, 2, 4, 8 chunks) whose cooperative grid
fits on the card, and on the tiled path,
beside cuBLAS, the plan's (`block.gemm_chunk`) marked; or, with --int8,
the four int8 products (fc2 in K groups of 512) at 144-11,520 rows
(`INT8_ROWS`: the step, B > 1 serving, training at B=2-16): on the
weight-streaming tile at every K chunk it takes at 144 and 288 rows and
at the plan's chunk (`quant.s8_chunk`, marked) past them, on the training
form (`csrc/gemm_s8_train.cuh`) at its tile, bit-equal to the streaming
tile (qkv, out and fc1 through EPI_F32, fc2 through its gated epilogue as
#9 runs it in bf16), and fc1 with the requantization of its GELU rows (the
streaming tile and quant_rows, or the training form's fused epilogue),
each beside one `torch._int_mm` of the whole product on a column-major
weight; then the row count from which the training form wins every
product (the threshold `quant.S8_TRAIN_ROWS` holds);
or, with --f32, the fp32 GEMM (`block.launch_gemm_f32`, fp32 FFMA) at the
four serving products at 144, 288, 432, 576 and 720 rows (each row marked
with the form that runs it: the serving form's 48-row tiles, or the
k-major form by `block.f32_fwd_form`; a checkout put first
on the path times its own forms, so an older tree's 64x64 tile runs
beside this tree's serving form in turns),
at 1,152 and 1,440 (the VAE at two frames, training at B=2), the VAE's
at 2,304 and 3,456
rows and the training step's forward products (fc1 1,024 ->
4,096, fc2 4,096 -> 1,024, qkv 1,024 -> 3,072, out 1,024 -> 1,024) at
11,520 rows, at every K chunk count it takes (1-8 chunks: of whole
16-deep steps dividing K, or on the forward's k-major form of whole
32-row steps, the last one short; a row-major A, which that form copies
transposed first), beside one cuBLAS SGEMM of the same product (no TF32:
strict_matmul), the plan's (`block.f32_plan`) marked; then the fp32
training step's backward products at 11,520 rows (B=16): dY @ W^T
(trans_b, EPI_F32) for dy @ W_out^T, dqkv @ W_qkv^T and dh1 @ W1^T, the
gelu' epilogue's dy @ W2^T (trans_b, EPI_DGELU), and the four weight
gradients (`gtax_gemm_f32_wgrad` + `reduce_rows`) at every row-chunk
count from 1 to 8, the plan's (`backward.wgrad_f32_plan`) marked, each
beside one cuBLAS SGEMM of the same product.

    python -m gtax_torch.tools.gemm_sweep [--wgrad-splits | --small |
                                           --int8 | --f32 [--forms]
                                           [--rows M,..]]
                                          [--out FILE]

--rows 144,288,576 restricts --f32 to the forward's products at those
rows (no backward). --f32 --forms times the forward's two forms against
each other at 144, 288, 432, 576 and 719 rows (or --rows), in turns, and
prints the row count from which the k-major form gives the least summed
time, for each product and for the two groups of `block.f32_fwd_form`
(the thresholds `block.F32_FWD_ROWS_WIDE` and `block.F32_FWD_ROWS`
hold).

It uses only `launch_gemm`'s arguments that every version of the port has,
so it can time another checkout's kernel as well: put that checkout first
on the path (`PYTHONPATH=<checkout> python <this file>`) and compare two
versions on one card, in turns. Times are CUDA-event medians with the L2
cache flushed and the stream held 10 ms before each call. The last line of
its output is a JSON object of every row.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

SHAPES = (  # (N, K, trans_b, what): the products of the main paths
    (3072, 1024, False, "qkv"), (1024, 1024, False, "out-proj"),
    (4096, 1024, False, "fc1"), (1024, 4096, False, "fc2"),
    (4096, 1024, True, "dy @ W2^T"), (1024, 4096, True, "dh1 @ W1^T"))
# a denoise step (1-2 frames of 144 tokens), a prefill (4-5 frames), the
# VAE (2-6 frames of 576), training at B=2 and B=16 (10 and 80 frames)
ROWS = (144, 288, 576, 720, 1152, 1440, 2304, 3456, 11520)
EPI_BF16 = 6  # bf16(acc), csrc/gemm_epi.cuh
WGRADS = (  # (Ka, N, what) over the 11,520 token rows of B=16
    (1024, 3072, "dW_qkv"), (1024, 1024, "dW_out"),
    (1024, 4096, "dW1"), (4096, 1024, "dW2"))


def median_ms(fn, iters=15, hold_ms=10.0):
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        flush.zero_()
        torch.cuda._sleep(int(hold_ms * 1.98e6))
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def sweep():
    from gtax_torch.kernels import block

    gen = np.random.default_rng(7)
    rows = []
    for N, K, trans_b, what in SHAPES:
        w = torch.from_numpy(gen.standard_normal(
            (N, K) if trans_b else (K, N)).astype(np.float32) * 0.02).to(
                "cuda", torch.bfloat16)
        for M in ROWS:
            a = torch.from_numpy(gen.standard_normal((M, K)).astype(
                np.float32)).to("cuda", torch.bfloat16)
            out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
            ms = median_ms(lambda: block.launch_gemm(
                a, w, out, M, N, K, EPI_BF16, trans_b=trans_b))
            lib = median_ms(lambda: torch.matmul(a, w.t() if trans_b else w))
            tf = 2 * M * N * K / 1e9
            print(f"[gemm] {what:10s} M={M:5d} N={N} K={K}: {ms:.4f} ms "
                  f"({tf / ms:.0f} TFLOP/s), cuBLAS {lib:.4f} ms "
                  f"({tf / lib:.0f} TFLOP/s)", flush=True)
            rows.append({"what": what, "M": M, "N": N, "K": K, "ms": ms,
                         "library_ms": lib})
    return rows


def wgrad_splits(M=11520):
    from gtax_torch.kernels import backward, build

    gen = np.random.default_rng(8)
    k_step = build.gemm_consts().k_step
    rows = []
    for Ka, N, what in WGRADS:
        a = torch.from_numpy(gen.standard_normal((M, Ka)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        b = torch.from_numpy(gen.standard_normal((M, N)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        plan = backward.wgrad_split(M, Ka, N, a.device)[0]
        ref = backward.wgrad(a, b)
        for s in range(1, 9):
            chunk = -(-M // s)
            chunk = -(-chunk // k_step) * k_step  # as wgrad_plan rounds it
            splits = -(-M // chunk)
            part = torch.empty((splits, Ka, N), device="cuda")

            def call():
                build.launch("gtax_gemm_wgrad", a.data_ptr(), b.data_ptr(),
                             part.data_ptr(), M, Ka, N, chunk,
                             torch.cuda.current_stream().cuda_stream)
                return part[0] if splits == 1 else backward.reduce_rows(part)

            err = float((call() - ref).abs().max())
            ms = median_ms(call)
            tf = 2 * M * Ka * N / 1e9
            mark = "  <- plan" if splits == plan else ""
            print(f"[wgrad] {what:7s} Ka={Ka} N={N} splits={splits} chunk="
                  f"{chunk}: {ms:.4f} ms ({tf / ms:.0f} TFLOP/s), max|diff| "
                  f"vs the plan's {err:.3g}{mark}", flush=True)
            rows.append({"what": what, "M": M, "Ka": Ka, "N": N,
                         "splits": splits, "chunk": chunk, "ms": ms,
                         "plan": splits == plan})
    return rows


SERVING = SHAPES[:4]  # the forward products of a denoise step


def small_sweep():
    from gtax_torch.kernels import block, build

    gen = np.random.default_rng(11)
    k_step = build.gemm_consts().k_step
    rows = []
    for N, K, _, what in SERVING:
        w = torch.from_numpy(gen.standard_normal((K, N)).astype(
            np.float32) * 0.02).to("cuda", torch.bfloat16)
        for M in (144, 288):
            a = torch.from_numpy(gen.standard_normal((M, K)).astype(
                np.float32)).to("cuda", torch.bfloat16)
            out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
            plan = block.gemm_chunk(M, N, K, a.device)  # 0: tiled
            lib = median_ms(lambda: torch.matmul(a, w))
            chunks = sorted({-(-K // s // k_step) * k_step
                             for s in (1, 2, 4, 8)
                             if s == 1 or N // 64 * s <= block.sm_count(
                                 a.device)}, reverse=True)
            ref = None
            for chunk in (0, *chunks):
                ms = median_ms(lambda: block.launch_gemm(
                    a, w, out, M, N, K, EPI_BF16, k_chunk=chunk))
                got = out.clone()
                ref = got if ref is None else ref
                err = float((got.float() - ref.float()).abs().max())
                splits = -(-K // chunk) if chunk else 0
                mark = "  <- plan" if chunk == plan else ""
                path = (f"small, {splits} chunks of {chunk}" if chunk
                        else "tiled")
                blocks = N // 64 * splits if chunk else None
                print(f"[small] {what:8s} M={M} N={N} K={K} {path}: "
                      f"{ms:.4f} ms, cuBLAS {lib:.4f} ms, max|diff| vs tiled "
                      f"{err:.3g}{mark}", flush=True)
                rows.append({"what": what, "M": M, "N": N, "K": K,
                             "k_chunk": chunk, "splits": splits,
                             "blocks": blocks, "ms": ms, "library_ms": lib,
                             "plan": chunk == plan})
    return rows


# the int8 products' rows: a denoise step (1-2 frames), the P=4 step and
# B > 1 serving (4 and 8 frames), training at B=2, 4, 8 and 16 (10-80
# frames of 144 tokens)
INT8_ROWS = (144, 288, 576, 1152, 1440, 2880, 5760, 11520)


def int8_sweep(only_rows=None):
    from gtax_torch.kernels import block, build, quant

    gen = np.random.default_rng(12)
    c = build.gemm_consts()
    train = hasattr(quant, "S8_TRAIN_ROWS")  # a checkout with the form
    sms = block.sm_count(torch.device("cuda"))
    rows = []
    for N, K, _, what in SERVING:
        group = 512 if what == "fc2" else K
        w_q, w_s = quant.quantize_weight(torch.from_numpy(
            gen.standard_normal((K, N)).astype(np.float32) * 0.02).cuda())
        w_cm = w_q.t().contiguous().t()  # column-major, as _int_mm is fed
        b = torch.from_numpy(gen.standard_normal(N).astype(
            np.float32) * 0.02).cuda()
        for M in only_rows or INT8_ROWS:
            a32 = torch.from_numpy(gen.standard_normal((M, K)).astype(
                np.float32)).cuda()
            q, sa = quant.quant_rows(a32, group)
            out = torch.empty((M, N), dtype=torch.float32, device="cuda")
            epi, kw = quant.EPI_F32, {}
            if group < K:  # fc2 with its epilogue in #9 (bf16): the
                # training form builds no EPI_F32 over several K groups
                epi, S = quant.EPI_BIAS_GATED, 144
                out = out.to(torch.bfloat16)
                kw = {"bias": b, "resid": a32[:, :N].to(torch.bfloat16),
                      "gate": a32[:-(-M // S), :N].to(torch.bfloat16),
                      "S": S}
            plan = quant.s8_chunk(M, N, K, group, sms)
            lib = median_ms(lambda: torch._int_mm(q, w_cm))
            steps = K // c.s8_k_step
            cands = [k * c.s8_k_step for k in range(steps, 0, -1)
                     if (group == K or (group // c.s8_k_step) % k == 0)
                     and -(-steps // k) <= c.s8_splits]
            if M > 288:  # past the serving rows, the plan's chunk alone
                cands = [plan]
            stream = {"form": "stream"} if train else {}
            ref = None
            for chunk in cands:
                ms = median_ms(lambda: quant._gemm_s8(
                    q, sa, w_q, w_s, out, epi, k_chunk=chunk, **kw,
                    **stream))
                got = out.clone()
                ref = got if ref is None else ref
                equal = bool(torch.equal(got, ref))
                splits = -(-K // chunk)
                units = -(-M // c.s8_rows) * (N // c.s8_n) * splits
                mark = "  <- plan" if chunk == plan else ""
                print(f"[int8] {what:8s} M={M} N={N} K={K} group={group} "
                      f"stream, {splits} chunks of {chunk} ({units} units): "
                      f"{ms:.4f} ms, {2 * M * N * K / ms / 1e9:.0f} TOP/s, "
                      f"torch._int_mm {lib:.4f} ms, bit-equal to the first "
                      f"{equal}{mark}", flush=True)
                rows.append({"what": what, "M": M, "N": N, "K": K,
                             "group": group, "form": "stream",
                             "k_chunk": chunk, "splits": splits,
                             "units": units, "ms": ms, "library_ms": lib,
                             "bit_equal": equal, "plan": chunk == plan})
            if train:
                rows.append(int8_train_row(quant, what, q, sa, w_q, w_s,
                                           out, epi, kw, ref, lib, M, N, K,
                                           group))
            if what == "fc1":  # with the GELU and the requantization
                rows += int8_fc1_quant_rows(quant, q, sa, w_q, w_s, b, M,
                                            train)
    if train and not only_rows:
        int8_threshold(quant, rows)
    return rows


def int8_train_row(quant, what, q, sa, w_q, w_s, out, epi, kw, ref, lib, M,
                   N, K, group):
    """The training form (csrc/gemm_s8_train.cuh) of one product at its
    tile, bit-equal to the streaming tile's output ref."""
    tile = quant.s8_train_tile(N, K, group)
    ms = median_ms(lambda: quant._gemm_s8(q, sa, w_q, w_s, out, epi,
                                          form="train", **kw))
    equal = bool(torch.equal(out, ref))
    print(f"[int8] {what:8s} M={M} N={N} K={K} group={group} train, "
          f"128 x {tile} tiles: {ms:.4f} ms, "
          f"{2 * M * N * K / ms / 1e9:.0f} TOP/s, torch._int_mm "
          f"{lib:.4f} ms, bit-equal to the streaming tile {equal}",
          flush=True)
    return {"what": what, "M": M, "N": N, "K": K, "group": group,
            "form": "train", "tile_n": tile, "ms": ms, "library_ms": lib,
            "bit_equal": equal, "plan": True}


def int8_fc1_quant_rows(quant, q, sa, w_q, w_s, b, M, train):
    """fc1 with its epilogue and the requantization of its GELU rows in
    512-column groups: the streaming tile's GELU epilogue then quant_rows,
    and (train) the training form's fused requantization; (hq, hs)
    bit-equal."""
    N = w_q.shape[1]
    G = N // quant._mlp_chunks(N)
    h = torch.empty((M, N), dtype=torch.float32, device="cuda")
    stream = {"form": "stream"} if train else {}
    res = {}

    def unfused():
        quant._gemm_s8(q, sa, w_q, w_s, h, quant.EPI_BIAS_GELU_F32, bias=b,
                       **stream)
        res["stream"] = quant._quant_rows_cuda(h, G)

    def fused():
        res["train"] = quant._fc1_quant_cuda(q, sa, w_q, w_s, b,
                                             quant.EPI_BIAS_GELU_F32, None, G)

    rows = []
    for form, fn in (("stream", unfused), ("train", fused)):
        if form == "train" and not train:
            continue
        ms = median_ms(fn)
        fn()
        equal = all(torch.equal(x, y) for x, y in zip(res[form],
                                                       res["stream"]))
        print(f"[int8] fc1+quant M={M} N={N} K={q.shape[1]} {form}: "
              f"{ms:.4f} ms, bit-equal to the streaming tile + quant_rows "
              f"{equal}", flush=True)
        rows.append({"what": "fc1+quant", "M": M, "N": N, "K": q.shape[1],
                     "form": form, "ms": ms, "bit_equal": equal,
                     "plan": True})
    return rows


def int8_threshold(quant, rows):
    """The least swept row count from which the training form (fc1 with
    its requantization) beats the streaming tile
    (at its plan's chunk) at every product, there and at every larger
    row count, beside the one quant.S8_TRAIN_ROWS holds."""
    best = {}
    for r in rows:
        if r["plan"]:
            best[(r["what"], r["M"], r["form"])] = r["ms"]
    wins = {}
    for (what, M, form), ms in best.items():
        if form == "train":
            wins.setdefault(M, []).append(ms < best[(what, M, "stream")])
    threshold = None
    for M in sorted(wins, reverse=True):
        if not all(wins[M]):
            break
        threshold = M
    print(f"[int8] the training form wins every product from "
          f"{threshold} rows (quant.S8_TRAIN_ROWS = {quant.S8_TRAIN_ROWS})",
          flush=True)


def f32_form(block, M, N, K):
    """The form of the checkout's fp32 forward for an (M, K) @ (K, N)
    product: by its rule f32_form where it has one ("serving",
    "k-major", "persistent"); else "k-major" by its rule (f32_fwd_form,
    or from its F32_FWD_ROWS); else "serving" (48-row tiles, K over a
    cluster) where the checkout has that form, else "64x64" (the tile it
    replaced)."""
    if hasattr(block, "f32_form"):
        return ("serving", "k-major", "persistent")[block.f32_form(M, N, K)]
    rule = getattr(block, "f32_fwd_form", None)
    if (rule(M, N, K) if rule
            else M >= getattr(block, "F32_FWD_ROWS", M + 1)):
        return "k-major"
    return "serving" if hasattr(block, "f32_serve_chunk") else "64x64"


def f32_chunks(block, M, N, K):
    """The K chunks the checkout's gemm_f32 takes for an (M, K) @ (K, N)
    product, by chunk count 1-8: on the forward's k-major form chunks of
    whole 32-row steps, the last one short; else whole 16-row steps
    dividing K."""
    form = f32_form(block, M, N, K)
    if form == "k-major":
        return f32_chunks_k_major(block, K)
    if form == "persistent":
        return f32_chunks_persist(block, K)
    step = block.F32_K_STEP
    return [K // s for s in range(1, block.F32_MAX_SPLITS + 1)
            if K % (s * step) == 0]


def f32_chunks_persist(block, K):
    """The persistent form's K chunks by chunk count, 1 to
    F32_PERSIST_MAX_SPLITS (whole 16-row granules, the last chunk short)."""
    step = block.F32_K_STEP
    g = -(-K // step)
    return sorted({-(-g // s) * step
                   for s in range(1, block.F32_PERSIST_MAX_SPLITS + 1)},
                  reverse=True)


def f32_sweep(only_rows=None):
    from gtax_torch.kernels import block

    gen = np.random.default_rng(13)
    rows = []
    shapes = [(N, K, what, M) for N, K, _, what in SERVING
              for M in (144, 288, 432, 576, 720)]
    shapes += [(N, K, "mid " + what, M) for N, K, _, what in SERVING
               for M in (1152, 1440)]
    shapes += [(N, K, "VAE " + what, M) for N, K, _, what in SERVING
               for M in (2304, 3456)]
    shapes += [(N, K, "train " + what, BWD_ROWS) for N, K, _, what in SERVING]
    if only_rows:
        shapes = [x for x in shapes if x[3] in only_rows]
    for N, K, what, M in shapes:
        w = torch.from_numpy(gen.standard_normal((K, N)).astype(
            np.float32) * 0.02).cuda()
        a = torch.from_numpy(gen.standard_normal((M, K)).astype(
            np.float32)).cuda()
        out = torch.empty((M, N), dtype=torch.float32, device="cuda")
        plan = block.f32_plan(M, N, K, a.device)
        lib = median_ms(lambda: torch.matmul(a, w))
        ref = torch.matmul(a, w)
        for chunk in f32_chunks(block, M, N, K):
            splits = -(-K // chunk)
            ms = median_ms(lambda: block.launch_gemm_f32(
                a, w, out, M, N, K, block.EPI_F32, k_chunk=chunk))
            err = float((out - ref).abs().max() / ref.abs().max())
            mark = "  <- plan" if chunk == plan else ""
            tflops = 2 * M * N * K / ms / 1e9
            lib_tf = 2 * M * N * K / lib / 1e9
            form = f32_form(block, M, N, K)
            print(f"[f32] {what:8s} M={M} N={N} K={K} {form} form, {splits} "
                  f"chunks of {chunk}: {ms:.4f} ms ({tflops:.1f} TFLOP/s), "
                  f"cuBLAS SGEMM {lib:.4f} ms ({lib_tf:.1f} TFLOP/s), "
                  f"max|diff| / max|ref| {err:.3g}{mark}", flush=True)
            rows.append({"what": what, "M": M, "N": N, "K": K, "form": form,
                         "k_chunk": chunk, "splits": splits, "ms": ms,
                         "tflops": tflops, "library_ms": lib,
                         "library_tflops": lib_tf, "rel_err": err,
                         "plan": chunk == plan})
    return rows


FORM_ROWS = (144, 288, 432, 576, 719)  # one to four frames, and below 720


def f32_forms(rows=FORM_ROWS):
    """The fp32 forward's three forms at the four serving products at each
    row count below the k-major form's 720 rows: the serving form at its
    plan (f32_serve_chunk), the persistent form at its plan
    (f32_persist_chunk) and the k-major form at its plan (f32_fwd_chunk),
    timed in turns (serving, persistent, k-major, k-major, persistent,
    serving; each form's time the mean of its two), and the persistent and
    k-major forms at each of their chunk counts. Prints the winner of each
    product, whether the persistent form gives the serving form's bits at
    the serving form's chunks, and the thresholds the times set: for the
    persistent form against the serving one below the k-major form, the
    measured row count up to which it gives the least summed time; for
    the k-major form, for each product and for the two groups of
    block.f32_fwd_form (products of at least F32_FWD_WIDE_WEIGHTS
    weights, and the rest), the measured row count from which it gives
    the least summed time against the form the rule runs below it (none:
    not at any)."""
    from gtax_torch.kernels import block

    gen = np.random.default_rng(15)
    sms = block.sm_count(torch.device("cuda"))
    forms = {"serving": block.F32_FORM_SERVE,
             "persistent": block.F32_FORM_PERSIST,
             "k-major": block.F32_FORM_K_MAJOR}
    out_rows = []
    for M in rows:
        for N, K, _, what in SERVING:
            w = torch.from_numpy(gen.standard_normal((K, N)).astype(
                np.float32) * 0.02).cuda()
            a = torch.from_numpy(gen.standard_normal((M, K)).astype(
                np.float32)).cuda()
            out = torch.empty((M, N), dtype=torch.float32, device="cuda")
            ref = torch.matmul(a, w)
            chunk = {name: block.f32_plan(M, N, K, a.device, form=f)
                     for name, f in forms.items()}

            def call(name, c=None):
                return lambda: block.launch_gemm_f32(
                    a, w, out, M, N, K, block.EPI_F32,
                    k_chunk=chunk[name] if c is None else c,
                    fwd=forms[name])

            errs = {}
            for name in forms:
                call(name)()
                errs[name] = float((out - ref).abs().max()
                                   / ref.abs().max())
            call("serving")()
            serve_bits = out.clone()
            call("persistent", chunk["serving"])()
            same_bits = bool(torch.equal(out, serve_bits))
            ms = {name: [] for name in forms}
            for name in (*forms, *reversed(forms)):
                ms[name].append(median_ms(call(name)))
            mean = {name: sum(t) / 2 for name, t in ms.items()}
            by_chunk = {
                "persistent": {c: median_ms(call("persistent", c))
                               for c in f32_chunks_persist(block, K)},
                "k-major": {c: median_ms(call("k-major", c))
                            for c in f32_chunks_k_major(block, K)}}
            lib = median_ms(lambda: torch.matmul(a, w))
            win = min(mean, key=mean.get)
            best = {n: min(v, key=v.get) for n, v in by_chunk.items()}
            print(f"[f32 forms] {what:8s} M={M} N={N} K={K}: "
                  + ", ".join(f"{n} {t[0]:.4f} / {t[1]:.4f} ms "
                              f"({-(-K // chunk[n])} chunks)"
                              for n, t in ms.items())
                  + "; fastest chunks: "
                  + ", ".join(f"{n} {by_chunk[n][c]:.4f} at {-(-K // c)}"
                              for n, c in best.items())
                  + f"; cuBLAS SGEMM {lib:.4f} ms: {win}; max|diff| / "
                  f"max|ref| "
                  + " / ".join(f"{e:.3g}" for e in errs.values())
                  + f"; persistent = serving bits at its chunks: "
                  f"{same_bits}", flush=True)
            out_rows.append({
                "what": what, "M": M, "N": N, "K": K,
                "serving_ms": ms["serving"], "persistent_ms": ms["persistent"],
                "k_major_ms": ms["k-major"],
                "serving_chunk": chunk["serving"],
                "persistent_chunk": chunk["persistent"],
                "k_major_chunk": chunk["k-major"],
                "persistent_by_chunk": by_chunk["persistent"],
                "k_major_by_chunk": by_chunk["k-major"],
                "library_ms": lib, "rel_err": errs,
                "persistent_serving_bits": same_bits})
    for _, _, _, what in SERVING:
        group = [r for r in out_rows if r["what"] == what]
        print(f"[f32 forms] threshold, {what}: the persistent form below "
              f"the serving one up to {persist_threshold(group, rows)} rows",
              flush=True)
    wide = block.F32_FWD_WIDE_WEIGHTS
    groups = {what: [r for r in out_rows if r["what"] == what]
              for _, _, _, what in SERVING}
    groups[f"weights >= {wide}"] = [r for r in out_rows
                                    if r["N"] * r["K"] >= wide]
    groups[f"weights < {wide}"] = [r for r in out_rows
                                   if r["N"] * r["K"] < wide]
    for name, group in groups.items():
        if group:
            print(f"[f32 forms] threshold, {name}: the k-major form from "
                  f"{least_sum_threshold(group, rows, block)} rows",
                  flush=True)
    print(f"[f32 forms] the rule (block.f32_form): the persistent form "
          f"below {block.F32_PERSIST_ROWS} rows; k-major from "
          f"{block.F32_FWD_ROWS_WIDE} rows for weights >= {wide}, from "
          f"{block.F32_FWD_ROWS} for the rest; else the serving form",
          flush=True)
    return out_rows


def persist_threshold(group, rows):
    """The largest row count T of `rows` (or None: none) for which the
    persistent form up to T and the serving form past it give `group` the
    least summed time."""
    def total(T):
        return sum(sum(r["persistent_ms"] if T is not None and r["M"] <= T
                       else r["serving_ms"]) for r in group)
    return min([None, *sorted(rows)], key=total)


def least_sum_threshold(group, rows, block):
    """The row count T of `rows` (or None: none) for which the form the
    rule runs below the k-major one (the persistent form below
    block.F32_PERSIST_ROWS, else the serving form) below T and k-major
    from T give `group` the least summed time."""
    def below(r):
        return r["persistent_ms" if r["M"] < block.F32_PERSIST_ROWS
                 else "serving_ms"]

    def total(T):
        return sum(sum(r["k_major_ms"] if T is not None and r["M"] >= T
                       else below(r)) for r in group)
    return min([*sorted(rows), None], key=total)


def f32_chunks_k_major(block, K):
    """The k-major form's K chunks by chunk count 1-8 (whole 32-row steps,
    the last one short)."""
    step, steps = block.F32_FWD_K_STEP, -(-K // block.F32_FWD_K_STEP)
    return sorted({min(K, -(-steps // s) * step)
                   for s in range(1, block.F32_MAX_SPLITS + 1)}, reverse=True)


# the fp32 backward's products at B=16 (11,520 rows): (N, K, epi, what)
# of dY @ W^T, W (N, K); EPI_DGELU: the gelu' epilogue's
F32_NT = ((1024, 1024, 0, "dy @ W_out^T"), (1024, 3072, 0, "dqkv @ W_qkv^T"),
          (1024, 4096, 0, "dh1 @ W1^T"), (4096, 1024, 9, "dy @ W2^T gelu'"))
BWD_ROWS = 11520


def _f32_rand(gen, shape, std=1.0):
    return torch.from_numpy(gen.standard_normal(shape).astype(
        np.float32) * std).cuda()


def _wgrad_call(a, b, part, chunk):
    from gtax_torch.kernels import backward, build

    M, Ka = a.shape
    build.launch("gtax_gemm_f32_wgrad", a.data_ptr(), b.data_ptr(),
                 part.data_ptr(), M, Ka, b.shape[1], chunk,
                 torch.cuda.current_stream().cuda_stream)
    return part[0] if part.shape[0] == 1 else backward.reduce_rows(part)


def _nt_operands(gen, N, K, epi, M=BWD_ROWS):
    """(a, w, out, the gelu' extras) of one backward dY @ W^T product."""
    a, w = _f32_rand(gen, (M, K)), _f32_rand(gen, (N, K), 0.02)
    out = torch.empty((M, N), device="cuda")
    extra = {}
    if epi == 9:
        extra = {"out2": torch.empty_like(out),
                 "aux": _f32_rand(gen, (M, N)),
                 "colsum": torch.empty((-(-M // 64), N), device="cuda")}
    return a, w, out, extra


def f32_bwd_sweep():
    """The backward's products beside cuBLAS SGEMM (see the docstring)."""
    from gtax_torch.kernels import backward, block

    gen = np.random.default_rng(14)
    M, rows = BWD_ROWS, []
    for N, K, epi, what in F32_NT:
        a, w, out, extra = _nt_operands(gen, N, K, epi)
        ms = median_ms(lambda: block.launch_gemm_f32(
            a, w, out, M, N, K, epi, trans_b=True, **extra))
        lib = median_ms(lambda: torch.matmul(a, w.t()))
        ref = torch.matmul(a, w.t())
        if epi:  # u = gelu'(h1) * (dY @ W^T)
            ref = backward.gelu_tanh_val_grad32(extra["aux"])[1] * ref
        err = float((out - ref).abs().max() / ref.abs().max())
        gf = 2 * M * N * K / 1e9
        print(f"[f32 bwd] {what:16s} M={M} N={N} K={K}: {ms:.4f} ms "
              f"({gf / ms:.1f} TFLOP/s), cuBLAS SGEMM {lib:.4f} ms "
              f"({gf / lib:.1f} TFLOP/s), max|diff| / max|ref| {err:.3g}",
              flush=True)
        rows.append({"what": what, "M": M, "N": N, "K": K, "epi": epi,
                     "ms": ms, "tflops": gf / ms, "library_ms": lib,
                     "library_tflops": gf / lib, "rel_err": err})
    for Ka, N, what in WGRADS:
        a, b = _f32_rand(gen, (M, Ka)), _f32_rand(gen, (M, N))
        plan = backward.wgrad_f32_plan(M, Ka, N, block.sm_count(a.device))[0]
        lib = median_ms(lambda: torch.matmul(a.t(), b))
        ref = torch.matmul(a.t(), b)
        gf = 2 * M * Ka * N / 1e9
        for s in range(1, 9):
            chunk = -(-(-(-M // s)) // block.F32_K_STEP) * block.F32_K_STEP
            splits = -(-M // chunk)
            part = torch.empty((splits, Ka, N), device="cuda")
            err = float((_wgrad_call(a, b, part, chunk) - ref).abs().max()
                        / ref.abs().max())
            ms = median_ms(lambda: _wgrad_call(a, b, part, chunk))
            mark = "  <- plan" if splits == plan else ""
            print(f"[f32 wgrad] {what:7s} Ka={Ka} N={N} splits={splits} "
                  f"chunk={chunk}: {ms:.4f} ms ({gf / ms:.1f} TFLOP/s), "
                  f"cuBLAS SGEMM {lib:.4f} ms ({gf / lib:.1f} TFLOP/s), "
                  f"max|diff| / max|ref| {err:.3g}{mark}", flush=True)
            rows.append({"what": what, "M": M, "Ka": Ka, "N": N,
                         "splits": splits, "chunk": chunk, "ms": ms,
                         "tflops": gf / ms, "library_ms": lib,
                         "rel_err": err, "plan": splits == plan})
    return rows


# the persistent form's shapes timed by --persist-shapes: (rows a thread,
# row groups, float4 column groups a thread, k-step, ring stages, blocks
# an SM), csrc/gemm_f32.cu's GTAX_PERSIST_R, _RG, _CJ, _KS, _STAGES,
# _BLOCKS; the first is the library's
PERSIST_SHAPES = ((6, 8, 2, 32, 2, 4), (6, 8, 2, 16, 3, 4),
                  (6, 8, 2, 32, 3, 3), (6, 8, 2, 16, 2, 4),
                  (6, 8, 2, 16, 3, 3), (6, 8, 2, 16, 4, 4),
                  (8, 6, 2, 16, 3, 4), (6, 8, 4, 16, 3, 2),
                  (6, 8, 4, 16, 3, 3), (4, 12, 4, 16, 3, 2),
                  (6, 12, 2, 16, 3, 2), (3, 16, 2, 16, 3, 4))
PERSIST_ROWS = (144, 288)


def persist_shapes(shapes=PERSIST_SHAPES, rows=PERSIST_ROWS):
    """The persistent form's shapes (PERSIST_SHAPES) at the step's four
    products at 144 and 288 rows and each chunk count: each shape from a
    copy of csrc/gemm_f32.cu built with its GTAX_PERSIST_* macros (all
    built at once), launched on one round of its blocks (blocks an SM x
    SMs). Prints each shape's times, its fastest chunk count beside the
    library plan's (block.f32_persist_chunk, for the library's shape),
    whether every shape gives the same bits at a chunk count (the tile
    does not change a sum's order), and each shape's summed time at its
    fastest counts and at the plan's."""
    from concurrent.futures import ThreadPoolExecutor

    from gtax_torch.kernels import block, build

    names = ("R", "RG", "CJ", "KS", "STAGES", "BLOCKS")

    def lib(shape):
        defs = tuple(f"GTAX_PERSIST_{n}={v}" for n, v in zip(names, shape))
        return build._load(build.build(defines=defs, names=("gemm_f32.cu",)),
                           ("gtax_gemm_f32",))

    with ThreadPoolExecutor(len(shapes)) as ex:
        libs = list(ex.map(lib, shapes))
    sms = block.sm_count(torch.device("cuda"))
    gen = np.random.default_rng(17)
    out_rows, bits = [], {}
    for M in rows:
        for N, K, _, what in SERVING:
            w = torch.from_numpy(gen.standard_normal((K, N)).astype(
                np.float32) * 0.02).cuda()
            a = torch.from_numpy(gen.standard_normal((M, K)).astype(
                np.float32)).cuda()
            out = torch.empty((M, N), dtype=torch.float32, device="cuda")
            ref = torch.matmul(a, w)
            plan = block.f32_persist_chunk(M, N, K, sms)
            for shape, lb in zip(shapes, libs):
                r, rg, cj, _, _, per_sm = shape
                tm, tn = r * rg, 64 * cj
                tiles = -(-M // tm) * -(-N // tn)
                flags = torch.zeros(2 * tiles, dtype=torch.int32,
                                    device="cuda")
                times = {}
                for c in f32_chunks_persist(block, K):
                    part = torch.empty(tiles * -(-K // c) * tm * tn,
                                       device="cuda")

                    def call(c=c, part=part):
                        build.launch(
                            "gtax_gemm_f32", a.data_ptr(), w.data_ptr(),
                            out.data_ptr(), None, None, None, None, 0, None,
                            None, 0, M, N, K, 1, block.EPI_F32, 0, c, 0, 0,
                            block.F32_FORM_PERSIST, per_sm * sms,
                            flags.data_ptr(), part.data_ptr(),
                            torch.cuda.current_stream().cuda_stream, lib=lb)

                    call()
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max() / ref.abs().max())
                    key = (M, what, c)
                    bits.setdefault(key, out.clone())
                    same = bool(torch.equal(bits[key], out))
                    times[c] = median_ms(call)
                    out_rows.append({"shape": shape, "what": what, "M": M,
                                     "N": N, "K": K, "k_chunk": c,
                                     "ms": times[c], "rel_err": err,
                                     "same_bits": same, "plan": c == plan})
                best = min(times, key=times.get)
                print(f"[persist shapes] {what:8s} M={M} {shape}: "
                      + ", ".join(f"{-(-K // c)}: {t:.4f}"
                                  for c, t in times.items())
                      + f" ms; fastest {-(-K // best)} chunks "
                      f"({2 * M * N * K / times[best] / 1e9:.1f} TFLOP/s), "
                      f"the plan {-(-K // plan)}", flush=True)
    for shape in shapes:
        mine = [r for r in out_rows if r["shape"] == shape]
        fastest = {}
        for r in mine:
            k = (r["M"], r["what"])
            fastest[k] = min(fastest.get(k, r["ms"]), r["ms"])
        print(f"[persist shapes] {shape}: summed {sum(fastest.values()):.4f}"
              f" ms at the fastest counts, "
              f"{sum(r['ms'] for r in mine if r['plan']):.4f} at the plan's; "
              f"same bits as the first shape: "
              f"{all(r['same_bits'] for r in mine)}; largest max|diff| / "
              f"max|ref| {max(r['rel_err'] for r in mine):.3g}", flush=True)
    return out_rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--wgrad-splits", action="store_true",
                      help="time the weight gradients' split counts instead")
    mode.add_argument("--small", action="store_true",
                      help="time the small-M path's K chunks instead")
    mode.add_argument("--int8", action="store_true",
                      help="time the int8 products' K chunks instead")
    mode.add_argument("--f32", action="store_true",
                      help="time the fp32 GEMM's K chunks and the fp32 "
                      "backward's products instead")
    ap.add_argument("--rows", help="with --f32: only the forward's products "
                    "at these row counts (comma-separated), no backward; "
                    "with --int8: only these rows")
    ap.add_argument("--forms", action="store_true",
                    help="with --f32: the forward's three forms in turns "
                    "below 720 rows (--rows: at these), and the thresholds")
    mode.add_argument("--persist-shapes", action="store_true",
                      help="time the fp32 persistent form's shapes at the "
                      "step's products instead (copies built with other "
                      "GTAX_PERSIST_* macros)")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemm_sweep: needs a CUDA device")
    from gtax_torch.utils.platform import strict_matmul

    strict_matmul()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = tuple(int(r) for r in args.rows.split(",")) if args.rows else None
    run = (wgrad_splits if args.wgrad_splits else small_sweep if args.small
           else (lambda: int8_sweep(rows)) if args.int8
           else (lambda: persist_shapes(rows=rows or PERSIST_ROWS))
           if args.persist_shapes
           else (lambda: f32_forms(rows or FORM_ROWS))
           if args.f32 and args.forms
           else (lambda: f32_sweep(set(rows)))
           if args.f32 and args.rows
           else (lambda: f32_sweep() + f32_bwd_sweep()) if args.f32
           else sweep)
    result = {"card": card, "rows": run()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
