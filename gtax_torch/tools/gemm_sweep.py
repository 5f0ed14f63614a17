"""Time the port's bf16 GEMM (`gtax_torch.kernels.block.launch_gemm`) at the
main paths' products and row counts, beside one cuBLAS call of the same
product, on one NVIDIA GPU; or, with --wgrad-splits, the B=16 training
step's four weight gradients (`gtax_torch.kernels.backward.wgrad`) at every
row-chunk count from 1 to 8, the plan's count marked.

    python -m gtax_torch.tools.gemm_sweep [--wgrad-splits] [--out FILE]

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wgrad-splits", action="store_true",
                    help="time the weight gradients' split counts instead")
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
    result = {"card": card,
              "rows": wgrad_splits() if args.wgrad_splits else sweep()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
