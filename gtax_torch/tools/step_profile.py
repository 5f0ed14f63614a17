"""Where one denoise step's time goes on one NVIDIA GPU: the host's time to
enqueue the step against the card's time to run it, and the host functions
that take the most of it.

    python -m gtax_torch.tools.step_profile     # from the repository root

One incremental denoise step (dit_apply_step over a 4-frame K/V cache) at
full DiT-S/2 width and depth, B=1, random seeded weights with nonzero adaLN
heads, in bf16, in int8 (W8A8: one paired kernel per half-block, as
serving runs it) and in int8 with the pair's gate closed (the sequential
int8 wrappers, two per half-block), in turns bf16, int8, int8-sequential,
int8-sequential, int8, bf16: the host's speed drifts within a run, so each
mode is read twice. Per mode it
prints the host enqueue ms (the card held busy so the queue never blocks),
the card ms (CUDA events, the host ahead of the card), and, from cProfile
over two steps, the host functions by own time and each kernel wrapper's
host ms per call (cProfile's own cost included). Needs one GPU.
"""

from __future__ import annotations

import cProfile
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

CYCLES_PER_MS = 1.98e6  # the H100's boost clock (torch.cuda._sleep counts)
WRAPPERS = ("fused_spatial_branch", "fused_mlp_branch", "fused_temporal_step",
            "fused_spatial_branch_q", "fused_mlp_branch_q",
            "fused_temporal_step_q", "fused_spatial_pair_q",
            "fused_temporal_pair_q")


def hold(ms):
    torch.cuda._sleep(int(ms * CYCLES_PER_MS))


def host_ms(fn, n=2):
    """Host ms to enqueue one call of `fn`, the card held busy meanwhile."""
    fn()
    torch.cuda.synchronize()
    hold(100.0)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / n


def card_ms(fn, iters=5):
    """Median CUDA-event ms of one call of `fn`, L2 flushed and the stream
    held 50 ms before each call so the host has enqueued all of it before
    the card starts."""
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        flush.zero_()
        hold(50.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def make_step(params, cfg):
    """A closure running one dit_apply_step over a prefilled 4-frame cache."""
    from gtax_torch.models import dit as dit_mod

    bf = torch.bfloat16
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(
        (1, 5, cfg.in_channels, cfg.input_h, cfg.input_w)).astype(
            np.float32)).cuda()
    t = torch.full((1, 5), 10, device="cuda")
    a = torch.from_numpy(rng.standard_normal(
        (1, 5, cfg.external_cond_dim)).astype(np.float32)).cuda()
    valid = [False] + [True] * 4

    def rows(mods, sl):
        return {"blocks": [{k: m[:, sl] for k, m in b.items()}
                           for b in mods["blocks"]],
                "final": mods["final"][:, sl]}

    with torch.inference_mode():
        mods = dit_mod.dit_cond(params, cfg, t, a, bf)
        kv = dit_mod.dit_prefill(params, cfg, x[:, :4], rows(mods, slice(4)),
                                 valid[:4], bf)
    live = rows(mods, slice(4, 5))

    def step():
        with torch.inference_mode():
            return dit_mod.dit_apply_step(params, cfg, x[:, 4:], kv, live,
                                          valid, bf)

    return step


def sequential(step):
    """`step` with the pair's gate closed: every int8 half-block runs the
    two sequential wrappers, as at more than PAIR_MAX_FRAMES live rows."""
    from gtax_torch.kernels import pair

    def call():
        gate, pair.PAIR_MAX_FRAMES = pair.PAIR_MAX_FRAMES, 0
        try:
            return step()
        finally:
            pair.PAIR_MAX_FRAMES = gate

    return call


def profile(label, step):
    host = float(np.median([host_ms(step) for _ in range(5)]))
    card = card_ms(step)
    prof = cProfile.Profile()
    hold(100.0)
    prof.enable()
    step()
    step()
    prof.disable()
    torch.cuda.synchronize()
    print(f"[step {label}] one denoise step, B=1: host enqueue {host:.3f} ms, "
          f"card {card:.3f} ms", flush=True)
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])
    for (path, line, fn), (_, calls, own_s, _, _) in top[:6]:
        print(f"[step {label}]   host {own_s * 500:7.3f} ms/step (cProfile) "
              f"{calls // 2:5d} calls  {fn} ({path.rsplit('/', 1)[-1]}:{line})")
    for (path, line, fn), (_, calls, _, cum_s, _) in stats.items():
        if fn in WRAPPERS and path.endswith(("block.py", "quant.py",
                                             "pair.py")):
            print(f"[step {label}]   wrapper {fn}: {1e3 * cum_s / calls:.4f} "
                  f"ms/call host (cProfile), {calls // 2} calls/step")


def main():
    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    from gtax_torch.kernels import build
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.utils.platform import strict_matmul

    strict_matmul()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    build.library()
    cfg = dit_mod.DiT_S_2()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = dit_mod.dit_init(cfg, gen, device="cuda")
    for bp in params["blocks"]:  # dit_init zeroes the adaLN heads
        for k in ("s_adaln", "t_adaln"):
            bp[k]["kernel"].normal_(0.0, 0.02, generator=gen)
            bp[k]["bias"].normal_(0.0, 0.2, generator=gen)
    bf16 = dit_mod.cast_params_for_inference(params, torch.bfloat16)
    del params
    steps = {"bf16": make_step(bf16, cfg),
             "int8": make_step(dit_mod.quantize_for_inference(bf16), cfg)}
    steps["int8-sequential"] = sequential(steps["int8"])
    for label in ("bf16", "int8", "int8-sequential", "int8-sequential",
                  "int8", "bf16"):
        profile(label, steps[label])
    return 0


if __name__ == "__main__":
    sys.exit(main())
