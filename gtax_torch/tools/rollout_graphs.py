"""The compiled rollout on one NVIDIA GPU: each serving mode's frame graph
against its eager frames.

    python -m gtax_torch.tools.rollout_graphs [--depth N] [--steps S]
        [--modes bf16,int8,...]      # from the repository root

For each mode of MODES, a VideoGenerator at full DiT-S/2 width (its depth
cut to --depth blocks, 16 by default), seeded random weights with nonzero
adaLN heads, B=1, four random prompt latents, "forward" actions and
injected noise:

- one eager frame under torch.cuda.set_sync_debug_mode("error") (after
  one that builds the frame plan and the cached constants, unless a graph
  was captured already): the frame body waits on nothing;
- a first graphed rollout of two frames (the first frame the capture's
  warm-up, the second a replay), then rollouts in turns eager, graph,
  graph, eager: every graphed rollout bit-equal to the eager one, the
  second graphed rollout (two replays) bit-equal to the first;
- s/frame of each run, and each capture's figures: capture ms,
  instantiate ms, the graph's nodes and how far it grew the memory pool
  the cache's graphs share.

chip_smoke.py's `[graph]` phase calls `graph_turns` on its own
generators. Needs one GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

# label -> ServingConfig fields (over the base generator's fp32 config);
# "int8-seq" serves int8 with the pair's gate closed (the sequential
# wrappers)
BF16 = {"dtype": "bfloat16"}
MODES = {
    "bf16": BF16,
    "bf16-fused_all": {**BF16, "attention_backend": "fused_all"},
    "int8": {**BF16, "quantize": "int8"},
    "int8-seq": {**BF16, "quantize": "int8"},
    "fp32": {},
    "fp32-int8": {"quantize": "int8"},
    "pallas": {**BF16, "attention_backend": "pallas"},
    "xla": {**BF16, "attention_backend": "xla"},
    "fused_mlp": {**BF16, "attention_backend": "fused_mlp"},
    "no-cond-cache": {**BF16, "cond_cache": False},
    "stacked": {**BF16, "unstack": False},
}


@contextlib.contextmanager
def pair_gate(label):
    """The pair's gate closed under "int8-seq", as it is set."""
    from gtax_torch.kernels import pair

    gate = pair.PAIR_MAX_FRAMES
    if label.endswith("-seq"):
        pair.PAIR_MAX_FRAMES = 0
    try:
        yield
    finally:
        pair.PAIR_MAX_FRAMES = gate


def rollout_inputs(gen, n_prompt=4, n_gen=2, seed=0):
    """(prompt latents, actions, noise) on the card, from numpy."""
    from gtax_torch.data.actions import forward_actions

    rng = np.random.default_rng(seed)
    shape = (1, n_prompt, gen.dit_cfg.in_channels, gen.dit_cfg.input_h,
             gen.dit_cfg.input_w)
    lat = rng.standard_normal(shape).astype(np.float32)
    noise = np.clip(rng.standard_normal(shape[:1] + (n_gen,) + shape[2:]),
                    -20, 20).astype(np.float32)
    acts = forward_actions(1, n_prompt + n_gen)
    return tuple(torch.from_numpy(a).cuda() for a in (lat, acts, noise))


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def graph_turns(gen, label, inputs, log=print):
    """The checks and figures above for one generator (its rollout built
    with graphs); raises on a difference. Returns a summary dict."""
    lat, acts, nz = inputs
    n_gen = nz.shape[1]
    roll, args = gen._rollout, (gen.dit_params, lat, acts, None, n_gen, nz)
    with pair_gate(label), torch.inference_mode():
        one = (gen.dit_params, lat, acts, None, 1, nz[:, :1])
        if not roll.graphs.graphs():  # the frame plan and cached constants
            roll.eager(*one)
            torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            roll.eager(*one)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        new = not roll.graphs.graphs()
        first, first_s = timed(lambda: roll(*args))
        runs = {"eager": [], "graph": []}
        outs = {"eager": [], "graph": [first]}
        for who in ("eager", "graph", "graph", "eager"):
            out, s = timed(lambda: (roll if who == "graph" else roll.eager)(
                *args))
            runs[who].append(s / n_gen)
            outs[who].append(out)
    ref = outs["eager"][0]
    equal = {"graph_vs_eager": all(torch.equal(o, ref) for o in outs["graph"]),
             "eager_vs_eager": torch.equal(outs["eager"][1], ref),
             "replay_vs_replay": torch.equal(outs["graph"][1],
                                             outs["graph"][2])}
    stats = [dict(e.stats) for e in roll.graphs.graphs().values()]
    summary = {"label": label, "steps": gen.cfg.noise_steps + 1,
               "depth": gen.dit_cfg.depth, "frames": n_gen,
               "first_graphed_s": first_s, "captured_here": new,
               "eager_s_per_frame": runs["eager"],
               "graph_s_per_frame": runs["graph"], "bit_equal": equal,
               "graphs": stats}
    log(f"[graph] {label}: {summary['depth']} blocks, {summary['steps']} "
        f"steps, {n_gen} frames; s/frame in turns eager, graph, graph, "
        f"eager: {runs['eager'][0]:.4f} {runs['graph'][0]:.4f} "
        f"{runs['graph'][1]:.4f} {runs['eager'][1]:.4f}; first graphed "
        f"rollout {first_s:.3f} s (capture in it: {new}); capture "
        f"{json.dumps(stats)}; bit-equal {json.dumps(equal)}")
    if not all(equal.values()):
        raise AssertionError(f"[graph] {label}: {equal}")
    if not all(torch.isfinite(o).all() for o in outs["graph"]):
        raise AssertionError(f"[graph] {label}: non-finite latents")
    return summary


def mode_generator(base, label, depth, steps):
    """A VideoGenerator of `label` over `base`'s (full-width) params, its
    DiT cut to `depth` blocks and registered under its own name."""
    from gtax_torch.models import dit as dit_mod
    from gtax_torch.serving import VideoGenerator

    name = f"DiT-S/2-depth{depth}"
    cut = dataclasses.replace(base.dit_cfg, depth=depth)
    dit_mod.DiT_MODELS[name] = lambda: cut
    cfg = dataclasses.replace(base.cfg, dit_model=name, noise_steps=steps,
                              **MODES[label])
    return VideoGenerator(
        dict(base.dit_params, blocks=base.dit_params["blocks"][:depth]),
        base.vae_params, cfg)


def base_generator():
    """The fp32 generator whose seeded weights every mode serves (the fp32
    modes as they are, the others cast or quantized), adaLN heads drawn
    nonzero so that every branch runs."""
    from gtax_torch.serving import ServingConfig, VideoGenerator

    base = VideoGenerator.load("", "", ServingConfig(dtype="float32"))
    gen = torch.Generator(device="cuda").manual_seed(2)
    for bp in base.dit_params["blocks"]:
        for k in ("s_adaln", "t_adaln"):
            bp[k]["kernel"].normal_(0.0, 0.02, generator=gen)
            bp[k]["bias"].normal_(0.0, 0.2, generator=gen)
    return base


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--modes", default=",".join(MODES))
    args = ap.parse_args(argv)
    from gtax_torch.utils.platform import strict_matmul

    strict_matmul()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    base = base_generator()
    inputs = rollout_inputs(base)
    failed = []
    for label in args.modes.split(","):
        g = mode_generator(base, label, args.depth, args.steps)
        try:
            graph_turns(g, label, inputs)
        except (AssertionError, RuntimeError) as e:
            print(f"[graph] {label}: FAILED {type(e).__name__}: {e}")
            failed.append(label)
        del g
        torch.cuda.empty_cache()
    print(f"[graph] failed: {failed}" if failed else "[graph] all passed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
