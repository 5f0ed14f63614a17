"""Requests of the HTTP server's shape against one VideoGenerator on one
NVIDIA GPU, timed whole: one prompt frame (gtax_torch/cli/serve.py sends
`frame[None, None]`), int8 W8A8 under `fused` (bf16), full DiT-S/2 (16
blocks, 101 steps), seeded weights with nonzero adaLN heads, actions on
and off.

    python gtax_torch/tools/serve_requests.py [--repo DIR] [--aot DIR]
        [--frames 8,32]

--repo imports gtax_torch from DIR, a checkout of another commit (by
default the one this file is in): the script calls only the generator's
public interface, so it times a commit whose rollout runs eagerly as well
as one that replays CUDA graphs. --aot: the kernel library's AOT cache
(ServingConfig.aot_dir), so that processes of two commits with the same
kernel sources build it once; it is loaded before the first request.

For each --frames length (prompt + generated, as the server's num_frames)
the requests go: actions, actions again, none, none again, then both once
more. Prints the card (nvidia-smi's name and power limit) and one JSON
line: each request's seconds, rollout seconds, the graphs it captured
(null where the commit has none) and a sha256 of its pixels (two commits
whose rollouts are bit-equal give the same digests); where the commit has
graphs, each held graph's capture figures (capture and instantiate ms,
nodes, how far it grew the pool the graphs share).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--aot", default=None)
    ap.add_argument("--frames", default="8,32")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import numpy as np
    import torch

    from gtax_torch.data.actions import forward_actions
    from gtax_torch.kernels import build
    from gtax_torch.serving import ServingConfig, VideoGenerator
    from gtax_torch.utils.platform import strict_matmul

    try:
        from gtax_torch.sampling import graphs
    except ImportError:
        graphs = None
    strict_matmul()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    base = VideoGenerator.load("", "", ServingConfig(dtype="float32"))
    gen = torch.Generator(device="cuda").manual_seed(2)
    for bp in base.dit_params["blocks"]:
        for k in ("s_adaln", "t_adaln"):
            bp[k]["kernel"].normal_(0.0, 0.02, generator=gen)
            bp[k]["bias"].normal_(0.0, 0.2, generator=gen)
    cfg = ServingConfig(dtype="bfloat16", quantize="int8", aot_dir=args.aot)
    server = VideoGenerator(base.dit_params, base.vae_params, cfg)
    del base
    t0 = time.perf_counter()
    build.library()
    load_s = time.perf_counter() - t0

    captures = []
    if graphs is not None:
        real = graphs.capture

        def counted(*a, **kw):
            captures.append(1)
            return real(*a, **kw)

        graphs.capture = counted
    vc = server.vae_cfg
    rng = np.random.default_rng(0)
    frame = rng.uniform(0, 1, (3, vc.input_height, vc.input_width)).astype(
        np.float32)
    requests = []
    for n in map(int, args.frames.split(",")):
        acts = forward_actions(1, n)
        for kind in ("actions", "actions", "none", "none", "actions",
                     "none"):
            before = len(captures)
            t = time.perf_counter()
            pixels = server.generate(frame[None, None],
                                     acts if kind == "actions" else None,
                                     num_frames=n, seed=7)
            s = time.perf_counter() - t
            requests.append({
                "num_frames": n, "actions": kind == "actions", "s": s,
                "rollout_s": server.last_timings["rollout_s"],
                "captures": (len(captures) - before if graphs is not None
                             else None),
                "pixels_sha256": hashlib.sha256(pixels.tobytes()).hexdigest()
                [:16]})
            print(f"[serve{args.label}] {n} frames, actions {kind}: "
                  f"{s:.3f} s (rollout {requests[-1]['rollout_s']:.3f} s), "
                  f"captures {requests[-1]['captures']}", flush=True)
    held = None
    if graphs is not None:
        held = [dict(g.stats)
                for g in server._rollout.graphs.graphs().values()]
        print(f"[serve{args.label}] {len(held)} graphs held, the pool "
              f"{sum(g['pool_bytes'] for g in held) / 2**20:.1f} MiB: "
              f"{json.dumps(held)}")
    print(json.dumps({"label": args.label, "card": card,
                      "torch": torch.__version__, "library_load_s": load_s,
                      "graphs": graphs is not None, "requests": requests,
                      "graphs_held": held}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
