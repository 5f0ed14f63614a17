"""Autoregressive video generation CLI (counterpart of gtax/cli/generate.py,
same flag names and defaults).

Usage:
  python -m gtax_torch.cli.generate --total-frames 32 --noise_steps 100 \\
      --dit_model_path dit.safetensors --vae_model_path vit-l-20.safetensors \\
      --start_frame img.png [--use_actions] [--output_path video1.mp4]

Empty --dit_model_path / --vae_model_path give random weights (a
checkpoint-free smoke run). Runs on the card unless --device cpu.
--aot_dir DIR takes the kernel library from an AOT cache there
(gtax_torch.aot: the first run builds and saves it, later runs load it
without nvcc) and prewarms the generator in the background while the
prompt is read (--no_prewarm: not).

On N cards, one process a card:
  torchrun --nproc_per_node N -m gtax_torch.cli.generate ... --mesh_data N
(or gtax's GTAX_COORDINATOR / GTAX_NUM_PROCESSES / GTAX_PROCESS_ID in each
process's environment). --mesh_data N: batched serving, --batch divides by
N and each rank writes its own rows' videos (<stem>_<row>.<ext>);
--mesh_model N: tensor-parallel serving on the `xla` backend, bf16, rank 0
writes the videos. Without --start_frame, or
with --batch_distinct, the prompts are the first 4 frames of test-set
clips (the webdataset backend's "test" split, gtax_torch.data.webtar),
one prompt replicated, or one distinct prompt a stream; their actions are
padded with "forward" to --total-frames.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from gtax_torch.data.actions import forward_actions
from gtax_torch.io.video import read_image, write_video


def build_parser():
    p = argparse.ArgumentParser(description="Video generation (gtax_torch)")
    p.add_argument("--total-frames", type=int, default=32)
    p.add_argument("--dit_model_path", type=str,
                   default="checkpoints/dit.safetensors")
    p.add_argument("--vae_model_path", type=str,
                   default="checkpoints/vit-l-20.safetensors")
    p.add_argument("--noise_steps", type=int, default=100)
    p.add_argument("--use_actions", action="store_true")
    p.add_argument("--output_path", type=str, default="video1.mp4")
    p.add_argument("--batch", type=int, default=1,
                   help="generate N videos of the same prompt in one "
                        "rollout; N>1 writes <output_path stem>_i.<ext>")
    p.add_argument("--batch_distinct", action="store_true",
                   help="N different test-set prompts, one a stream "
                        "(not with --start_frame)")
    p.add_argument("--start_frame", type=str, default=None)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="float32: the kernels' fp32 forms on the card "
                        "(with --quantize int8 too, and under the pallas "
                        "backend)")
    p.add_argument("--attention_backend", type=str, default="fused",
                   choices=["xla", "pallas", "fused", "fused_mlp",
                            "fused_all"],
                   help="fused / fused_all: the fused branch kernels with "
                        "incremental decoding; xla / pallas / fused_mlp: "
                        "full-window rollouts through the unfused branches "
                        "(pallas on the attention kernels)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--pipeline_depth", type=int, default=1)
    p.add_argument("--attn_broadcast", type=int, default=1)
    p.add_argument("--benchmark_json", action="store_true",
                   help="print a timing JSON line at the end")
    p.add_argument("--quantize", choices=["none", "int8"], default="none")
    p.add_argument("--no_incremental", action="store_true",
                   help="disable incremental decoding (full-window steps)")
    p.add_argument("--no_cond_cache", action="store_true",
                   help="disable the conditioning cache")
    p.add_argument("--no_unstack", action="store_true")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel serving over N processes, one a "
                        "card (forces the xla backend; not with --quantize "
                        "int8 or --mesh_data)")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="batched serving over N processes, one a card: "
                        "each rolls out its rows of --batch (which N "
                        "divides) and writes their videos")
    p.add_argument("--decode_chunk", type=int, default=None,
                   help="decode at most N frames per VAE call")
    p.add_argument("--aot_dir", type=str, default=None,
                   help="AOT kernel-library cache dir (gtax_torch.aot): "
                        "the first run builds and saves the library, later "
                        "runs load it and need no nvcc")
    p.add_argument("--no_prewarm", action="store_true",
                   help="with --aot_dir: skip the background run on zeros "
                        "that loads the library and warms the card during "
                        "prompt preparation")
    p.add_argument("--dit_model", type=str, default="DiT-S/2")
    p.add_argument("--vae_model", type=str,
                   default="vit-l-20-shallow-encoder")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def test_prompts(n_prompts, n_prompt, total_frames, use_actions):
    """(video (n, n_prompt, 3, H, W) float32, actions (n, total_frames, 25)
    or None): the first n_prompt frames of the test split's first n clips,
    their actions padded with "forward" (gtax cli/generate.py:170-195)."""
    from gtax_torch.data.loader import make_dataset

    it = iter(make_dataset("webdataset", "test", use_actions))
    vids, acts = [], []
    for _ in range(n_prompts):
        sample = next(it)
        vids.append(np.asarray(sample["video"], np.float32)[:n_prompt])
        if use_actions:
            acts.append(np.asarray(sample["actions"], np.float32))
    if not use_actions:
        return np.stack(vids), None
    acts = np.stack(acts)
    if acts.shape[1] < total_frames:
        acts = np.concatenate([acts, forward_actions(
            n_prompts, total_frames - acts.shape[1])], axis=1)
    return np.stack(vids), acts


def main(argv=None):
    args = build_parser().parse_args(argv)
    from gtax_torch.parallel import mesh as meshlib
    from gtax_torch.serving import ServingConfig, VideoGenerator

    # the process group first (no-op in one process)
    meshlib.initialize_distributed(device=args.device)

    if args.batch_distinct and args.start_frame:
        raise ValueError("--batch_distinct draws prompts from the test set; "
                         "it cannot be combined with a single --start_frame")
    cfg = ServingConfig(
        dtype=args.dtype, attention_backend=args.attention_backend,
        quantize=args.quantize, unstack=not args.no_unstack,
        cond_cache=not args.no_cond_cache,
        incremental=not args.no_incremental,
        pipeline_depth=args.pipeline_depth,
        attn_broadcast=args.attn_broadcast, noise_steps=args.noise_steps,
        mesh_data=args.mesh_data, mesh_model=args.mesh_model,
        decode_chunk=args.decode_chunk, aot_dir=args.aot_dir,
        dit_model=args.dit_model, vae_model=args.vae_model)
    gen = VideoGenerator.load(args.dit_model_path, args.vae_model_path, cfg,
                              device=args.device)
    dit_cfg, vae_cfg = gen.dit_cfg, gen.vae_cfg
    total_frames = args.total_frames
    n_prompt = 4 if args.start_frame is None else 1
    if args.aot_dir and not args.no_prewarm:
        # load the library and warm the card in the background NOW, while
        # the prompt is read (gtax cli/generate.py); generate() waits for it
        gen.prewarm(num_frames=total_frames, batch_size=args.batch,
                    n_prompt=n_prompt, use_actions=args.use_actions)
    print(f"We will generate {total_frames} frames, starting with "
          f"{n_prompt} frames.")
    print(f"Noise steps: {args.noise_steps}; stabilization 15; "
          f"window {dit_cfg.max_frames}; actions={args.use_actions}")
    if args.start_frame is not None:
        frame = read_image(args.start_frame,
                           (vae_cfg.input_height, vae_cfg.input_width))
        video = frame[None, None]
        actions = (forward_actions(1, total_frames) if args.use_actions
                   else None)
    else:
        video, actions = test_prompts(
            args.batch if args.batch_distinct else 1, n_prompt,
            total_frames, args.use_actions)
    if args.batch > 1 and video.shape[0] == 1:
        # one prompt for every stream; each draws its own rollout noise
        video = np.tile(video, (args.batch, 1, 1, 1, 1))
        if actions is not None:
            actions = np.tile(actions, (args.batch, 1, 1))
    seed = args.seed if args.seed is not None else int(time.time())
    if args.seed is None and meshlib.world_size() > 1:
        import torch.distributed as dist

        box = [seed]  # rank 0's clock: the ranks' noise derives from one
        dist.broadcast_object_list(box, src=0)
        seed = box[0]

    t0 = time.perf_counter()
    pixels = gen.generate(video, actions, num_frames=total_frames, seed=seed)
    total_seconds = time.perf_counter() - t0
    gen_seconds = gen.last_timings["rollout_s"]
    if args.mesh_model > 1 and meshlib.process_index() > 0:
        rows = range(0)  # every rank holds the same pixels: rank 0 writes
    elif args.mesh_data > 1:  # this rank's rows of the batch
        own = meshlib.process_batch_slice(args.batch)
        rows = range(own.start, own.stop)
    else:
        rows = range(args.batch)
    if args.batch == 1:
        if rows:
            write_video(args.output_path, pixels[0], fps=10)
            print(f"generation saved to {args.output_path}.")
    else:
        stem, ext = os.path.splitext(args.output_path)
        for i, row in enumerate(rows):
            write_video(f"{stem}_{row}{ext}", pixels[i], fps=10)
        print(f"{len(rows)} generations saved to {stem}_*{ext}.")
    if args.benchmark_json:
        n_gen = (total_frames - n_prompt) * len(pixels)
        print(json.dumps({
            "generated_frames": n_gen,
            "noise_steps": args.noise_steps,
            "seconds": gen_seconds,
            "frames_per_sec": n_gen / gen_seconds,
            "total_seconds_with_vae": total_seconds,
            "device": str(gen.device),
        }))
    return pixels


if __name__ == "__main__":
    main()
