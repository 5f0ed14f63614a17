"""Export a training checkpoint to reference-format safetensors
(counterpart of gtax/cli/export.py): ship the weights of any saved state
without resuming training. The output loads in the reference, in gtax
(safetensors_port.load_dit) and in the port.

    python -m gtax_torch.cli.export <ckpt_dir> --out dit.safetensors \\
        [--dit_model DiT-S/2] [--step N]

<ckpt_dir> is a `<output_dir>/train_checkpoints/<name>_last` directory
(step.json picks the step; --step overrides it) or a `state_<N>`
directory. It runs on the host: no card is needed.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt_dir", help="train_checkpoints/<name>_last dir or a "
                                    "state_<N> dir")
    p.add_argument("--out", required=True, help="output .safetensors path")
    p.add_argument("--dit_model", default="DiT-S/2",
                   help="model preset the checkpoint was trained with")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: step.json)")
    args = p.parse_args(argv)

    from gtax_torch.io import safetensors_port as port
    from gtax_torch.models.dit import DiT_MODELS
    from gtax_torch.train import checkpoint as ckpt
    from gtax_torch.train.optim import leaves

    state_dir = ckpt.resolve_state_dir(args.ckpt_dir, args.step)
    params = ckpt.read_params(state_dir)
    port.save_dit(args.out, params, DiT_MODELS[args.dit_model]())
    n = sum(t.numel() for _, t in leaves(params))
    print(f"exported {n / 1e6:.1f}M params from {state_dir} to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
