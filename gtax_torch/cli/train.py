"""Training CLI (counterpart of gtax/cli/train.py).

    python -m gtax_torch.cli.train cfg.yaml [--dummy_size N] [--device cpu]

Loads gtax's YAML configs unchanged (with PyYAML), or the same keys as a
JSON object in a `.json` file (for machines without PyYAML), builds the
loaders and the Trainer, and runs the training loop. Runs on the card unless
--device cpu. Options the port does not run yet raise
NotImplementedError (gtax_torch.train.trainer.check_slice).
"""

from __future__ import annotations

import argparse
import json
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(description="DiT training (gtax_torch)")
    parser.add_argument("config", type=str,
                        help="config file: YAML, or JSON (.json)")
    parser.add_argument("--dummy_size", type=int, default=None,
                        help="override the dummy dataset length (smoke runs)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from gtax_torch.train.config import TrainingConfig
    from gtax_torch.train.trainer import Trainer, build_loaders

    if args.config.endswith(".json"):
        with open(args.config) as f:
            config = TrainingConfig.from_dict(json.load(f))
    else:
        config = TrainingConfig.from_yaml(args.config)
    dataset_kw = {}
    if args.dummy_size is not None and config.dataset_type == "dummy":
        dataset_kw["size"] = args.dummy_size
    train_loader, val_loader = build_loaders(config, **dataset_kw)
    trainer = Trainer(config, total_dataset_size=len(train_loader.dataset),
                      device=args.device)
    trainer.training_loop(train_loader, val_loader)
    return trainer


if __name__ == "__main__":
    main()
