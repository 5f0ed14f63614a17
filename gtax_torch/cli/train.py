"""Training CLI (counterpart of gtax/cli/train.py).

    python -m gtax_torch.cli.train cfg.yaml [--dummy_size N] \
        [--dataset_root DIR [--dataset_size N]] [--latent_cache DIR] \
        [--device cpu]

Loads gtax's YAML configs unchanged (with PyYAML), or the same keys as a
JSON object in a `.json` file (for machines without PyYAML), builds the
loaders and the Trainer, and runs the training loop; a run whose output
directory holds a checkpoint resumes from it (resume_from_checkpoint).
Runs on the card unless --device cpu. Every option of gtax's config runs
(the attention backends but `pallas`, int8_forward, remat, unstack_train,
mesh_data and mesh_model); a `pallas` backend raises ValueError (no
gradient; gtax_torch.train.trainer.check_slice).

On N cards, one process a card, as a mesh_data x mesh_model layout
(mesh_data: -1 takes N / mesh_model):
  torchrun --nproc_per_node N -m gtax_torch.cli.train cfg.yaml
or gtax's GTAX_COORDINATOR=host:port GTAX_NUM_PROCESSES=N
GTAX_PROCESS_ID=i in each process's environment. batch_size is each data
index's (the model ranks of a data index share its rows); a
--latent_cache must be built by a one-process run first.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="DiT training (gtax_torch)")
    parser.add_argument("config", type=str,
                        help="config file: YAML, or JSON (.json)")
    parser.add_argument("--dataset_root", type=str, default=None,
                        help="local shard dir for the webdataset backend "
                             "(validation: its val/, dev/ or validation/ "
                             "subdir, else the training shards)")
    parser.add_argument("--dummy_size", type=int, default=None,
                        help="override the dummy dataset length (smoke runs)")
    parser.add_argument("--dataset_size", type=int, default=None,
                        help="true sample count of --dataset_root's shards "
                             "(the schedule's steps/epoch and the latent "
                             "cache's size; without it ~1000 a shard)")
    parser.add_argument("--latent_cache", type=str, default=None,
                        help="directory of precomputed VAE latents for the "
                             "training split, built from the configured "
                             "dataset on first use; the frozen encode then "
                             "leaves the step (validation stays on pixels)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # the process group before anything else (no-op in one process)
    from gtax_torch.parallel import mesh as meshlib

    meshlib.initialize_distributed(device=args.device)

    from gtax_torch.train.config import TrainingConfig
    from gtax_torch.train.trainer import Trainer, build_loaders

    if args.config.endswith(".json"):
        with open(args.config) as f:
            config = TrainingConfig.from_dict(json.load(f))
    else:
        config = TrainingConfig.from_yaml(args.config)
    dataset_kw = {}
    if args.dataset_root and config.dataset_type == "webdataset":
        dataset_kw["shards"] = sorted(
            glob.glob(os.path.join(args.dataset_root, "*.tar")))
        for sub in ("val", "dev", "validation"):
            vs = sorted(glob.glob(os.path.join(args.dataset_root, sub,
                                               "*.tar")))
            if vs:
                dataset_kw["val_shards"] = vs
                break
        else:
            logging.warning("--dataset_root has no val/dev/validation "
                            "subdir: validation streams the TRAINING shards")
            dataset_kw["val_shards"] = dataset_kw["shards"]
    if args.dummy_size is not None and config.dataset_type == "dummy":
        dataset_kw["size"] = args.dummy_size
    if args.dataset_size is not None and config.dataset_type == "webdataset":
        dataset_kw["size"] = args.dataset_size
    train_loader, val_loader = build_loaders(config, **dataset_kw)
    trainer = Trainer(config, total_dataset_size=len(train_loader.dataset),
                      device=args.device)
    if args.latent_cache:
        from gtax_torch.data.latents import LatentCacheDataset
        from gtax_torch.data.loader import DataLoader

        if os.path.exists(os.path.join(args.latent_cache, "meta.json")):
            lat_ds = LatentCacheDataset(args.latent_cache)
        elif meshlib.world_size() > 1:
            raise ValueError(
                f"{args.latent_cache} holds no latent cache: build it in one "
                "process first (each rank here reads only its own shards)")
        else:
            logging.info("Building latent cache at %s ...", args.latent_cache)
            lat_ds = LatentCacheDataset.build(
                train_loader.dataset, trainer.vae_params, trainer.vae_cfg,
                args.latent_cache, encode_batch=config.batch_size,
                compute_dtype=trainer.compute_dtype,
                backend=config.attention_backend)
        train_loader = DataLoader(
            lat_ds, train_loader.batch_size,
            num_workers=train_loader.num_workers, seed=config.seed,
            rank=train_loader.rank, world=train_loader.world)
    trainer.training_loop(train_loader, val_loader)
    return trainer


if __name__ == "__main__":
    main()
