"""Training configuration (counterpart of gtax/train/config.py).

The same keys and defaults as gtax's TrainingConfig (the reference's 27
fields plus gtax's extras), so gtax's YAML configs load unchanged; the
reference's misspelled `warnup_ratio` is accepted, and numbers written in
scientific notation as strings are coerced to float. PyYAML is imported by
`from_yaml` only: machines without it build configs with `from_dict`.
Which of the options the port's Trainer runs is its business
(gtax_torch.train.trainer).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainingConfig:
    vae_checkpoint: str = "checkpoints/vit-l-20.safetensors"
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    batch_size: int = 16
    num_epochs: int = 5
    save_every: int = 2000
    gradient_accumulation_steps: int = 2
    seed: int = 42
    use_wandb: bool = True
    output_dir: str = "checkpoints"
    ddim_noise_steps: int = 16
    ddim_noise_steps_inference: int = 16
    ctx_max_noise_idx: int = 3
    noise_abs_max: float = 20.0
    n_prompt_frames: int = 1
    min_learning_rate: float = 1e-6
    validation_batch_size: int = 8
    max_steps: int = -1
    validation_steps: int = 2000
    logging_steps: int = 5
    use_action_conditioning: bool = True
    warmup_ratio: float = 0.05
    max_grad_norm: float = 1.0
    dataset_type: str = "webdataset"  # webdataset | hfdataset | dummy
    pretrained_model: Optional[str] = None
    model_name: str = "dit"
    resume_from_checkpoint: bool = True

    # gtax's extras (defaults keep the reference's behaviour)
    dit_model: str = "DiT-S/2"
    vae_model: str = "vit-l-20-shallow-encoder"
    compute_dtype: str = "bfloat16"
    mesh_data: int = -1
    mesh_model: int = 1
    attention_backend: str = "xla"
    int8_forward: bool = False
    remat: bool = False
    mu_bf16: bool = False
    profile_dir: Optional[str] = None
    unstack_train: bool = True
    validation_max_batches: int = 0

    @classmethod
    def from_yaml(cls, path: str) -> "TrainingConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "TrainingConfig":
        raw = dict(raw)
        if "warnup_ratio" in raw and "warmup_ratio" not in raw:
            raw["warmup_ratio"] = raw.pop("warnup_ratio")
        raw.pop("warnup_ratio", None)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        cfg = cls(**raw)
        for name in ("learning_rate", "min_learning_rate", "weight_decay",
                     "noise_abs_max", "warmup_ratio"):
            setattr(cfg, name, float(getattr(cfg, name)))
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
