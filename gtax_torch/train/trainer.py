"""The training orchestrator and the frozen-VAE frame encoding and
decoding (counterpart of gtax/train/trainer.py).

Ported: the steps math and warmup, random init or a `pretrained_model`
load, the frozen VAE encode, gradient accumulation, AdamW with the
cosine-to-min_lr schedule, the metrics (train_loss, grad_norm before
clipping, learning_rate, step_time_s, mfu), eval loss and the epoch /
max_steps loop. Not ported yet (check_slice raises NotImplementedError):
checkpoints and resume, the rollout / renoise visualisations, the
webdataset and hfdataset backends, int8-forward training, remat, profiling
traces and parallel training (ROADMAP.md).
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from gtax_torch.core import schedules
from gtax_torch.core.constants import LATENT_SCALE
from gtax_torch.data.loader import Batch, DataLoader, make_dataset, to_device
from gtax_torch.io import safetensors_port as port
from gtax_torch.models import dit as dit_mod
from gtax_torch.models import vae as vae_mod
from gtax_torch.models.vae import vae_decode, vae_encode
from gtax_torch.sampling.diffusion import LossConfig, diffusion_forcing_loss
from gtax_torch.train.config import TrainingConfig
from gtax_torch.train.optim import decays, leaves, make_optimizer
from gtax_torch.utils.platform import resolve_device
from gtax_torch.utils.profiling import MFUCounter, dit_forward_flops

logger = logging.getLogger("gtax_torch.train")


def as_float_video(video: torch.Tensor) -> torch.Tensor:
    """uint8 channel-last (..., H, W, 3) pixels -> float (..., 3, H, W) in
    [0, 1] on the tensor's device; float inputs pass through unchanged."""
    if video.dtype != torch.uint8:
        return video
    n = video.dim()
    return video.permute(*range(n - 3), n - 1, n - 3, n - 2).float() / 255.0


def encode_frames(vae_params, vae_cfg, frames, compute_dtype, fused=False,
                  backend="xla"):
    """frames (B, T, 3, H, W) in [0, 1] (or uint8 (B, T, H, W, 3)) ->
    latents (B, T, C, h, w) float32 (gtax/train/trainer.py encode_frames).
    fused: the fused VAE block kernels (serving under the fused backends);
    otherwise the unfused blocks with the attention of `backend`."""
    frames = as_float_video(frames)
    B, T = frames.shape[:2]
    flat = frames.reshape(B * T, *frames.shape[2:])
    mean, _ = vae_encode(vae_params, vae_cfg, flat * 2.0 - 1.0, compute_dtype,
                         fused, backend)
    lat = (mean * LATENT_SCALE).reshape(B, T, vae_cfg.seq_h, vae_cfg.seq_w,
                                        vae_cfg.latent_dim)
    return lat.permute(0, 1, 4, 2, 3).float()


def decode_frames(vae_params, vae_cfg, latents, compute_dtype, fused=False,
                  backend="xla"):
    """latents (B, T, C, h, w) -> uint8 video (B, T, H, W, 3); fused and
    backend as encode_frames'."""
    B, T, C, h, w = latents.shape
    flat = latents.permute(0, 1, 3, 4, 2).reshape(B * T, h * w, C)
    pix = vae_decode(vae_params, vae_cfg, flat / LATENT_SCALE, compute_dtype,
                     fused, backend)
    pix = ((pix + 1.0) / 2.0).reshape(B, T, 3, vae_cfg.input_height,
                                       vae_cfg.input_width)
    pix = torch.clamp(pix * 255.0, 0, 255).to(torch.uint8)
    return pix.permute(0, 1, 3, 4, 2)


# ---------------------------------------------------------------- training

# options of the trainer that the port runs: name -> allowed values
_PORTED = {
    "attention_backend": ("fused_all",),
    "int8_forward": (False,),
    "remat": (False,),
    "unstack_train": (True,),
    "profile_dir": (None,),
    "dataset_type": ("dummy",),
}


def check_slice(config: TrainingConfig) -> None:
    """Raise NotImplementedError for the options the port does not run yet
    (ROADMAP.md lists them)."""
    for name, allowed in _PORTED.items():
        value = getattr(config, name)
        if value not in allowed:
            raise NotImplementedError(
                f"TrainingConfig.{name}={value!r} is not ported yet (only "
                f"{' / '.join(map(repr, allowed))}); see ROADMAP.md")
    for name in ("mesh_data", "mesh_model"):
        if getattr(config, name) > 1:
            raise NotImplementedError(
                f"TrainingConfig.{name}={getattr(config, name)}: parallel "
                "training is not ported yet; see ROADMAP.md")
    if config.save_every > 0:
        raise NotImplementedError(
            "save_every > 0: checkpoints and the safetensors export are not "
            "ported yet; set save_every: 0 (ROADMAP.md)")


class Trainer:
    """Diffusion-forcing DiT training with a frozen VAE (gtax Trainer): AdamW
    with warmup and cosine decay to min_lr, gradient accumulation, eval
    loss, deferred metrics.

    The step runs eagerly: per micro-batch the frozen VAE encodes under
    torch.no_grad(), the loss runs forward and backward through the fused
    branches and their backward kernels, gradients accumulate in the fp32
    masters' .grad; then they are divided by the accumulation count, clipped
    and applied, all on the card without a host read. train_step returns the
    PREVIOUS step's metrics, so the host prepares and enqueues step N+1
    while the card runs step N."""

    def __init__(self, config: TrainingConfig, total_dataset_size: int,
                 dit_cfg=None, vae_cfg=None, dit_params=None, vae_params=None,
                 device=None):
        check_slice(config)
        self.config = config
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, config.compute_dtype)
        if self.device.type == "cuda" and self.compute_dtype != torch.bfloat16:
            raise NotImplementedError(
                "the CUDA kernels compute in bfloat16; float32 runs only on "
                "device='cpu'")
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)

        self.dit_cfg = dit_cfg or dit_mod.DiT_MODELS[config.dit_model]()
        if dit_params is not None:
            params = dit_params
        elif config.pretrained_model:
            logger.info("Loading pretrained DiT from %s",
                        config.pretrained_model)
            params = port.load_dit(config.pretrained_model, self.dit_cfg)
        else:
            logger.info("Initializing new DiT model from scratch")
            params = dit_mod.dit_init(self.dit_cfg, self.generator,
                                      self.device)
        # fp32 masters of the trainer's own (the caller's tensors are not
        # updated in place)
        self.dit_params = dit_mod._map_params(
            params, lambda _, a: a.detach().to(self.device, torch.float32,
                                                copy=True))
        for path, p in leaves(self.dit_params):
            p.requires_grad_(decays(path))  # rope tables stay frozen

        self.vae_cfg = vae_cfg or vae_mod.VAE_MODELS[config.vae_model]()
        if vae_params is None and config.vae_checkpoint:
            vae_params = port.load_vae(config.vae_checkpoint, self.vae_cfg)
        elif vae_params is None:
            logger.warning("vae_checkpoint empty: initializing a RANDOM VAE "
                           "(smoke-test path; latents are meaningless)")
            vae_params = vae_mod.vae_init(self.vae_cfg, self.generator,
                                          self.device)
        vae_params = dit_mod.params_to(vae_params, self.device)
        if self.compute_dtype != torch.float32:
            vae_params = vae_mod.cast_params_for_inference(
                vae_params, self.compute_dtype)
        self.vae_params = vae_params
        if (self.dit_cfg.in_channels, self.dit_cfg.input_h,
                self.dit_cfg.input_w) != (self.vae_cfg.latent_dim,
                                          self.vae_cfg.seq_h,
                                          self.vae_cfg.seq_w):
            raise ValueError("DiT latent geometry must match the VAE's; "
                             "check the dit_model/vae_model pairing")
        self.max_frames = self.dit_cfg.max_frames

        self.steps_per_epoch = total_dataset_size // (
            config.batch_size * config.gradient_accumulation_steps)
        self.total_training_steps = self.steps_per_epoch * config.num_epochs
        if config.max_steps > 0:
            self.total_training_steps = min(self.total_training_steps,
                                            config.max_steps)
        warmup = int(config.warmup_ratio * self.total_training_steps)
        self.optimizer, self.lr_schedule = make_optimizer(
            self.dit_params, config.learning_rate, config.min_learning_rate,
            warmup, self.total_training_steps,
            weight_decay=config.weight_decay,
            max_grad_norm=config.max_grad_norm,
            mu_dtype=torch.bfloat16 if config.mu_bf16 else None)

        _, abar, noise_range, _ = schedules.make_diffusion_constants(
            config.ddim_noise_steps)
        self.alphas_cumprod = abar.to(self.device)
        self.noise_range = noise_range.to(self.device)
        self.loss_cfg = LossConfig(
            ddim_noise_steps=config.ddim_noise_steps,
            ctx_max_noise_idx=config.ctx_max_noise_idx,
            noise_abs_max=config.noise_abs_max,
            n_prompt_frames=config.n_prompt_frames,
            max_frames=self.max_frames)

        self.global_step = 0
        self.start_epoch = 0
        flops = 3.0 * dit_forward_flops(  # forward + backward ~ 3x forward
            self.dit_cfg,
            config.batch_size * config.gradient_accumulation_steps,
            self.max_frames) * max(1, 5 - config.n_prompt_frames)
        self.mfu = None
        if self.device.type == "cuda":
            self.mfu = MFUCounter(flops, MFUCounter.peak_for_kind(
                torch.cuda.get_device_name(self.device)))
        self._inflight = None  # (device metrics, entry time, lr)

    # --------------------------------------------------------- the step

    def encode(self, video):
        """The frozen VAE's latents of (B, T, 3, H, W) pixels, without
        gradient, as gtax's trainer encodes them: the unfused VAE blocks
        under the trainer's attention backend (gtax/train/trainer.py:312)."""
        with torch.no_grad():
            return encode_frames(self.vae_params, self.vae_cfg, video,
                                 self.compute_dtype,
                                 backend=self.config.attention_backend)

    def loss(self, params, video, actions, generator):
        """(mean_loss, sum_loss) of one micro-batch: frozen-VAE encode of
        the (B, T, 3, H, W) pixels, then the diffusion-forcing loss through
        the DiT."""
        latents = self.encode(video)

        def dit_fn(x, t, a, valid):
            return dit_mod.dit_apply(params, self.dit_cfg, x, t, a, valid,
                                     compute_dtype=self.compute_dtype,
                                     backend=self.config.attention_backend)

        return diffusion_forcing_loss(
            dit_fn, latents, actions, generator, self.loss_cfg,
            self.alphas_cumprod, self.noise_range)

    def _dispatch(self, batch: Batch):
        """Enqueue one optimizer step over the batch's micro-batches
        (leading axis of batch.video); returns device metrics."""
        accum = self.config.gradient_accumulation_steps
        params = [p for _, p in leaves(self.dit_params)]
        for p in params:
            p.grad = None
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            acts = None if batch.actions is None else batch.actions[i]
            mean_loss, sum_loss = self.loss(self.dit_params, batch.video[i],
                                            acts, self.generator)
            sum_loss.backward()
            loss_sum = loss_sum + mean_loss.detach()
        grads = [None if p.grad is None else p.grad / accum for p in params]
        norm = self.optimizer.step(grads)
        return {"train_loss": loss_sum / accum, "grad_norm": norm}

    def train_step(self, batch: Batch):
        """Enqueue one step; return the PREVIOUS step's metrics (None on
        the first call), read before this step is enqueued: the card ran
        that step while the host prepared this batch."""
        entry = time.perf_counter()
        prev, self._inflight = self._inflight, None
        out = None if prev is None else self._materialize(prev)
        lr = self.lr_schedule(self.global_step)
        self._inflight = (self._dispatch(batch), entry, lr)
        return out

    def flush_metrics(self):
        """Wait for the in-flight step and return its metrics (or None)."""
        prev, self._inflight = self._inflight, None
        return None if prev is None else self._materialize(prev)

    def train_step_sync(self, batch: Batch):
        """train_step + flush: the just-dispatched step's metrics."""
        self.train_step(batch)
        return self.flush_metrics()

    def _materialize(self, inflight):
        """Host values of a dispatched step's metrics (the only step in
        flight). step_time_s is taken once the step's work has finished on
        the card and its values are on the host (gtax read its clock before
        that; ADVICE.md)."""
        metrics, entry, lr = inflight
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - entry
        out["step_time_s"] = dt
        if self.mfu is not None:
            out["mfu"] = self.mfu.mfu(dt)
        out["learning_rate"] = lr
        return out

    # ---------------------------------------------------------- the loop

    def iter_device_batches(self, loader):
        """Groups of gradient_accumulation_steps loader batches, stacked on
        a leading axis and copied to the device."""
        accum = self.config.gradient_accumulation_steps
        vids, acts = [], []
        for b in loader:
            vids.append(b.video)
            acts.append(b.actions)
            if len(vids) == accum:
                yield Batch(
                    video=to_device(np.stack(vids), self.device),
                    actions=(None if acts[0] is None else
                             to_device(np.stack(acts), self.device)))
                vids, acts = [], []

    def training_loop(self, train_loader, val_loader, callbacks=None):
        """The main loop (gtax training_loop): epochs over the loader until
        max_steps, validation every validation_steps. Every step's record
        is logged and passed to each callback exactly once, in step order,
        labelled with its step (`metrics["step"]`, 1-based: the step count
        after it); gtax delivered two steps out of order at flush points
        (ADVICE.md)."""
        cfg = self.config
        callbacks = callbacks or []
        self.try_resume()
        if self.global_step == 0:
            self.run_validation(val_loader)

        def deliver(metrics, epoch, force_log=False):
            if metrics is None:
                return
            if force_log or metrics["step"] % cfg.logging_steps == 0:
                self.log_metrics(metrics, epoch, step=metrics["step"])
            for cb in callbacks:
                cb(self, metrics)

        for epoch in range(self.start_epoch, cfg.num_epochs):
            for batch in self.iter_device_batches(train_loader):
                if cfg.max_steps > 0 and self.global_step >= cfg.max_steps:
                    deliver(self._flush_labelled(), epoch, force_log=True)
                    logger.info("Reached max_steps=%d", cfg.max_steps)
                    return
                deliver(self._step_labelled(batch), epoch)
                if (cfg.validation_steps > 0
                        and self.global_step % cfg.validation_steps == 0):
                    deliver(self._flush_labelled(), epoch)
                    self.run_validation(val_loader)
            deliver(self._flush_labelled(), epoch)
            self.start_epoch = epoch + 1

    def _step_labelled(self, batch):
        out = self.train_step(batch)
        self.global_step += 1
        if out is not None:
            out["step"] = self.global_step - 1
        return out

    def _flush_labelled(self):
        out = self.flush_metrics()
        if out is not None:
            out["step"] = self.global_step
        return out

    def try_resume(self) -> bool:
        """Checkpoints are not ported yet: start fresh, but refuse to
        ignore a checkpoint that is there."""
        if not self.config.resume_from_checkpoint:
            return False
        path = os.path.join(self.config.output_dir, "train_checkpoints",
                            f"{self.config.model_name}_last", "step.json")
        if os.path.exists(path):
            raise NotImplementedError(
                f"{path} exists, but resuming from checkpoints is not "
                "ported yet (ROADMAP.md)")
        logger.info("No checkpoint to resume; starting fresh")
        return False

    def _eval_generator(self, tag: int):
        """Evals draw from their own generator keyed by (seed, step, tag):
        they never advance the training stream."""
        seed = hash((self.config.seed ^ 0x5EED, self.global_step, tag))
        return torch.Generator(device=self.device).manual_seed(
            seed & 0x7FFFFFFFFFFFFFFF)

    def run_validation(self, val_loader, max_batches: int | None = None):
        """Eval loss over the validation loader (the whole split unless
        validation_max_batches or max_batches caps it). gtax's rollout and
        renoise visualisations are not ported yet (ROADMAP.md)."""
        if val_loader is None:
            return None
        if max_batches is None:
            max_batches = self.config.validation_max_batches
        losses = []
        with torch.no_grad():
            for i, b in enumerate(val_loader):
                if max_batches > 0 and i >= max_batches:
                    break
                video = to_device(b.video, self.device)
                acts = (None if b.actions is None
                        else to_device(b.actions, self.device))
                mean_loss, _ = self.loss(self.dit_params, video, acts,
                                         self._eval_generator(i))
                losses.append(float(mean_loss))
        avg = sum(losses) / max(1, len(losses))
        logger.info("val_loss=%.5f at step %d", avg, self.global_step)
        self.log_metrics({"val_loss": avg}, epoch=self.start_epoch)
        return avg

    def log_metrics(self, metrics: dict, epoch: int, step: int | None = None):
        """Log a record and append it to <output_dir>/<model>_metrics.jsonl
        (and wandb, when configured and installed)."""
        step = self.global_step if step is None else step
        record = {"step": step, "epoch": epoch,
                  "wall_time": round(time.time(), 3), **metrics}
        logger.info("step %d | %s", step, " ".join(
            f"{k}={v:.5g}" for k, v in metrics.items()
            if isinstance(v, (int, float)) and k != "step"))
        if self.config.use_wandb:
            try:
                import wandb

                if wandb.run is None:
                    wandb.init(project="diffusion-transformer",
                               config=self.config.to_dict())
                wandb.log(record)
            except ImportError:
                logger.info("wandb unavailable; metrics go to JSONL only")
        os.makedirs(self.config.output_dir, exist_ok=True)
        path = os.path.join(self.config.output_dir,
                            f"{self.config.model_name}_metrics.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")


def build_loaders(config: TrainingConfig, **dataset_kw):
    """(train_loader, val_loader) for the configured dataset; the dummy
    frames take the VAE's input geometry."""
    if config.dataset_type == "dummy":
        vae_cfg = vae_mod.VAE_MODELS[config.vae_model]()
        dataset_kw.setdefault("height", vae_cfg.input_height)
        dataset_kw.setdefault("width", vae_cfg.input_width)
    val_kw = {k: v for k, v in dataset_kw.items() if k != "size"}
    train_ds = make_dataset(config.dataset_type, "train",
                            config.use_action_conditioning, **dataset_kw)
    val_ds = make_dataset(config.dataset_type, "validation",
                          config.use_action_conditioning, **val_kw)
    return (DataLoader(train_ds, config.batch_size, seed=config.seed),
            DataLoader(val_ds, config.validation_batch_size,
                       seed=config.seed, shuffle=False))
