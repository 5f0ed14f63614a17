"""The training orchestrator and the frozen-VAE frame encoding and
decoding (counterpart of gtax/train/trainer.py).

Ported: the steps math and warmup, random init or a `pretrained_model`
load, the frozen VAE encode (or latent-cache batches that skip it),
gradient accumulation, AdamW with the cosine-to-min_lr schedule, the
metrics (train_loss, grad_norm before clipping, learning_rate,
step_time_s, mfu), the epoch / max_steps loop, eval loss with the rollout
mp4 and the renoise grid, the safetensors weight export and the full-state
checkpoints with resume (gtax's paths; the state in the port's own format,
gtax_torch.train.checkpoint), the wandb run id carried across restarts,
and the profile_dir trace window; the attention backends `xla`, `fused`,
`fused_mlp` and `fused_all`, int8-forward training (`int8_forward` under
`fused` / `fused_all`), per-block remat (`remat`) and the stacked weight
layout (`unstack_train: false`). `pallas` is refused: its attention
kernels have no gradient (nor has gtax's Pallas attention).

More than one process (one a card; gtax_torch.parallel.mesh) lays the
group out as `mesh_data` x `mesh_model`, rank = data index * model + model
index, as gtax's (data, model) mesh:

- Data-parallel (the data axis): each data index trains on
  config.batch_size rows of its own a micro-step (the loaders' stride),
  takes its rows of the global batch's loss draws from the shared
  training generator, and after the last micro-batch an all-reduce of
  each gradient over the data axis (gtax's psum) makes them the
  one-process gradients at the global batch before the clip and AdamW.
- Tensor-parallel (the model axis, `mesh_model` > 1): the model ranks of
  a data index see the same rows and draws; each holds its shards of the
  cut leaves (mesh.shard_params) and AdamW's masters and moments of them
  only (gtax's _place_state); dit_apply(tp=) runs the blocks over the
  axis, differentiably, under every training backend (module docstring
  of gtax_torch.models.dit). The replicated leaves' gradients agree
  across the axis; the norm that clips is the whole model's. A save
  gathers the shards, so its files equal a one-process run's; a resume
  cuts them to the resuming layout.

Rank 0's masters are broadcast at construction; rank 0 writes the export,
the state and the metrics records; step.json keeps every data index's
stream cursor.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from gtax_torch.core import schedules
from gtax_torch.core.constants import LATENT_SCALE
from gtax_torch.data.actions import forward_actions
from gtax_torch.data.loader import Batch, DataLoader, make_dataset, to_device
from gtax_torch.io import safetensors_port as port
from gtax_torch.kernels import block
from gtax_torch.models import dit as dit_mod
from gtax_torch.models import vae as vae_mod
from gtax_torch.models.vae import vae_decode, vae_encode
from gtax_torch.parallel import mesh as meshlib
from gtax_torch.sampling.diffusion import (LossConfig, SamplerConfig,
                                           diffusion_forcing_loss,
                                           draw_loss_noise, make_rollout,
                                           renoise_last_frame)
from gtax_torch.train import checkpoint as ckpt
from gtax_torch.train.config import TrainingConfig
from gtax_torch.train.optim import decays, leaves, make_optimizer
from gtax_torch.utils.platform import resolve_device
from gtax_torch.utils.profiling import MFUCounter, dit_forward_flops, trace

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

# the attention backends a trainer can take a gradient through
TRAIN_BACKENDS = ("xla", "fused", "fused_mlp", "fused_all")


def check_slice(config: TrainingConfig) -> None:
    """Raise ValueError for a configuration that cannot train (the `pallas`
    backend; int8_forward off the fused backends, as gtax asserts; a mesh
    that does not fill the process group)."""
    backend = config.attention_backend
    if backend == "pallas":
        raise ValueError(
            "attention_backend 'pallas' cannot train: its attention kernels "
            "are forward-only, and gtax's Pallas attention has no gradient "
            "either (jax.grad through it fails); take 'xla', 'fused', "
            "'fused_mlp' or 'fused_all'")
    if backend not in TRAIN_BACKENDS:
        raise ValueError(f"attention_backend {backend!r}: one of "
                         f"{TRAIN_BACKENDS}")
    if config.int8_forward and backend not in ("fused", "fused_all"):
        raise ValueError("int8_forward runs through the fused trainable "
                         "kernels: attention_backend 'fused' or "
                         f"'fused_all', not {backend!r}")
    meshlib.MeshConfig(config.mesh_data, config.mesh_model).resolve(
        meshlib.world_size())


def check_compute_dtype(dtype, device_type: str) -> None:
    """The compute dtypes the card trains in: bf16 and fp32, the dtypes of
    the training kernels (the emit_train forwards of #1-#3 and #7-#9, the
    backwards #12-#14, each with its fp32 form); any float dtype trains
    on the CPU, through the plain versions."""
    if device_type == "cuda" and dtype not in block.KERNEL_DTYPES:
        raise ValueError(
            f"compute_dtype {dtype} on the card: the training kernels take "
            "bfloat16 or float32")


class Trainer:
    """Diffusion-forcing DiT training with a frozen VAE (gtax Trainer): AdamW
    with warmup and cosine decay to min_lr, gradient accumulation, evals,
    checkpoints and resume, deferred metrics.

    The step runs eagerly: per micro-batch the frozen VAE encodes under
    torch.no_grad(), the loss runs forward and backward through the fused
    branches and their backward kernels, gradients accumulate in the fp32
    masters' .grad; then they are divided by the accumulation count, clipped
    and applied, all on the card without a host read. train_step returns the
    PREVIOUS step's metrics, so the host prepares and enqueues step N+1
    while the card runs step N. In a process group the trainer is
    data- and tensor-parallel over it (module docstring): `mesh` is its
    layout, `world` and `rank` its data axis, `tp` its model axis (None
    with one model rank), `is_main` whether it writes the files."""

    def __init__(self, config: TrainingConfig, total_dataset_size: int,
                 dit_cfg=None, vae_cfg=None, dit_params=None, vae_params=None,
                 device=None):
        check_slice(config)
        self.config = config
        self.mesh = meshlib.make_mesh(meshlib.MeshConfig(config.mesh_data,
                                                         config.mesh_model))
        self.world, self.rank = self.mesh.data.size, self.mesh.data.index
        self.tp = self.mesh.model if self.mesh.model.size > 1 else None
        self.is_main = meshlib.process_index() == 0
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, config.compute_dtype)
        check_compute_dtype(self.compute_dtype, self.device.type)
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)

        self.dit_cfg = dit_cfg or dit_mod.DiT_MODELS[config.dit_model]()
        if config.remat and not self.dit_cfg.block_remat:
            self.dit_cfg = dataclasses.replace(self.dit_cfg,
                                               block_remat=True)
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
        # the layout of unstack_train: per-block leaves, or stacked
        # (depth, ...) leaves that AdamW updates as they are
        params = (dit_mod.unstack_for_inference(params, self.dit_cfg)
                  if config.unstack_train
                  else dit_mod.restack_params(params, self.dit_cfg))
        # fp32 masters of the trainer's own (the caller's tensors are not
        # updated in place)
        self.dit_params = dit_mod._map_params(
            params, lambda _, a: a.detach().to(self.device, torch.float32,
                                                copy=True))
        for _, p in leaves(self.dit_params):
            self.mesh.broadcast(p.data)  # rank 0's init or file
        # this rank's shards (the tree itself with one model rank)
        self.dit_params = meshlib.shard_params(self.dit_params, self.mesh)
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
            config.batch_size * self.world
            * config.gradient_accumulation_steps)
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
            mu_dtype=torch.bfloat16 if config.mu_bf16 else None,
            model_axis=self.tp,
            cut=[self.tp is not None
                 and meshlib.spec_dim(path, p.dim()) is not None
                 for path, p in leaves(self.dit_params)])

        _, abar, noise_range, stabilization = (
            schedules.make_diffusion_constants(config.ddim_noise_steps))
        self.alphas_cumprod = abar.to(self.device)
        self.noise_range = noise_range.to(self.device)
        self.loss_cfg = LossConfig(
            ddim_noise_steps=config.ddim_noise_steps,
            ctx_max_noise_idx=config.ctx_max_noise_idx,
            noise_abs_max=config.noise_abs_max,
            n_prompt_frames=config.n_prompt_frames,
            max_frames=self.max_frames)
        # the evals' sampler (gtax: ddim_noise_steps_inference steps,
        # stabilization at the training range's first level)
        self.sampler_cfg = SamplerConfig(
            ddim_noise_steps=config.ddim_noise_steps_inference,
            stabilization_level=stabilization,
            noise_abs_max=config.noise_abs_max, schedule_clamp_min=1e-6)

        self.global_step = 0
        self.start_epoch = 0
        self.skip_batches = 0  # set by try_resume
        self.wandb_run_id = None  # kept in step.json across restarts
        self.train_dataset = None  # the training loader's (its cursor)
        flops = 3.0 * dit_forward_flops(  # forward + backward ~ 3x forward
            self.dit_cfg, config.batch_size * self.world
            * config.gradient_accumulation_steps,
            self.max_frames) * max(1, 5 - config.n_prompt_frames)
        self.mfu = None
        if self.device.type == "cuda":  # the global step over every card
            self.mfu = MFUCounter(flops, meshlib.world_size()
                                  * MFUCounter.peak_for_kind(
                                      torch.cuda.get_device_name(self.device)))
        self._inflight = None  # (device metrics, entry time, lr)
        # the int8 forward's weights of the step being dispatched
        self._int8_weights = None

    # --------------------------------------------------------- the step

    def encode(self, video):
        """The frozen VAE's latents of (B, T, 3, H, W) pixels, without
        gradient, as gtax's trainer encodes them: the unfused VAE blocks
        under the trainer's attention backend (gtax/train/trainer.py:312)."""
        with torch.no_grad():
            return encode_frames(self.vae_params, self.vae_cfg, video,
                                 self.compute_dtype,
                                 backend=self.config.attention_backend)

    def dit_fn(self, params, x, t, actions, valid):
        """The DiT forward the trainer and its evals run: the compute dtype,
        attention backend and int8 forward of the config (the evals' int8
        forward quantizes the weights itself)."""
        return dit_mod.dit_apply(params, self.dit_cfg, x, t, actions, valid,
                                 compute_dtype=self.compute_dtype,
                                 backend=self.config.attention_backend,
                                 int8_fwd=self.config.int8_forward,
                                 int8_weights=self._int8_weights, tp=self.tp)

    def loss(self, params, video, actions, generator, is_latents=False,
             global_draws=False):
        """(mean_loss, sum_loss) of one micro-batch: frozen-VAE encode of
        the pixels (unless they are latent-cache latents already), then the
        diffusion-forcing loss through the DiT. global_draws (the training
        step's): on more than one rank, this rank's rows of the global
        batch's draws (rank_draws); one rank draws its batch's own, the
        same values."""
        latents = video if is_latents else self.encode(video)
        kw = {}
        if global_draws and self.world > 1:
            kw["draws"] = self.rank_draws(latents, generator)
        return diffusion_forcing_loss(
            lambda x, t, a, v: self.dit_fn(params, x, t, a, v), latents,
            actions, generator, self.loss_cfg, self.alphas_cumprod,
            self.noise_range, **kw)

    def rank_draws(self, latents, generator):
        """The loss draws of the global batch (world x this rank's rows),
        from the shared generator, cut to this rank's rows: the draws gtax
        takes over its global array, and every rank's generator stays the
        same."""
        B = latents.shape[0]
        draws = draw_loss_noise(latents, self.loss_cfg, generator,
                                batch=B * self.world)
        rows = slice(self.rank * B, (self.rank + 1) * B)
        return {k: v[:, rows] for k, v in draws.items()}

    def _dispatch(self, batch: Batch):
        """Enqueue one optimizer step over the batch's micro-batches
        (leading axis of batch.video); returns device metrics."""
        accum = self.config.gradient_accumulation_steps
        params = [p for _, p in leaves(self.dit_params)]
        for p in params:
            p.grad = None
        if self.config.int8_forward and self.tp is None:
            # once a step: bit-equal a micro-step (under tp each gathered
            # block quantizes itself: a shard's scales are not the
            # whole kernel's)
            self._int8_weights = dit_mod.quantize_train_weights(
                self.dit_params, self.compute_dtype)
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            acts = None if batch.actions is None else batch.actions[i]
            mean_loss, sum_loss = self.loss(self.dit_params, batch.video[i],
                                            acts, self.generator,
                                            batch.is_latents,
                                            global_draws=True)
            sum_loss.backward()
            loss_sum = loss_sum + mean_loss.detach()
        self._int8_weights = None
        # gtax's psum: each data index's gradient is the mean over its
        # rows, so the sum over the data axis / world is the global
        # batch's (the model ranks' copies of a replicated leaf agree)
        meshlib.all_reduce_grads([p.grad for p in params
                                  if p.grad is not None], self.mesh.data)
        self.mesh.data.all_reduce(loss_sum)
        scale = accum * self.world
        grads = [None if p.grad is None else p.grad / scale for p in params]
        norm = self.optimizer.step(grads)
        return {"train_loss": loss_sum / scale, "grad_norm": norm}

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

    def iter_device_batches(self, loader, skip: int = 0):
        """Groups of gradient_accumulation_steps loader batches, stacked on
        a leading axis and copied to the device; the first `skip` groups
        are dropped on the host (a resumed epoch's trained batches)."""
        accum = self.config.gradient_accumulation_steps
        vids, acts = [], []
        for b in loader:
            vids.append(b.video)
            acts.append(b.actions)
            if len(vids) < accum:
                continue
            if skip > 0:
                skip -= 1
            else:
                yield Batch(
                    video=to_device(np.stack(vids), self.device),
                    actions=(None if acts[0] is None else
                             to_device(np.stack(acts), self.device)),
                    is_latents=b.is_latents)
            vids, acts = [], []

    def training_loop(self, train_loader, val_loader, callbacks=None):
        """The main loop (gtax training_loop): resume, epochs over the
        loader until max_steps, validation every validation_steps, the
        weight export and full checkpoint every save_every steps, and the
        profile_dir trace over steps restart+3 .. restart+12, closed and
        written however the loop ends. Every step's record is logged and
        passed to each callback exactly once, in step order, labelled with
        its step (`metrics["step"]`, 1-based: the step count after it); a
        save or a validation first flushes the step in flight, so the
        records stay in order and the saved state is final (gtax delivered
        two steps out of order there, and left its trace open when the run
        ended inside the window; ADVICE.md)."""
        cfg = self.config
        callbacks = callbacks or []
        self.train_dataset = getattr(train_loader, "dataset", None)
        if cfg.resume_from_checkpoint:
            self.try_resume()
        self._init_wandb()
        if self.global_step == 0:
            self.run_validation(val_loader)
        if hasattr(train_loader, "set_epoch"):
            # the replayed epoch reshuffles as the interrupted run did
            train_loader.set_epoch(self.start_epoch)
        trace_from = self.global_step + 3 if cfg.profile_dir else None

        def deliver(metrics, epoch, force_log=False):
            if metrics is None:
                return
            if force_log or metrics["step"] % cfg.logging_steps == 0:
                self.log_metrics(metrics, epoch, step=metrics["step"])
            for cb in callbacks:
                cb(self, metrics)

        skip = self.skip_batches
        with contextlib.ExitStack() as window:
            for epoch in range(self.start_epoch, cfg.num_epochs):
                for batch in self.iter_device_batches(train_loader, skip):
                    if cfg.max_steps > 0 and self.global_step >= cfg.max_steps:
                        deliver(self._flush_labelled(), epoch, force_log=True)
                        logger.info("Reached max_steps=%d", cfg.max_steps)
                        return
                    if self.global_step == 0:
                        self._step0_diagnostics(batch)
                    if self.global_step == trace_from:
                        window.enter_context(trace(
                            cfg.profile_dir, f"trace_step_{trace_from}.json"))
                    deliver(self._step_labelled(batch), epoch)
                    if trace_from is not None and (
                            self.global_step == trace_from + 10):
                        window.close()
                    want_val = (cfg.validation_steps > 0 and
                                self.global_step % cfg.validation_steps == 0)
                    want_save = (cfg.save_every > 0 and
                                 self.global_step % cfg.save_every == 0)
                    if want_val or want_save:
                        deliver(self._flush_labelled(), epoch)
                    if want_val:
                        self.run_validation(val_loader)
                    if want_save:
                        self.save_model(epoch)
                        self.save_checkpoint(epoch)
                skip = 0
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

    # ------------------------------------------------------ checkpointing

    def save_model(self, epoch: int) -> str:
        """The weight-only export: the masters as the reference's fp32
        safetensors, <output_dir>/<model_name>_epoch_<epoch+1>_<step>
        .safetensors (gtax save_model), keyed by blocks.{i} in either
        layout (nothing restacked). Written by rank 0; returns its path."""
        path = os.path.join(
            self.config.output_dir, f"{self.config.model_name}_epoch_"
            f"{epoch + 1}_{self.global_step}.safetensors")
        params = meshlib.gather_params(self.dit_params, self.mesh)
        if not self.is_main:
            return path
        os.makedirs(self.config.output_dir, exist_ok=True)
        port.save_dit(path, params, self.dit_cfg)
        logger.warning("Saved checkpoint to %s", path)
        return path

    def _layout(self) -> str:
        return "stacked" if dit_mod.is_stacked(self.dit_params) else (
            "unstacked")

    def _ckpt_dir(self) -> str:
        return ckpt.ckpt_dir(self.config.output_dir, self.config.model_name)

    def _whole_state(self):
        """(masters, optimizer state_dict) whole: under tensor parallelism
        the shards gathered over the model axis (collective), so the files
        equal a one-process run's."""
        if self.tp is None:
            return self.dit_params, self.optimizer
        opt = self.optimizer.state_dict()
        for name in ("mu", "nu"):
            opt[name] = {k: meshlib.gather_leaf(path, v, self.tp)
                         for path, (k, v) in zip(self.optimizer.paths,
                                                 opt[name].items())}
        return meshlib.gather_params(self.dit_params, self.mesh), opt

    def save_checkpoint(self, epoch: int) -> int:
        """The full state (masters, optimizer moments and count, the
        training generator, global_step) into state_<step>, then step.json
        (step, epoch, time, the wandb run id, the stream cursor: on more
        than one data index every index's, `data_cursors` in index order),
        then the superseded states pruned. Rank 0 writes (the state is the
        same on every rank; tensor-parallel shards are gathered first) and
        every rank waits for it. Returns the state's bytes (0 on the other
        ranks)."""
        cursor = getattr(self.train_dataset, "cursor", None)
        cursors = self.mesh.data.gather_objects(
            None if cursor is None else list(cursor))
        params, opt = self._whole_state()
        n = 0
        if self.is_main:
            path = self._ckpt_dir()
            os.makedirs(path, exist_ok=True)
            name = f"state_{self.global_step}"
            n = ckpt.write_state(os.path.join(path, name), params, opt,
                                 self.generator, self.global_step,
                                 self._layout())
            meta = {"step": self.global_step, "epoch": epoch,
                    "time": time.time()}
            if self.wandb_run_id is not None:
                meta["wandb_run_id"] = self.wandb_run_id
            if cursor is not None and self.world == 1:
                meta["data_cursor"] = cursors[0]
            elif cursor is not None:
                meta["data_cursors"] = cursors
            ckpt.write_json(os.path.join(path, ckpt.STEP), meta)
            ckpt.prune(path, keep=name)
            logger.warning("Saved checkpoint for step %d (%d bytes)",
                           self.global_step, n)
        del params, opt
        self.mesh.barrier()
        return n

    def try_resume(self) -> bool:
        """Restore the masters (in place), the optimizer, the generator, the
        step, the epoch, the wandb run id and the data position from the
        last checkpoint, if there is one (gtax try_resume); every rank
        reads it. The position is the stream cursor when the training
        dataset has one, each rank's own (gtax set rank 0's on every rank,
        whose streams differ); otherwise the replayed epoch skips
        global_step % steps_per_epoch batches, and a state saved at an
        epoch's last step resumes at the next epoch (gtax replayed the
        finished epoch whole)."""
        path = self._ckpt_dir()
        meta_path = os.path.join(path, ckpt.STEP)
        if not os.path.exists(meta_path):
            logger.info("No checkpoint at %s; starting fresh", path)
            return False
        with open(meta_path) as f:
            meta = json.load(f)
        cut = None if self.tp is None else (
            lambda key, t: meshlib.cut_leaf(meshlib.key_path(key), t,
                                            self.tp))
        state = ckpt.read_state(os.path.join(path, f"state_{meta['step']}"),
                                self.dit_params, self.optimizer,
                                self.generator, self._layout(), cut)
        if state["global_step"] != meta["step"]:
            raise ValueError(f"{path}: step.json says step {meta['step']}, "
                             f"the state {state['global_step']}")
        self.global_step = meta["step"]
        self.start_epoch = meta["epoch"]
        self.wandb_run_id = meta.get("wandb_run_id")
        cursors = meta.get("data_cursors", (
            [meta["data_cursor"]] if "data_cursor" in meta else None))
        cursor_restored = (
            cursors is not None and hasattr(self.train_dataset, "cursor"))
        if cursor_restored:
            if len(cursors) != self.world:
                raise ValueError(
                    f"{path}: stream cursors of {len(cursors)} ranks; this "
                    f"run has {self.world} (each rank streams its own shards)")
            self.train_dataset.cursor = list(cursors[self.rank])
            self.skip_batches = 0
        else:
            self.skip_batches = self.global_step % max(1,
                                                       self.steps_per_epoch)
            if self.skip_batches == 0 and self.global_step > 0:
                self.start_epoch += 1
        logger.info("Resumed from epoch %d, step %d, skipping %d steps%s",
                    self.start_epoch + 1, self.global_step,
                    self.skip_batches,
                    " (stream cursor restored)" if cursor_restored else "")
        return True

    # -------------------------------------------------------------- evals

    def _eval_generator(self, tag: int):
        """Evals draw from their own generator keyed by (seed, step, tag):
        they never advance the training stream."""
        seed = hash((self.config.seed ^ 0x5EED, self.global_step, tag))
        return torch.Generator(device=self.device).manual_seed(
            seed & 0x7FFFFFFFFFFFFFFF)

    def run_validation(self, val_loader, max_batches: int | None = None):
        """Eval loss over the validation loader (the whole split unless
        validation_max_batches or max_batches caps it), then the rollout
        and renoise evals on its first pixel batch (gtax run_validation).
        A failed eval is logged; it never stops training."""
        if val_loader is None:
            return None
        if max_batches is None:
            max_batches = self.config.validation_max_batches
        losses, first = [], None
        with torch.no_grad():
            for i, b in enumerate(val_loader):
                if max_batches > 0 and i >= max_batches:
                    break
                if first is None:
                    first = b
                video = to_device(b.video, self.device)
                acts = (None if b.actions is None
                        else to_device(b.actions, self.device))
                mean_loss, _ = self.loss(self.dit_params, video, acts,
                                         self._eval_generator(i),
                                         b.is_latents)
                losses.append(float(mean_loss))
        avg = sum(losses) / max(1, len(losses))
        if self.world > 1:  # the mean over ranks (gtax :615-621)
            t = torch.tensor([avg], dtype=torch.float64, device=self.device)
            avg = float(self.mesh.data.all_reduce(t)) / self.world
        logger.info("val_loss=%.5f at step %d", avg, self.global_step)
        self.log_metrics({"val_loss": avg}, epoch=self.start_epoch)
        # the evals are data index 0's (its model ranks run them together;
        # rank 0 writes the files: every rank would write the same)
        if first is not None and not first.is_latents and self.rank == 0:
            try:
                self.predict(first)
                self.predict_noise(first)
            except Exception as e:  # evals never stop training
                logger.warning("predict eval failed: %r", e)
        return avg

    def _eval_actions(self, actions, num_frames=None):
        """The first clip's actions on the device (None without action
        conditioning), padded with "forward" to num_frames."""
        if not self.config.use_action_conditioning or actions is None:
            return None
        a = to_device(actions[:1], self.device).float()
        if num_frames is not None and a.shape[1] < num_frames:
            fill = forward_actions(1, num_frames - a.shape[1], a.shape[2])
            a = torch.cat([a, torch.from_numpy(fill).to(a.device)], dim=1)
        return a

    @torch.no_grad()
    def predict_frames(self, batch: Batch, num_frames: int = 32):
        """The rollout eval's frames (gtax predict without the file): the
        first clip's n_prompt_frames encoded, its actions padded with
        "forward", num_frames - n_prompt_frames frames rolled out by the
        exact sampler over the full window (ddim_noise_steps_inference
        steps; the eval generator), decoded. Returns (num_frames, H, W, 3)
        uint8 numpy."""
        video = to_device(batch.video[:1, :self.config.n_prompt_frames],
                          self.device)
        latents = self.encode(video)
        rollout = make_rollout(self.dit_fn, self.max_frames, self.sampler_cfg)
        lat = rollout(self.dit_params, latents,
                      self._eval_actions(batch.actions, num_frames),
                      self._eval_generator(101),
                      num_gen_frames=num_frames - latents.shape[1])
        pix = decode_frames(self.vae_params, self.vae_cfg, lat,
                            self.compute_dtype,
                            backend=self.config.attention_backend)
        return pix[0].cpu().numpy()

    def predict(self, batch: Batch, num_frames: int = 32) -> str:
        """predict_frames written as an mp4 to debug_visualizations/
        test_<model>_0_epoch_<e>_gs_<step>.mp4 (gtax predict); returns the
        path."""
        from gtax_torch.io.video import write_video

        frames = self.predict_frames(batch, num_frames)
        path = (f"debug_visualizations/test_{self.config.model_name}_0_epoch_"
                f"{self.start_epoch}_gs_{self.global_step}.mp4")
        if not self.is_main:
            return path
        os.makedirs("debug_visualizations", exist_ok=True)
        write_video(path, frames, fps=10)
        logger.info("generation saved to %s", path)
        return path

    @torch.no_grad()
    def predict_noise(self, batch: Batch):
        """The renoise eval (gtax predict_noise): the first clip's context
        noised at stabilization_level - 1, its last frame from pure noise
        denoised over the window, and the 5-row grid written to
        debug_visualizations/<model>_noise_gs_<step>.png (a failed grid is
        logged). Returns the denoised latents (1, T, C, h, w)."""
        latents = self.encode(to_device(batch.video[:1], self.device))
        abar, noise_range = self.sampler_cfg.tables()
        out = renoise_last_frame(
            lambda x, t, a, v: self.dit_fn(self.dit_params, x, t, a, v),
            latents, self._eval_actions(batch.actions),
            self._eval_generator(102), self.sampler_cfg, abar, noise_range)
        if not self.is_main:  # the grid is rank 0's file
            return out["denoised"]
        try:
            from gtax_torch.train.viz import visualize_step

            def decode(lat):
                return decode_frames(
                    self.vae_params, self.vae_cfg,
                    torch.from_numpy(lat).to(self.device),
                    self.compute_dtype,
                    backend=self.config.attention_backend).cpu().numpy()

            host = {k: v.float().cpu().numpy() for k, v in out.items()}
            visualize_step(
                x_curr=latents.cpu().numpy(), x_noisy=host["x_noisy"],
                noise=host["noise"], v=host["v"], pred=host["denoised"],
                step=self.global_step, decode_fn=decode,
                name=f"{self.config.model_name}_noise_gs_"
                     f"{self.global_step}.png")
        except Exception as e:
            logger.warning("visualization failed: %r", e)
        return out["denoised"]

    def _step0_diagnostics(self, batch: Batch):
        """The first training batch's tensor stats, each rank's own and
        labelled with its rank, and rank 0's renoise grid (gtax
        _step0_diagnostics); never stops training."""
        try:
            for name, arr in (("video", batch.video),
                              ("actions", batch.actions)):
                if arr is None:
                    logger.info("[rank %d] step0 %s: None", self.rank, name)
                    continue
                a = arr.float()
                logger.info("[rank %d] step0 %s: shape=%s dtype=%s min=%.4f "
                            "max=%.4f mean=%.4f std=%.4f", self.rank, name,
                            tuple(arr.shape), arr.dtype, a.min().item(),
                            a.max().item(), a.mean().item(), a.std().item())
        except Exception as e:
            logger.warning("step0 tensor-stat dump failed: %r", e)
        if batch.is_latents or self.rank > 0:
            return  # the grid decodes pixels, into rank 0's file
        try:  # the first micro-batch of the accumulation axis
            self.predict_noise(Batch(
                batch.video[0],
                None if batch.actions is None else batch.actions[0]))
        except Exception as e:
            logger.warning("step0 visualization failed: %r", e)

    # ----------------------------------------------------------- logging

    def _init_wandb(self):
        """wandb.init with the run id from step.json, so a resumed run
        logs into the same wandb run (gtax _init_wandb); rank 0's."""
        if not self.config.use_wandb or not self.is_main:
            return
        try:
            import wandb
        except ImportError:
            logger.info("wandb unavailable; metrics go to JSONL only")
            return
        run = wandb.run or wandb.init(
            project="diffusion-transformer", config=self.config.to_dict(),
            id=self.wandb_run_id,
            resume="allow" if self.wandb_run_id else None)
        self.wandb_run_id = run.id

    def log_metrics(self, metrics: dict, epoch: int, step: int | None = None):
        """Log a record and append it to <output_dir>/<model>_metrics.jsonl
        (and to the wandb run, when one is open): the file and wandb are
        rank 0's, one record a step (gtax appended on every process)."""
        step = self.global_step if step is None else step
        record = {"step": step, "epoch": epoch,
                  "wall_time": round(time.time(), 3), **metrics}
        logger.info("step %d | %s", step, " ".join(
            f"{k}={v:.5g}" for k, v in metrics.items()
            if isinstance(v, (int, float)) and k != "step"))
        if not self.is_main:
            return
        if self.config.use_wandb:
            try:
                import wandb

                if wandb.run is not None:
                    wandb.log(record)
            except ImportError:
                pass
        os.makedirs(self.config.output_dir, exist_ok=True)
        path = os.path.join(self.config.output_dir,
                            f"{self.config.model_name}_metrics.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")


def build_loaders(config: TrainingConfig, **dataset_kw):
    """(train_loader, val_loader) for the configured dataset, as gtax's
    build_loaders wires them: dummy frames take the VAE's input geometry;
    the tar streamer defaults to uint8 clips (pixel_u8), a decode pool
    sized to the host and, for a VAE that is not 360x640, a resize to its
    geometry, and its validation split is one unshuffled pass (not
    resampled, no shuffle buffer) so that a validation ends. `shards`,
    `size`, `val_shards` and `val_size` are the splits' own: validation
    takes val_shards / val_size. In a process group each rank reads only
    its part: map-style datasets a stride of one permutation, the tar
    streamer its shards (worker_index = rank of num_workers = world), both
    splits; its batches are config.batch_size rows (gtax's batch_size x
    local_device_count, one card a process). "Rank" and "world" here are
    the data axis's index and size: the model ranks of a data index read
    the same rows."""
    rank, world = meshlib.data_position(
        meshlib.MeshConfig(config.mesh_data, config.mesh_model))
    vae_cfg = vae_mod.VAE_MODELS[config.vae_model]()
    if config.dataset_type == "dummy":
        dataset_kw.setdefault("height", vae_cfg.input_height)
        dataset_kw.setdefault("width", vae_cfg.input_width)
    elif config.dataset_type == "webdataset":
        dataset_kw.setdefault("pixel_u8", True)
        dataset_kw.setdefault("decode_workers", min(os.cpu_count() or 1, 16))
        if (vae_cfg.input_height, vae_cfg.input_width) != (360, 640):
            from gtax_torch.data.common import ClipTransform

            dataset_kw.setdefault("transform", ClipTransform(
                target_h=vae_cfg.input_height, target_w=vae_cfg.input_width))
        if world > 1:
            dataset_kw.setdefault("worker_index", rank)
            dataset_kw.setdefault("num_workers", world)
    split_only = ("shards", "size", "val_shards", "val_size")
    val_kw = {k: v for k, v in dataset_kw.items() if k not in split_only}
    if config.dataset_type == "webdataset":
        val_kw.setdefault("resampled", False)
        val_kw.setdefault("shuffle_shards", False)
        val_kw.setdefault("shuffle_buffer", 1)
    if "val_shards" in dataset_kw:
        val_kw["shards"] = dataset_kw.pop("val_shards")
    if "val_size" in dataset_kw:
        val_kw["size"] = dataset_kw.pop("val_size")
    if "shards" in dataset_kw and "shards" not in val_kw:
        logger.warning("custom train shards without val_shards: validation "
                       "falls back to the registry 'validation' split")
    train_ds = make_dataset(config.dataset_type, "train",
                            config.use_action_conditioning, **dataset_kw)
    val_ds = make_dataset(config.dataset_type, "validation",
                          config.use_action_conditioning, **val_kw)
    cpus = os.cpu_count() or 1
    return (DataLoader(train_ds, config.batch_size,
                       num_workers=min(cpus, 32), seed=config.seed,
                       rank=rank, world=world),
            DataLoader(val_ds, config.validation_batch_size,
                       num_workers=min(cpus, 8), seed=config.seed,
                       shuffle=False, rank=rank, world=world))
