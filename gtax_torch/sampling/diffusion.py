"""Diffusion-forcing sampler, exact path (counterpart of
gtax/sampling/diffusion.py).

gtax runs the frames x noise-steps loop nest as nested lax.scans over a
FIXED max_frames-slot window; here both loops are Python loops over the
same fixed window. Growing contexts (fewer prompt frames than
max_frames - 1) left-pad the window with zeros and mask the padded slots
out of temporal attention with `valid`.

The per-step DDIM coefficients are fp32 numbers computed on the host with
numpy float32 arithmetic (the same fp32 sqrt and division XLA runs), so the
card never waits on the host and the host never waits on the card inside
a frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gtax_torch.core import schedules
from gtax_torch.core.constants import MAX_NOISE_LEVEL, NOISE_ABS_MAX


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    ddim_noise_steps: int = 100
    stabilization_level: int = 15
    noise_abs_max: float = NOISE_ABS_MAX
    max_noise_level: int = MAX_NOISE_LEVEL
    schedule_clamp_min: float = 1e-4  # generate default; trainer uses 1e-6

    def tables(self):
        """(alphas_cumprod float32 numpy, noise_range int numpy)."""
        betas = schedules.sigmoid_beta_schedule(
            self.max_noise_level, clamp_min=self.schedule_clamp_min)
        abar = schedules.alphas_cumprod_from_betas(betas)
        noise_range = schedules.ddim_noise_range(self.ddim_noise_steps,
                                                 self.max_noise_level)
        return abar.numpy(), noise_range.numpy()


def _coefs(alpha, alpha_next):
    """fp32 DDIM coefficients (any broadcastable numpy float32 arrays)."""
    one = np.float32(1.0)
    alpha = np.asarray(alpha, np.float32)
    alpha_next = np.asarray(alpha_next, np.float32)
    return (np.sqrt(alpha), np.sqrt(one - alpha), np.sqrt(one / alpha),
            np.sqrt(one / alpha - one), np.sqrt(alpha_next),
            np.sqrt(one - alpha_next))


def _ddim_update(x, v, alpha, alpha_next, noise_idx: int):
    """DDIM v-prediction update in fp32: recover x_start and the implied
    noise from v, re-noise to alpha_next, or return x_start itself at the
    final step. alpha/alpha_next: numpy float32 scalars or arrays that
    broadcast against x. The single copy of the parity-critical math."""
    x32, v = x.float(), v.float()
    sa, s1a, sia, sia1, san, s1an = (
        c.item() if c.ndim == 0 else torch.from_numpy(c).to(x.device)
        for c in _coefs(alpha, alpha_next))
    x_start = sa * x32 - s1a * v
    if noise_idx <= 0:
        return x_start
    x_noise = (sia * x32 - x_start) / sia1
    return san * x_start + s1an * x_noise


def denoise_step(dit_fn, x, actions, valid, noise_idx: int,
                 stabilization_level: int, noise_range, alphas_cumprod):
    """One DDIM update of the window's last frame. x: (B, T, C, H, W)
    float32 window (context clean, last frame at noise_range[noise_idx]).
    Returns (x_pred, v_pred); the caller commits x_pred[:, -1:] only."""
    B, T = x.shape[:2]
    curr = int(noise_range[noise_idx])
    nxt = int(noise_range[max(noise_idx - 1, 0)])
    t = torch.full((B, T), stabilization_level, dtype=torch.int32)
    t[:, -1] = curr
    v = dit_fn(x, t.to(x.device), actions, valid).float()
    alpha = np.full((B, T), alphas_cumprod[stabilization_level], np.float32)
    alpha[:, -1] = alphas_cumprod[curr]
    # context frames are already clean: alpha_next = 1 for them
    alpha_next = np.ones((B, T), np.float32)
    alpha_next[:, -1] = alphas_cumprod[nxt]
    shape = (B, T, 1, 1, 1)
    return _ddim_update(x, v, alpha.reshape(shape),
                        alpha_next.reshape(shape), noise_idx), v


def _rows(tree, fn):
    """Apply fn to every tensor of a dit_cond output."""
    return {"blocks": [{k: fn(m) for k, m in b.items()}
                       for b in tree["blocks"]],
            "final": fn(tree["final"])}


def denoise_window(dit_fn, x, actions, valid, cfg: SamplerConfig,
                   alphas_cumprod, noise_range, cond=None, incremental=None):
    """Run the whole reversed noise-step loop on one window; returns
    (window with its last frame denoised, v-prediction of the final step).

    cond: optional (cond_fn, apply_fn) pair (params bound): all adaLN head
    outputs of the loop are computed up front — T-1 stabilization rows
    plus one last row per noise level — instead of once per step.
    cond_fn(t, a) -> mods; apply_fn(x, mods, valid) -> v.

    incremental: optional (prefill_fn, step_fn) pair (params bound;
    requires cond): the context rows are prefilled once (per-block temporal
    K/V cache) and each step runs the last frame only. The context rows'
    v is not computed in this mode and comes back as zeros."""
    if cond is None:
        if incremental is not None:
            raise ValueError("incremental decoding requires cond")
        v = torch.zeros_like(x)
        for noise_idx in range(cfg.ddim_noise_steps, -1, -1):
            x_pred, v = denoise_step(dit_fn, x, actions, valid, noise_idx,
                                     cfg.stabilization_level, noise_range,
                                     alphas_cumprod)
            x = torch.cat([x[:, :-1], x_pred[:, -1:]], dim=1)
        return x, v

    cond_fn, apply_fn = cond
    B, T = x.shape[:2]
    dev = x.device
    steps = cfg.ddim_noise_steps
    n_lv = steps + 1
    t_stab = torch.full((B, T), cfg.stabilization_level, dtype=torch.int32,
                        device=dev)
    mods_ctx = cond_fn(t_stab, actions)
    # last-row mods for every noise index in loop order (steps -> 0), as one
    # (steps+1)*B row batch
    idxs = list(range(steps, -1, -1))
    t_last = torch.from_numpy(
        np.repeat(noise_range[idxs].astype(np.int32), B)).reshape(
            n_lv * B, 1).to(dev)
    a_last = None
    if actions is not None:
        a_last = actions[None, :, -1:, :].expand(
            n_lv, B, 1, actions.shape[-1]).reshape(n_lv * B, 1, -1)
    mods_all = _rows(cond_fn(t_last, a_last),
                     lambda m: m.reshape((n_lv, B) + m.shape[1:]))

    if incremental is not None:
        prefill_fn, step_fn = incremental
        kv = prefill_fn(x[:, :-1], _rows(mods_ctx, lambda m: m[:, :-1]),
                        None if valid is None else valid[:-1])
        x_last = x[:, -1:]
        v_last = torch.zeros_like(x_last)
        for k, noise_idx in enumerate(idxs):
            v_last = step_fn(x_last, kv, _rows(mods_all, lambda m: m[k]),
                             valid).float()
            curr = int(noise_range[noise_idx])
            nxt = int(noise_range[max(noise_idx - 1, 0)])
            x_last = _ddim_update(x_last, v_last, alphas_cumprod[curr],
                                  alphas_cumprod[nxt], noise_idx)
        x = torch.cat([x[:, :-1], x_last], dim=1)
        v = torch.cat([torch.zeros_like(x[:, :-1]), v_last], dim=1)
        return x, v

    v = torch.zeros_like(x)
    for k, noise_idx in enumerate(idxs):
        mods = {"blocks": [{key: torch.cat([w[key][:, :-1], l[key][k]],
                                           dim=1)
                            for key in w}
                           for w, l in zip(mods_ctx["blocks"],
                                           mods_all["blocks"])],
                "final": torch.cat([mods_ctx["final"][:, :-1],
                                    mods_all["final"][k]], dim=1)}

        def call(xx, tt, aa, vv, mods=mods):
            return apply_fn(xx, mods, vv)

        x_pred, v = denoise_step(call, x, actions, valid, noise_idx,
                                 cfg.stabilization_level, noise_range,
                                 alphas_cumprod)
        x = torch.cat([x[:, :-1], x_pred[:, -1:]], dim=1)
    return x, v


def make_rollout(dit_fn, max_frames: int, cfg: SamplerConfig, cond=None,
                 incremental=None):
    """Build the autoregressive rollout.

    dit_fn(params, x, t, actions, valid) -> v. Returns
    rollout(params, prompt_latents, actions, generator, num_gen_frames,
    noise=None) -> (B, n_prompt + num_gen_frames, C, H, W) float32 latents.
    `noise`, if given, is a pre-drawn (B, num_gen_frames, C, H, W) tensor
    used for the fresh frames instead of `generator` — the hook that lets a
    test feed this port and gtax identical noise.

    cond / incremental: optional (cond_fn, apply_fn) and (prefill_fn,
    step_fn) pairs (gtax_torch.models.dit.make_cond_fns /
    make_incremental_fns), both reference-exact."""
    abar, noise_range = cfg.tables()
    W = max_frames

    def rollout(params, prompt_latents, actions, generator, num_gen_frames,
                noise=None):
        B, n_prompt, C, H, Wd = prompt_latents.shape
        if n_prompt < 1:
            raise ValueError("need at least one prompt frame")
        dev = prompt_latents.device
        prompt_latents = prompt_latents.float()
        n_ctx = min(n_prompt, W - 1)
        ctx = prompt_latents[:, n_prompt - n_ctx:]
        if n_ctx < W - 1:
            pad = torch.zeros((B, W - 1 - n_ctx, C, H, Wd), device=dev)
            ctx = torch.cat([pad, ctx], dim=1)
        actions_padded = None
        if actions is not None:
            A = actions.shape[-1]
            actions_padded = torch.cat(
                [torch.zeros((B, W - 1, A), dtype=actions.dtype, device=dev),
                 actions], dim=1)
        bound_dit = (lambda x, t, a, v: dit_fn(params, x, t, a, v))  # noqa
        bound_cond = bound_inc = None
        if cond is not None:
            bound_cond = (lambda t_, a_: cond[0](params, t_, a_),
                          lambda x_, m_, v_: cond[1](params, x_, m_, v_))
            if incremental is not None:
                bound_inc = (
                    lambda xc, mc, vc: incremental[0](params, xc, mc, vc),
                    lambda xl, kv, ml, vv: incremental[1](params, xl, kv, ml,
                                                          vv))
        frames = []
        for s in range(num_gen_frames):
            i = n_prompt + s  # absolute index of the frame being generated
            if noise is None:
                fresh = torch.randn((B, 1, C, H, Wd), generator=generator,
                                    device=dev).clamp(-cfg.noise_abs_max,
                                                      cfg.noise_abs_max)
            else:
                fresh = noise[:, s:s + 1].to(dev).float()
            window = torch.cat([ctx, fresh], dim=1)
            # slot j holds frame i - (W-1) + j; valid iff that index >= 0
            valid = torch.tensor([i - (W - 1) + j >= 0 for j in range(W)])
            awin = (None if actions_padded is None
                    else actions_padded[:, i:i + W])
            window, _ = denoise_window(bound_dit, window, awin, valid, cfg,
                                       abar, noise_range, cond=bound_cond,
                                       incremental=bound_inc)
            frames.append(window[:, -1:])
            ctx = torch.cat([ctx[:, 1:], window[:, -1:]], dim=1)
        return torch.cat([prompt_latents, *frames], dim=1)

    return rollout
