"""Diffusion-forcing sampler (counterpart of gtax/sampling/diffusion.py):
the exact rollout and its approximate serving modes (attention broadcast,
the pyramid-pipelined rollout), the renoise diagnostic and the loss.

gtax runs the frames x noise-steps loop nest as nested lax.scans over a
FIXED max_frames-slot window, jitted; here the frame loop is a Python loop
over the same fixed window, and each frame of the exact rollout is a
FramePlan's body: on the card one CUDA graph a frame (sampling/graphs.py,
gtax's jit), on the CPU the same body run eagerly. Growing contexts
(fewer prompt frames than max_frames - 1) left-pad the window with zeros
and mask the padded slots out of temporal attention with `valid`.

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
    # attention broadcast: recompute the DiT's attention branches every
    # K-th denoise step and reuse their cached residual deltas in between;
    # 1 = off (the exact scheme). The final noise_idx <= 0 step always
    # recomputes. Takes effect when the rollout is built with pab fns.
    attn_broadcast: int = 1

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


def _ddim_apply(x, v, coefs, final: bool):
    """DDIM v-prediction update in fp32 with _coefs' six factors (Python
    floats or tensors that broadcast against x): recover x_start and the
    implied noise from v, re-noise to alpha_next, or return x_start itself
    at the final step. The single copy of the parity-critical math."""
    x32, v = x.float(), v.float()
    sa, s1a, sia, sia1, san, s1an = coefs
    x_start = sa * x32 - s1a * v
    if final:
        return x_start
    x_noise = (sia * x32 - x_start) / sia1
    return san * x_start + s1an * x_noise


def _ddim_update(x, v, alpha, alpha_next, noise_idx: int):
    """_ddim_apply at alpha/alpha_next: numpy float32 scalars or arrays
    that broadcast against x (arrays copied to x's device)."""
    return _ddim_apply(x, v, tuple(
        c.item() if c.ndim == 0 else torch.from_numpy(c).to(x.device)
        for c in _coefs(alpha, alpha_next)), noise_idx <= 0)


def _window_alphas(alphas_cumprod, B, T, stabilization_level, curr, nxt):
    """(alpha, alpha_next) of a full-window step, (B, T, 1, 1, 1) float32:
    the context at the stabilization level and already clean (alpha_next
    1), the last frame from noise level curr to nxt."""
    alpha = np.full((B, T), alphas_cumprod[stabilization_level], np.float32)
    alpha[:, -1] = alphas_cumprod[curr]
    alpha_next = np.ones((B, T), np.float32)
    alpha_next[:, -1] = alphas_cumprod[nxt]
    shape = (B, T, 1, 1, 1)
    return alpha.reshape(shape), alpha_next.reshape(shape)


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
    return _ddim_update(x, v, *_window_alphas(
        alphas_cumprod, B, T, stabilization_level, curr, nxt),
        noise_idx), v


def _rows(tree, fn):
    """Apply fn to every tensor of a dit_cond output."""
    return {"blocks": [{k: fn(m) for k, m in b.items()}
                       for b in tree["blocks"]],
            "final": fn(tree["final"])}


def denoise_window(dit_fn, x, actions, valid, cfg: SamplerConfig,
                   alphas_cumprod, noise_range, cached=None):
    """Run the whole reversed noise-step loop on one window; returns
    (window with its last frame denoised, v-prediction of the final step).
    The loop of the renoise diagnostic and of attention broadcast; the
    exact rollout runs FramePlan.frame.

    cached: optional (collect_fn, reuse_fn, cache0) triple enabling
    attention broadcast when cfg.attn_broadcast > 1: collect_fn(x, t, a,
    valid) -> (v, cache); reuse_fn(x, t, a, valid, cache) -> v. Step k of
    the loop (noise index steps - k) recomputes when k % attn_broadcast ==
    0 or at the final index, and reuses the cache otherwise."""
    steps = cfg.ddim_noise_steps
    pick = None
    if cached is not None and cfg.attn_broadcast > 1:
        collect_fn, reuse_fn, cache0 = cached
        held = [cache0]

        def collect(xx, tt, aa, vv):
            v_, held[0] = collect_fn(xx, tt, aa, vv)
            return v_

        def reuse(xx, tt, aa, vv):
            return reuse_fn(xx, tt, aa, vv, held[0])

        def pick(k_iter, noise_idx):
            recompute = k_iter % cfg.attn_broadcast == 0 or noise_idx <= 0
            return collect if recompute else reuse

    v = torch.zeros_like(x)
    for k_iter in range(steps + 1):
        noise_idx = steps - k_iter
        fn = dit_fn if pick is None else pick(k_iter, noise_idx)
        x_pred, v = denoise_step(fn, x, actions, valid, noise_idx,
                                 cfg.stabilization_level, noise_range,
                                 alphas_cumprod)
        x = torch.cat([x[:, :-1], x_pred[:, -1:]], dim=1)
    return x, v


class FramePlan:
    """One generated frame of the exact rollout, for one (B, latent shape,
    slot validity, actions) and the rollout's bound functions: every
    per-step constant made once, on the device or as a Python float, and
    `frame`, the frame's body, which copies nothing from the host and waits
    on nothing, so a CUDA graph can capture it (sampling/graphs.py). On the
    CPU the same body runs eagerly on the plain versions.

    The three forms of make_rollout's exact rollout: incremental (cond and
    incremental: dit_cond's rows, dit_prefill of the context, then the
    last frame's steps, their DDIM factors Python floats); the full window
    with the conditioning cache (cond: the rows, then dit_apply with them);
    the full window without it (dit_fn with each step's timestep rows).
    Under the full window each step's (B, W) DDIM factors are views of one
    device array."""

    def __init__(self, fns, cfg: SamplerConfig, alphas_cumprod, noise_range,
                 B, W, valid, actions, device):
        self.dit_fn, self.cond, self.incremental = fns
        # a graph cache's family (sampling/graphs.py) and its member
        self.family, self.valid_key = (B, W, actions, str(device)), valid
        self.valid = torch.tensor(valid)
        self.valid_ctx = self.valid[:-1]
        steps = cfg.ddim_noise_steps
        idxs = np.arange(steps, -1, -1)  # loop order
        curr = noise_range[idxs]
        nxt = noise_range[np.maximum(idxs - 1, 0)]
        self.final = [int(i) <= 0 for i in idxs]
        if self.cond is not None:
            self.t_stab = torch.full((B, W), cfg.stabilization_level,
                                     dtype=torch.int32, device=device)
            # the last row's timestep at every noise index, as one
            # (steps+1)*B row batch
            self.t_last = torch.from_numpy(
                np.repeat(curr.astype(np.int32), B)).reshape(-1, 1).to(device)
        if self.incremental is not None:
            self.coefs = [tuple(c.item() for c in _coefs(
                alphas_cumprod[c_], alphas_cumprod[n_]))
                for c_, n_ in zip(curr, nxt)]
            return
        self.coefs = torch.from_numpy(np.stack([
            np.stack(_coefs(*_window_alphas(alphas_cumprod, B, W,
                                            cfg.stabilization_level, c_,
                                            n_)))
            for c_, n_ in zip(curr, nxt)])).to(device)
        t = np.full((steps + 1, B, W), cfg.stabilization_level, np.int32)
        t[:, :, -1] = curr[:, None]
        self.t = torch.from_numpy(t).to(device)

    def frame(self, params, ctx, fresh, awin):
        """ctx (B, W-1, C, H, W) and fresh (B, 1, C, H, W) float32, awin
        (B, W, A) or None -> the denoised last frame, (B, 1, C, H, W)
        float32."""
        x = torch.cat([ctx, fresh], dim=1)
        if self.cond is not None:
            cond_fn, apply_fn = self.cond
            n_lv = len(self.final)
            B = x.shape[0]
            mods_ctx = cond_fn(params, self.t_stab, awin)
            a_last = None
            if awin is not None:
                a_last = awin[None, :, -1:, :].expand(
                    n_lv, B, 1, awin.shape[-1]).reshape(n_lv * B, 1, -1)
            mods_all = _rows(cond_fn(params, self.t_last, a_last),
                             lambda m: m.reshape((n_lv, B) + m.shape[1:]))
        if self.incremental is not None:
            prefill_fn, step_fn = self.incremental
            kv = prefill_fn(params, x[:, :-1],
                            _rows(mods_ctx, lambda m: m[:, :-1]),
                            self.valid_ctx)
            x_last = x[:, -1:]
            for k, coefs in enumerate(self.coefs):
                v = step_fn(params, x_last, kv,
                            _rows(mods_all, lambda m: m[k]),
                            self.valid).float()
                x_last = _ddim_apply(x_last, v, coefs, self.final[k])
            return x_last
        for k, final in enumerate(self.final):
            if self.cond is not None:
                mods = {"blocks": [
                    {key: torch.cat([w[key][:, :-1], lr[key][k]], dim=1)
                     for key in w}
                    for w, lr in zip(mods_ctx["blocks"],
                                     mods_all["blocks"])],
                    "final": torch.cat([mods_ctx["final"][:, :-1],
                                        mods_all["final"][k]], dim=1)}
                v = apply_fn(params, x, mods, self.valid)
            else:
                v = self.dit_fn(params, x, self.t[k], awin, self.valid)
            x_pred = _ddim_apply(x, v.float(), self.coefs[k].unbind(0),
                                 final)
            x = torch.cat([x[:, :-1], x_pred[:, -1:]], dim=1)
        return x[:, -1:]


def make_rollout(dit_fn, max_frames: int, cfg: SamplerConfig, pab=None,
                 cond=None, incremental=None, graphs=None):
    """Build the autoregressive rollout.

    dit_fn(params, x, t, actions, valid) -> v. Returns
    rollout(params, prompt_latents, actions, generator, num_gen_frames,
    noise=None) -> (B, n_prompt + num_gen_frames, C, H, W) float32 latents.
    `noise`, if given, is a pre-drawn (B, num_gen_frames, C, H, W) tensor
    used for the fresh frames instead of `generator` — the hook that lets a
    test feed this port and gtax identical noise.

    pab: optional (collect_fn, reuse_fn, init_cache_fn) triple
    (gtax_torch.models.dit.make_pab_fns) enabling attention broadcast when
    cfg.attn_broadcast > 1: collect_fn(params, x, t, a, valid) -> (v,
    cache); reuse_fn(params, x, t, a, valid, cache) -> v;
    init_cache_fn(params, B, T) -> zero cache. cond and incremental are
    ignored while it is active.

    cond / incremental: optional (cond_fn, apply_fn) and (prefill_fn,
    step_fn) pairs (gtax_torch.models.dit.make_cond_fns /
    make_incremental_fns), both reference-exact; incremental requires
    cond.

    graphs: a sampling.graphs.FrameGraphs (gtax's jit of the rollout):
    on the card every frame of the exact rollout then runs as one CUDA
    graph of its FramePlan, captured at its plan's first frame (which runs
    eagerly as the capture's warm-up) and replayed after; on the CPU the
    frames run eagerly. rollout.eager is the same rollout with every frame
    run eagerly, rollout.graphs the cache."""
    abar, noise_range = cfg.tables()
    W = max_frames
    use_pab = pab is not None and cfg.attn_broadcast > 1
    if not use_pab and incremental is not None and cond is None:
        raise ValueError("incremental decoding requires cond")
    plans = {}

    def plan_for(B, valid, awin, device):
        actions = None if awin is None else (awin.shape[-1], awin.dtype)
        key = (B, valid, actions, str(device))
        if key not in plans:
            plans[key] = FramePlan((dit_fn, cond, incremental), cfg, abar,
                                   noise_range, B, W, valid, actions, device)
        return plans[key]

    def loop(run):
        def rollout(params, prompt_latents, actions, generator,
                    num_gen_frames, noise=None):
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
                    [torch.zeros((B, W - 1, A), dtype=actions.dtype,
                                 device=dev), actions], dim=1)
            frames = []
            for s in range(num_gen_frames):
                i = n_prompt + s  # absolute index of the frame generated
                if noise is None:
                    fresh = torch.randn((B, 1, C, H, Wd), generator=generator,
                                        device=dev).clamp(-cfg.noise_abs_max,
                                                          cfg.noise_abs_max)
                else:
                    fresh = noise[:, s:s + 1].to(dev).float()
                # slot j holds frame i - (W-1) + j; valid iff that index >= 0
                valid = tuple(i - (W - 1) + j >= 0 for j in range(W))
                awin = (None if actions_padded is None
                        else actions_padded[:, i:i + W])
                if use_pab:
                    cached = (
                        lambda x_, t_, a_, v_: pab[0](params, x_, t_, a_, v_),
                        lambda x_, t_, a_, v_, c_: pab[1](params, x_, t_, a_,
                                                          v_, c_),
                        pab[2](params, B, W))
                    window, _ = denoise_window(
                        lambda x_, t_, a_, v_: dit_fn(params, x_, t_, a_, v_),
                        torch.cat([ctx, fresh], dim=1), awin,
                        torch.tensor(valid), cfg, abar, noise_range,
                        cached=cached)
                    x_last = window[:, -1:]
                else:
                    x_last = run(plan_for(B, valid, awin, dev), params, ctx,
                                 fresh, awin)
                frames.append(x_last)
                ctx = torch.cat([ctx[:, 1:], x_last], dim=1)
            return torch.cat([prompt_latents, *frames], dim=1)

        return rollout

    def eager(plan, params, ctx, fresh, awin):
        return plan.frame(params, ctx, fresh, awin)

    def compiled(plan, params, ctx, fresh, awin):
        if ctx.device.type != "cuda":
            return plan.frame(params, ctx, fresh, awin)
        return graphs.run(plan, params, ctx, fresh, awin)

    rollout = loop(eager if graphs is None else compiled)
    rollout.eager = loop(eager)
    rollout.graphs = graphs
    return rollout


def renoise_last_frame(dit_fn, latents, actions, generator,
                       cfg: SamplerConfig, alphas_cumprod, noise_range,
                       ctx_noise=None, new_frame=None):
    """Eval diagnostic (gtax renoise_last_frame): noise the context at
    stabilization_level - 1, replace the last frame with pure noise and
    denoise it through the plain loop. latents: (B, T, C, H, W);
    alphas_cumprod / noise_range: cfg.tables(). ctx_noise (B, T-1, C, H, W)
    and new_frame (B, 1, C, H, W) are unclipped normal draws that replace
    the draws from `generator` (the hook that lets a test feed gtax's).
    Returns {"denoised", "x_noisy", "noise" (the clipped noise applied),
    "v" (the final step's v-prediction)}."""
    B, T, C, H, W = latents.shape
    dev = latents.device
    if ctx_noise is None:
        ctx_noise = torch.randn((B, T - 1, C, H, W), generator=generator,
                                device=dev)
    if new_frame is None:
        new_frame = torch.randn((B, 1, C, H, W), generator=generator,
                                device=dev)
    clip = cfg.noise_abs_max
    ctx_noise = ctx_noise.to(dev).float().clamp(-clip, clip)
    new_frame = new_frame.to(dev).float().clamp(-clip, clip)
    a = np.float32(alphas_cumprod[cfg.stabilization_level - 1])
    noisy_ctx = (float(np.sqrt(a)) * latents[:, :-1].float()
                 + float(np.sqrt(np.float32(1.0) - a)) * ctx_noise)
    x_noisy = torch.cat([noisy_ctx, new_frame], dim=1)
    denoised, v = denoise_window(dit_fn, x_noisy, actions, None, cfg,
                                 alphas_cumprod, noise_range)
    return {"denoised": denoised, "x_noisy": x_noisy,
            "noise": torch.cat([ctx_noise, new_frame], dim=1), "v": v}


def make_pipelined_rollout(dit_fn, max_frames: int, cfg: SamplerConfig,
                           pipeline_depth: int = 4, pab=None, cond=None,
                           incremental=None):
    """Pyramid-pipelined rollout (gtax make_pipelined_rollout): P =
    pipeline_depth frames are in flight at staggered noise levels, so each
    DiT call advances P frames by one DDIM step; every frame still runs the
    whole noise_steps + 1 trajectory, in stride = ceil((steps + 1) / P)
    calls a cycle. The window holds W - P clean context slots and the P
    in-flight slots; a cycle draws one fresh frame, runs `stride` calls
    and emits the oldest in-flight frame. P = 1 is the exact scheme.

    Warm-up cycles (the first P - 1, whose emitted frames are dropped) take
    their context slots from the prompt at the window's true frame
    positions; in-flight slots whose frame has not entered yet are masked
    out of temporal attention, and a slot whose raw noise index overshoots
    the schedule top idles at pure noise for that call.

    pab: make_rollout's triple; attention broadcast within each cycle when
    cfg.attn_broadcast > 1 (the cache resets every cycle; the first and
    last calls recompute). cond + incremental: make_rollout's pairs; each
    cycle prefills the context rows once and every call runs the P live
    rows (dit_apply_step with Tl = P), their adaLN rows computed in one
    cond batch a cycle. Incremental excludes pab.

    Returns rollout(params, prompt_latents, actions, generator,
    num_gen_frames, noise=None); `noise`, if given, is a pre-drawn
    (B, num_gen_frames + P - 1, C, H, W) tensor, one draw a cycle (frame s
    starts from draw s), used instead of `generator`."""
    abar, noise_range = cfg.tables()
    W, P = max_frames, pipeline_depth
    # at least one clean-context slot must remain
    if not 1 <= P <= W - 1:
        raise ValueError(f"pipeline_depth={P} must be in [1, {W - 1}] for "
                         f"a {W}-frame window")
    if incremental is not None and cond is None:
        raise ValueError("incremental pipelined decoding requires the "
                         "conditioning cache (cond)")
    use_pab = pab is not None and cfg.attn_broadcast > 1
    if incremental is not None and use_pab:
        raise ValueError("incremental pipelined decoding and attention "
                         "broadcast are mutually exclusive")
    steps, K = cfg.ddim_noise_steps, cfg.attn_broadcast
    stride = -(-(steps + 1) // P)  # calls per emitted frame
    n_ctx = W - P
    # inner call k runs at p = stride-1-k: slot j's raw noise index is
    # j * stride + p (host tables, the same every cycle)
    raw = (np.arange(P)[None, :] * stride
           + np.arange(stride - 1, -1, -1)[:, None])  # (stride, P)
    idxs = np.clip(raw, 0, steps)
    t_live = noise_range[idxs].astype(np.int32)
    coefs = np.stack(_coefs(abar[t_live],
                            abar[noise_range[np.clip(idxs - 1, 0, steps)]]),
                     axis=1)  # (stride, 6, P) fp32
    t_window = np.concatenate(
        [np.full((stride, n_ctx), cfg.stabilization_level, np.int32),
         t_live], axis=1)  # (stride, W)

    def rollout(params, prompt_latents, actions, generator, num_gen_frames,
                noise=None):
        B, n_prompt, C, H, Wd = prompt_latents.shape
        if n_prompt < 1:
            raise ValueError("need at least one prompt frame")
        dev = prompt_latents.device
        prompt_latents = prompt_latents.float()
        n_cycles = num_gen_frames + P - 1
        coef = torch.from_numpy(coefs).to(dev)[..., None, None, None]
        final = torch.from_numpy(idxs <= 0).to(dev)[..., None, None, None]
        # a slot past the schedule top has not started: it idles at noise
        started = torch.from_numpy(raw <= steps).to(dev)[..., None, None,
                                                         None]
        t_win = torch.from_numpy(t_window).to(dev)[:, None].expand(
            stride, B, W).contiguous()

        def zeros(n):
            return torch.zeros((B, n, C, H, Wd), device=dev)

        # clean-context carry after warm-up: the newest prompt frames
        n_fill = min(n_prompt, n_ctx)
        ctx = torch.cat([zeros(n_ctx - n_fill),
                         prompt_latents[:, n_prompt - n_fill:]], dim=1)
        ctx_valid = [False] * (n_ctx - n_fill) + [True] * n_fill
        # frame f of the prompt at index f + W, for the warm-up slices
        prompt_pad = torch.cat([zeros(W), prompt_latents, zeros(n_ctx)],
                               dim=1)
        actions_padded = None
        if actions is not None:
            A = actions.shape[-1]
            # front pad W-1; back pad P: frames in flight near the end
            # overshoot the action horizon (their outputs are dropped)
            actions_padded = torch.cat(
                [torch.zeros((B, W - 1, A), dtype=actions.dtype, device=dev),
                 actions,
                 torch.zeros((B, P, A), dtype=actions.dtype, device=dev)],
                dim=1)
        inflight = zeros(P)
        frames = []
        for c in range(n_cycles):
            if noise is None:
                fresh = torch.randn((B, 1, C, H, Wd), generator=generator,
                                    device=dev).clamp(-cfg.noise_abs_max,
                                                      cfg.noise_abs_max)
            else:
                fresh = noise[:, c:c + 1].to(dev).float()
            inflight = torch.cat([inflight[:, 1:], fresh], dim=1)
            # in-flight slot k holds a frame once it has entered (cycle
            # c - (P-1-k) >= 0); window slot j holds frame base + j
            active = [c - (P - 1 - k) >= 0 for k in range(P)]
            base = n_prompt + c - (P - 1) - n_ctx
            if c < P - 1:  # warm-up: the carry is not aligned to base yet
                ctx_win = prompt_pad[:, base + W:base + W + n_ctx]
                ctx_valid_win = [0 <= base + j < n_prompt
                                 for j in range(n_ctx)]
            else:
                ctx_win, ctx_valid_win = ctx, ctx_valid
            awin = (None if actions_padded is None
                    else actions_padded[:, base + W - 1:base + 2 * W - 1])
            valid = torch.tensor(ctx_valid_win + active)

            if incremental is not None:
                # the context rows are fixed for the cycle: prefill their
                # temporal K/V once; all live adaLN rows in one batch
                mods_ctx = cond[0](
                    params, torch.full((B, n_ctx), cfg.stabilization_level,
                                       dtype=torch.int32, device=dev),
                    None if awin is None else awin[:, :n_ctx])
                kv = incremental[0](params, ctx_win, mods_ctx, valid[:n_ctx])
                a_live = None
                if awin is not None:
                    a_live = awin[None, :, n_ctx:].expand(
                        stride, B, P, awin.shape[-1]).reshape(
                            stride * B, P, -1)
                mods_live = _rows(
                    cond[0](params, t_win[:, :, n_ctx:].reshape(
                        stride * B, P), a_live),
                    lambda m: m.reshape((stride, B) + m.shape[1:]))
            cache = pab[2](params, B, W) if use_pab else None
            for k in range(stride):
                if incremental is not None:
                    v = incremental[1](params, inflight, kv,
                                       _rows(mods_live, lambda m: m[k]),
                                       valid).float()
                else:
                    window = torch.cat([ctx_win, inflight], dim=1)
                    if not use_pab:
                        v = dit_fn(params, window, t_win[k], awin, valid)
                    elif k % K == 0 or k == stride - 1:
                        v, cache = pab[0](params, window, t_win[k], awin,
                                          valid)
                    else:
                        v = pab[1](params, window, t_win[k], awin, valid,
                                   cache)
                    v = v.float()[:, n_ctx:]
                # DDIM in fp32, gtax's pipelined form and rounding points
                sa, s1a, sia, sia1, san, s1an = coef[k].unbind(0)
                x_start = sa * inflight - s1a * v
                x_noise = (sia * inflight - x_start) / sia1
                x_pred = san * x_start + s1an * x_noise
                x_out = torch.where(final[k], x_start, x_pred)
                inflight = torch.where(started[k], x_out, inflight)
            if c >= P - 1:  # emitted frames become context once real
                frames.append(inflight[:, :1])
                ctx = torch.cat([ctx[:, 1:], inflight[:, :1]], dim=1)
                ctx_valid = ctx_valid[1:] + [True]
        return torch.cat([prompt_latents, *frames], dim=1)

    return rollout


# --------------------------------------------------------------- training loss


@dataclasses.dataclass(frozen=True)
class LossConfig:
    ddim_noise_steps: int = 50
    ctx_max_noise_idx: int = 40
    noise_abs_max: float = NOISE_ABS_MAX
    n_prompt_frames: int = 4
    max_frames: int = 5
    max_noise_level: int = MAX_NOISE_LEVEL


def draw_loss_noise(latents, cfg: LossConfig, generator, batch=None):
    """The random draws of diffusion_forcing_loss for a (B, T, C, H, W)
    clip, from `generator` (on the latents' device): per generated frame a
    target noise index in [1, ddim_noise_steps], a context index in
    [1, ctx_max_noise_idx] (unclipped), and unclipped normal noise for the
    window's context slots and last slot; each (n_gen, B, ...). batch:
    draw for that many clips instead of B (a data-parallel step's global
    batch, of which each rank keeps its rows)."""
    B, T, C, H, W = latents.shape
    B = B if batch is None else batch
    n_gen = T - cfg.n_prompt_frames
    Wn = cfg.max_frames
    dev = latents.device

    def ints(hi):
        return torch.randint(1, hi + 1, (n_gen, B), generator=generator,
                             device=dev)

    def normal(n):
        return torch.randn((n_gen, B, n, C, H, W), generator=generator,
                           device=dev)

    return {"target_idx": ints(cfg.ddim_noise_steps),
            "ctx_idx": ints(cfg.ctx_max_noise_idx),
            "ctx_noise": normal(Wn - 1), "last_noise": normal(1)}


def diffusion_forcing_loss(dit_fn, latents, actions, generator,
                           cfg: LossConfig, alphas_cumprod, noise_range,
                           draws=None):
    """Diffusion-forcing v-prediction loss over a clip (gtax
    diffusion_forcing_loss).

    latents: (B, T, C, H, W) float32 (VAE-encoded and scaled); actions:
    (B, T, A) or None; alphas_cumprod / noise_range: tensors on the latents'
    device. `draws` (draw_loss_noise's dict) replaces the draws from
    `generator`: the hook that lets a test feed gtax's own draws. Returns
    (mean_loss, sum_loss): the frame-mean the reference reports and the sum
    that gradients flow through.

    Per generated frame i: the window holds frames i-(W-1)..i, left
    zero-padded with `valid` False on the padded slots; the context index is
    clipped to the target index; context slots are noised at
    noise_range[ctx_idx], the last at noise_range[target_idx], the noise
    clipped to +-noise_abs_max; v-target = sqrt(a) eps - sqrt(1-a) x0; the
    MSE is taken on the last frame only."""
    B, T, C, H, W = latents.shape
    n_gen = T - cfg.n_prompt_frames
    if n_gen < 1:
        raise ValueError(f"clip of {T} frames has no frame after the "
                         f"{cfg.n_prompt_frames} prompt frames")
    Wn = cfg.max_frames
    if draws is None:
        draws = draw_loss_noise(latents, cfg, generator)
    target_idx = draws["target_idx"]
    ctx_idx = torch.minimum(draws["ctx_idx"], target_idx)

    if actions is not None:
        A = actions.shape[-1]
        actions_padded = torch.cat(
            [torch.zeros((B, Wn - 1, A), dtype=actions.dtype,
                         device=actions.device), actions], dim=1)

    total = torch.zeros((), device=latents.device)
    for idx, i in enumerate(range(cfg.n_prompt_frames, T)):
        lo = i - (Wn - 1)
        if lo < 0:
            pad = torch.zeros((B, -lo, C, H, W), dtype=latents.dtype,
                              device=latents.device)
            window = torch.cat([pad, latents[:, :i + 1]], dim=1)
        else:
            window = latents[:, lo:i + 1]
        valid = [lo + j >= 0 for j in range(Wn)]
        awin = (None if actions is None
                else actions_padded[:, lo + Wn - 1:lo + 2 * Wn - 1])

        t = torch.cat([noise_range[ctx_idx[idx]][:, None].expand(B, Wn - 1),
                       noise_range[target_idx[idx]][:, None]], dim=1).to(
                           torch.int32)
        clip = cfg.noise_abs_max
        ctx_noise = draws["ctx_noise"][idx].float().clamp(-clip, clip)
        last_noise = draws["last_noise"][idx].float().clamp(-clip, clip)
        a = alphas_cumprod[t.long()][:, :, None, None, None]
        a_ctx, a_tgt = a[:, :-1], a[:, -1:]
        noisy_ctx = (torch.sqrt(a_ctx) * window[:, :-1]
                     + torch.sqrt(1 - a_ctx) * ctx_noise)
        noisy_tgt = (torch.sqrt(a_tgt) * window[:, -1:]
                     + torch.sqrt(1 - a_tgt) * last_noise)
        x_noisy = torch.cat([noisy_ctx, noisy_tgt], dim=1)
        v_target = (torch.sqrt(a_tgt) * last_noise
                    - torch.sqrt(1 - a_tgt) * window[:, -1:])

        v_pred = dit_fn(x_noisy, t, awin, valid).float()
        total = total + torch.mean(torch.square(v_pred[:, -1:] - v_target))
    return total / n_gen, total
