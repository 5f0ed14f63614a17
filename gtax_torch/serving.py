"""Serving API: load checkpoints once, generate videos in one call
(counterpart of gtax/serving.py).

    from gtax_torch.serving import ServingConfig, VideoGenerator

    gen = VideoGenerator.load("dit.safetensors", "vit-l-20.safetensors")
    frames = gen.generate(prompt_frames, actions, num_frames=32, seed=0)
    # frames: (B, num_frames, H, W, 3) uint8 numpy

Defaults reproduce the reference sampling scheme exactly (stabilization 15,
window 5, DDIM over noise_steps + 1) on the fused kernels with the
conditioning cache and incremental decoding on. The generator runs on the
card (`cuda`, in bf16) unless the caller passes device="cpu".
dtype="float32" serves in fp32 as gtax does (the params are not cast):
on the card the fused kernels' fp32 forms under `fused` and `fused_all`
(fp32 FFMA GEMMs, no TF32), torch's fp32 products under `xla` and
`fused_mlp`, and under `pallas` the fp32 form of its attention kernels
(CUDA cores) between torch's fp32 products. fp32 with quantize="int8"
quantizes the fp32 params (gtax/serving.py:82-92) and runs the int8
kernels' fp32 forms: fp32 activations and K/V cache, int8 products summed
in int32.

quantize="int8" serves W8A8 params (quantize_for_inference, after the
cast) through the int8 kernels of gtax_torch.kernels.quant and, at one or
two live frames, the paired kernels of gtax_torch.kernels.pair. The
attention backend is gtax's: `fused` / `fused_all` run the fused branches
with incremental decoding and the fused VAE; `xla`, `pallas` and
`fused_mlp` roll out the full window (with the conditioning cache) through
the unfused branches of the backend and the unfused VAE, `pallas` on the
attention kernels of gtax_torch.kernels.attention. The backend belongs to
the generator: two generators with different backends do not touch each
other.

The approximate modes are gtax's, built as gtax/serving.py builds them:
attn_broadcast=K > 1 recomputes the attention branches every K-th denoise
step and reuses their cached residual deltas in between (full-window
steps, no conditioning cache); pipeline_depth=P > 1 runs the
pyramid-pipelined rollout (P frames in flight, ~P-fold fewer DiT calls a
frame), with the conditioning cache and incremental decoding composed in
under the fused backends when attention broadcast is off, and over the
full window otherwise. pipeline_depth must stay below the window
(max_frames), and generate(noise=) is a non-pipelined hook, as in gtax.

unstack=False keeps the params in the stacked layout, as gtax does: the
rollout is then the full-window one, with no conditioning cache and no
incremental decoding (gtax/serving.py:88-91, :133, :149).

More than one card (gtax_torch.parallel.mesh; one process a card, in an
initialized process group, as torchrun launches them):
mesh_data = N (the world size) is batched serving: every rank passes the
same global batch, whose size N divides, and encodes, rolls out and
decodes its own rows on its card on the single-card path (fused kernels,
conditioning cache, incremental decoding, bf16 or int8) with a generator
of its own (mesh.rank_seed), and returns those rows (gtax's multi-process
contract); generate(noise=) is refused there. mesh_model = N (the world
size) is tensor-parallel serving, as gtax's GSPMD path: bf16 or fp32 on
the `xla` backend (the backend is forced, int8 refused), the DiT blocks
cut by mesh.shard_params, the full-window rollout with no conditioning
cache; every rank returns the same pixels. The two together are refused,
as in gtax, and so is a mesh that does not fill the group (1x1 in a group
of two among them).

On one card the exact rollout is compiled, as gtax jits it: each
generated frame runs as one CUDA graph of its frame body, captured at the
first frame of its shape (batch, latent shape, valid slots, actions) and
replayed after (gtax_torch.sampling.graphs); on the CPU the same body runs
eagerly. No knob turns the graphs off, as none turns gtax's jit off.

aot_dir (gtax_torch.aot): the kernel library comes from an AOT cache in
that directory: the first process builds it with nvcc and saves it, later
ones load it and need no nvcc. prewarm() runs encode, rollout and decode
once on zeros in a background thread (gtax's prewarm), so a following
generate() finds the library loaded, the rollout's graph of that shape
captured and the card warm; generate() and prewarm serialise on the
generator's lock. On the CPU there is nothing to build: the directory is
made and prewarm still runs. Under mesh_model the cache is off, as gtax's
(its GSPMD path keeps the jit; the port's runs no kernel).

Options that run: quantize "none" or "int8", any pipeline_depth and
attn_broadcast gtax takes, every backend, either layout, mesh_data and
mesh_model as above, aot_dir.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from gtax_torch.io import safetensors_port as port
from gtax_torch.models import dit as dit_mod
from gtax_torch.models import vae as vae_mod
from gtax_torch.nn import attention as attn
from gtax_torch.parallel import mesh as meshlib
from gtax_torch.sampling.diffusion import (SamplerConfig,
                                           make_pipelined_rollout,
                                           make_rollout)
from gtax_torch.sampling.graphs import FrameGraphs
from gtax_torch.train.trainer import decode_frames, encode_frames
from gtax_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Serving knobs, the same fields as gtax's."""
    dtype: str = "bfloat16"
    attention_backend: str = "fused"   # xla | pallas | fused | fused_mlp
    #                                    | fused_all
    quantize: str = "none"
    unstack: bool = True
    cond_cache: bool = True            # bit-exact adaLN trajectory precompute
    incremental: bool = True           # context K/V prefill + last-frame steps
    pipeline_depth: int = 1
    attn_broadcast: int = 1
    noise_steps: int = 100
    mesh_data: int = 1
    mesh_model: int = 1
    # decode at most this many frames per VAE call (bounds decoder memory
    # for long rollouts; the same output either way — the VAE is per frame)
    decode_chunk: int | None = None
    aot_dir: str | None = None
    dit_model: str = "DiT-S/2"
    vae_model: str = "vit-l-20-shallow-encoder"


def _check_slice(cfg: ServingConfig, device_type: str = "cpu") -> None:
    """Refuse what the port does not serve, or not on `device_type`."""
    if cfg.quantize not in ("none", "int8"):
        raise NotImplementedError(
            f"ServingConfig.quantize={cfg.quantize!r} is not ported (only "
            "'none' and 'int8'); see ROADMAP.md")
    if cfg.mesh_model > 1 and cfg.mesh_data > 1:
        raise ValueError("mesh_model and mesh_data are mutually exclusive "
                         "serving modes")
    if cfg.mesh_model > 1 and cfg.quantize == "int8":
        raise ValueError("mesh_model: the int8 kernels are single-card; use "
                         "bf16 (the `xla` backend) for tensor-parallel "
                         "serving")
    # the mesh fills the process group: a 1x1 mesh in a group of N would
    # have every rank roll out the whole batch and write the same files
    meshlib.MeshConfig(cfg.mesh_data, cfg.mesh_model).resolve(
        meshlib.world_size())
    attn.check_backend(cfg.attention_backend)
    if cfg.dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype must be bfloat16 or float32, got "
                         f"{cfg.dtype!r}")


def _to(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device)


def build_rollout(dit_cfg, cfg: ServingConfig, dtype, tp=None):
    """The rollout a VideoGenerator with `cfg` runs, built as
    gtax/serving.py:105-160 builds it: attention broadcast when
    attn_broadcast > 1 (then no conditioning cache); otherwise, in the
    unstacked layout, the conditioning cache, with incremental decoding
    under the fused backends; the pipelined rollout when pipeline_depth > 1
    (the cache serves its incremental decoding only). tp: the model axis of
    tensor-parallel params (dit_apply's); the rollout is then the full
    window, with no conditioning cache, as gtax's under a model mesh. On
    one card in one process the exact rollout runs each frame as a CUDA
    graph (sampling/graphs.py, gtax's jit); the pipelined rollout,
    attention broadcast and the mesh rollouts run eagerly.
    Returns rollout(params, prompt_latents, actions, generator,
    num_gen_frames, noise=None)."""
    sampler = SamplerConfig(ddim_noise_steps=cfg.noise_steps,
                            stabilization_level=15, schedule_clamp_min=1e-4,
                            attn_broadcast=cfg.attn_broadcast)
    backend = cfg.attention_backend

    def dit_fn(params, x, t, a, valid):
        return dit_mod.dit_apply(params, dit_cfg, x, t, a, valid,
                                 compute_dtype=dtype, backend=backend, tp=tp)

    pab = cond = incremental = None
    if cfg.attn_broadcast > 1:
        pab = dit_mod.make_pab_fns(dit_cfg, dtype, backend, tp)
    elif (cfg.attn_broadcast == 1 and cfg.unstack and cfg.cond_cache
          and tp is None):
        cond = dit_mod.make_cond_fns(dit_cfg, dtype, backend)
        if cfg.incremental and backend in attn.FUSED_ATTENTION:
            incremental = dit_mod.make_incremental_fns(dit_cfg, dtype)
    if cfg.pipeline_depth > 1:
        return make_pipelined_rollout(
            dit_fn, dit_cfg.max_frames, sampler,
            pipeline_depth=cfg.pipeline_depth, pab=pab, cond=cond,
            incremental=incremental)
    graphs = None
    if tp is None and cfg.mesh_data == 1:
        graphs = FrameGraphs(dtype, cfg.quantize, backend, cfg.noise_steps)
    return make_rollout(dit_fn, dit_cfg.max_frames, sampler, pab=pab,
                        cond=cond, incremental=incremental, graphs=graphs)


class VideoGenerator:
    """Holds prepared params and the rollout (and, on more than one card,
    this rank's place in the mesh: `mesh`, None on one)."""

    def __init__(self, dit_params, vae_params, cfg: ServingConfig =
                 ServingConfig(), device=None):
        self.device = resolve_device(device)
        _check_slice(cfg, self.device.type)
        self.cfg = cfg
        self.dit_cfg = dit_mod.DiT_MODELS[cfg.dit_model]()
        self.vae_cfg = vae_mod.VAE_MODELS[cfg.vae_model]()
        dtype = getattr(torch, cfg.dtype)
        self._dtype = dtype
        dit_params = dit_mod.params_to(dit_params, self.device)
        vae_params = dit_mod.params_to(vae_params, self.device)
        if dtype != torch.float32:  # fp32 serves the params as they are
            dit_params = dit_mod.cast_params_for_inference(dit_params, dtype)
            vae_params = vae_mod.cast_params_for_inference(vae_params, dtype)
        dit_params = (dit_mod.unstack_for_inference(dit_params, self.dit_cfg)
                      if cfg.unstack
                      else dit_mod.restack_params(dit_params, self.dit_cfg))
        if cfg.quantize == "int8":
            dit_params = dit_mod.quantize_for_inference(dit_params)
        self.mesh, tp, run_cfg = None, None, cfg
        if cfg.mesh_data > 1 or cfg.mesh_model > 1:
            self.mesh = meshlib.make_mesh(meshlib.MeshConfig(
                data=cfg.mesh_data, model=cfg.mesh_model))
        if cfg.mesh_model > 1:
            # the fused kernels are single-card, as gtax's Pallas calls
            # are under GSPMD: the blocks' products go over the model axis
            tp = self.mesh.model
            run_cfg = dataclasses.replace(cfg, attention_backend="xla")
            dit_params = meshlib.shard_params(dit_params, self.mesh)
        self.dit_params = dit_params
        self.vae_params = vae_params

        # the fused VAE rides the fused backends only, as in gtax
        self._backend = run_cfg.attention_backend
        self._fused = self._backend in attn.FUSED_ATTENTION
        self._rollout = build_rollout(self.dit_cfg, run_cfg, dtype, tp)
        # the card runs one generate (or prewarm) at a time
        self._lock = threading.Lock()
        self._aot = None
        if cfg.aot_dir and cfg.mesh_model <= 1:
            from gtax_torch.aot import AotCache

            self._aot = AotCache(cfg.aot_dir)
            if self.device.type == "cuda":
                from gtax_torch.kernels import build

                build.use_cache(self._aot)  # loaded at the first launch
        # stage timings of the most recent generate() call, seconds
        self.last_timings = {}

    @classmethod
    def load(cls, dit_path: str, vae_path: str,
             cfg: ServingConfig = ServingConfig(), device=None):
        """Load reference-format safetensors checkpoints, or random weights
        for an empty path (seeded: DiT 0, VAE 1)."""
        dev = resolve_device(device)
        dit_cfg = dit_mod.DiT_MODELS[cfg.dit_model]()
        vae_cfg = vae_mod.VAE_MODELS[cfg.vae_model]()
        if dit_path:
            dit_params = port.load_dit(dit_path, dit_cfg)
        else:
            gen = torch.Generator(device=dev).manual_seed(0)
            dit_params = dit_mod.dit_init(dit_cfg, gen, dev)
        if vae_path:
            vae_params = port.load_vae(vae_path, vae_cfg)
        else:
            gen = torch.Generator(device=dev).manual_seed(1)
            vae_params = vae_mod.vae_init(vae_cfg, gen, dev)
        return cls(dit_params, vae_params, cfg, dev)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _decode(self, lat):
        """VAE-decode latents to uint8 pixels, in frame chunks when
        cfg.decode_chunk is set."""
        chunk = self.cfg.decode_chunk
        T = lat.shape[1]
        chunk = T if chunk is None else chunk
        return torch.cat([decode_frames(self.vae_params, self.vae_cfg,
                                        lat[:, i:i + chunk], self._dtype,
                                        self._fused, self._backend)
                          for i in range(0, T, chunk)], dim=1)

    def prewarm(self, num_frames: int = 32, batch_size: int = 1,
                n_prompt: int = 4, use_actions: bool = False,
                wait: bool = False):
        """Run encode -> rollout -> decode once on zeros for one generate()
        shape, in a daemon thread (gtax's prewarm): the kernel library is
        loaded (or built) from the AOT cache, the rollout's frame graph of
        that shape captured and the card warmed while the caller prepares
        its prompt. Records prewarm_start, then
        prewarm_done or prewarm_failed, in the cache's events; a failure
        never reaches the caller. wait=True joins the thread. Returns the
        thread, or None when aot_dir is unset (gtax's no-op)."""
        if self._aot is None:
            return None
        tag = f"B{batch_size}x{num_frames}"
        vc = self.vae_cfg

        def work():
            try:
                video = np.zeros((batch_size, n_prompt, 3, vc.input_height,
                                  vc.input_width), np.float32)
                acts = (np.zeros((batch_size, num_frames,
                                  self.dit_cfg.external_cond_dim),
                                 np.float32) if use_actions else None)
                with (torch.cuda.device(self.device)
                      if self.device.type == "cuda"
                      else contextlib.nullcontext()):
                    self.generate(video, acts, num_frames, seed=0)
                self._aot.events.append(("prewarm_done", tag))
            except Exception as e:  # never kill the caller from the thread
                self._aot.events.append(("prewarm_failed", repr(e)))

        self._aot.events.append(("prewarm_start", tag))
        t = threading.Thread(target=work, daemon=True,
                             name="gtax-aot-prewarm")
        t.start()
        if wait:
            t.join()
        return t

    def generate(self, prompt_frames, actions=None, num_frames: int = 32,
                 seed: int = 0, noise=None):
        """prompt_frames: (B, T0, 3, H, W) float in [0, 1] (or (T0, 3, H,
        W) for B=1); actions: (B, num_frames, 25) or None; noise: optional
        pre-drawn (B, num_frames - T0, C, h, w) fresh-frame latents (not
        with pipeline_depth > 1, where the rollout's own `noise=` takes
        one draw a cycle, nor with mesh_data > 1).
        Returns (B, num_frames, H, W, 3) uint8 numpy pixels; num_frames
        counts prompt + generated frames. Under mesh_data = N every rank
        passes the same global batch and gets back its own B / N rows. Runs
        under the generator's lock (a prewarm in flight finishes first)."""
        with self._lock:
            return self._generate(prompt_frames, actions, num_frames, seed,
                                  noise)

    def _generate(self, prompt_frames, actions, num_frames, seed, noise):
        dev = self.device
        video = _to(prompt_frames, dev)
        if video.dim() == 4:
            video = video[None]
        B, n_prompt = video.shape[:2]
        if num_frames <= n_prompt:
            raise ValueError(f"num_frames={num_frames} must exceed the "
                             f"{n_prompt} prompt frames (it counts prompt + "
                             "generated)")
        if actions is not None:
            actions = _to(actions, dev).float()
            if actions.dim() == 2:
                actions = actions[None]
            if actions.shape[1] < num_frames:
                raise ValueError(f"need actions for all {num_frames} frames")
        n_gen = num_frames - n_prompt
        data = 1 if self.mesh is None else self.mesh.data.size
        if noise is not None:
            if self.cfg.pipeline_depth > 1 or data > 1:
                raise ValueError("pre-drawn noise is a single-mesh, "
                                 "non-pipelined hook")
            noise = _to(noise, dev).float()
        if data > 1:
            if B % data:
                raise ValueError(f"batch {B} must divide over "
                                 f"mesh_data={data}")
            rows = meshlib.process_batch_slice(B, self.mesh.data)
            video = video[rows]
            actions = None if actions is None else actions[rows]
            dp = meshlib.data_parallel_rollout(self._rollout, self.mesh,
                                               n_gen)

            def roll(latents):
                return dp(self.dit_params, latents, actions, seed)
        else:
            generator = torch.Generator(device=dev).manual_seed(seed)

            def roll(latents):
                return self._rollout(self.dit_params, latents, actions,
                                     generator, num_gen_frames=n_gen,
                                     noise=noise)
        with torch.inference_mode():
            t0 = time.perf_counter()
            latents = encode_frames(self.vae_params, self.vae_cfg, video,
                                    self._dtype, self._fused, self._backend)
            self._sync()
            t1 = time.perf_counter()
            lat = roll(latents)
            self._sync()
            t2 = time.perf_counter()
            pix = self._decode(lat)
            self._sync()
            t3 = time.perf_counter()
            pixels = pix.cpu().numpy()
            t4 = time.perf_counter()
        self.last_timings = {"encode_s": t1 - t0, "rollout_s": t2 - t1,
                             "decode_s": t3 - t2, "fetch_s": t4 - t3}
        return pixels
