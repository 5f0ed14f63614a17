"""Optimizer and learning-rate schedule (counterpart of
gtax/train/optim.py), written in torch ops to match gtax's optax chain
term for term:

    clip_by_global_norm(max_grad_norm)
    adamw(schedule, b1=0.9, b2=0.999, eps=1e-7, weight_decay, mu_dtype,
          mask=_decay_mask)

- the clip scales by max_norm / norm only when norm >= max_norm (optax;
  torch's clip_grad_norm_ adds 1e-6 to the norm and differs);
- Adam's bias corrections use the incremented count; eps is added to
  sqrt(nu_hat); with mu_dtype=bfloat16 the new moment is computed and used
  in fp32 and then stored in bf16, and b1 multiplies the stored moment as a
  bf16 constant (what XLA makes of optax's `b1 * mu` in gtax's jitted
  step);
- weight decay is decoupled, wd * p added to the Adam direction, and masked
  off the rope frequency tables;
- the learning rate is the schedule at the count before the increment, so
  the first update of a warmup has lr 0.

Parameters are the port's nested dicts of fp32 tensors; the state holds
one (mu, nu) pair per leaf. The clip and the update run on the params'
device without reading anything back to the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_FROZEN_KEYS = {"spatial_rope_freqs", "temporal_rope_freqs"}


def cosine_min_lr_schedule(learning_rate: float, min_learning_rate: float,
                           warmup_steps: int, total_steps: int,
                           num_cycles: float = 0.25):
    """transformers' get_cosine_with_min_lr_schedule_with_warmup, in fp32
    as gtax computes it: step -> learning rate (a Python float)."""
    f32 = np.float32
    min_ratio = f32(min_learning_rate / learning_rate
                    if learning_rate > 0 else 0.0)

    def schedule(step) -> float:
        step = f32(step)
        warm = step / f32(max(1.0, warmup_steps))
        progress = (step - f32(warmup_steps)) / f32(
            max(1.0, total_steps - warmup_steps))
        factor = max(f32(0.0), f32(0.5) * (f32(1.0) + np.cos(
            f32(math.pi * 2.0 * num_cycles) * progress, dtype=f32)))
        factor = max(f32(0.0), factor * (f32(1.0) - min_ratio) + min_ratio)
        return float(f32(learning_rate) * (warm if step < warmup_steps
                                           else factor))

    return schedule


def leaves(tree, path=()):
    """(path, tensor) pairs of a nested dict/list of tensors, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def decays(path) -> bool:
    """False for the frozen rope frequency tables (gtax _decay_mask)."""
    return not (set(path) & _FROZEN_KEYS)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float().square()) for t in tensors))


class AdamW:
    """clip_by_global_norm + AdamW over a param tree, updated in place.

    Under tensor parallelism the tree holds this rank's shards (gtax's
    _place_state puts the masters and the moments on the same sharding):
    `cut` flags the leaves cut over `model_axis`, whose squares the global
    norm sums over the axis, while the replicated leaves count once, so
    the clip and the norm are the whole model's."""

    def __init__(self, params, schedule, weight_decay=0.0, max_grad_norm=1.0,
                 b1=0.9, b2=0.999, eps=1e-7, mu_dtype=None, model_axis=None,
                 cut=None):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.paths, self.params = zip(*leaves(params))
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in self.params]
        self.b1_mu = float(torch.tensor(b1).to(mu_dtype or torch.float32))
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.model_axis = model_axis
        self.cut = cut or [False] * len(self.params)

    def global_norm(self, grads) -> torch.Tensor:
        """The whole model's gradient norm (global_norm in one process)."""
        if self.model_axis is None:
            return global_norm(grads)
        zero = torch.zeros((), device=grads[0].device)
        cut = sum((torch.sum(g.float().square())
                   for g, c in zip(grads, self.cut) if c), zero)
        rep = sum((torch.sum(g.float().square())
                   for g, c in zip(grads, self.cut) if not c), zero)
        return torch.sqrt(self.model_axis.all_reduce(cut) + rep)

    @torch.no_grad()
    def step(self, grads):
        """One update from `grads` (one tensor or None per leaf, in the
        order of `leaves(params)`; None counts as zero). Returns the global
        norm of the gradients before clipping (a device tensor)."""
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(self.params, grads)]
        norm = self.global_norm(grads)
        keep = norm < self.max_grad_norm
        f32 = np.float32
        inc = self.count + 1
        c1 = float(f32(1.0) - f32(self.b1) ** f32(inc))
        c2 = float(f32(1.0) - f32(self.b2) ** f32(inc))
        lr = self.schedule(self.count)
        for i, (path, p, g) in enumerate(zip(self.paths, self.params,
                                             grads)):
            g = torch.where(keep, g, (g / norm) * self.max_grad_norm)
            mu = (1 - self.b1) * g + self.b1_mu * self.mu[i].float()
            nu = (1 - self.b2) * g.square() + self.b2 * self.nu[i]
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if decays(path):
                upd = upd + self.weight_decay * p
            p.add_(upd * -lr)
            self.mu[i] = mu.to(self.mu[i].dtype)
            self.nu[i] = nu
        self.count = inc
        return norm

    def state_dict(self) -> dict:
        """{"count": int, "mu": {path: tensor}, "nu": {path: tensor}}, the
        moments in their own dtypes (mu in bf16 under mu_dtype=bfloat16),
        keyed by the param paths ("/"-joined); the tensors are the live
        ones, not copies."""
        key = ["/".join(map(str, p)) for p in self.paths]
        return {"count": self.count, "mu": dict(zip(key, self.mu)),
                "nu": dict(zip(key, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a state_dict's moments into this optimizer's, in place and
        in their dtypes (a shape, dtype or key mismatch raises), and take
        its count: the schedule goes on from it."""
        key = ["/".join(map(str, p)) for p in self.paths]
        for name in ("mu", "nu"):
            src = state[name]
            if set(src) != set(key):
                raise KeyError(f"optimizer state {name}: keys differ from "
                               "the params'")
            for k, dst in zip(key, getattr(self, name)):
                if src[k].shape != dst.shape or src[k].dtype != dst.dtype:
                    raise ValueError(
                        f"optimizer state {name}/{k}: {src[k].dtype} "
                        f"{tuple(src[k].shape)}, want {dst.dtype} "
                        f"{tuple(dst.shape)}")
                dst.copy_(src[k])
        self.count = int(state["count"])


def make_optimizer(params, learning_rate: float, min_learning_rate: float,
                   warmup_steps: int, total_steps: int,
                   weight_decay: float = 0.0, max_grad_norm: float = 1.0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7,
                   mu_dtype=None, model_axis=None, cut=None):
    """(optimizer, schedule) as gtax make_optimizer builds them; model_axis
    and cut as AdamW's."""
    schedule = cosine_min_lr_schedule(learning_rate, min_learning_rate,
                                      warmup_steps, total_steps)
    return AdamW(params, schedule, weight_decay, max_grad_norm, b1, b2, eps,
                 mu_dtype, model_axis, cut), schedule
