"""The diffusion-forcing loss of the port against gtax's, on the CPU: the
same draws (gtax's own, replayed from its key) give the same loss and the
same parameter gradients, at the tolerances of test_torch_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.core import schedules as jsched
from gtax.models import dit as jdit
from gtax.sampling import diffusion as jdiff
from gtax_torch.models import dit as tdit
from gtax_torch.sampling import diffusion as tdiff
from tests.test_torch_train import (  # noqa: F401 (autouse fixture)
    B, JCFG, T, TCFG, _check_grads, _fused_all, _random_params,
    _requires_grad, _torch_params, interpret_mode)

torch.set_num_threads(2)


# -------------------------------------------------------------- the loss

def _gtax_draws(key, n_gen, cfg):
    """gtax diffusion_forcing_loss's own draws, replayed from its key."""
    k_t, k_c, k_noise = jax.random.split(key, 3)
    target = jax.random.randint(k_t, (n_gen, B), 1, cfg.ddim_noise_steps + 1)
    ctx = jax.random.randint(k_c, (n_gen, B), 1, cfg.ctx_max_noise_idx + 1)
    shape = (B, cfg.max_frames - 1, 8, 6, 8)
    ctx_noise, last_noise = [], []
    for idx in range(n_gen):
        k_ctx, k_last = jax.random.split(jax.random.fold_in(k_noise, idx))
        ctx_noise.append(jax.random.normal(k_ctx, shape, jnp.float32))
        last_noise.append(jax.random.normal(k_last, (B, 1, 8, 6, 8),
                                            jnp.float32))

    def t_(a):
        return torch.from_numpy(np.array(a))

    return {"target_idx": t_(target).long(), "ctx_idx": t_(ctx).long(),
            "ctx_noise": t_(jnp.stack(ctx_noise)),
            "last_noise": t_(jnp.stack(last_noise))}


@pytest.mark.parametrize("n_prompt", [4, 1])
def test_loss_and_gradient_match_gtax(n_prompt):
    """diffusion_forcing_loss fed gtax's draws: the (mean, sum) loss and
    its gradient against gtax's value_and_grad (n_prompt 1: four windows,
    the first three left-padded with invalid slots)."""
    cfg_kw = dict(ddim_noise_steps=50, ctx_max_noise_idx=40,
                  n_prompt_frames=n_prompt, max_frames=5)
    jcfg, tcfg = jdiff.LossConfig(**cfg_kw), tdiff.LossConfig(**cfg_kw)
    abar = jsched.alphas_cumprod_from_betas(
        jsched.sigmoid_beta_schedule(1000, clamp_min=1e-6))
    noise_range = jsched.ddim_noise_range(50)
    r = np.random.default_rng(4)
    lat = r.standard_normal((B, T, 8, 6, 8)).astype(np.float32)
    acts = r.standard_normal((B, T, 25)).astype(np.float32)
    jp = _random_params(5)
    key = jax.random.PRNGKey(6)

    def jloss(p):
        def fn(x, t, a, valid):
            return jdit.dit_apply(p, JCFG, x, t, a, valid,
                                  compute_dtype=jnp.float32)
        return jdiff.diffusion_forcing_loss(fn, jnp.asarray(lat),
                                            jnp.asarray(acts), key, jcfg,
                                            abar, noise_range)

    (jsum, jmean), jgrads = _fused_all(lambda: jax.value_and_grad(
        lambda p: jloss(p)[::-1], has_aux=True)(
            jax.tree.map(jnp.asarray, jp)))
    tp = _requires_grad(_torch_params(jp))

    def tfn(x, t, a, valid):
        return tdit.dit_apply(tp, TCFG, x, t, a, valid,
                              compute_dtype=torch.float32)

    mean, total = tdiff.diffusion_forcing_loss(
        tfn, torch.from_numpy(lat), torch.from_numpy(acts), None, tcfg,
        torch.from_numpy(np.array(abar)),
        torch.from_numpy(np.array(noise_range)),
        draws=_gtax_draws(key, T - n_prompt, jcfg))
    np.testing.assert_allclose(float(mean.detach()), float(jmean),
                               rtol=1e-5)
    np.testing.assert_allclose(float(total.detach()), float(jsum),
                               rtol=1e-5)
    total.backward()
    _check_grads(tp, jgrads)


def test_loss_draws_from_generator():
    """Without `draws` the loss draws from the generator: the same seed
    gives the same loss, and the clip is the only nondeterminism."""
    tp = tdit.dit_init(TCFG, torch.Generator().manual_seed(0))
    lat = torch.randn((B, T, 8, 6, 8), generator=torch.Generator()
                      .manual_seed(1))
    cfg = tdiff.LossConfig(n_prompt_frames=2)
    abar = tdiff.schedules.alphas_cumprod_from_betas(
        tdiff.schedules.sigmoid_beta_schedule(1000, clamp_min=1e-6))
    nr = tdiff.schedules.ddim_noise_range(50)

    def run(seed):
        def fn(x, t, a, valid):
            return tdit.dit_apply(tp, TCFG, x, t, a, valid,
                                  compute_dtype=torch.float32)
        return tdiff.diffusion_forcing_loss(
            fn, lat, None, torch.Generator().manual_seed(seed), cfg, abar,
            nr)

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    torch.testing.assert_close(a[1], a[0] * 3)
