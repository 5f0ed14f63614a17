"""The stacked layout and int8-forward on the CPU against gtax: two
Trainer steps of the stacked layout against gtax's stacked Trainer over
the same weights and the same injected loss noise (the helpers here serve
test_torch_train_backends.py's steps too); the layout's helpers, its
dit_apply and its checkpoints.

Noise: both trainers draw the loss noise of one JAX key (gtax's trainer
is handed LOSS_KEY in place of its step key; the port's loss is handed
gtax's draws from that key, test_torch_loss.py's _gtax_draws), on
DiT-debug in fp32 with pre-encoded latents (no VAE in the step).

Tolerances: the loss to 1e-5 relative and the gradient norm to 1e-4
relative (fp32: the two sides differ in summation order, and the norm
adds up every leaf's); under int8-forward the gradient norm to 1e-3 (an
int8 rounding flipped in the forward moves a row's residuals by a
quantization step, test_torch_int8_train.py). The layouts against each
other in the port: gtax's own bar (tests/test_train_e2e.py
test_unstack_train_matches_stacked), the losses to 1e-6 relative.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.data.loader import Batch as JBatch
from gtax.models import vae as jvae
from gtax.nn import attention as jattn
from gtax.nn import branches as jbr
from gtax.train import config as jconfig
from gtax.train import trainer as jtrainer
from gtax_torch.data.loader import Batch
from gtax_torch.io.safetensors_port import read_safetensors, vae_from_gtax
from gtax_torch.models import dit as tdit
from gtax_torch.models import vae as tvae
from gtax_torch.train import trainer as ttrainer
from gtax_torch.train.config import TrainingConfig
from gtax_torch.train.optim import leaves
from tests.test_torch_loss import _gtax_draws
from tests.test_torch_train import (  # noqa: F401 (autouse fixture)
    B, JCFG, T, TCFG, _port_params, _random_params, _torch_params,
    interpret_mode)

torch.set_num_threads(2)

LOSS_KEY = jax.random.PRNGKey(7)
BASE = dict(dataset_type="dummy", batch_size=B, num_epochs=1, max_steps=4,
            gradient_accumulation_steps=1, ddim_noise_steps=8,
            ctx_max_noise_idx=3, n_prompt_frames=4, use_wandb=False,
            learning_rate=1e-3, min_learning_rate=1e-4, weight_decay=0.01,
            compute_dtype="float32", validation_steps=0, save_every=0,
            logging_steps=1, attention_backend="fused_all",
            dit_model="DiT-debug", vae_model="vae-debug", model_name="m")


@pytest.fixture
def gtax_globals():
    """gtax's Trainer sets its attention backend and int8 switch process
    wide; restored after."""
    backend, int8 = jattn.get_backend(), jbr.use_int8_fwd()
    yield
    jattn.set_backend(backend)
    jbr.set_int8_fwd(int8)


def _config(tmp_path, **overrides):
    return dict(BASE, output_dir=str(tmp_path), **overrides)


def _port_trainer(cfg, params, vae_params):
    return ttrainer.Trainer(
        TrainingConfig.from_dict(cfg), total_dataset_size=64, dit_cfg=TCFG,
        vae_cfg=tvae.VAE_debug(), dit_params=params, vae_params=vae_params,
        device="cpu")


def _port_weights():
    """The port-only tests' DiT and VAE, made without JAX."""
    return _port_params(0), tvae.vae_init(tvae.VAE_debug(),
                                          torch.Generator().manual_seed(1))


def _inject_noise(monkeypatch):
    """Both trainers' loss noise from LOSS_KEY."""
    j_loss, t_loss = jtrainer.diffusion_forcing_loss, \
        ttrainer.diffusion_forcing_loss
    draws = _gtax_draws(LOSS_KEY, T - BASE["n_prompt_frames"],
                        SimpleNamespace(max_frames=T, **{
                            k: BASE[k] for k in ("ddim_noise_steps",
                                                 "ctx_max_noise_idx")}))
    monkeypatch.setattr(
        jtrainer, "diffusion_forcing_loss",
        lambda fn, lat, act, rng, *a: j_loss(fn, lat, act, LOSS_KEY, *a))
    monkeypatch.setattr(
        ttrainer, "diffusion_forcing_loss",
        lambda fn, lat, act, gen, *a: t_loss(fn, lat, act, None, *a,
                                             draws=draws))


def _latent_batch(seed):
    r = np.random.default_rng(seed)
    lat = r.standard_normal((1, B, T, 8, 6, 8)).astype(np.float32)
    acts = r.standard_normal((1, B, T, 25)).astype(np.float32)
    return (JBatch(video=lat, actions=acts, is_latents=True),
            Batch(torch.from_numpy(lat), torch.from_numpy(acts),
                  is_latents=True))


def _steps_against_gtax(tmp_path, monkeypatch, steps, **overrides):
    """(port metrics, gtax metrics) of `steps` steps on one batch."""
    _inject_noise(monkeypatch)
    cfg = _config(tmp_path, **overrides)
    jp = _random_params(0)
    jv = jvae.vae_init(jax.random.PRNGKey(1), jvae.VAE_debug())
    jt = jtrainer.Trainer(jconfig.TrainingConfig.from_dict(cfg),
                          total_dataset_size=64, dit_cfg=JCFG,
                          vae_cfg=jvae.VAE_debug(),
                          dit_params=jax.tree.map(jnp.asarray, jp),
                          vae_params=jv)
    tt = _port_trainer(cfg, _torch_params(jp),
                       vae_from_gtax(jax.tree.map(np.asarray, jv)))
    jb, tb = _latent_batch(2)
    return ([tt.train_step_sync(tb) for _ in range(steps)],
            [jt.train_step_sync(jb) for _ in range(steps)])


def test_stacked_trainer_matches_gtax(tmp_path, monkeypatch, gtax_globals):
    """unstack_train: false against gtax's stacked (`scan`) trainer: two
    steps' losses and gradient norms."""
    got, ref = _steps_against_gtax(tmp_path, monkeypatch, 2,
                                   unstack_train=False)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["train_loss"], r["train_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                   rtol=1e-4)


def _master_rel_diff(a, b):
    """The masters' largest relative difference, b's layout read as a's."""
    ua = dict(leaves(tdit.unstack_for_inference(a, TCFG)))
    ub = dict(leaves(tdit.unstack_for_inference(b, TCFG)))
    return max(((ua[p] - ub[p]).abs().max() / ub[p].abs().max().clamp_min(
        1e-30)).item() for p in ub)


def test_stacked_trainer_matches_unstacked(tmp_path):
    """The two layouts in the port: three steps' losses within 1e-6; the
    masters' largest relative difference is reported (the global norm sums
    a stacked leaf's 2 blocks at once, so the clip scale, and the
    masters, may differ in the last bits)."""
    params, vae = _port_weights()
    _, tb = _latent_batch(3)
    runs = []
    for unstack in (True, False):
        tt = _port_trainer(_config(tmp_path / str(unstack),
                                   unstack_train=unstack), params, vae)
        assert tdit.is_stacked(tt.dit_params) == (not unstack)
        runs.append(([tt.train_step_sync(tb)["train_loss"]
                      for _ in range(3)], tt.dit_params))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    diff = _master_rel_diff(runs[1][1], runs[0][1])
    print(f"masters' largest relative difference, stacked vs unstacked: "
          f"{diff:.3e}")
    assert diff < 1e-5


def test_stacked_checkpoint_records_its_layout(tmp_path):
    """A full-state checkpoint records its layout: the same layout resumes,
    the other raises a clear error (gtax's orbax state needs the same
    unstack_train too); the weight export is keyed by blocks.{i} in
    either layout and holds the same tensors."""
    params, vae = _port_weights()
    _, tb = _latent_batch(4)
    exports = {}
    for unstack in (False, True):
        cfg = _config(tmp_path, unstack_train=unstack)
        tt = _port_trainer(cfg, params, vae)
        tt.train_step_sync(tb)
        tt.global_step = 1
        if not unstack:
            tt.save_checkpoint(0)
            assert _port_trainer(cfg, params, vae).try_resume()
        else:
            with pytest.raises(ValueError, match="unstack_train: false"):
                tt.try_resume()
        exports[unstack] = read_safetensors(tt.save_model(0))
    assert exports[False].keys() == exports[True].keys()
    assert {k.split(".")[1] for k in exports[False]
            if k.startswith("blocks.")} == {"0", "1"}
    for k, v in exports[True].items():
        torch.testing.assert_close(exports[False][k], v, rtol=1e-5,
                                   atol=1e-7)


# ------------------------------------------------ the stacked layout

def test_restack_and_unstack_round_trip():
    """restack_params stacks as gtax's dit_init lays the blocks out
    (every stacked leaf equal to gtax's); unstack_for_inference gives
    views of the stacked leaves, no copy, equal to the per-block params;
    both are no-ops on their own layout."""
    jp = _random_params(0)
    per_block = _torch_params(jp)
    stacked = tdit.restack_params(per_block, TCFG)
    want = dict(leaves(jax.tree.map(np.asarray, jp["blocks"])))
    got = dict(leaves(stacked["blocks"]))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path])
    back = tdit.unstack_for_inference(stacked, TCFG)
    assert len(back["blocks"]) == TCFG.depth
    for i, bp in enumerate(back["blocks"]):
        for path, leaf in leaves(bp):
            assert torch.equal(leaf, dict(leaves(per_block["blocks"][i]))[
                path])
            src = dict(leaves(stacked["blocks"]))[path]
            assert (leaf.untyped_storage().data_ptr()
                    == src.untyped_storage().data_ptr())
    assert tdit.restack_params(stacked, TCFG) is stacked
    assert tdit.unstack_for_inference(per_block, TCFG) is per_block


@pytest.mark.parametrize("backend", ["fused_all", "xla"])
def test_dit_apply_stacked_bit_equal_unstacked(backend):
    """dit_apply over the stacked layout: the output bit-equal to the
    unstacked one, and every gradient (block i's slice of a stacked
    gradient) bit-equal too."""
    r = np.random.default_rng(8)
    x, ct = (torch.from_numpy(r.standard_normal((B, T, 8, 6, 8)).astype(
        np.float32)) for _ in range(2))
    t = torch.from_numpy(r.integers(0, 1000, (B, T)))
    a = torch.from_numpy(r.standard_normal((B, T, 25)).astype(np.float32))
    base = _port_params(9)
    runs = []
    for stacked in (False, True):
        p = tdit._map_params(base, lambda _, l: l.clone())
        if stacked:
            p = tdit.restack_params(p, TCFG)
        for _, leaf in leaves(p):
            leaf.requires_grad_(True)
        v = tdit.dit_apply(p, TCFG, x, t, a, [False] + [True] * 4,
                           compute_dtype=torch.float32, backend=backend)
        (v * ct).sum().backward()
        grads = tdit._map_params(p, lambda _, l: l.grad)
        runs.append((v.detach(), tdit.unstack_for_inference(grads, TCFG)))
    assert torch.equal(runs[0][0], runs[1][0])
    ref = dict(leaves(runs[0][1]))
    n = 0
    for path, g in leaves(runs[1][1]):
        assert (g is None) == (ref[path] is None), path
        if g is not None:  # the rope tables take no gradient
            assert torch.equal(g, ref[path]), path
            n += 1
    assert n > 20


def test_stacked_layout_refused_where_gtax_refuses():
    """dit_cond, dit_prefill, dit_apply_step and dit_apply(mods=) need the
    unstacked layout, as gtax's do."""
    p = tdit.restack_params(_port_params(0), TCFG)
    t = torch.zeros(1, T, dtype=torch.long)
    x = torch.zeros(1, T, 8, 6, 8)
    mods = tdit.dit_cond(tdit.unstack_for_inference(p, TCFG), TCFG, t)
    for call in (lambda: tdit.dit_cond(p, TCFG, t),
                 lambda: tdit.dit_prefill(p, TCFG, x[:, :4], mods, None),
                 lambda: tdit.dit_apply_step(p, TCFG, x[:, 4:], [], mods,
                                             None),
                 lambda: tdit.dit_apply(p, TCFG, x, mods=mods)):
        with pytest.raises(ValueError, match="unstacked"):
            call()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cast_and_quantize_take_either_layout(dtype):
    """cast_params_for_inference and quantize_for_inference on the stacked
    layout give, block by block, the unstacked results bit for bit (a
    stacked kernel quantizes with per-block scales), and the quantized
    stacked forward equals the quantized unstacked one."""
    per_block = _port_params(0)
    stacked = tdit.restack_params(per_block, TCFG)
    qs, qu = (tdit.quantize_for_inference(
        tdit.cast_params_for_inference(p, dtype)) for p in (stacked,
                                                              per_block))
    ref = dict(leaves(qu))
    got = dict(leaves(tdit.unstack_for_inference(qs, TCFG)))
    assert got.keys() == ref.keys()
    for path, leaf in got.items():
        assert leaf.dtype == ref[path].dtype and torch.equal(
            leaf, ref[path]), path
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.standard_normal((1, T, 8, 6, 8)).astype(
        np.float32)).to(dtype)
    t = torch.from_numpy(r.integers(0, 1000, (1, T)))
    with torch.no_grad():
        assert torch.equal(
            tdit.dit_apply(qs, TCFG, x, t, compute_dtype=dtype),
            tdit.dit_apply(qu, TCFG, x, t, compute_dtype=dtype))
