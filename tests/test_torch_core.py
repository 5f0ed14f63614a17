"""gtax_torch core against gtax and the torch-reference golden fixtures:
schedules, rope, timestep embedding, actions, the device rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.core import rope as jrope
from gtax.core import schedules as jsched
from gtax.nn import layers as jlayers
from gtax_torch.core import rope, schedules
from gtax_torch.data import actions
from gtax_torch.nn import layers
from gtax_torch.utils.platform import resolve_device
from tests.conftest import assert_close

torch.set_num_threads(2)


@pytest.mark.parametrize("clamp", [1e-4, 1e-6])
def test_sigmoid_schedule(golden, clamp):
    g = golden("schedules.npz")
    betas = schedules.sigmoid_beta_schedule(1000, clamp_min=clamp)
    # same float64 host math as gtax, cast once: bit-equal
    np.testing.assert_array_equal(
        betas.numpy(),
        np.asarray(jsched.sigmoid_beta_schedule(1000, clamp_min=clamp)))
    assert_close(betas, g[f"sigmoid_{clamp:g}"], atol=1e-7, rtol=1e-4)
    abar = schedules.alphas_cumprod_from_betas(betas)
    # fp32 cumulative product: reduction order may differ from XLA's
    assert_close(abar, jsched.alphas_cumprod_from_betas(
        jsched.sigmoid_beta_schedule(1000, clamp_min=clamp)), atol=1e-6)
    assert_close(abar, g[f"sigmoid_{clamp:g}_abar"], atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("name", ["clamped", "og", "cosine", "linear"])
def test_schedule_variants(golden, name):
    g = golden("schedules.npz")
    ours = {"clamped": schedules.sigmoid_beta_schedule_clamped,
            "og": schedules.sigmoid_beta_schedule_og,
            "cosine": schedules.cosine_beta_schedule,
            "linear": schedules.linear_beta_schedule}[name](1000)
    ref = {"clamped": jsched.sigmoid_beta_schedule_clamped,
           "og": jsched.sigmoid_beta_schedule_og,
           "cosine": jsched.cosine_beta_schedule,
           "linear": jsched.linear_beta_schedule}[name](1000)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    key = {"clamped": "sigmoid_clamped", "og": "sigmoid_og"}.get(name, name)
    # the reference computes the cosine schedule in float32
    assert_close(ours, g[key], atol=2e-5 if name == "cosine" else 1e-7,
                 rtol=2e-3 if name == "cosine" else 1e-4)


def test_noise_range_and_constants(golden):
    g = golden("schedules.npz")
    np.testing.assert_array_equal(schedules.ddim_noise_range(50).numpy(),
                                  g["noise_range_50"])
    betas, abar, nr, stab = schedules.make_diffusion_constants(50)
    jb, ja, jnr, jstab = jsched.make_diffusion_constants(50)
    np.testing.assert_array_equal(betas.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(nr.numpy(), np.asarray(jnr))
    assert stab == jstab


def test_rope_freqs(golden):
    g = golden("rope.npz")
    np.testing.assert_array_equal(rope.lang_freqs(64).numpy(),
                                  np.asarray(jrope.lang_freqs(64)))
    np.testing.assert_array_equal(rope.pixel_freqs(32, 256.0).numpy(),
                                  np.asarray(jrope.pixel_freqs(32, 256.0)))
    assert_close(rope.lang_freqs(64), g["temporal_freqs"], atol=1e-7)
    axial = rope.axial_freqs(rope.pixel_freqs(32, 256.0), (9, 16), pixel=True)
    assert_close(axial, jrope.axial_freqs(jrope.pixel_freqs(32, 256.0),
                                          (9, 16), pixel=True), atol=1e-5)
    assert_close(axial, g["spatial_axial_freqs"], atol=2e-3, rtol=1e-5)


def test_rotate_half_is_interleaved():
    x = torch.arange(6.0)
    np.testing.assert_array_equal(rope.rotate_half(x).numpy(),
                                  [-1.0, 0.0, -3.0, 2.0, -5.0, 4.0])
    np.testing.assert_array_equal(
        rope.rotate_half(x).numpy(),
        np.asarray(jrope.rotate_half(jnp.arange(6.0))))


def test_rotations_against_golden(golden):
    g = golden("rope.npz")
    t = rope.temporal_rope_freqs(torch.arange(5), rope.lang_freqs(64))
    out = rope.apply_rotary_emb(t, torch.from_numpy(g["temporal_in"]))
    assert_close(out, g["temporal_out"], atol=1e-5)
    out = rope.apply_rotary_emb(torch.from_numpy(g["spatial_axial_freqs"]),
                                torch.from_numpy(g["spatial_in"]))
    assert_close(out, g["spatial_out"], atol=1e-5)
    vf = rope.axial_freqs(rope.pixel_freqs(16, 48.0), (6, 8), pixel=True)
    vin = torch.from_numpy(g["vae_in"])
    out = rope.apply_rotary_emb(vf, vin)
    # fp32 sin/cos of arguments up to ~150*pi: transcendental noise
    assert_close(out, g["vae_out"], atol=2e-4)
    rot = vf.shape[-1]
    np.testing.assert_array_equal(out[..., rot:].numpy(),
                                  g["vae_in"][..., rot:])


def test_timestep_embedding(golden):
    g = golden("timestep_embedding.npz")
    emb = layers.timestep_embedding(torch.from_numpy(g["t"]), 256)
    # fp32 cos of arguments up to 999: ~1e-3 transcendental noise vs torch
    assert_close(emb, g["emb"], atol=5e-3)
    t = np.array([0, 15, 500, 999], np.int32)
    assert_close(layers.timestep_embedding(torch.from_numpy(t), 256),
                 jlayers.timestep_embedding(jnp.asarray(t), 256), atol=5e-3)
    assert torch.equal(layers.timestep_embedding(torch.zeros(1), 8)[0, :4],
                       torch.ones(4))  # cos first


def test_modulate_and_linear_match_gtax():
    gen = np.random.default_rng(0)
    x = gen.standard_normal((2, 3, 4, 8)).astype(np.float32)
    sh = gen.standard_normal((2, 3, 8)).astype(np.float32)
    sc = gen.standard_normal((2, 3, 8)).astype(np.float32)
    assert_close(layers.modulate(*map(torch.from_numpy, (x, sh, sc))),
                 jlayers.modulate(*map(jnp.asarray, (x, sh, sc))), atol=1e-6)
    prm = {"kernel": gen.standard_normal((8, 5)).astype(np.float32),
           "bias": gen.standard_normal(5).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in prm.items()}
    jp = {k: jnp.asarray(v) for k, v in prm.items()}
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 2e-2)):
        assert_close(layers.linear(tp, torch.from_numpy(x), dt).float(),
                     jlayers.linear(jp, jnp.asarray(x), jdt).astype(
                         jnp.float32), atol=tol, rtol=tol)
    assert_close(layers.layer_norm(torch.from_numpy(x)),
                 jlayers.layer_norm(jnp.asarray(x)), atol=1e-5)


def test_actions_match_gtax():
    from gtax.data import actions as jactions

    np.testing.assert_array_equal(
        actions.actions_to_one_hot([3, -1, 24]),
        jactions.actions_to_one_hot([3, -1, 24]))
    np.testing.assert_array_equal(actions.forward_actions(2, 3),
                                  jactions.forward_actions(2, 3))


def test_device_rule(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="not available"):
        resolve_device("cuda")
