"""gtax_torch VideoGenerator with the approximate serving modes
(pipeline_depth, attn_broadcast) against gtax's VideoGenerator over the
same weights, on the CPU: DiT_debug + vae-debug, 3 noise steps (8 where a
config needs reuse inside a pipelined cycle), fp32, int8 and bf16. The
weights and helpers are tests/test_torch_approx.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax import serving as jserving
from gtax.kernels import attention as kattn
from gtax.models import vae as jvae
from gtax.nn import attention as jattn
from gtax_torch import serving
from gtax_torch.io import safetensors_port as port
from tests.conftest import assert_close
from tests.test_torch_approx import LAT, _debug_params, _j, _t, gtax_draws

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_mode():
    kattn.set_interpret(True)
    yield
    kattn.set_interpret(None)


KW = dict(noise_steps=3, dit_model="DiT-debug", vae_model="vae-debug")
N_FRAMES = 6


@pytest.fixture(scope="module")
def weights():
    """(gtax DiT params, gtax VAE params) as numpy trees."""
    _, jdit_params = _debug_params()
    jv = jvae.vae_init(jax.random.PRNGKey(1), jvae.VAE_debug())
    jv = jax.tree.map(lambda l: np.asarray(l + 0.01 if l.ndim == 1 else l),
                      jv)
    return jdit_params, jv


def _generators(weights, **cfg):
    """(gtax generator, port generator, port exact generator: the same
    config without the approximate modes)."""
    kattn.set_interpret(True)
    jdit_params, jv = weights
    cfg = dict(KW, **cfg)
    jgen = jserving.VideoGenerator(
        jax.tree.map(jnp.asarray, jdit_params), jax.tree.map(jnp.asarray, jv),
        jserving.ServingConfig(**cfg))
    gen = serving.VideoGenerator(
        port.dit_from_gtax(jdit_params), port.vae_from_gtax(jv),
        serving.ServingConfig(**cfg), device="cpu")
    exact = serving.VideoGenerator(
        gen.dit_params, gen.vae_params, serving.ServingConfig(**dict(
            cfg, pipeline_depth=1, attn_broadcast=1)), device="cpu")
    return jgen, gen, exact


def _prompt(seed, n_prompt=4):
    rng = np.random.default_rng(seed)
    prompt = rng.random((1, n_prompt, 3, 48, 64), np.float32)
    acts = rng.standard_normal((1, N_FRAMES, 25)).astype(np.float32)
    return prompt, acts


def _check_generator(weights, cfg, seed):
    """One rollout of each generator from the same encoded prompt and the
    same draws (gtax's key chain replayed for a pipelined rollout, which
    has no noise hook in gtax; pre-drawn noise otherwise). fp32: latents
    within 1e-4 of gtax's and pixels within 1 LSB, and the mode moves the
    latents off the exact rollout's by more than 1e-3 (so the check can
    tell the mode from the exact scheme). bf16: latents within 2**-5 of
    their largest magnitude (PERF.md §2's rule for bf16 rollouts: gtax's
    temporal cores round each q.k and p.v product to bf16 where the port
    sums in fp32, ROADMAP.md §C)."""
    jgen, gen, exact = _generators(weights, **cfg)
    P = cfg.get("pipeline_depth", 1)
    prompt, acts = _prompt(seed)
    lat = jgen._encode(jgen.vae_params, jnp.asarray(prompt))
    n_gen = N_FRAMES - 4
    key = jax.random.PRNGKey(seed)
    if P > 1:
        noise = gtax_draws(key, n_gen + P - 1, 1)
        jkw = {}
    else:
        noise = _t(np.random.default_rng(seed).standard_normal(
            (1, n_gen, *LAT)).astype(np.float32))
        jkw = {"noise": _j(noise.numpy())}
    with jattn.backend_scope(jgen._backend):
        ref = jgen._rollout(jgen.dit_params, lat, jnp.asarray(acts), key,
                            num_gen_frames=n_gen, **jkw)
        ref_pix = np.asarray(jgen._decode(jgen.vae_params, ref))
        ref = np.asarray(ref.astype(jnp.float32))
    lat, acts_t = _t(np.asarray(lat.astype(jnp.float32))), _t(acts)
    got = gen._rollout(gen.dit_params, lat, acts_t, None, n_gen, noise=noise)
    pix = gen._decode(got).numpy()
    assert pix.shape == ref_pix.shape == (1, N_FRAMES, 48, 64, 3)
    if cfg["dtype"] == "bfloat16":
        scale = max(1.0, float(np.abs(ref).max()))
        assert_close(got.float(), ref, atol=2.0**-5 * scale, rtol=0)
        return gen
    assert_close(got, ref, atol=1e-4, rtol=1e-4)
    assert np.abs(pix.astype(np.int32) - ref_pix.astype(np.int32)).max() <= 1
    base = exact._rollout(exact.dit_params, lat, acts_t, None, n_gen,
                          noise=noise[:, :n_gen])
    assert (got - base).abs().max() > 1e-3
    return gen


@pytest.mark.parametrize("cfg", [
    dict(dtype="float32", pipeline_depth=2),
    dict(dtype="float32", pipeline_depth=4, quantize="int8"),
    dict(dtype="bfloat16", pipeline_depth=4),
    dict(dtype="bfloat16", pipeline_depth=2, quantize="int8"),
    dict(dtype="float32", pipeline_depth=2, attn_broadcast=2,
         attention_backend="xla", noise_steps=8)],
    ids=["p2", "p4-int8", "p4-bf16", "p2-int8-bf16", "p2-k2-xla"])
def test_generator_pipelined_matches_gtax(weights, cfg):
    """VideoGenerator(pipeline_depth=P): the composed incremental path
    under the default fused backend, and the full window with attention
    broadcast (8 steps: stride 5, calls 1 and 3 reuse). A seeded generate
    runs, and pre-drawn noise is refused there, as gtax refuses it."""
    gen = _check_generator(weights, cfg, 20 + cfg["pipeline_depth"])
    prompt, acts = _prompt(0)
    seeded = gen.generate(prompt, acts, num_frames=N_FRAMES, seed=3)
    assert seeded.shape == (1, N_FRAMES, 48, 64, 3)
    assert seeded.dtype == np.uint8
    with pytest.raises(ValueError, match="non-pipelined"):
        gen.generate(prompt, acts, num_frames=N_FRAMES,
                     noise=np.zeros((1, 2, *LAT), np.float32))


@pytest.mark.parametrize("cfg", [
    dict(dtype="float32", attn_broadcast=2),
    dict(dtype="float32", attn_broadcast=2, quantize="int8"),
    dict(dtype="bfloat16", attn_broadcast=2),
    dict(dtype="bfloat16", attn_broadcast=2, quantize="int8"),
    dict(dtype="float32", attn_broadcast=3, attention_backend="pallas")],
    ids=["k2", "k2-int8", "k2-bf16", "k2-int8-bf16", "k3-pallas"])
def test_generator_broadcast_matches_gtax(weights, cfg):
    """VideoGenerator(attn_broadcast=K): full-window steps through the pab
    fns under the config's backend (int8: the W8A8 wrappers)."""
    _check_generator(weights, cfg, 30)
