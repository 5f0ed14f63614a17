"""The slice as a whole: gtax_torch VideoGenerator.generate against gtax's,
debug presets, fp32, on the CPU, with the same weights (weight bridge) and
the same injected noise (torch and JAX draw different random numbers, so
rollouts are compared only with injected noise, never by seed).

Tolerances: pixels may differ by 1 LSB (fp32 summation order can move a
value across a uint8 truncation boundary); latents within 1e-4 (fp32
summation-order differences through three DDIM steps of a small DiT)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax import serving as jserving
from gtax.kernels import attention as kattn
from gtax.models import vae as jvae
from gtax_torch import serving
from gtax_torch.io import safetensors_port as port
from gtax_torch.models import dit
from tests.conftest import assert_close
from tests.test_torch_models import _gtax_debug_params

torch.set_num_threads(2)

KW = dict(dtype="float32", noise_steps=3, dit_model="DiT-debug",
          vae_model="vae-debug")
N_FRAMES = 6


@pytest.fixture(autouse=True)
def interpret_mode():
    kattn.set_interpret(True)
    yield
    kattn.set_interpret(None)


@pytest.fixture(scope="module")
def pair():
    """(gtax generator, port generator) over the same weights."""
    kattn.set_interpret(True)
    _, jdit_params = _gtax_debug_params()
    jv = jvae.vae_init(jax.random.PRNGKey(1), jvae.VAE_debug())
    jv = jax.tree.map(lambda l: np.asarray(l + 0.01 if l.ndim == 1 else l),
                      jv)
    jgen = jserving.VideoGenerator(
        jax.tree.map(jnp.asarray, jdit_params),
        jax.tree.map(jnp.asarray, jv), jserving.ServingConfig(**KW))
    gen = serving.VideoGenerator(
        port.dit_from_gtax(jdit_params), port.vae_from_gtax(jv),
        serving.ServingConfig(**KW), device="cpu")
    return jgen, gen


def _inputs(n_prompt, seed=0, B=1):
    rng = np.random.default_rng(seed)
    prompt = rng.random((B, n_prompt, 3, 48, 64), np.float32)
    noise = rng.standard_normal(
        (B, N_FRAMES - n_prompt, 8, 6, 8)).astype(np.float32)
    acts = rng.standard_normal((B, N_FRAMES, 25)).astype(np.float32)
    return prompt, noise, acts


@pytest.mark.parametrize("n_prompt", [4, 2])
def test_generate_matches_gtax(pair, n_prompt):
    """n_prompt=2 leaves two padded slots in the first window (valid
    mask)."""
    jgen, gen = pair
    prompt, noise, acts = _inputs(n_prompt)
    ref = jgen.generate(prompt, acts, num_frames=N_FRAMES,
                        noise=jnp.asarray(noise))
    got = gen.generate(prompt, acts, num_frames=N_FRAMES, noise=noise)
    assert got.shape == ref.shape == (1, N_FRAMES, 48, 64, 3)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


@pytest.fixture(scope="module")
def pair_int8(pair):
    """The W8A8 generators (quantize="int8") over the same weights."""
    kattn.set_interpret(True)
    jgen, gen = pair
    cfg = dict(KW, quantize="int8")
    _, jdit_params = _gtax_debug_params()
    jgen8 = jserving.VideoGenerator(jax.tree.map(jnp.asarray, jdit_params),
                                    jgen.vae_params,
                                    jserving.ServingConfig(**cfg))
    gen8 = serving.VideoGenerator(port.dit_from_gtax(jdit_params),
                                  gen.vae_params, serving.ServingConfig(**cfg),
                                  device="cpu")
    return jgen8, gen8


def test_generate_int8_matches_gtax(pair_int8):
    """The int8 serving path end to end: gtax takes its paired int8 kernels
    at B=1, the port its sequential ones; both quantize the same fp32
    values, so pixels agree within 1 LSB as in bf16."""
    jgen, gen = pair_int8
    assert "kernel_q" in gen.dit_params["blocks"][0]["s_adaln"]
    prompt, noise, acts = _inputs(4, seed=4)
    ref = jgen.generate(prompt, acts, num_frames=N_FRAMES,
                        noise=jnp.asarray(noise))
    got = gen.generate(prompt, acts, num_frames=N_FRAMES, noise=noise)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


@pytest.fixture(scope="module")
def unfused_pairs(pair):
    """backend -> (gtax generator, port generator) for the `xla` and
    `pallas` backends: full-window rollouts, unfused VAE."""
    kattn.set_interpret(True)
    jgen, gen = pair
    _, jdit_params = _gtax_debug_params()
    out = {}
    for backend in ("xla", "pallas"):
        cfg = dict(KW, attention_backend=backend)
        out[backend] = (
            jserving.VideoGenerator(jax.tree.map(jnp.asarray, jdit_params),
                                    jgen.vae_params,
                                    jserving.ServingConfig(**cfg)),
            serving.VideoGenerator(gen.dit_params, gen.vae_params,
                                   serving.ServingConfig(**cfg),
                                   device="cpu"))
    return out


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_generate_unfused_backends_match_gtax(unfused_pairs, backend):
    """gtax's `xla` / `pallas` serving end to end: no incremental decoding,
    the unfused DiT blocks and VAE; pixels within 1 LSB, as above."""
    jgen, gen = unfused_pairs[backend]
    prompt, noise, acts = _inputs(3, seed=6)
    ref = jgen.generate(prompt, acts, num_frames=N_FRAMES,
                        noise=jnp.asarray(noise))
    got = gen.generate(prompt, acts, num_frames=N_FRAMES, noise=noise)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_generators_with_different_backends_do_not_interfere(
        pair, unfused_pairs):
    """The backend belongs to the generator, not to the process: calls of
    an `xla` and a `pallas` generator interleaved with a `fused` one give
    each the pixels it gives alone. Exact."""
    _, fused = pair
    gens = {"fused": fused, **{b: g for b, (_, g) in unfused_pairs.items()}}
    prompt, noise, acts = _inputs(4, seed=7)

    def run(g):
        return g.generate(prompt, acts, num_frames=N_FRAMES, noise=noise)

    alone = {name: run(g) for name, g in gens.items()}
    for name in ("pallas", "fused", "xla", "fused", "pallas"):
        np.testing.assert_array_equal(run(gens[name]), alone[name])


def test_int8_generator_from_quantized_params(pair):
    """A bf16 quantize="int8" generator built from params that another one
    already quantized holds the same params (int8 kernels, fp32 scales)
    and generates the same pixels as one built from the unquantized
    params: serving's cast leaves W8A8 leaves alone. Exact."""
    _, gen = pair
    cfg = serving.ServingConfig(**dict(KW, dtype="bfloat16", quantize="int8"))
    first = serving.VideoGenerator(gen.dit_params, gen.vae_params, cfg,
                                   device="cpu")
    second = serving.VideoGenerator(first.dit_params, first.vae_params, cfg,
                                    device="cpu")
    flat = {}
    for g in (first, second):
        dit._map_params(g.dit_params,
                        lambda p, leaf: flat.setdefault(p, []).append(leaf))
    for path, (a, b) in flat.items():
        assert a.dtype == b.dtype and torch.equal(a, b), path
        if path[-1] == "scale":
            assert a.dtype == torch.float32, path
    prompt, noise, acts = _inputs(4, seed=5)
    np.testing.assert_array_equal(
        second.generate(prompt, acts, num_frames=N_FRAMES, noise=noise),
        first.generate(prompt, acts, num_frames=N_FRAMES, noise=noise))


def test_rollout_latents_match_gtax(pair):
    jgen, gen = pair
    prompt, noise, acts = _inputs(3, seed=1)
    lat = np.array(jgen._encode(jgen.vae_params, jnp.asarray(prompt)))
    ref = jgen._rollout(jgen.dit_params, jnp.asarray(lat), jnp.asarray(acts),
                        jax.random.PRNGKey(0),
                        num_gen_frames=N_FRAMES - 3,
                        noise=jnp.asarray(noise))
    got = gen._rollout(gen.dit_params, torch.from_numpy(lat),
                       torch.from_numpy(acts), None, N_FRAMES - 3,
                       noise=torch.from_numpy(noise))
    assert_close(got, np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["full_window", "no_cond_cache"])
def test_incremental_equals_full_window(pair, mode):
    _, gen = pair
    prompt, noise, acts = _inputs(2, seed=2)
    cfg = (dict(incremental=False) if mode == "full_window"
           else dict(cond_cache=False))
    other = serving.VideoGenerator(
        gen.dit_params, gen.vae_params,
        dataclasses.replace(gen.cfg, **cfg), device="cpu")
    lat = torch.randn(1, 2, 8, 6, 8, generator=torch.Generator().manual_seed(0))
    a = gen._rollout(gen.dit_params, lat, torch.from_numpy(acts), None,
                     N_FRAMES - 2, noise=torch.from_numpy(noise))
    b = other._rollout(gen.dit_params, lat, torch.from_numpy(acts), None,
                       N_FRAMES - 2, noise=torch.from_numpy(noise))
    assert_close(a, b, atol=1e-5)


def test_seeded_rollout_and_decode_chunk(pair):
    _, gen = pair
    prompt, _, _ = _inputs(4, seed=3, B=2)
    a = gen.generate(prompt, num_frames=N_FRAMES, seed=5)
    b = gen.generate(prompt, num_frames=N_FRAMES, seed=5)
    np.testing.assert_array_equal(a, b)
    assert set(gen.last_timings) == {"encode_s", "rollout_s", "decode_s",
                                     "fetch_s"}
    chunked = serving.VideoGenerator(
        gen.dit_params, gen.vae_params,
        dataclasses.replace(gen.cfg, decode_chunk=4), device="cpu")
    np.testing.assert_array_equal(
        chunked.generate(prompt, num_frames=N_FRAMES, seed=5), a)


def test_generate_validates_inputs(pair):
    _, gen = pair
    prompt, _, _ = _inputs(4)
    with pytest.raises(ValueError, match="actions"):
        gen.generate(prompt, np.zeros((1, 3, 25), np.float32),
                     num_frames=N_FRAMES)
    with pytest.raises(ValueError, match="exceed"):
        gen.generate(prompt, num_frames=4)


@pytest.mark.parametrize("field,value", [
    ("quantize", "int4"), ("mesh_data", 2), ("mesh_model", 2)])
def test_unported_options_raise(field, value):
    """What is not ported raises NotImplementedError; a mesh axis of 2 in
    one process raises ValueError: the mesh must fill the process group
    (tests/test_torch_multiproc.py runs both axes over two processes).
    aot_dir is ported (test_ported_options_accepted)."""
    cfg = serving.ServingConfig(**KW, **{field: value})
    error, match = ((ValueError, "mesh 2x1|mesh 1x2")
                    if field.startswith("mesh") else
                    (NotImplementedError, field))
    with pytest.raises(error, match=match):
        serving.VideoGenerator.load("", "", cfg, device="cpu")


@pytest.mark.parametrize("field,value", [("unstack", False),
                                         ("aot_dir", "x")])
def test_ported_options_accepted(field, value, tmp_path):
    """unstack=False (the stacked layout) builds a generator whose params
    stay stacked; aot_dir (here under tmp_path) one with an AOT cache in
    that directory (tests/test_torch_aot.py holds its contract)."""
    if field == "aot_dir":
        value = str(tmp_path / value)
    cfg = serving.ServingConfig(**KW, **{field: value})
    gen = serving.VideoGenerator.load("", "", cfg, device="cpu")
    if field == "unstack":
        assert dit.is_stacked(gen.dit_params)
    else:
        assert gen._aot.dir == value and os.path.isdir(value)


@pytest.mark.parametrize("case", [
    "depth_is_window", "depth_past_window", "incremental_with_broadcast",
    "incremental_without_cond", "noise_with_pipelining"])
def test_approximate_options_refused_as_gtax(case):
    """What gtax's asserts refuse, raised as ValueError: a pipeline as deep
    as the window or deeper (make_pipelined_rollout's 1 <= P <= W-1),
    incremental pipelining without the conditioning cache or combined with
    attention broadcast (the rollout's own call; serving never builds
    them), and pre-drawn noise for a pipelined generate."""
    from gtax_torch.sampling import diffusion as sd

    cfg = dit.DiT_debug()
    sampler = sd.SamplerConfig(ddim_noise_steps=3, attn_broadcast=2)
    inc = dit.make_incremental_fns(cfg, torch.float32)
    with pytest.raises(ValueError):
        if case.startswith("depth"):
            P = cfg.max_frames + (case == "depth_past_window")
            serving.VideoGenerator.load(
                "", "", serving.ServingConfig(**KW, pipeline_depth=P),
                device="cpu")
        elif case == "incremental_with_broadcast":
            sd.make_pipelined_rollout(
                None, cfg.max_frames, sampler, pipeline_depth=2,
                pab=dit.make_pab_fns(cfg, torch.float32),
                cond=dit.make_cond_fns(cfg, torch.float32, "fused"),
                incremental=inc)
        elif case == "incremental_without_cond":
            sd.make_pipelined_rollout(None, cfg.max_frames, sampler,
                                      pipeline_depth=2, incremental=inc)
        else:
            gen = serving.VideoGenerator.load(
                "", "", serving.ServingConfig(**KW, pipeline_depth=2),
                device="cpu")
            prompt, noise, acts = _inputs(4)
            gen.generate(prompt, acts, num_frames=N_FRAMES, noise=noise)


def test_load_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.VideoGenerator.load("", "", serving.ServingConfig(**KW))


def test_cli_generate_cpu(tmp_path):
    from PIL import Image

    from gtax_torch.cli import generate as cli

    img = tmp_path / "start.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (48, 64, 3), dtype=np.uint8)).save(img)
    out = tmp_path / "v.mp4"
    pixels = cli.main([
        "--total-frames", "3", "--noise_steps", "2", "--dit_model",
        "DiT-debug", "--vae_model", "vae-debug", "--dit_model_path", "",
        "--vae_model_path", "", "--use_actions", "--start_frame", str(img),
        "--output_path", str(out), "--dtype", "float32", "--seed", "0",
        "--device", "cpu"])
    assert pixels.shape == (1, 3, 48, 64, 3)
    assert out.exists() and out.stat().st_size > 0
