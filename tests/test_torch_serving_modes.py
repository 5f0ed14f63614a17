"""Serving and generate-CLI options this slice ports, on the CPU against
gtax: ServingConfig(unstack=False), the stacked layout's full-window
rollout (no conditioning cache, no incremental decoding), and the generate
CLI's test-set prompts (no --start_frame, or --batch_distinct) read from
a tiny tar shard built as tests/test_torch_data.py builds its shards.

Tolerances: pixels within 1 LSB of gtax's, latents bit-equal between the
port's own stacked and unstacked full-window rollouts, as in
test_torch_serving.py; the prompts and actions the two CLIs hand their
generators bit-equal (the same JPEG decode and resize as
test_torch_data.py's streams)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax import serving as jserving
from gtax.cli import generate as jcli
from gtax.data import common as jcommon
from gtax.data import loader as jloader
from gtax.models import vae as jvae
from gtax_torch import serving
from gtax_torch.cli import generate as tcli
from gtax_torch.data import common as tcommon
from gtax_torch.data import loader as tloader
from gtax_torch.data.actions import forward_actions
from gtax_torch.io import safetensors_port as port
from gtax_torch.models import dit
from tests.test_torch_data import _shard
from tests.test_torch_models import _gtax_debug_params
from tests.test_torch_serving import (  # noqa: F401 (autouse fixture)
    KW, N_FRAMES, _inputs, interpret_mode)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    """gtax DiT-debug and VAE-debug weights (numpy), as test_torch_serving's
    pair holds them."""
    _, jdit_params = _gtax_debug_params()
    jv = jvae.vae_init(jax.random.PRNGKey(1), jvae.VAE_debug())
    jv = jax.tree.map(lambda l: np.asarray(l + 0.01 if l.ndim == 1 else l),
                      jv)
    return jdit_params, jv


def _pair(weights, **cfg):
    jdit_params, jv = weights
    jgen = jserving.VideoGenerator(
        jax.tree.map(jnp.asarray, jdit_params),
        jax.tree.map(jnp.asarray, jv), jserving.ServingConfig(**KW, **cfg))
    gen = serving.VideoGenerator(
        port.dit_from_gtax(jdit_params), port.vae_from_gtax(jv),
        serving.ServingConfig(**KW, **cfg), device="cpu")
    return jgen, gen


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_unstack_false_matches_gtax(weights, quantize):
    """unstack=False: the params stay stacked (quantized per block under
    int8), the rollout is the full-window one; pixels within 1 LSB of
    gtax's VideoGenerator(unstack=False) on the same noise, and the
    latents bit-equal to the port's unstacked rollout without the
    conditioning cache."""
    jgen, gen = _pair(weights, unstack=False, quantize=quantize)
    assert dit.is_stacked(gen.dit_params)
    prompt, noise, acts = _inputs(3, seed=9)
    ref = jgen.generate(prompt, acts, num_frames=N_FRAMES,
                        noise=jnp.asarray(noise))
    got = gen.generate(prompt, acts, num_frames=N_FRAMES, noise=noise)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1

    jdit_params, jv = weights
    flat = serving.VideoGenerator(
        port.dit_from_gtax(jdit_params), port.vae_from_gtax(jv),
        serving.ServingConfig(**KW, quantize=quantize, cond_cache=False),
        device="cpu")
    with torch.no_grad():
        lat = serving.encode_frames(gen.vae_params, gen.vae_cfg,
                                    torch.from_numpy(prompt), torch.float32)
        outs = [g._rollout(g.dit_params, lat, torch.from_numpy(acts),
                           torch.Generator(), N_FRAMES - 3,
                           noise=torch.from_numpy(noise))
                for g in (gen, flat)]
    assert torch.equal(outs[0], outs[1])


# ------------------------------------------------- test-set prompts

@pytest.fixture
def test_split(tmp_path, monkeypatch):
    """The webdataset "test" split of both frameworks on one local shard
    of three clips, resized to the VAE-debug geometry, streamed in order;
    returns the shard's path."""
    path = str(tmp_path / "00000.tar")
    _shard(path, 0, 3)

    def wrap(module, common):
        make = module.make_dataset

        def make_dataset(kind, split, actions, **kw):
            assert (kind, split) == ("webdataset", "test")
            return make(kind, split, actions, shards=[path],
                        shuffle_shards=False, shuffle_buffer=1,
                        resampled=False,
                        transform=common.ClipTransform(target_h=48,
                                                       target_w=64), **kw)

        monkeypatch.setattr(module, "make_dataset", make_dataset)

    wrap(jloader, jcommon)
    wrap(tloader, tcommon)
    return path


def _captured(cli, gen_cls, monkeypatch, argv):
    """The (video, actions) a CLI hands its generator's generate."""
    seen = {}

    def generate(self, video, actions=None, num_frames=32, seed=0, **kw):
        self.last_timings = {"rollout_s": 1.0}
        seen["video"] = np.asarray(video, np.float32)
        seen["actions"] = (None if actions is None
                           else np.asarray(actions, np.float32))
        return np.zeros((np.asarray(video).shape[0], num_frames, 48, 64, 3),
                        np.uint8)

    monkeypatch.setattr(gen_cls, "generate", generate)
    cli.main(argv)
    return seen


@pytest.mark.parametrize("args", [["--batch", "2"],
                                  ["--batch", "2", "--batch_distinct"],
                                  ["--batch", "1"]],
                         ids=["replicated", "distinct", "single"])
def test_cli_test_set_prompts_match_gtax(args, test_split, tmp_path,
                                         monkeypatch):
    """Without --start_frame the CLI prompts with the first 4 frames of
    test-set clips: one clip for every stream, or with --batch_distinct
    one clip a stream; their actions padded with "forward" to
    --total-frames. The port's prompts and actions bit-equal to gtax's."""
    common = ["--total-frames", "8", "--noise_steps", "2", "--dit_model",
              "DiT-debug", "--vae_model", "vae-debug", "--dit_model_path",
              "", "--vae_model_path", "", "--use_actions", "--dtype",
              "float32", "--seed", "0", *args]
    ref = _captured(jcli, jserving.VideoGenerator, monkeypatch,
                    common + ["--output_path", str(tmp_path / "j.mp4")])
    got = _captured(tcli, serving.VideoGenerator, monkeypatch,
                    common + ["--output_path", str(tmp_path / "t.mp4"),
                              "--device", "cpu"])
    n = 2 if "2" in args else 1
    assert got["video"].shape == ref["video"].shape == (n, 4, 3, 48, 64)
    assert got["actions"].shape == ref["actions"].shape == (n, 8, 25)
    np.testing.assert_array_equal(got["video"], ref["video"])
    np.testing.assert_array_equal(got["actions"], ref["actions"])
    distinct = not np.array_equal(got["video"][0], got["video"][-1])
    assert distinct == ("--batch_distinct" in args)
    np.testing.assert_array_equal(got["actions"][:, 5:],
                                  forward_actions(n, 3))


def test_cli_batch_distinct_with_start_frame_raises(tmp_path):
    """gtax asserts --batch_distinct and --start_frame exclude each
    other; the port raises ValueError."""
    with pytest.raises(AssertionError):
        jcli.main(["--batch_distinct", "--start_frame", "x.png"])
    with pytest.raises(ValueError, match="batch_distinct"):
        tcli.main(["--batch_distinct", "--start_frame", "x.png",
                   "--device", "cpu"])
