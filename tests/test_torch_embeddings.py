"""gtax_torch.nn.embeddings against gtax.nn.embeddings: the seven functions
on the same numpy-seeded inputs and params, fp32, rtol 1e-6 (with an atol
of 1e-6 for elements near zero, where one fp32 ulp of sin or cos is the
whole relative error).

get_timestep_embedding at diffusion timesteps (up to 999, times `scale`)
adds the argument's rounding to that atol: XLA's fp32 exp on the CPU is
not correctly rounded (one ulp off torch's, and off float64's exp rounded
to fp32, at some frequencies), and an argument t * freq * scale of up to
2,500 turns that ulp into ~1e-6 of sin. There the port is also held to the
float64 formula, no further from it than gtax is (within that ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.nn import embeddings as jemb
from gtax_torch.nn import embeddings as temb

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("flip,shift,scale,max_period,dim", [
    (False, 1.0, 1.0, 10000.0, 32), (True, 0.0, 1.0, 10000.0, 32),
    (True, 1.0, 2.5, 500.0, 33), (False, 0.0, 0.5, 10000.0, 7)])
def test_get_timestep_embedding(flip, shift, scale, max_period, dim):
    t = np.random.default_rng(0).uniform(0, 999, (3, 4)).astype(np.float32)
    want = jemb.get_timestep_embedding(
        jnp.asarray(t), dim, flip_sin_to_cos=flip,
        downscale_freq_shift=shift, scale=scale, max_period=max_period)
    got = temb.get_timestep_embedding(
        torch.from_numpy(t), dim, flip_sin_to_cos=flip,
        downscale_freq_shift=shift, scale=scale, max_period=max_period)
    assert got.dtype == torch.float32 and got.shape == (3, 4, dim)
    # one ulp of a frequency (2**-24 relative) times the largest argument,
    # on each side
    arg_ulp = 2 * float(t.max()) * scale * 2.0**-24
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                               atol=1e-6 + arg_ulp)
    exact = _formula(t, dim, flip, shift, scale, max_period)
    assert (np.abs(_np(got) - exact).max()
            <= np.abs(_np(want) - exact).max() + arg_ulp)


def _formula(t, dim, flip, shift, scale, max_period):
    """The sinusoid in float64 (tests/test_embeddings.py's re-derivation,
    with scale, max_period and the odd dim's zero column)."""
    half = dim // 2
    freqs = np.exp(-np.log(max_period) * np.arange(half) / (half - shift))
    args = t.astype(np.float64)[..., None] * freqs * scale
    out = np.concatenate([np.sin(args), np.cos(args)], axis=-1)
    if flip:
        out = np.concatenate([out[..., half:], out[..., :half]], axis=-1)
    if dim % 2:
        out = np.concatenate([out, np.zeros(out.shape[:-1] + (1,))], -1)
    return out


def test_timesteps_embedding():
    pos = np.arange(17)
    np.testing.assert_allclose(
        _np(temb.timesteps_embedding(torch.from_numpy(pos), 24)),
        _np(jemb.timesteps_embedding(jnp.asarray(pos), 24)), **TOL)


def test_positions_2d_embedding():
    got = temb.positions_2d_embedding(torch.arange(3), torch.arange(5), 16)
    want = jemb.positions_2d_embedding(jnp.arange(3), jnp.arange(5), 16)
    assert got.shape == (3, 5, 16)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _mlp_params(din=16, hidden=64, dout=16):
    """gtax's init (its key), as numpy: both sides run the same params."""
    p = jemb.timestep_embedding_mlp_init(jax.random.PRNGKey(3), din, hidden,
                                         out_dim=dout)
    return (jax.tree.map(np.asarray, p),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p))


def test_timestep_embedding_mlp_init():
    """The same tree, shapes and dtypes, zero biases, kernels uniform in
    +-1/sqrt(fan_in) (the draws are torch's own)."""
    jp, _ = _mlp_params()
    tp = temb.timestep_embedding_mlp_init(
        torch.Generator().manual_seed(0), 16, 64, out_dim=16)
    for name, din in (("fc1", 16), ("fc2", 64)):
        for leaf in ("kernel", "bias"):
            assert tuple(tp[name][leaf].shape) == jp[name][leaf].shape
            assert tp[name][leaf].dtype == torch.float32
        assert torch.equal(tp[name]["bias"], torch.zeros_like(
            tp[name]["bias"]))
        k = tp[name]["kernel"]
        assert k.abs().max() <= din**-0.5 and k.std() > 0.4 * din**-0.5
    assert temb.timestep_embedding_mlp_init(
        torch.Generator().manual_seed(0), 8, 32)["fc2"]["kernel"].shape == (
            32, 32)


def test_timestep_embedding_mlp():
    jp, tp = _mlp_params()
    x = np.random.default_rng(1).standard_normal((5, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(temb.timestep_embedding_mlp(tp, torch.from_numpy(x))),
        _np(jemb.timestep_embedding_mlp(jp, jnp.asarray(x))), **TOL)


def test_temporal_pos_emb_fallback():
    jp, tp = _mlp_params()
    got = temb.temporal_pos_emb_fallback(tp, 5, 16)
    assert got.shape == (5, 16)
    np.testing.assert_allclose(
        _np(got), _np(jemb.temporal_pos_emb_fallback(jp, 5, 16)), **TOL)


def test_spatial_pos_emb_fallback():
    jp, tp = _mlp_params()
    got = temb.spatial_pos_emb_fallback(tp, 3, 4, 16)
    assert got.shape == (3, 4, 16)
    np.testing.assert_allclose(
        _np(got), _np(jemb.spatial_pos_emb_fallback(jp, 3, 4, 16)), **TOL)
