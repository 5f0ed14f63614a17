"""Per-row (B, T) window masks through the port's dit_apply and the
rollout's step function (gtax_torch.sampling.diffusion.denoise_step)
against gtax's on the same numpy-seeded window and mask, DiT-debug in
fp32, within 1e-5 of the largest magnitude of gtax's output.

Under `xla` the mask goes to the unfused temporal attention on both sides.
Under `fused` / `pallas` gtax falls through to that same attention for a
(B, T) mask (gtax/models/dit.py:326-328; gtax/nn/attention.py:245), and
the port follows. W8A8 params refuse a (B, T) mask on both sides: gtax's
assertion (gtax/models/dit.py:305-306), the port's ValueError, with the
same reason."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.kernels import attention as kattn
from gtax.models import dit as jdit
from gtax.nn import attention as jattn
from gtax.sampling import diffusion as jdiff
from gtax_torch.models import dit
from gtax_torch.sampling import diffusion as tdiff
from tests.test_torch_models import _gtax_debug_params

torch.set_num_threads(2)

TOL = 1e-5  # of the largest magnitude of gtax's output
# rows with different padding: one row's first two slots, the other's first
ROW_MASK = np.array([[False, False, True, True, True],
                     [False, True, True, True, True]])


@pytest.fixture(autouse=True)
def interpret_mode():
    kattn.set_interpret(True)
    yield
    kattn.set_interpret(None)


@pytest.fixture(scope="module")
def bridged():
    from gtax_torch.io.safetensors_port import dit_from_gtax

    jcfg, jparams = _gtax_debug_params()
    return jcfg, jparams, dit.DiT_debug(), dit_from_gtax(jparams)


def _window(seed=4, B=2, T=5):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, T, 8, 6, 8)).astype(np.float32),
            r.integers(0, 1000, (B, T)).astype(np.int32),
            r.standard_normal((B, T, 25)).astype(np.float32))


def _close(got, ref):
    ref = np.asarray(ref)
    err = np.abs(got.detach().numpy() - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("backend", ["xla", "fused", "pallas"])
def test_dit_apply_row_mask(bridged, backend):
    jcfg, jparams, cfg, params = bridged
    x, t, a = _window()
    with jattn.backend_scope(backend):
        ref = jdit.dit_apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(a), jnp.asarray(ROW_MASK),
                             compute_dtype=jnp.float32)
    got = dit.dit_apply(params, cfg, torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(a), torch.from_numpy(ROW_MASK),
                        compute_dtype=torch.float32, backend=backend)
    _close(got, ref)


def test_row_mask_is_per_row(bridged):
    """Each row of a (B, T) mask is that row's (T,) mask: the rows' outputs
    equal the (T,) runs of their own masks, and differ from each other's."""
    _, _, cfg, params = bridged
    x, t, a = (torch.from_numpy(v) for v in _window())
    both = dit.dit_apply(params, cfg, x, t, a, torch.from_numpy(ROW_MASK),
                         compute_dtype=torch.float32, backend="xla")
    for i, row in enumerate(ROW_MASK):
        one = dit.dit_apply(params, cfg, x[i:i + 1], t[i:i + 1], a[i:i + 1],
                            list(row), compute_dtype=torch.float32,
                            backend="xla")
        assert torch.allclose(both[i], one[0], atol=1e-6, rtol=1e-6)
        other = dit.dit_apply(params, cfg, x[i:i + 1], t[i:i + 1],
                              a[i:i + 1], list(ROW_MASK[1 - i]),
                              compute_dtype=torch.float32, backend="xla")
        assert not torch.allclose(both[i], other[0], atol=1e-4)


def test_denoise_step_row_mask(bridged):
    """The rollout's DDIM step over a (B, T) mask, `xla`: the step's
    prediction and v against gtax's denoise_step."""
    jcfg, jparams, cfg, params = bridged
    x, _, a = _window(5)
    abar = np.linspace(0.999, 0.01, 1000).astype(np.float32)
    noise_range = np.linspace(0, 999, 11).astype(np.int32)

    def jfn(xx, tt, aa, vv):
        return jdit.dit_apply(jparams, jcfg, xx, tt, aa, vv,
                              compute_dtype=jnp.float32)

    with jattn.backend_scope("xla"):
        jx, jv = jdiff.denoise_step(jfn, jnp.asarray(x), jnp.asarray(a),
                                    jnp.asarray(ROW_MASK), 7, 15,
                                    jnp.asarray(noise_range),
                                    jnp.asarray(abar))

    def tfn(xx, tt, aa, vv):
        return dit.dit_apply(params, cfg, xx, tt, aa, vv,
                             compute_dtype=torch.float32, backend="xla")

    tx, tv = tdiff.denoise_step(tfn, torch.from_numpy(x), torch.from_numpy(a),
                                torch.from_numpy(ROW_MASK), 7, 15,
                                noise_range, abar)
    _close(tv, jv)
    _close(tx, jx)


def test_w8a8_refuses_a_row_mask(bridged):
    """gtax asserts a W8A8 temporal branch takes None or a (T,) mask; the
    port raises ValueError with the same reason. A (T,) mask runs."""
    jcfg, jparams, cfg, params = bridged
    x, t, a = _window()
    jq = jdit.quantize_for_inference(jdit.unstack_for_inference(
        jax.tree.map(jnp.asarray, jparams), jcfg), jcfg)
    with pytest.raises(AssertionError) as jerr:
        jdit.dit_apply(jq, jcfg, jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(a), jnp.asarray(ROW_MASK),
                       compute_dtype=jnp.float32)
    q = dit.quantize_for_inference(params)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(a))
    with pytest.raises(ValueError) as err:
        dit.dit_apply(q, cfg, *args, torch.from_numpy(ROW_MASK),
                      compute_dtype=torch.float32, backend="fused")
    assert str(err.value) == str(jerr.value)
    out = dit.dit_apply(q, cfg, *args, list(ROW_MASK[0]),
                        compute_dtype=torch.float32, backend="fused")
    assert torch.isfinite(out).all()
