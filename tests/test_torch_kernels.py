"""The five ported kernel functions, CPU path, against the gtax Pallas
kernels in interpret mode (as tests/test_kernels.py runs them).

Same numpy inputs from a seed on both sides, at DiT_debug / VAE_debug
widths (D=64, 2 heads of 32; S=12 DiT tokens, S=48 VAE tokens), batch 2.

Tolerances:
- fp32: both sides compute the same function in fp32 and differ only in
  summation order and transcendental ulps -> atol/rtol 2e-4 (gtax's own
  fp32 kernel-vs-XLA tolerance).
- bf16: both sides round at the same points (the spatial and MLP branches
  agree bit for bit here), but the gtax temporal cores round every q*k and
  p*v product and partial sum to bf16 where the port accumulates in fp32,
  which moves an output by a bf16 ulp or two -> atol/rtol 5e-2 (outputs
  reach |15|, where one bf16 ulp is 0.0625).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.core import rope as jrope
from gtax.kernels import attention as kattn
from gtax.kernels import block as jblock
from gtax.kernels import vae_block as jvae
from gtax_torch.kernels import block, vae_block
from tests.conftest import assert_close

torch.set_num_threads(2)

D, H = 64, 2
HD = D // H
S = 12  # DiT_debug 3x4 patch grid
DTYPES = {"fp32": (torch.float32, jnp.float32, 2e-4),
          "bf16": (torch.bfloat16, jnp.bfloat16, 5e-2)}


@pytest.fixture(autouse=True)
def interpret_mode():
    kattn.set_interpret(True)
    yield
    kattn.set_interpret(None)


class Inputs:
    """numpy arrays from a seed, handed to both frameworks."""

    def __init__(self, seed, dtype):
        self.gen = np.random.default_rng(seed)
        self.tdt, self.jdt, self.tol = DTYPES[dtype]
        self.arrays = []

    def __call__(self, shape, std=1.0, offset=0.0, cast=True):
        a = (self.gen.standard_normal(shape) * std + offset).astype(
            np.float32)
        self.arrays.append((a, cast))
        return a

    def both(self):
        t = [torch.from_numpy(a).to(self.tdt if c else torch.float32)
             for a, c in self.arrays]
        j = [jnp.asarray(a).astype(self.jdt if c else jnp.float32)
             for a, c in self.arrays]
        return t, j


def _branch(inp, N, *weights):
    inp((N, S, D))
    for _ in range(3):  # shift, scale, gate
        inp((N, D), 0.5)
    for shape, std in weights:
        inp(shape, std)


def _check(got, ref, tol, name=""):
    assert_close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                 atol=tol, rtol=tol, name=name)


def _spatial_freqs():
    return np.array(jrope.axial_freqs(jrope.pixel_freqs(HD // 2, 256.0),
                                      (3, 4), pixel=True)).reshape(S, HD)


def _temporal_freqs(T):
    return np.array(jrope.temporal_rope_freqs(jnp.arange(T),
                                              jrope.lang_freqs(HD)))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_spatial_branch(dtype):
    inp = Inputs(0, dtype)
    _branch(inp, 2, ((D, 3 * D), 0.2), ((D, D), 0.2), ((D,), 0.1))
    (t, j) = inp.both()
    f = _spatial_freqs()
    got = block.fused_spatial_branch(*t, torch.from_numpy(f), H)
    ref = jblock.fused_spatial_branch(*j, jnp.asarray(f), H)
    _check(got, ref, inp.tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_branch(dtype):
    inp = Inputs(1, dtype)
    _branch(inp, 2, ((D, 4 * D), 0.2), ((4 * D,), 0.1), ((4 * D, D), 0.1),
            ((D,), 0.1))
    t, j = inp.both()
    _check(block.fused_mlp_branch(*t), jblock.fused_mlp_branch(*j), inp.tol)


VALIDS = {"all": None, "padded": [False, False, True, True, True]}


@pytest.mark.parametrize("valid", ["all", "padded"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_temporal_branch_emit_kv(dtype, valid):
    T, B = 5, 2
    inp = Inputs(2, dtype)
    _branch(inp, B * T, ((D, 3 * D), 0.2), ((D, D), 0.2), ((D,), 0.1))
    t, j = inp.both()
    f = _temporal_freqs(T)
    v = VALIDS[valid]
    got = block.fused_temporal_branch(*t, torch.from_numpy(f), v, H, T,
                                      emit_kv=True)
    ref = jblock.fused_temporal_branch(
        *j, jnp.asarray(f), None if v is None else jnp.asarray(v), H, T,
        emit_kv=True)
    for name, a, b in zip(("out", "k", "v"), got, ref):
        _check(a, b, inp.tol, name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_temporal_step(dtype):
    B, n_ctx = 2, 4
    inp = Inputs(3, dtype)
    _branch(inp, B, ((D, 3 * D), 0.2), ((D, D), 0.2), ((D,), 0.1))
    inp((B * n_ctx * S, D))  # k_ctx
    inp((B * n_ctx * S, D))  # v_ctx
    t, j = inp.both()
    f = _temporal_freqs(n_ctx + 1)
    v = [False, True, True, True, True]
    got = block.fused_temporal_step(*t, torch.from_numpy(f), v, H, n_ctx)
    ref = jblock.fused_temporal_step(*j, jnp.asarray(f), jnp.asarray(v), H,
                                     n_ctx)
    _check(got, ref, inp.tol)


def test_temporal_step_equals_full_window_rows():
    """The step over a context emitted by the full branch reproduces the
    full window's last-frame rows (what incremental decoding relies on)."""
    B, T = 2, 5
    inp = Inputs(4, "fp32")
    _branch(inp, B * T, ((D, 3 * D), 0.2), ((D, D), 0.2), ((D,), 0.1))
    (x, sh, sc, g, qw, ow, ob), _ = inp.both()
    f = torch.from_numpy(_temporal_freqs(T))
    v = [False, True, True, True, True]
    full = block.fused_temporal_branch(x, sh, sc, g, qw, ow, ob, f, v, H, T)

    def rows(a, sl):
        return a.reshape(B, T, *a.shape[1:])[:, sl].reshape(-1, *a.shape[1:])

    ctx = slice(0, T - 1)
    _, kk, vv = block.fused_temporal_branch(
        rows(x, ctx), rows(sh, ctx), rows(sc, ctx), rows(g, ctx), qw, ow, ob,
        f[:T - 1], v[:-1], H, T - 1, emit_kv=True)
    last = slice(T - 1, T)
    step = block.fused_temporal_step(
        rows(x, last), rows(sh, last), rows(sc, last), rows(g, last), qw, ow,
        ob, kk.reshape(-1, D), vv.reshape(-1, D), f, v, H, T - 1)
    assert_close(step, rows(full, last), atol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_vae_block(dtype):
    S_v, rot = 48, HD // 2
    inp = Inputs(5, dtype)
    inp((2, S_v, D))
    inp((D,), 0.1, 1.0, cast=False)   # ln1_w
    inp((D,), 0.1, cast=False)        # ln1_b
    inp((D, 3 * D), 0.2)
    inp((3 * D,), 0.1, cast=False)
    inp((D, D), 0.2)
    inp((D,), 0.1, cast=False)
    inp((D,), 0.1, 1.0, cast=False)   # ln2_w
    inp((D,), 0.1, cast=False)
    inp((D, 4 * D), 0.2)
    inp((4 * D,), 0.1, cast=False)
    inp((4 * D, D), 0.1)
    inp((D,), 0.1, cast=False)
    t, j = inp.both()
    f = np.array(jrope.axial_freqs(jrope.pixel_freqs(HD // 4, 48.0),
                                   (6, 8), pixel=True)).reshape(S_v, rot)
    got = vae_block.fused_vae_block(*t, torch.from_numpy(f), H)
    ref = jvae.fused_vae_block(*j, jnp.asarray(f), H)
    _check(got, ref, inp.tol)


def test_cpu_tensor_takes_plain_version():
    inp = Inputs(6, "fp32")
    _branch(inp, 1, ((D, 4 * D), 0.2), ((4 * D,), 0.1), ((4 * D, D), 0.1),
            ((D,), 0.1))
    t, _ = inp.both()
    before = block.fused_mlp_branch.launches
    out = block.fused_mlp_branch(*t)
    assert block.fused_mlp_branch.launches == before  # no kernel launched
    assert torch.equal(out, block.mlp_branch_plain(*t))
