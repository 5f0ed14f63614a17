"""The MLP branches' exact-GELU mode (approx_gelu=False) of the port, on
the CPU: the plain versions of fused_mlp_branch (#2, fp32 and bf16),
fused_mlp_branch_q (#9) and the two int8 pairs (#10, #11) against gtax's
kernels in interpret mode, with the same numpy inputs from a seed on both
sides, and the default (approx_gelu=True) against the arithmetic the port
computed before the flag existed, bit for bit.

Tolerances, and why:
- #2: those of tests/test_torch_kernels.py (fp32 atol/rtol 2e-4, gtax's
  own fp32 kernel tolerance; bf16 5e-2, a bf16 ulp or two at |15|): the
  two sides round at the same points and differ in summation order and
  in erfc's last bits (torch's against XLA's).
- #9-#11: the int8 rules of tests/test_torch_quant.py (check_int8): both
  sides quantize the same values, and an erfc ulp can flip an int8
  rounding of the GELU output as summation order can.
- approx_gelu=True against the former arithmetic, and a pair against
  its sequential wrappers: bit for bit (the same torch operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.kernels import attention as kattn
from gtax.kernels import block as jblock
from gtax.kernels import pair as jpair
from gtax.kernels import quant as jquant
from gtax_torch.kernels import block, pair, quant
from tests.test_torch_kernels import DTYPES, Inputs, _branch, _check
from tests.test_torch_pair import NH, PairInputs
from tests.test_torch_pair import S as PAIR_S
from tests.test_torch_quant import HID, QInputs, check_int8

torch.set_num_threads(2)

D = 64


@pytest.fixture(autouse=True)
def interpret_mode():
    kattn.set_interpret(True)
    yield
    kattn.set_interpret(None)


def _mlp_inputs(dtype, seed=1):
    inp = Inputs(seed, dtype)
    _branch(inp, 2, ((D, 4 * D), 0.5), ((4 * D,), 0.3), ((4 * D, D), 0.1),
            ((D,), 0.1))
    return inp


def _q_inputs(dtype, seed=1):
    inp = QInputs(seed, dtype)
    inp.branch(2)
    inp.qweight((D, HID), 0.5)
    inp.act((HID,), 0.3)
    inp.qweight((HID, D), 0.1)
    inp.act((D,), 0.1)
    return inp


# ------------------------------------------------------------- the GELU

def test_gelu_exact32_is_jax_gelu():
    """gelu_exact32 is jax.nn.gelu(approximate=False) (0.5 x erfc(-x /
    sqrt 2)) within an fp32 ulp or two, and not the tanh form."""
    h = np.linspace(-9.0, 9.0, 4001, dtype=np.float32)
    got = block.gelu_exact32(torch.from_numpy(h)).numpy()
    ref = np.asarray(jax.nn.gelu(jnp.asarray(h), approximate=False))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    tanh = block.gelu_tanh32(torch.from_numpy(h)).numpy()
    assert np.abs(tanh - ref).max() > 1e-4
    assert block.gelu32(True) is block.gelu_tanh32
    assert block.gelu32(False) is block.gelu_exact32


# --------------------------------------------------------------- #2

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_branch_exact_gelu_matches_gtax(dtype):
    inp = _mlp_inputs(dtype)
    t, j = inp.both()
    got = block.fused_mlp_branch(*t, approx_gelu=False)
    ref = jblock.fused_mlp_branch(*j, approx_gelu=False)
    _check(got, ref, inp.tol)
    tanh = jblock.fused_mlp_branch(*j)  # the flag moves the output
    assert not np.array_equal(np.asarray(tanh.astype(jnp.float32)),
                              np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_branch_exact_gelu_emit_train_matches_gtax(dtype):
    """emit_train with the exact GELU: (out, h1 before the GELU, y)."""
    inp = _mlp_inputs(dtype, seed=2)
    t, j = inp.both()
    got = block.fused_mlp_branch(*t, approx_gelu=False, emit_train=True)
    ref = jblock.fused_mlp_branch(*j, approx_gelu=False, emit_train=True)
    assert len(got) == len(ref) == 3
    for a, b, name in zip(got, ref, ("out", "h1", "y")):
        _check(a, b, inp.tol, name)


def _former_mlp_plain(x, shift, scale, gate, w1, b1, w2, b2):
    """block.mlp_branch_plain as the port computed it before the flag."""
    dt = x.dtype
    x32 = x.float()
    h = block.mm32(block._modulated(x32, shift, scale, dt), w1) + b1.float()
    y = block.mm32(block.gelu_tanh32(h).to(dt), w2) + b2.float()
    return (x32 + gate.float()[:, None] * y).to(dt)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_branch_default_bits_unchanged(dtype):
    t, _ = _mlp_inputs(dtype, seed=3).both()
    former = _former_mlp_plain(*t)
    assert torch.equal(block.fused_mlp_branch(*t), former)
    assert torch.equal(block.fused_mlp_branch(*t, approx_gelu=True), former)
    assert not torch.equal(block.fused_mlp_branch(*t, approx_gelu=False),
                           former)


# --------------------------------------------------------------- #9

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_branch_q_exact_gelu_matches_gtax(dtype):
    inp = _q_inputs(dtype)
    got = quant.fused_mlp_branch_q(*inp.t, approx_gelu=False)
    ref = jquant.fused_mlp_branch_q(*inp.j, approx_gelu=False)
    check_int8(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_branch_q_exact_gelu_emit_train_matches_gtax(dtype):
    inp = _q_inputs(dtype, seed=4)
    got = quant.fused_mlp_branch_q(*inp.t, approx_gelu=False,
                                   emit_train=True)
    ref = jquant.fused_mlp_branch_q(*inp.j, approx_gelu=False,
                                    emit_train=True)
    for a, b, name in zip(got, ref, ("out", "h1", "y")):
        check_int8(a, b, dtype, name)


def _former_mlp_q_plain(x, shift, scale, gate, w1_q, w1_s, b1, w2_q, w2_s,
                        b2):
    """quant.mlp_branch_q_plain as the port computed it before the flag."""
    x32 = x.float()
    Hd = w1_q.shape[-1]
    nc = quant._mlp_chunks(Hd)
    G = Hd // nc
    h = quant.qdot(quant.modulated32(x32, shift, scale), w1_q, w1_s) \
        + b1.float()
    hq, hs = quant.quant_rows(block.gelu_tanh32(h), G)
    acc = torch.zeros_like(x32)
    for c in range(nc):
        cols = slice(c * G, (c + 1) * G)
        acc = acc + quant.mm_int(hq[..., cols], w2_q[cols]) * hs[..., c:c + 1]
    y = acc * w2_s.reshape(-1) + b2.float()
    return quant._gated(x32, gate, y, x.dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_branch_q_default_bits_unchanged(dtype):
    t = _q_inputs(dtype, seed=5).t
    former = _former_mlp_q_plain(*t)
    assert torch.equal(quant.fused_mlp_branch_q(*t), former)
    assert torch.equal(quant.fused_mlp_branch_q(*t, approx_gelu=True),
                       former)
    assert not torch.equal(quant.fused_mlp_branch_q(*t, approx_gelu=False),
                           former)


# ---------------------------------------------------------- #10, #11

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_spatial_pair_exact_gelu_matches_gtax(dtype):
    inp = PairInputs(40, dtype, 2)
    tf, jf = inp.freqs(PAIR_S)
    got = pair.fused_spatial_pair_q(*inp.t, tf, NH, approx_gelu=False)
    ref = jpair.fused_spatial_pair_q(*inp.j, jf, NH, approx_gelu=False)
    check_int8(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n_live", [1, 2])
def test_temporal_pair_exact_gelu_matches_gtax(dtype, n_live):
    n_ctx = 3
    T = n_ctx + n_live
    inp = PairInputs(41 + n_live, dtype, n_live)
    kc, jkc = inp.extra((n_ctx * PAIR_S, D))
    vc, jvc = inp.extra((n_ctx * PAIR_S, D))
    tf, jf = inp.freqs(T)
    valid = [False] + [True] * (T - 1)
    got = pair.fused_temporal_pair_q(*inp.t, kc, vc, tf, valid, NH, n_ctx,
                                     n_live=n_live, approx_gelu=False)
    ref = jpair.fused_temporal_pair_q(*inp.j, jkc, jvc, jf,
                                      jnp.asarray(valid), NH, n_ctx,
                                      n_live=n_live, approx_gelu=False)
    check_int8(got, ref, dtype)


@pytest.mark.parametrize("approx_gelu", [True, False])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pairs_equal_sequential_wrappers(dtype, approx_gelu):
    """Each pair is its two sequential int8 wrappers with the same GELU,
    bit for bit, in both modes."""
    inp = PairInputs(45, dtype, 2)
    x, sh1, sc1, g1, sh2, sc2, g2, *w = inp.t
    attn_w, mlp_w = w[:5], w[5:]
    tf, _ = inp.freqs(PAIR_S)
    kw = {"approx_gelu": approx_gelu}
    seq = quant.fused_mlp_branch_q(
        quant.fused_spatial_branch_q(x, sh1, sc1, g1, *attn_w, tf, NH),
        sh2, sc2, g2, *mlp_w, **kw)
    assert torch.equal(pair.fused_spatial_pair_q(*inp.t, tf, NH, **kw), seq)
    n_ctx, valid = 4, [False, True, True, True, True]
    kc, _ = inp.extra((2 * n_ctx * PAIR_S, D))
    vc, _ = inp.extra((2 * n_ctx * PAIR_S, D))
    tf, _ = inp.freqs(n_ctx + 1)
    seq = quant.fused_mlp_branch_q(
        quant.fused_temporal_step_q(x, sh1, sc1, g1, *attn_w, kc, vc, tf,
                                    valid, NH, n_ctx),
        sh2, sc2, g2, *mlp_w, **kw)
    got = pair.fused_temporal_pair_q(*inp.t, kc, vc, tf, valid, NH, n_ctx,
                                     **kw)
    assert torch.equal(got, seq)

