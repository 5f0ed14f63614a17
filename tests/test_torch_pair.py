"""The paired W8A8 kernels of the port (gtax_torch.kernels.pair) and their
routing, on the CPU: the port's plain versions against gtax's
fused_spatial_pair_q / fused_temporal_pair_q in interpret mode, with the
same numpy inputs from a seed on both sides, at tests/test_pair.py's
sizes (S=48 tokens, D=64, 2 heads, MLP width H=256, N = 1 or 2 frames).

Tolerances:
- port pair against gtax pair: the int8 tolerance of
  tests/test_torch_quant.py (check_int8: fp32 at least 99% of the
  elements within 2e-4, bf16 at least 99.9% within 5e-2, every element
  within 2**-6 of the output's largest magnitude), the tolerance of the
  matching sequential branch cases there: both sides quantize the same
  values and differ only in summation order, which may flip an int8
  rounding.
- port pair against the port's sequential pair: bit for bit
  (torch.equal); the pair's plain version is that sequence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.kernels import attention as kattn
from gtax.kernels import pair as jpair
from gtax.kernels import quant as jquant
from gtax.models import dit as jdit
from gtax_torch.kernels import pair, quant
from gtax_torch.models import dit
from tests.test_torch_quant import DTYPES, check_int8, quantized  # noqa: F401
from tests.test_torch_quant import _cut
from tests.test_torch_models import _window

torch.set_num_threads(2)

S, D, HID, NH = 48, 64, 256, 2


@pytest.fixture(autouse=True)
def interpret_mode():
    kattn.set_interpret(True)
    yield
    kattn.set_interpret(None)


class PairInputs:
    """numpy inputs from a seed at tests/test_pair.py's scales, in both
    frameworks: x, the six per-frame vectors, the int8 attention and MLP
    weights (quantized once by gtax)."""

    def __init__(self, seed, dtype, N):
        self.gen = np.random.default_rng(seed)
        self.tdt, self.jdt = DTYPES[dtype]
        self.t, self.j = [], []
        self.act((N, S, D))
        for _ in range(6):  # sh1, sc1, g1, sh2, sc2, g2
            self.act((N, D), 0.3)
        self.qweight((D, 3 * D), 0.05)
        self.qweight((D, D), 0.05)
        self.act((D,), 0.01, cast=False)
        self.qweight((D, HID), 0.05)
        self.act((HID,), 0.01, cast=False)
        self.qweight((HID, D), 0.05)
        self.act((D,), 0.01, cast=False)

    def act(self, shape, std=1.0, cast=True):
        a = (self.gen.standard_normal(shape) * std).astype(np.float32)
        self.t.append(torch.from_numpy(a).to(self.tdt if cast
                                             else torch.float32))
        self.j.append(jnp.asarray(a).astype(self.jdt if cast
                                            else jnp.float32))

    def qweight(self, shape, std):
        w = (self.gen.standard_normal(shape) * std).astype(np.float32)
        q, s = jquant.quantize_weight(jnp.asarray(w))
        self.t += [torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))]
        self.j += [q, s]

    def extra(self, shape, std=1.0):
        """One more compute-dtype array, returned in both frameworks."""
        self.act(shape, std)
        return self.t.pop(), self.j.pop()

    def freqs(self, rows):
        f = self.gen.standard_normal((rows, D // NH)).astype(np.float32)
        return torch.from_numpy(f), jnp.asarray(f)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("N", [1, 2])
def test_spatial_pair_matches_gtax(N, dtype):
    inp = PairInputs(N, dtype, N)
    tf, jf = inp.freqs(S)
    got = pair.fused_spatial_pair_q(*inp.t, tf, NH)
    ref = jpair.fused_spatial_pair_q(*inp.j, jf, NH)
    check_int8(got, ref, dtype)


LIVE = [(1, 1), (2, 1), (1, 2)]  # (B, n_live): N = B * n_live frames


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,n_live", LIVE, ids=["B1-live1", "B2-live1",
                                                 "B1-live2"])
def test_temporal_pair_matches_gtax(B, n_live, dtype):
    n_ctx = 3
    T = n_ctx + n_live
    inp = PairInputs(10 + B + n_live, dtype, B * n_live)
    kc, jkc = inp.extra((B * n_ctx * S, D))
    vc, jvc = inp.extra((B * n_ctx * S, D))
    tf, jf = inp.freqs(T)
    valid = [False] + [True] * (T - 1)  # slot 0 padded
    got = pair.fused_temporal_pair_q(*inp.t, kc, vc, tf, valid, NH, n_ctx,
                                     n_live=n_live)
    ref = jpair.fused_temporal_pair_q(*inp.j, jkc, jvc, jf,
                                      jnp.asarray(valid), NH, n_ctx,
                                      n_live=n_live)
    check_int8(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pair_plain_equals_sequential_plain(dtype):
    """The pair's plain version is the port's sequential plain pair: equal
    bit for bit, spatial and temporal."""
    inp = PairInputs(20, dtype, 2)
    x, sh1, sc1, g1, sh2, sc2, g2, *w = inp.t
    attn_w, mlp_w = w[:5], w[5:]
    tf, _ = inp.freqs(S)
    seq = quant.mlp_branch_q_plain(
        quant.spatial_branch_q_plain(x, sh1, sc1, g1, *attn_w, tf, NH),
        sh2, sc2, g2, *mlp_w)
    assert torch.equal(pair.fused_spatial_pair_q(*inp.t, tf, NH), seq)

    n_ctx, valid = 4, [False, True, True, True, True]
    kc, _ = inp.extra((2 * n_ctx * S, D))
    vc, _ = inp.extra((2 * n_ctx * S, D))
    tf, _ = inp.freqs(n_ctx + 1)
    seq = quant.mlp_branch_q_plain(
        quant.temporal_step_q_plain(x, sh1, sc1, g1, *attn_w, kc, vc, tf,
                                    valid, NH, n_ctx),
        sh2, sc2, g2, *mlp_w)
    got = pair.fused_temporal_pair_q(*inp.t, kc, vc, tf, valid, NH, n_ctx)
    assert torch.equal(got, seq)


def test_cpu_pair_counts_no_launch_and_tanh_gelu_only():
    """The plain version launches nothing, in either GELU mode; the tanh
    GELU is the default, and approx_gelu=False (once refused) computes the
    exact one: tests/test_torch_exact_gelu.py holds it against gtax."""
    inp = PairInputs(30, "fp32", 1)
    tf, _ = inp.freqs(S)
    before = pair.fused_spatial_pair_q.launches
    tanh = pair.fused_spatial_pair_q(*inp.t, tf, NH)
    exact = pair.fused_spatial_pair_q(*inp.t, tf, NH, approx_gelu=False)
    assert pair.fused_spatial_pair_q.launches == before
    assert torch.equal(tanh, pair.fused_spatial_pair_q(*inp.t, tf, NH,
                                                       approx_gelu=True))
    assert not torch.equal(tanh, exact)


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("B", [1, 4])
def test_int8_step_routing(quantized, monkeypatch, B):
    """gtax's gate: a W8A8 half-block over at most 2 live frames takes the
    pair (the B=1 step), more frames the sequential wrappers (B=4), and the
    B=1 prefill (4 context frames) stays sequential."""
    _, _, cfg, params = quantized
    calls = []
    for name in ("fused_spatial_pair_q", "fused_temporal_pair_q"):
        _spy(monkeypatch, pair, name, calls)
    for name in ("fused_spatial_branch_q", "fused_temporal_step_q",
                 "fused_mlp_branch_q"):
        _spy(monkeypatch, quant, name, calls)
    x, t, a = _window(5, B=B)
    mods = dit.dit_cond(params, cfg, torch.from_numpy(t), torch.from_numpy(a),
                        torch.float32)
    valid = [False, True, True, True, True]
    kv = dit.dit_prefill(params, cfg, torch.from_numpy(x[:, :4]),
                         _cut(mods, slice(0, 4)), valid[:4], torch.float32)
    n_blocks = cfg.depth
    assert calls.count("fused_spatial_branch_q") == n_blocks
    assert "fused_spatial_pair_q" not in calls
    calls.clear()
    dit.dit_apply_step(params, cfg, torch.from_numpy(x[:, 4:]), kv,
                       _cut(mods, slice(4, 5)), valid, torch.float32)
    if B == 1:
        assert calls == ["fused_spatial_pair_q", "fused_temporal_pair_q"] * \
            n_blocks
    else:
        assert calls == ["fused_spatial_branch_q", "fused_mlp_branch_q",
                         "fused_temporal_step_q", "fused_mlp_branch_q"] * \
            n_blocks


def test_int8_step_b1_matches_gtax(quantized):
    """int8 dit_apply_step at B=1, where both gtax and the port pair every
    half-block, against gtax's; the prefill (sequential on both sides)
    feeds it."""
    jcfg, jq, cfg, params = quantized
    x, t, a = _window(6, B=1)
    valid = [False, True, True, True, True]
    jvalid = jnp.asarray(valid)
    jmods = jdit.dit_cond(jq, jcfg, jnp.asarray(t), jnp.asarray(a),
                          jnp.float32)
    mods = dit.dit_cond(params, cfg, torch.from_numpy(t), torch.from_numpy(a),
                        torch.float32)
    ctx, last = slice(0, 4), slice(4, 5)

    def jcut(tree, sl):
        return {"blocks": tuple({k: m[:, sl] for k, m in b.items()}
                                for b in tree["blocks"]),
                "final": tree["final"][:, sl]}

    jkv = jdit.dit_prefill(jq, jcfg, jnp.asarray(x[:, ctx]), jcut(jmods, ctx),
                           jvalid[ctx], jnp.float32)
    kv = dit.dit_prefill(params, cfg, torch.from_numpy(x[:, ctx]),
                         _cut(mods, ctx), valid[ctx], torch.float32)
    ref = jdit.dit_apply_step(jq, jcfg, jnp.asarray(x[:, last]), jkv,
                              jcut(jmods, last), jvalid, jnp.float32)
    got = dit.dit_apply_step(params, cfg, torch.from_numpy(x[:, last]), kv,
                             _cut(mods, last), valid, torch.float32)
    check_int8(got, ref, name="step")
