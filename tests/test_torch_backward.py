"""The training kernels' CPU path against gtax: the emit_train residuals of
the forward branches, the three whole-branch backwards, and the autograd
Functions of gtax_torch.nn.branches.

gtax's Pallas kernels run in interpret mode (as tests/test_kernels.py runs
them). The same numpy inputs from a seed go to both sides, at gtax's own
backward-test shapes: N=10 frames of S=16 tokens, D=64, 4 heads of 16
(temporal: B=2, T=5), MLP width 256.

Tolerances:
- fp32: both sides compute the same function in fp32 and differ only in
  summation order -> gtax's own backward-test tolerance, atol 1e-4 of the
  output's largest magnitude, rtol 5e-4.
- bf16: both sides round at the same points, but a different summation
  order can flip a bf16 rounding of an intermediate (dy, dO, dq/dk/dv,
  dh1), and the gtax temporal kernel rounds each q*k and dO*v product to
  bf16 where the port sums in fp32 -> atol 3e-2 of the largest magnitude,
  rtol 3e-2 (about four bf16 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.kernels import attention as kattn
from gtax.kernels import backward as jbwd
from gtax.kernels import block as jblock
from gtax.nn import branches as jbr
from gtax_torch.kernels import backward, block
from gtax_torch.nn import branches

torch.set_num_threads(2)

N, S, D, HEADS, HID = 10, 16, 64, 4, 256
T = 5
d = D // HEADS
DTYPES = {"fp32": (torch.float32, jnp.float32, 1e-4, 5e-4),
          "bf16": (torch.bfloat16, jnp.bfloat16, 3e-2, 3e-2)}
VALIDS = {"all": None, "padded": [False, True, True, True, True]}


@pytest.fixture(autouse=True)
def interpret_mode():
    kattn.set_interpret(True)
    yield
    kattn.set_interpret(None)


def _inputs(seed, kind):
    """numpy inputs of one branch: x, shift, scale, g, weights, ct."""
    r = np.random.default_rng(seed)

    def a(shape, std=1.0):
        return (r.standard_normal(shape) * std).astype(np.float32)

    base = [a((N, S, D)), a((N, D), 0.5), a((N, D), 0.1), a((N, D), 0.5)]
    if kind == "mlp":
        w = [a((D, HID), 0.05), a((HID,), 0.01), a((HID, D), 0.05),
             a((D,), 0.01)]
    else:
        w = [a((D, 3 * D), 0.05), a((D, D), 0.05), a((D,), 0.01)]
    freqs = a((S if kind == "spatial" else T, d), 0.3)
    return base + w, freqs, a((N, S, D))


def _to(arrays, tdt, jdt):
    return ([torch.from_numpy(x).to(tdt) for x in arrays],
            [jnp.asarray(x).astype(jdt) for x in arrays])


def _close(got, ref, atol, rtol, name):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(1e-8, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=atol * scale, rtol=rtol,
                               err_msg=name)


# ---------------------------------------------------- emit_train residuals

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_spatial_emit_train(dtype):
    tdt, jdt, atol, rtol = DTYPES[dtype]
    arrays, f, _ = _inputs(0, "spatial")
    t, j = _to(arrays, tdt, jdt)
    got = block.fused_spatial_branch(*t, torch.from_numpy(f), HEADS,
                                     emit_train=True)
    ref = jblock.fused_spatial_branch(*j, jnp.asarray(f), HEADS,
                                      emit_train=True)
    for name, a, b in zip(("out", "q", "k", "v", "y"), got, ref):
        _close(a, b, atol, rtol, name)


@pytest.mark.parametrize("valid", ["all", "padded"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_temporal_emit_train(dtype, valid):
    tdt, jdt, atol, rtol = DTYPES[dtype]
    arrays, f, _ = _inputs(1, "temporal")
    t, j = _to(arrays, tdt, jdt)
    v = VALIDS[valid]
    got = block.fused_temporal_branch(*t, torch.from_numpy(f), v, HEADS, T,
                                      emit_train=True)
    ref = jblock.fused_temporal_branch(
        *j, jnp.asarray(f), None if v is None else jnp.asarray(v), HEADS, T,
        emit_train=True)
    for name, a, b in zip(("out", "q", "k", "v", "y"), got, ref):
        _close(a, b, atol, rtol, name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_emit_train(dtype):
    tdt, jdt, atol, rtol = DTYPES[dtype]
    arrays, _, _ = _inputs(2, "mlp")
    t, j = _to(arrays, tdt, jdt)
    got = block.fused_mlp_branch(*t, emit_train=True)
    ref = jblock.fused_mlp_branch(*j, emit_train=True)
    for name, a, b in zip(("out", "h1", "y"), got, ref):
        _close(a, b, atol, rtol, name)


# ------------------------------------------------------------- backwards

ATTN_GRADS = ("dx", "dshift", "dscale", "dg", "dW_qkv", "dW_out", "db_out")
MLP_GRADS = ("dx", "dshift", "dscale", "dg", "dW1", "db1", "dW2", "db2")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_spatial_branch_bwd(dtype):
    """The plain backward against gtax's Pallas backward kernel, both fed
    gtax's emitted residuals."""
    tdt, jdt, atol, rtol = DTYPES[dtype]
    arrays, f, ct = _inputs(3, "spatial")
    t, j = _to(arrays + [ct], tdt, jdt)
    jf = jnp.asarray(f)
    _, *res = jblock.fused_spatial_branch(*j[:7], jf, HEADS, emit_train=True)
    tres = [torch.from_numpy(np.array(r.astype(jnp.float32))).to(tdt)
            for r in res]
    x, sh, sc, g, qkv_w, out_w = t[:6]
    got = backward.fused_spatial_branch_bwd(x, sh, sc, g, qkv_w, out_w,
                                            torch.from_numpy(f), *tres, t[7],
                                            HEADS)
    ref = jbwd.fused_spatial_branch_bwd(*j[:6], jf, *res, j[7],
                                        num_heads=HEADS)
    for name, a, b in zip(ATTN_GRADS, got, ref):
        _close(a, b, atol, rtol, name)


@pytest.mark.parametrize("valid", ["all", "padded"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_temporal_branch_bwd(dtype, valid):
    tdt, jdt, atol, rtol = DTYPES[dtype]
    arrays, f, ct = _inputs(4, "temporal")
    t, j = _to(arrays + [ct], tdt, jdt)
    jf = jnp.asarray(f)
    v = VALIDS[valid]
    jv = None if v is None else jnp.asarray(v)
    _, *res = jblock.fused_temporal_branch(*j[:7], jf, jv, HEADS, T,
                                           emit_train=True)
    tres = [torch.from_numpy(np.array(r.astype(jnp.float32))).to(tdt)
            for r in res]
    got = backward.fused_temporal_branch_bwd(
        *t[:6], torch.from_numpy(f), v, *tres, t[7], HEADS, T)
    ref = jbwd.fused_temporal_branch_bwd(*j[:6], jf, jv, *res, j[7],
                                         num_heads=HEADS, n_frames=T)
    for name, a, b in zip(ATTN_GRADS, got, ref):
        _close(a, b, atol, rtol, name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_branch_bwd(dtype):
    tdt, jdt, atol, rtol = DTYPES[dtype]
    arrays, _, ct = _inputs(5, "mlp")
    t, j = _to(arrays + [ct], tdt, jdt)
    _, h1, y = jblock.fused_mlp_branch(*j[:8], emit_train=True)
    th1, ty = (torch.from_numpy(np.array(r.astype(jnp.float32))).to(tdt)
               for r in (h1, y))
    x, sh, sc, g, w1, _, w2, _ = t[:8]
    got = backward.fused_mlp_branch_bwd(x, sh, sc, g, w1, w2, th1, ty, t[8])
    ref = jbwd.fused_mlp_branch_bwd(j[0], j[1], j[2], j[3], j[4], j[6], h1,
                                    y, j[8])
    for name, a, b in zip(MLP_GRADS, got, ref):
        _close(a, b, atol, rtol, name)


# ------------------------------------------- autograd Functions vs jax.vjp

def _grads_torch(fn, tensors, ct):
    leaves = [a.clone().requires_grad_(True) for a in tensors]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, ct)


@pytest.mark.parametrize("kind", ["spatial", "temporal", "temporal_valid",
                                  "mlp"])
def test_branch_function_grads_match_jax_vjp(kind):
    """Each trainable branch's gradients (forward with emit_train, backward
    through the kernels' plain versions) against jax.vjp of gtax's
    trainable branch (Pallas forward and backward in interpret mode),
    fp32, at gtax's backward-test tolerance."""
    _, _, atol, rtol = DTYPES["fp32"]
    base = "mlp" if kind == "mlp" else kind.split("_")[0]
    arrays, f, ct = _inputs(6, base)
    t, j = _to(arrays, torch.float32, jnp.float32)
    tct, jct = torch.from_numpy(ct), jnp.asarray(ct)
    valid = VALIDS["padded"] if kind == "temporal_valid" else None
    if kind == "mlp":
        jfn = jbr.trainable_mlp_branch("float32")
        tfn = branches.trainable_mlp_branch
        jargs, extra = j, ()
    elif kind == "spatial":
        jfn = jbr.trainable_spatial_branch(HEADS, "float32")
        tfn = branches.trainable_spatial_branch
        jargs, extra = j + [jnp.asarray(f)], (torch.from_numpy(f), HEADS)
    else:
        f0 = jbr.trainable_temporal_branch(HEADS, T, valid is not None,
                                           "float32")
        jv = () if valid is None else (jnp.asarray(valid),)

        def jfn(*a):
            return f0(*a, *jv)

        tfn = branches.trainable_temporal_branch
        jargs = j + [jnp.asarray(f)]
        extra = (torch.from_numpy(f), valid, HEADS, T)
    n = len(t)
    _, vjp = jax.vjp(jfn, *jargs)
    ref = vjp(jct)[:n]
    got = _grads_torch(lambda *a: tfn(*a, *extra), t, tct)
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, atol, rtol, f"{kind} arg {i}")


def test_branch_without_grad_is_the_plain_wrapper_call():
    """No gradient needed: the trainable branch is the wrapper itself (no
    residuals kept), with the same output as under autograd."""
    arrays, f, _ = _inputs(7, "spatial")
    t = [torch.from_numpy(a) for a in arrays]
    fr = torch.from_numpy(f)
    with torch.no_grad():
        plain = branches.trainable_spatial_branch(*t, fr, HEADS)
    ref = block.fused_spatial_branch(*t, fr, HEADS)
    assert torch.equal(plain, ref)
    leaves = [a.clone().requires_grad_(True) for a in t]
    out = branches.trainable_spatial_branch(*leaves, fr, HEADS)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), ref)


@pytest.mark.parametrize("kind", ["spatial", "temporal", "mlp"])
def test_xla_branches_match_gtax(kind):
    """The plain xla_* forwards against gtax's xla_* branches, fp32."""
    _, _, atol, rtol = DTYPES["fp32"]
    arrays, f, _ = _inputs(8, kind)
    t, j = _to(arrays, torch.float32, jnp.float32)
    tf, jf = torch.from_numpy(f), jnp.asarray(f)
    if kind == "spatial":
        got = branches.xla_spatial_branch(*t, tf, HEADS, torch.float32)
        ref = jbr.xla_spatial_branch(*j, jf, HEADS, jnp.float32)
    elif kind == "temporal":
        v = VALIDS["padded"]
        got = branches.xla_temporal_branch(*t, tf, v, HEADS, T,
                                           torch.float32)
        ref = jbr.xla_temporal_branch(*j, jf, jnp.asarray(v), HEADS, T,
                                      jnp.float32)
    else:
        got = branches.xla_mlp_branch(*t, torch.float32)
        ref = jbr.xla_mlp_branch(*j, jnp.float32)
    _close(got, ref, atol, rtol, kind)


# --------------------------------- the temporal branch's bf16 q/k/v and mod

def _window_inputs(seed, n_frames, B=2):
    """numpy inputs of a temporal branch over B windows of n_frames:
    x, shift, scale, g, qkv_w, out_w, out_b; freqs (n_frames, d); ct."""
    r = np.random.default_rng(seed)
    N = B * n_frames

    def a(shape, std=1.0):
        return (r.standard_normal(shape) * std).astype(np.float32)

    arrays = [a((N, S, D)), a((N, D), 0.5), a((N, D), 0.1), a((N, D), 0.5),
              a((D, 3 * D), 0.05), a((D, D), 0.05), a((D,), 0.01)]
    return arrays, a((n_frames, d), 0.3), a((N, S, D))


def _valid(kind, n_frames):
    return None if kind == "all" else [False] + [True] * (n_frames - 1)


@pytest.mark.parametrize("valid", ["all", "padded"])
@pytest.mark.parametrize("n_frames", [5, 3])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rope_qkv_plain_matches_gtax_emit_train(dtype, n_frames, valid):
    """rope_qkv_plain (the plain version of the qkv GEMM's rope epilogue)
    over the plain qkv product against gtax's emit_train q, k, v."""
    tdt, jdt, atol, rtol = DTYPES[dtype]
    arrays, f, _ = _window_inputs(10 + n_frames, n_frames)
    t, j = _to(arrays, tdt, jdt)
    v = _valid(valid, n_frames)
    x, sh, sc = t[:3]
    N = x.shape[0]
    mod = block.modulated32(x.float(), sh, sc).to(tdt)
    qkv32 = block.mm32(mod, t[4]).reshape(N * S, 3 * D)
    got = block.rope_qkv_plain(qkv32, torch.from_numpy(f), S, n_frames, 0,
                               tdt)
    _, *ref = jblock.fused_temporal_branch(
        *j, jnp.asarray(f), None if v is None else jnp.asarray(v), HEADS,
        n_frames, emit_train=True)
    for name, a, b in zip(("q", "k", "v"), got, ref[:3]):
        assert a.dtype == tdt and a.shape == (N * S, D)
        _close(a.reshape(N, S, D), b, atol, rtol, name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_temporal_emit_mod(dtype):
    """emit_mod appends the modulated rows to gtax's five emit_train
    outputs and changes none of them; it needs emit_train."""
    tdt, _, _, _ = DTYPES[dtype]
    arrays, f, _ = _window_inputs(20, T)
    t = [torch.from_numpy(a).to(tdt) for a in arrays]
    fr = torch.from_numpy(f)
    five = block.fused_temporal_branch(*t, fr, None, HEADS, T,
                                       emit_train=True)
    six = block.fused_temporal_branch(*t, fr, None, HEADS, T,
                                      emit_train=True, emit_mod=True)
    assert len(five) == 5 and len(six) == 6
    for a, b in zip(five, six):
        assert torch.equal(a, b)
    x, sh, sc = t[:3]
    assert torch.equal(six[5], block.modulated32(x.float(), sh, sc).to(tdt))
    with pytest.raises(ValueError):
        block.fused_temporal_branch(*t, fr, None, HEADS, T, emit_mod=True)


@pytest.mark.parametrize("valid", ["all", "padded"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_temporal_bwd_with_mod_is_bit_equal(dtype, valid):
    """fused_temporal_branch_bwd given the forward's mod rows gives the
    bits it gives when it forms them itself."""
    tdt, _, _, _ = DTYPES[dtype]
    arrays, f, ct = _window_inputs(21, T)
    t = [torch.from_numpy(a).to(tdt) for a in arrays]
    fr, tct = torch.from_numpy(f), torch.from_numpy(ct).to(tdt)
    v = _valid(valid, T)
    _, *res, mod = block.fused_temporal_branch(
        *t, fr, v, HEADS, T, emit_train=True, emit_mod=True)
    args = (*t[:6], fr, v, *res, tct, HEADS, T)
    without = backward.fused_temporal_branch_bwd(*args)
    given = backward.fused_temporal_branch_bwd(*args, mod=mod)
    for name, a, b in zip(ATTN_GRADS, given, without):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("valid", ["all", "padded"])
@pytest.mark.parametrize("n_frames", [5, 3])
def test_temporal_branch_function_keeps_mod(monkeypatch, n_frames, valid):
    """TemporalBranch's gradients against jax.vjp of gtax's trainable
    temporal branch (fp32, gtax's backward-test tolerance), with the
    backward taking the forward's mod rows: forming them again would
    raise."""
    _, _, atol, rtol = DTYPES["fp32"]
    arrays, f, ct = _window_inputs(22 + n_frames, n_frames)
    t, j = _to(arrays, torch.float32, jnp.float32)
    v = _valid(valid, n_frames)
    f0 = jbr.trainable_temporal_branch(HEADS, n_frames, v is not None,
                                       "float32")
    jv = () if v is None else (jnp.asarray(v),)
    _, vjp = jax.vjp(lambda *a: f0(*a, *jv), *j, jnp.asarray(f))
    ref = vjp(jnp.asarray(ct))[:len(t)]

    def no_recompute(*a, **k):
        raise AssertionError("the backward formed mod again")

    monkeypatch.setattr(backward, "modulated32", no_recompute)
    got = _grads_torch(
        lambda *a: branches.trainable_temporal_branch(
            *a, torch.from_numpy(f), v, HEADS, n_frames),
        t, torch.from_numpy(ct))
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, atol, rtol, f"T={n_frames} arg {i}")


@pytest.mark.parametrize("n_frames,ok", [(0, False), (1, True), (5, True),
                                         (8, True), (9, False)])
def test_window_frames_dispatch_limits(n_frames, ok):
    """The temporal kernels are instantiated for windows of 1 to 8 frames
    (T a template parameter); the wrappers refuse any other window before
    a launch."""
    assert block.MAX_WINDOW == 8
    if ok:
        block.check_window(n_frames)
    else:
        with pytest.raises(ValueError, match="1 to 8"):
            block.check_window(n_frames)
