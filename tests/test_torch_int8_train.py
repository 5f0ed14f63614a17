"""int8-forward training of the port on the CPU against gtax: the
emit_train mode of the three W8A8 wrappers (gtax_torch.kernels.quant), the
int8 trainable branches (gtax_torch.nn.branches with qw) and
dit_apply(int8_fwd=True), each held against gtax's counterpart
(gtax.kernels.quant with emit_train=True, trainable_*_branch(quant=True),
dit_apply under set_int8_fwd(True)) on the same numpy inputs, gtax's
Pallas kernels in interpret mode.

Tolerances, and why:
- emit_train outputs: test_torch_quant.py's int8 rule (check_int8), the
  one the wrappers' outputs are held to: both sides quantize the same
  values, and a value within rounding noise of a half step may round
  either way (fp32: 99% of the elements within 2e-4; bf16: 99.9% within
  5e-2; every element within 2**-6 of the largest magnitude). The output
  with emit_train is bit-equal to the output without, in the port (gtax's
  test_int8_fwd_emit_residuals_match_nonemit).
- gradients, fp32, against gtax (each branch, and the whole DiT at depth
  2): the int8 rule's element bound, 2**-6 of each gradient's largest
  magnitude, and a relative L2 error of at most 5e-3. The share rule does
  not carry over to gradients that sum over tokens: one int8 rounding
  flipped in the forward moves the residuals of its row by a
  quantization step, and a sum over the rows (dg, a bias, the action
  embedding) carries that into all of its elements. Measured: with no
  flip, every branch gradient within 4e-7 of its largest magnitude; with
  one (the MLP's dg, in some process orders: the fp32 LayerNorm sums in
  another order), 87% of its elements within 2e-4; the whole DiT under
  `fused_all` 81% within 2e-4 for the action embedding's bias, the
  largest error 6.8e-4 of the largest magnitude, relative L2 5.3e-4
  (2.6e-6 under `fused`, whose MLP is not quantized).
- int8 against bf16 gradients in the port: 2e-2 of each gradient's largest
  magnitude, gtax's test_int8_fwd_gradients_close_to_bf16_path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.kernels import quant as jquant
from gtax.models import dit as jdit
from gtax.nn import branches as jbr
from gtax_torch.io.safetensors_port import dit_from_gtax
from gtax_torch.kernels import quant
from gtax_torch.models import dit as tdit
from gtax_torch.nn import branches
from gtax_torch.train.optim import leaves
from tests.test_torch_kernels import _spatial_freqs, _temporal_freqs
from tests.test_torch_quant import (  # noqa: F401 (autouse fixture)
    HID, VALIDS, D, H, QInputs, check_int8, interpret_mode)
from tests.test_torch_train import (B, JCFG, T, TCFG, _port_params,
                                    _random_params, _requires_grad,
                                    _torch_params)

torch.set_num_threads(2)

def check_grad(got, ref, name):
    """The gradient rule of the module docstring."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    assert np.abs(got - ref).max() <= 2.0**-6 * np.abs(ref).max(), name
    assert np.linalg.norm(got - ref) <= 5e-3 * np.linalg.norm(ref), name


NAMES = {"spatial": ("out", "q", "k", "v", "y"),
         "temporal": ("out", "q", "k", "v", "y"),
         "mlp": ("out", "h1", "y")}
PORT = {"spatial": quant.fused_spatial_branch_q,
        "temporal": quant.fused_temporal_branch_q,
        "mlp": quant.fused_mlp_branch_q}
GTAX = {"spatial": jquant.fused_spatial_branch_q,
        "temporal": jquant.fused_temporal_branch_q,
        "mlp": jquant.fused_mlp_branch_q}


def _case(kind, dtype, seed, valid=None):
    """(inputs, the port's trailing arguments, gtax's) of one int8 branch
    at test_torch_quant.py's widths."""
    inp = QInputs(seed, dtype)
    if kind == "mlp":
        inp.branch(2)
        inp.qweight((D, HID), 0.2)
        inp.act((HID,), 0.1)
        inp.qweight((HID, D), 0.1)
        inp.act((D,), 0.1)
        return inp, (), ()
    if kind == "spatial":
        inp.branch(2)
        inp.attn()
        f = _spatial_freqs()
        return inp, (torch.from_numpy(f), H), (jnp.asarray(f), H)
    Tn = 5
    inp.branch(2 * Tn)
    inp.attn()
    f = _temporal_freqs(Tn)
    jv = None if valid is None else jnp.asarray(valid)
    return inp, (torch.from_numpy(f), valid, H, Tn), (jnp.asarray(f), jv, H,
                                                      Tn)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["spatial", "temporal", "temporal_padded",
                                  "mlp"])
def test_emit_train_matches_gtax(kind, dtype):
    """Every emit_train output of the int8 plain versions against gtax's
    int8 kernels with emit_train=True (gtax reorders its temporal
    kernel's (o, k, v, q, y) to (o, q, k, v, y)); the output bit-equal to
    the call without emit_train."""
    base = kind.split("_")[0]
    valid = VALIDS["padded"] if kind.endswith("padded") else None
    inp, targs, jargs = _case(base, dtype, 10 + len(kind), valid)
    got = PORT[base](*inp.t, *targs, emit_train=True)
    ref = GTAX[base](*inp.j, *jargs, emit_train=True)
    assert len(got) == len(ref) == len(NAMES[base])
    for name, a, b in zip(NAMES[base], got, ref):
        assert a.dtype == inp.tdt, name
        check_int8(a, b, dtype, name)
    assert torch.equal(PORT[base](*inp.t, *targs), got[0])


def test_emit_kv_and_emit_train_are_exclusive():
    inp, targs, _ = _case("temporal", "fp32", 3)
    with pytest.raises(ValueError, match="exclusive"):
        quant.fused_temporal_branch_q(*inp.t, *targs, emit_kv=True,
                                      emit_train=True)


# ------------------------------------------------------ the int8 branches

def _branch_inputs(seed, kind, N=10, S=16, hid=256, heads=4, Tn=5):
    """fp32 numpy inputs of one trainable branch (the compute-dtype
    weights, not quantized) and its cotangent."""
    r = np.random.default_rng(seed)

    def a(shape, std=1.0):
        return (r.standard_normal(shape) * std).astype(np.float32)

    base = [a((N, S, D)), a((N, D), 0.1), a((N, D), 0.1), a((N, D), 0.5)]
    if kind == "mlp":
        w = [a((D, hid), 0.05), a((hid,), 0.01), a((hid, D), 0.05),
             a((D,), 0.01)]
    else:
        w = [a((D, 3 * D), 0.05), a((D, D), 0.05), a((D,), 0.01)]
    f = a((S if kind == "spatial" else Tn, D // heads), 0.3)
    return base + w, f, a((N, S, D))


def _port_fn(kind, f, valid, heads, Tn, int8):
    """The port's trainable branch over (x, shift, scale, g, weights...),
    quantizing its weights for the int8 forward as dit_apply does."""
    ft = torch.from_numpy(f)

    def fn(*args):
        if kind == "mlp":
            qw = branches.int8_weights(args[4], args[6]) if int8 else None
            return branches.trainable_mlp_branch(*args, qw=qw)
        qw = branches.int8_weights(args[4], args[5]) if int8 else None
        if kind == "spatial":
            return branches.trainable_spatial_branch(*args, ft, heads,
                                                     qw=qw)
        return branches.trainable_temporal_branch(*args, ft, valid, heads,
                                                  Tn, qw=qw)

    return fn


def _port_grads(fn, arrays, ct):
    leaves_ = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*leaves_)
    return out.detach(), torch.autograd.grad(out, leaves_,
                                             torch.from_numpy(ct))


@pytest.mark.parametrize("kind", ["spatial", "temporal", "temporal_padded",
                                  "mlp"])
def test_int8_branch_grads_match_gtax(kind):
    """The int8 trainable branches' forward and gradients (port: int8 plain
    forward with emit_train, the bf16 backward's plain versions; fp32)
    against jax.vjp of gtax's trainable_*_branch(quant=True)."""
    base = kind.split("_")[0]
    valid = VALIDS["padded"] if kind.endswith("padded") else None
    arrays, f, ct = _branch_inputs(20 + len(kind), base)
    j = [jnp.asarray(a) for a in arrays]
    if base == "mlp":
        jfn = jbr.trainable_mlp_branch("float32", quant=True)
    elif base == "spatial":
        f0 = jbr.trainable_spatial_branch(4, "float32", quant=True)

        def jfn(*a):
            return f0(*a, jnp.asarray(f))
    else:
        f0 = jbr.trainable_temporal_branch(4, 5, valid is not None,
                                           "float32", quant=True)
        extra = () if valid is None else (jnp.asarray(valid),)

        def jfn(*a):
            return f0(*a, jnp.asarray(f), *extra)
    jout, vjp = jax.vjp(jfn, *j)
    ref = vjp(jnp.asarray(ct))
    out, got = _port_grads(_port_fn(base, f, valid, 4, 5, True), arrays, ct)
    check_int8(out, jout, "fp32", "out")
    for i, (a, b) in enumerate(zip(got, ref)):
        check_grad(a.numpy(), b, f"{kind} grad {i}")


@pytest.mark.parametrize("kind", ["spatial", "temporal", "mlp"])
def test_int8_gradients_close_to_bf16_path(kind):
    """The port's int8 branch gradients against its bf16 (here fp32) path
    within 2e-2 of each gradient's largest magnitude, at the shapes of
    gtax's test_int8_fwd_gradients_close_to_bf16_path (N=5, S=16, D=64,
    4 heads, H=256)."""
    arrays, f, ct = _branch_inputs(30, kind, N=5)
    _, gq = _port_grads(_port_fn(kind, f, None, 4, 5, True), arrays, ct)
    _, gb = _port_grads(_port_fn(kind, f, None, 4, 5, False), arrays, ct)
    for i, (a, b) in enumerate(zip(gq, gb)):
        assert torch.isfinite(a).all(), i
        scale = max(1e-8, b.abs().max().item())
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2 * scale,
                                   rtol=0, err_msg=f"{kind} arg {i}")


def test_int8_branch_without_grad_is_the_wrapper_call():
    """No gradient needed: the int8 trainable branch is the int8 wrapper
    itself, and its output equals the one under autograd."""
    arrays, f, ct = _branch_inputs(40, "spatial")
    t = [torch.from_numpy(a) for a in arrays]
    fn = _port_fn("spatial", f, None, 4, 5, True)
    with torch.no_grad():
        plain = fn(*t)
    qw = branches.int8_weights(t[4], t[5])
    ref = quant.fused_spatial_branch_q(*t[:4], *qw, t[6],
                                       torch.from_numpy(f), 4)
    assert torch.equal(plain, ref)
    out, _ = _port_grads(fn, arrays, ct)
    assert torch.equal(out, ref)


# ------------------------------------------------------- the whole DiT

@pytest.fixture
def gtax_int8_fwd():
    """gtax's process-wide int8-forward switch on, restored after."""
    prev = jbr.use_int8_fwd()
    jbr.set_int8_fwd(True)
    yield
    jbr.set_int8_fwd(prev)


def _dit_inputs(seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, T, 8, 6, 8)).astype(np.float32),
            r.integers(0, 1000, (B, T)).astype(np.int32),
            r.standard_normal((B, T, 25)).astype(np.float32),
            r.standard_normal((B, T, 8, 6, 8)).astype(np.float32))


@pytest.mark.parametrize("backend", ["fused_all", "fused"])
def test_dit_apply_int8_fwd_grads_match_gtax(backend, gtax_int8_fwd):
    """dit_apply(int8_fwd=True) gradients w.r.t. every parameter against
    jax.grad of gtax's dit_apply under set_int8_fwd(True) and the same
    backend (`fused`: the MLP unfused in both), fp32, every leaf held to
    the int8 rule."""
    from gtax.nn import attention as jattn

    x, t, a, ct = _dit_inputs(1)
    jp = _random_params(0)
    valid = np.array([False, True, True, True, True])

    def jloss(p):
        v = jdit.dit_apply(p, JCFG, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(a), jnp.asarray(valid),
                           compute_dtype=jnp.float32)
        return jnp.sum(v * ct)

    prev = jattn.get_backend()
    jattn.set_backend(backend)
    try:
        jgrads = jax.grad(jloss)(jax.tree.map(jnp.asarray, jp))
    finally:
        jattn.set_backend(prev)
    tp = _requires_grad(_torch_params(jp))
    v = tdit.dit_apply(tp, TCFG, torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(a), list(valid),
                       compute_dtype=torch.float32, backend=backend,
                       int8_fwd=True)
    (v * torch.from_numpy(ct)).sum().backward()
    ref = dict(leaves(dit_from_gtax(jax.tree.map(np.asarray, jgrads))))
    n = 0
    for path, p in leaves(tp):
        want = ref[path].numpy()
        if p.grad is None:
            assert not np.any(want), path
            continue
        check_grad(p.grad.numpy(), want, path)
        n += 1
    assert n > 20


@pytest.mark.parametrize("backend", ["xla", "fused_mlp", "pallas"])
def test_int8_fwd_needs_a_fused_attention_backend(backend):
    """gtax asserts int8_forward runs through the fused trainable kernels
    (gtax/train/trainer.py:123-124); dit_apply raises ValueError."""
    tp = tdit.dit_init(TCFG, torch.Generator().manual_seed(0))
    x = torch.zeros(1, T, 8, 6, 8)
    with pytest.raises(ValueError, match="int8_fwd"):
        tdit.dit_apply(tp, TCFG, x, torch.zeros(1, T, dtype=torch.long),
                       backend=backend, int8_fwd=True)
    with pytest.raises(ValueError, match="plain_branches"):
        tdit.dit_apply(tp, TCFG, x, torch.zeros(1, T, dtype=torch.long),
                       int8_fwd=True, plain_branches=True)


@pytest.mark.parametrize("stacked", [False, True])
def test_int8_weights_made_once_are_bit_equal(stacked):
    """The trainer's quantize_train_weights (once an optimizer step, in
    either layout) gives the loss and every gradient bit for bit of
    dit_apply quantizing each block's weights itself."""
    x, t, a, ct = _dit_inputs(2)
    base = _port_params(3)
    if stacked:
        base = tdit.restack_params(base, TCFG)
    runs = []
    for once in (False, True):
        tp = _requires_grad(tdit._map_params(base, lambda _, l: l.clone()))
        w = (tdit.quantize_train_weights(tp, torch.float32) if once
             else None)
        v = tdit.dit_apply(tp, TCFG, torch.from_numpy(x),
                           torch.from_numpy(t), torch.from_numpy(a),
                           compute_dtype=torch.float32, int8_fwd=True,
                           int8_weights=w)
        (v * torch.from_numpy(ct)).sum().backward()
        runs.append((v.detach(), [p.grad for _, p in leaves(tp)]))
    assert torch.equal(runs[0][0], runs[1][0])
    for g0, g1 in zip(runs[0][1], runs[1][1]):
        assert (g0 is None and g1 is None) or torch.equal(g0, g1)

