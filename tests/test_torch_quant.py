"""The W8A8 int8 serving path of the port (gtax_torch.kernels.quant, the
int8 branch of nn.layers.linear, models.dit.quantize_for_inference and the
int8 routing, the quantized weight bridge) against gtax, on the CPU: the
port's plain versions against gtax's int8 Pallas kernels in interpret mode,
with the same numpy inputs from a seed on both sides. Debug widths: D=64,
2 heads of 32, S=12 tokens per frame, MLP width H=256 (two hidden chunks
of 128), batch 2.

Tolerances, and why:
- quantize_weight and quant_rows: bit for bit (the same fp32 operations).
- Every int8 comparison allows some flipped int8 roundings: a value that
  lies within rounding noise of a half step may round either way, and one
  flipped step moves every output of its row by up to a few hundredths
  (2**-6 of the output's largest magnitude bounds it here). Within that
  bound on every element:
  - fp32: both sides quantize the same fp32 values and differ only in
    summation order (LayerNorm, attention), so flips are rare: at least
    99% of the elements agree within 2e-4 (gtax's own fp32 kernel
    tolerance; measured: all but one flip's row, errors ~1e-6).
  - bf16: at least 99.9% within 5e-2 (the bf16 branches' tolerance). The
    spatial and MLP branches agree bit for bit here; gtax's temporal
    cores round each q*k and p*v product to bf16 where the port sums in
    fp32, and the int8 path quantizes that attention output, so the
    temporal branches flip roundings in a fifth to a half of their rows
    (measured: at most 1 element in 7680 beyond 5e-2, 0.125 at |15|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.kernels import attention as kattn
from gtax.kernels import quant as jquant
from gtax.models import dit as jdit
from gtax.nn import layers as jlayers
from gtax_torch.io import safetensors_port as port
from gtax_torch.kernels import quant
from gtax_torch.models import dit
from gtax_torch.nn import layers
from tests.test_torch_kernels import _spatial_freqs, _temporal_freqs
from tests.test_torch_models import _gtax_debug_params, _window

torch.set_num_threads(2)

D, H, S, HID = 64, 2, 12, 256
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def interpret_mode():
    kattn.set_interpret(True)
    yield
    kattn.set_interpret(None)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a).astype(jnp.float32), np.float64)


def check_int8(got, ref, dtype="fp32", name=""):
    """The int8 tolerance of the module docstring."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.isfinite(got).all(), name
    err = np.abs(got - ref)
    tol, share = {"fp32": (2e-4, 0.99), "bf16": (5e-2, 0.999)}[dtype]
    within = np.mean(err <= tol + tol * np.abs(ref))
    assert within >= share, f"{name}: only {within:.4f} within {tol}"
    assert err.max() <= 2.0**-6 * np.abs(ref).max(), (name, err.max())


# --------------------------------------------------------- quantization

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(D, 3 * D), (2, D, HID)],
                         ids=["single", "stacked"])
def test_quantize_weight_bit_equal(shape, dtype):
    tdt, jdt = DTYPES[dtype]
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero column takes the 1e-12 floor
    q, s = quant.quantize_weight(torch.from_numpy(w).to(tdt))
    jq, js = jquant.quantize_weight(jnp.asarray(w).astype(jdt))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("group", [None, 128])
def test_quant_rows_bit_equal(group):
    gen = np.random.default_rng(1)
    a = (gen.standard_normal((24, HID))
         * gen.uniform(0.01, 30.0, (24, 1))).astype(np.float32)
    a[3] = 0.0                                        # the 1e-12 floor
    a[4, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5]  # half steps
    q, s = quant.quant_rows(torch.from_numpy(a), group)
    G = group or HID
    assert q.dtype == torch.int8 and s.shape == (24, HID // G)
    for g in range(HID // G):
        cols = slice(g * G, (g + 1) * G)
        jq, js = jquant._quant_rows(jnp.asarray(a[:, cols]))
        np.testing.assert_array_equal(q[:, cols].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s[:, g].numpy(), np.asarray(js)[:, 0])


def test_linear_kernel_q_matches_gtax():
    """The int8 adaLN head path: a plain product in both frameworks (XLA
    there, torch.matmul here). Bit for bit up to the bf16 output rounding
    of an fp32 result that may differ in its last bit (one bf16 ulp)."""
    gen = np.random.default_rng(2)
    w = (gen.standard_normal((D, 6 * D)) * 0.05).astype(np.float32)
    b = (gen.standard_normal((6 * D,)) * 0.1).astype(np.float32)
    x = gen.standard_normal((2, 5, D)).astype(np.float32)
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    jp = {"kernel_q": jq, "scale": js, "bias": jnp.asarray(b, jnp.bfloat16)}
    tp = port._tree_to_torch(jax.tree.map(np.asarray, jp))
    ref = jlayers.linear(jp, jnp.asarray(x, jnp.bfloat16), jnp.bfloat16)
    got = layers.linear(tp, torch.from_numpy(x).bfloat16(), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2.0**-8, atol=0)


# ------------------------------------------------------------- branches

class QInputs:
    """numpy inputs from a seed, handed to both frameworks: activations in
    the compute dtype, int8 weights quantized once by gtax."""

    def __init__(self, seed, dtype):
        self.gen = np.random.default_rng(seed)
        self.tdt, self.jdt = DTYPES[dtype]
        self.t, self.j = [], []

    def act(self, shape, std=1.0):
        a = (self.gen.standard_normal(shape) * std).astype(np.float32)
        self.t.append(torch.from_numpy(a).to(self.tdt))
        self.j.append(jnp.asarray(a).astype(self.jdt))

    def qweight(self, shape, std):
        w = (self.gen.standard_normal(shape) * std).astype(np.float32)
        q, s = jquant.quantize_weight(jnp.asarray(w))
        self.t += [torch.from_numpy(np.array(q)),
                   torch.from_numpy(np.array(s))]
        self.j += [q, s]

    def branch(self, N):
        self.act((N, S, D))
        for _ in range(3):  # shift, scale, gate
            self.act((N, D), 0.5)

    def attn(self):
        self.qweight((D, 3 * D), 0.2)
        self.qweight((D, D), 0.2)
        self.act((D,), 0.1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_spatial_branch_q(dtype):
    inp = QInputs(0, dtype)
    inp.branch(2)
    inp.attn()
    f = _spatial_freqs()
    got = quant.fused_spatial_branch_q(*inp.t, torch.from_numpy(f), H)
    ref = jquant.fused_spatial_branch_q(*inp.j, jnp.asarray(f), H)
    check_int8(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_branch_q(dtype):
    inp = QInputs(1, dtype)
    inp.branch(2)
    inp.qweight((D, HID), 0.2)
    inp.act((HID,), 0.1)
    inp.qweight((HID, D), 0.1)
    inp.act((D,), 0.1)
    got = quant.fused_mlp_branch_q(*inp.t)
    ref = jquant.fused_mlp_branch_q(*inp.j)
    check_int8(got, ref, dtype)


def test_mlp_branch_q_requantizes_per_chunk():
    """fc2 sums the hidden chunks in fp32, each with its own row scale: the
    one-scale-per-row version (one int32 product over all of H) is a
    different function, and the port must not compute it."""
    inp = QInputs(1, "fp32")
    inp.branch(2)
    inp.qweight((D, HID), 0.2)
    inp.act((HID,), 0.1)
    inp.qweight((HID, D), 0.1)
    inp.act((D,), 0.1)
    assert quant._mlp_chunks(HID) == 2
    x, sh, sc, g, w1q, w1s, b1, w2q, w2s, b2 = inp.t
    x32 = x.float()
    h = quant.qdot(quant.modulated32(x32, sh, sc), w1q, w1s) + b1
    one_scale = quant.qdot(quant.gelu_tanh32(h), w2q, w2s) + b2
    wrong = x32 + g[:, None] * one_scale
    got = quant.fused_mlp_branch_q(*inp.t)
    ref = jquant.fused_mlp_branch_q(*inp.j)
    assert np.abs(_np(wrong) - _np(ref)).max() > 1e-3
    check_int8(got, ref)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("approx_gelu", [True, False], ids=["tanh", "erf"])
def test_fc1_quant_plain_matches_gtax_quant_rows(approx_gelu, dtype):
    """The plain version of fc1's training form (fc1_quant_plain: the fp32
    u = dequant(int8 rows @ w1) + b1, h1 = u cast once to x's dtype, and
    the GELU'd rows requantized in groups of 512 columns) against gtax's
    _quant_rows of each 512-column chunk of the same GELU'd rows: bit for
    bit, in both GELU modes."""
    gen = np.random.default_rng(30 + approx_gelu)
    tdt, _ = DTYPES[dtype]
    Hd, G = 1024, 512
    x = torch.from_numpy(gen.standard_normal((24, D)).astype(np.float32))
    a32 = x.to(tdt).float()
    jq, js = jquant.quantize_weight(jnp.asarray(
        (gen.standard_normal((D, Hd)) * 0.2).astype(np.float32)))
    w1_q, w1_s = (torch.from_numpy(np.array(t)) for t in (jq, js))
    b1 = torch.from_numpy((gen.standard_normal(Hd) * 0.1).astype(
        np.float32)).to(tdt)
    h1, hq, hs = quant.fc1_quant_plain(a32, w1_q, w1_s, b1, approx_gelu, G,
                                       tdt)
    u = quant.qdot(a32, w1_q, w1_s) + b1.float()
    assert h1.dtype == tdt and torch.equal(h1, u.to(tdt))
    g = quant.gelu32(approx_gelu)(u).numpy()
    assert hq.shape == (24, Hd) and hs.shape == (24, Hd // G)
    for c in range(Hd // G):
        cols = slice(c * G, (c + 1) * G)
        rq, rs = jquant._quant_rows(jnp.asarray(g[:, cols]))
        np.testing.assert_array_equal(hq[:, cols].numpy(), np.asarray(rq))
        np.testing.assert_array_equal(hs[:, c].numpy(), np.asarray(rs)[:, 0])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("approx_gelu", [True, False], ids=["tanh", "erf"])
def test_mlp_branch_q_emit_train_matches_gtax(approx_gelu, dtype):
    """mlp_branch_q_plain with emit_train (its fc1 through fc1_quant_plain)
    against gtax's fused_mlp_branch_q with emit_train in interpret mode:
    out, the pre-GELU h1 and y under the int8 rule, in both GELU modes;
    the output bit-equal to the call without emit_train."""
    inp = QInputs(3, dtype)
    inp.branch(2)
    inp.qweight((D, HID), 0.2)
    inp.act((HID,), 0.1)
    inp.qweight((HID, D), 0.1)
    inp.act((D,), 0.1)
    got = quant.mlp_branch_q_plain(*inp.t, approx_gelu=approx_gelu,
                                   emit_train=True)
    ref = jquant.fused_mlp_branch_q(*inp.j, approx_gelu=approx_gelu,
                                    emit_train=True)
    assert len(got) == len(ref) == 3
    for name, a, b in zip(("out", "h1", "y"), got, ref):
        assert a.dtype == inp.tdt, name
        check_int8(a, b, dtype, name)
    assert torch.equal(got[0], quant.mlp_branch_q_plain(
        *inp.t, approx_gelu=approx_gelu))


@pytest.mark.parametrize("chunk", [128, 256, 512])
def test_int8_split_k_premise(chunk):
    """The card's int8 tile (csrc/gemm_s8.cuh) splits K into chunks and adds
    their int32 partials: bit-equal to the unsplit product in any order of
    the chunks. fc2 then folds each K group's sum into fp32 in group order,
    float(sum) * s_row, which is mlp_branch_q_plain's arithmetic bit for
    bit however the groups were split (chunks stay inside a group)."""
    gen = np.random.default_rng(chunk)
    q = torch.from_numpy(gen.integers(-127, 128, (24, 1024))).to(torch.int8)
    w = torch.from_numpy(gen.integers(-127, 128, (1024, 96))).to(torch.int8)
    full = q.long() @ w.long()
    parts = [q[:, k:k + chunk].long() @ w[k:k + chunk].long()
             for k in range(0, 1024, chunk)]
    assert torch.equal(sum(parts), full)
    assert torch.equal(sum(reversed(parts)), full)
    assert torch.equal(quant.mm_int(q, w), full.float())

    x = torch.from_numpy(gen.standard_normal((2, S, D)).astype(np.float32))
    mods = torch.from_numpy(gen.standard_normal((2, 3 * D)).astype(
        np.float32) * 0.5)
    sh, sc, g = mods[:, :D], mods[:, D:2 * D], mods[:, 2 * D:]
    w1_q, w1_s = quant.quantize_weight(torch.from_numpy(
        gen.standard_normal((D, HID)).astype(np.float32) * 0.2))
    w2_q, w2_s = quant.quantize_weight(torch.from_numpy(
        gen.standard_normal((HID, D)).astype(np.float32) * 0.1))
    b1 = torch.from_numpy(gen.standard_normal(HID).astype(np.float32) * 0.1)
    b2 = torch.from_numpy(gen.standard_normal(D).astype(np.float32) * 0.1)
    G = HID // quant._mlp_chunks(HID)
    h = quant.qdot(quant.modulated32(x, sh, sc), w1_q, w1_s) + b1
    hq, hs = quant.quant_rows(quant.gelu_tanh32(h), G)
    step = min(chunk // 2, G)  # chunks of a group, as the kernel splits it
    f = torch.zeros_like(x)
    for gi in range(HID // G):
        isum = sum(hq[..., k:k + step].long() @ w2_q[k:k + step].long()
                   for k in range(gi * G, (gi + 1) * G, step))
        f = f + isum.float() * hs[..., gi:gi + 1]
    out = x + g[:, None] * (f * w2_s.reshape(-1) + b2)
    assert torch.equal(out, quant.mlp_branch_q_plain(
        x, sh, sc, g, w1_q, w1_s, b1, w2_q, w2_s, b2))


VALIDS = {"all": None, "padded": [False, False, True, True, True]}


@pytest.mark.parametrize("valid", ["all", "padded"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_temporal_branch_q_emit_kv(dtype, valid):
    T, B = 5, 2
    inp = QInputs(2, dtype)
    inp.branch(B * T)
    inp.attn()
    f = _temporal_freqs(T)
    v = VALIDS[valid]
    got = quant.fused_temporal_branch_q(*inp.t, torch.from_numpy(f), v, H, T,
                                        emit_kv=True)
    ref = jquant.fused_temporal_branch_q(
        *inp.j, jnp.asarray(f), None if v is None else jnp.asarray(v), H, T,
        emit_kv=True)
    for name, a, b in zip(("out", "k", "v"), got, ref):
        check_int8(a, b, dtype, name)
    out = quant.fused_temporal_branch_q(*inp.t, torch.from_numpy(f), v, H, T)
    assert torch.equal(out, got[0])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_temporal_step_q(dtype):
    B, n_ctx = 2, 4
    inp = QInputs(3, dtype)
    inp.branch(B)
    inp.attn()
    inp.act((B * n_ctx * S, D))  # k_ctx
    inp.act((B * n_ctx * S, D))  # v_ctx
    f = _temporal_freqs(n_ctx + 1)
    v = [False, True, True, True, True]
    got = quant.fused_temporal_step_q(*inp.t, torch.from_numpy(f), v, H,
                                      n_ctx)
    ref = jquant.fused_temporal_step_q(*inp.j, jnp.asarray(f),
                                       jnp.asarray(v), H, n_ctx)
    check_int8(got, ref, dtype)


def test_cpu_tensor_takes_plain_version():
    inp = QInputs(6, "fp32")
    inp.branch(1)
    inp.attn()
    f = torch.from_numpy(_spatial_freqs())
    before = quant.fused_spatial_branch_q.launches
    out = quant.fused_spatial_branch_q(*inp.t, f, H)
    assert quant.fused_spatial_branch_q.launches == before
    assert torch.equal(out, quant.spatial_branch_q_plain(*inp.t, f, H))


# ------------------------------------------------- params and the model

@pytest.fixture(scope="module")
def quantized():
    """(gtax cfg, gtax W8A8 params, port cfg, port W8A8 params): fp32
    weights, nonzero adaLN heads, quantized on each side."""
    jcfg, jparams = _gtax_debug_params()
    jq = jdit.quantize_for_inference(
        jdit.unstack_for_inference(jax.tree.map(jnp.asarray, jparams), jcfg),
        jcfg)
    cfg = dit.DiT_debug()
    return jcfg, jq, cfg, dit.quantize_for_inference(
        port.dit_from_gtax(jparams))


def _flat(tree):
    out = {}
    dit._map_params(tree, lambda p, leaf: out.__setitem__(p, leaf))
    return out


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantized_bridge(dtype):
    """gtax's W8A8 tree through the weight bridge equals the port's own
    quantize_for_inference of the bridged (cast) params: int8 kernels and
    fp32 scales bit for bit, biases and unquantized leaves by value."""
    tdt, jdt = DTYPES[dtype]
    jcfg, jparams = _gtax_debug_params()
    jp = jdit.unstack_for_inference(jax.tree.map(jnp.asarray, jparams), jcfg)
    jp = jdit.cast_params_for_inference(jp, jdt) if dtype == "bf16" else jp
    ours = dit.quantize_for_inference(
        dit.cast_params_for_inference(port.dit_from_gtax(jparams), tdt)
        if dtype == "bf16" else port.dit_from_gtax(jparams))
    theirs = port.dit_from_gtax(jax.tree.map(
        np.asarray, jdit.quantize_for_inference(jp, jcfg)))
    a, b = _flat(ours), _flat(theirs)
    assert set(a) == set(b)
    for path, leaf in a.items():
        if path[-1] in ("kernel_q", "scale"):
            assert leaf.dtype == b[path].dtype, path
            assert torch.equal(leaf, b[path]), path
        else:
            assert torch.equal(leaf.float(), b[path]), path
    n_q = sum(p[-1] == "kernel_q" for p in a)
    assert n_q == 2 * 5 * 2  # 2 blocks x (qkv, out, fc1, fc2, adaLN) x 2


def test_recast_keeps_w8a8_leaves():
    """Serving casts whatever params it is given, so W8A8 params passed to a
    second VideoGenerator are cast again: the int8 kernels and their fp32
    scales come through unchanged (a bf16 scale would change every
    dequantized product), and quantizing again changes nothing. Exact."""
    _, jparams = _gtax_debug_params()
    bf = torch.bfloat16
    once = dit.quantize_for_inference(
        dit.cast_params_for_inference(port.dit_from_gtax(jparams), bf))
    again = dit.quantize_for_inference(dit.cast_params_for_inference(once, bf))
    a, b = _flat(once), _flat(again)
    assert set(a) == set(b)
    for path, leaf in a.items():
        if path[-1] == "kernel_q":
            assert leaf.dtype == torch.int8, path
        if path[-1] == "scale":
            assert leaf.dtype == torch.float32, path
        assert b[path].dtype == leaf.dtype and torch.equal(b[path], leaf), path


@pytest.mark.parametrize("valid", [None, [False, True, True, True, True]])
def test_quantized_dit_apply(quantized, valid):
    jcfg, jq, cfg, params = quantized
    x, t, a = _window(0)
    ref = jdit.dit_apply(jq, jcfg, jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(a),
                         None if valid is None else jnp.asarray(valid),
                         compute_dtype=jnp.float32)
    got = dit.dit_apply(params, cfg, torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(a), valid, compute_dtype=torch.float32)
    check_int8(got, ref)


def test_quantized_forward_meets_gtax_gate():
    """gtax's int8 quality gate (tests/test_quant.py
    test_quantized_dit_forward: relative L2 error of the int8 forward
    against the fp32 one below 2e-2, gtax measured 3.3e-3) holds for the
    port on gtax's own regime: its small depth-2 config with every leaf
    drawn as normal * 0.05 from the same keys, passed through the bridge,
    and the same inputs."""
    from tests.test_models_parity import DIT_SMALL as JSMALL
    from tests.test_torch_models import DIT_SMALL

    params = jdit.dit_init(jax.random.PRNGKey(0), JSMALL)
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(42), len(leaves))
    params = jax.tree.unflatten(treedef, [
        jax.random.normal(k, leaf.shape, leaf.dtype) * 0.05
        if jnp.issubdtype(leaf.dtype, jnp.floating) else leaf
        for k, leaf in zip(keys, leaves)])
    C, Hh, W = JSMALL.in_channels, JSMALL.input_h, JSMALL.input_w
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 5, C, Hh, W)))
    a = np.array(jax.random.normal(jax.random.PRNGKey(2), (1, 5, 25)))
    t = torch.full((1, 5), 10)
    p = port.dit_from_gtax(jax.tree.map(np.asarray, params))
    ref, out = (dit.dit_apply(pp, DIT_SMALL, torch.from_numpy(x), t,
                              torch.from_numpy(a), compute_dtype=torch.float32)
                for pp in (p, dit.quantize_for_inference(p)))
    assert ((out - ref).norm() / ref.norm()).item() < 2e-2


def _cut(tree, sl):
    return {"blocks": [{k: m[:, sl] for k, m in b.items()}
                       for b in tree["blocks"]],
            "final": tree["final"][:, sl]}


def test_quantized_prefill_and_step(quantized):
    """dit_cond (int8 adaLN heads), dit_prefill's K/V cache and
    dit_apply_step against gtax's. gtax's step at two live frames takes
    its paired kernels (rows 10-11 of PERF.md's table) where the port runs
    the sequential ones, so this also holds pair against sequential."""
    jcfg, jq, cfg, params = quantized
    x, t, a = _window(1)
    valid = [False, True, True, True, True]
    jvalid = jnp.asarray(valid)
    jmods = jdit.dit_cond(jq, jcfg, jnp.asarray(t), jnp.asarray(a),
                          jnp.float32)
    mods = dit.dit_cond(params, cfg, torch.from_numpy(t), torch.from_numpy(a),
                        torch.float32)
    for blk, jblk in zip(mods["blocks"], jmods["blocks"]):
        for k in ("s", "t"):
            check_int8(blk[k], jblk[k], name=f"adaLN {k}")
    ctx, last = slice(0, 4), slice(4, 5)
    jkv = jdit.dit_prefill(jq, jcfg, jnp.asarray(x[:, ctx]),
                           jax.tree.map(lambda m: m[:, ctx], jmods),
                           jvalid[ctx], jnp.float32)
    kv = dit.dit_prefill(params, cfg, torch.from_numpy(x[:, ctx]),
                         _cut(mods, ctx), valid[ctx], torch.float32)
    for (k, v), (jk, jv) in zip(kv, jkv):
        check_int8(k, jk, name="k")
        check_int8(v, jv, name="v")
    ref = jdit.dit_apply_step(jq, jcfg, jnp.asarray(x[:, last]), jkv,
                              jax.tree.map(lambda m: m[:, last], jmods),
                              jvalid, jnp.float32)
    got = dit.dit_apply_step(params, cfg, torch.from_numpy(x[:, last]), kv,
                             _cut(mods, last), valid, torch.float32)
    check_int8(got, ref, name="step")


def test_quantized_rollout_matches_gtax(quantized):
    """The int8 rollout with conditioning cache and incremental decoding,
    injected noise, B=1: gtax takes its paired kernels at every step, the
    port the sequential ones."""
    from gtax.sampling import diffusion as jsd
    from gtax_torch.sampling import diffusion as sd

    jcfg, jq, cfg, params = quantized
    gen = np.random.default_rng(4)
    lat = gen.standard_normal((1, 3, 8, 6, 8)).astype(np.float32)
    acts = gen.standard_normal((1, 6, 25)).astype(np.float32)
    noise = gen.standard_normal((1, 3, 8, 6, 8)).astype(np.float32)
    sampler = dict(ddim_noise_steps=3, stabilization_level=15,
                   schedule_clamp_min=1e-4)
    def jdit_fn(p, x, t, a, v):
        return jdit.dit_apply(p, jcfg, x, t, a, v, compute_dtype=jnp.float32)

    jroll = jax.jit(jsd.make_rollout(
        jdit_fn, 5, jsd.SamplerConfig(**sampler),
        cond=jdit.make_cond_fns(jcfg, jnp.float32),
        incremental=jdit.make_incremental_fns(jcfg, jnp.float32)),
        static_argnums=(4,))
    ref = jroll(jq, jnp.asarray(lat), jnp.asarray(acts),
                jax.random.PRNGKey(0), 3, jnp.asarray(noise))
    roll = sd.make_rollout(
        None, 5, sd.SamplerConfig(**sampler),
        cond=dit.make_cond_fns(cfg, torch.float32),
        incremental=dit.make_incremental_fns(cfg, torch.float32))
    got = roll(params, torch.from_numpy(lat), torch.from_numpy(acts), None,
               3, torch.from_numpy(noise))
    check_int8(got, ref)
