"""The `xla` and `pallas` attention backends of the port against gtax's, on
the CPU: the plain versions of fused_sdpa / fused_mha_token_major against
gtax's Pallas kernels in interpret mode, the four attention functions of
gtax_torch.nn.attention, the full-window dit_apply under each of the five
backends, and the unfused VAE. The same numpy inputs (from a seed) go to
both sides; weights are carried across by the weight bridge.

Tolerances, and why:
- fp32: products and softmax in fp32 on both sides, summed in another
  order: 1e-5 for one attention call (values of order one), gtax's own
  fp32 parity tolerance (2e-4 absolute, 1e-4 relative) for whole models.
- bf16: both sides round at the same points (operands, probabilities and
  outputs in bf16), but an fp32 sum taken in another order can land on the
  other side of a bf16 rounding: every element within 2**-6 of the
  output's largest magnitude (four bf16 ulps at the top of its range), the
  tolerance of tests/test_torch_models.py's bf16 serving case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.kernels import attention as jkattn
from gtax.models import dit as jdit
from gtax.models import vae as jvae
from gtax.nn import attention as jattn
from gtax_torch.io import safetensors_port as port
from gtax_torch.kernels import attention as kattn
from gtax_torch.models import dit, vae
from gtax_torch.nn import attention as attn
from tests.conftest import assert_close
from tests.test_torch_models import _gtax_debug_params, _window

torch.set_num_threads(2)

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
NH, HD = 2, 32


@pytest.fixture(autouse=True)
def interpret_mode():
    jkattn.set_interpret(True)
    yield
    jkattn.set_interpret(None)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a).astype(jnp.float32), np.float64)


def check(got, ref, dtype, fp32_tol=1e-5):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, atol=fp32_tol, rtol=fp32_tol)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2.0**-6 * np.abs(ref).max())


def _arrays(seed, dtype, *shapes, std=1.0):
    gen = np.random.default_rng(seed)
    tdt, jdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        a = (gen.standard_normal(shape) * std).astype(np.float32)
        out.append((torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)))
    return out


# ------------------------------------------------------- the two kernels

S_K = 12
MASKS = {
    "none": (None, False),
    "causal": (None, True),
    "keys": ([True] * 9 + [False] * 3, False),
    "square": (np.random.default_rng(9).random((S_K, S_K)) > 0.3, False),
    "causal+keys": ([False, False] + [True] * 10, True),
}


def _both(mask):
    if mask is None:
        return None, None
    m = np.asarray(mask)
    return torch.from_numpy(m), jnp.asarray(m)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(MASKS))
def test_fused_sdpa_matches_gtax(case, dtype):
    mask, causal = MASKS[case]
    tm, jm = _both(mask)
    (q, jq), (k, jk), (v, jv) = _arrays(1, dtype, *[(2, 3, S_K, HD)] * 3)
    got = kattn.fused_sdpa(q, k, v, mask=tm, causal=causal)
    ref = jkattn.fused_sdpa(jq, jk, jv, mask=jm, causal=causal)
    assert got.dtype == q.dtype
    check(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(MASKS))
def test_fused_mha_token_major_matches_gtax(case, dtype):
    mask, causal = MASKS[case]
    tm, jm = _both(mask)
    (q, jq), (k, jk), (v, jv) = _arrays(2, dtype, *[(3, S_K, NH * HD)] * 3)
    got = kattn.fused_mha_token_major(q, k, v, NH, mask=tm, causal=causal)
    ref = jkattn.fused_mha_token_major(jq, jk, jv, NH, mask=jm,
                                       causal=causal)
    check(got, ref, dtype)


def test_fully_masked_row_averages_v():
    """A query row with every key masked sees the -1e30 bias everywhere and
    averages V uniformly, as gtax's kernel does (never -inf, never NaN)."""
    (q, jq), (k, jk), (v, jv) = _arrays(3, "fp32", *[(2, 4, HD)] * 3)
    mask = np.ones((4, 4), bool)
    mask[1] = False
    got = kattn.fused_sdpa(q, k, v, mask=torch.from_numpy(mask))
    ref = jkattn.fused_sdpa(jq, jk, jv, mask=jnp.asarray(mask))
    check(got, ref, "fp32")
    np.testing.assert_allclose(got[:, 1].numpy(), v.mean(1).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(2, S_K), (2, S_K, S_K), (S_K, 4)],
                         ids=["batched-keys", "batched-square", "not-SxS"])
def test_batch_masks_return_none(shape):
    """gtax's dispatch by the mask's shape: a mask with batch dimensions (or
    a 2-D one that is not (S, S)) is not the kernels'; both return None."""
    (q, jq), = _arrays(4, "fp32", (2, S_K, NH * HD))
    mask = np.ones(shape, bool)
    assert kattn.fused_sdpa(q, q, q, mask=torch.from_numpy(mask)) is None
    assert jkattn.fused_sdpa(jq, jq, jq, mask=jnp.asarray(mask)) is None
    assert kattn.fused_mha_token_major(
        q, q, q, NH, mask=torch.from_numpy(mask)) is None
    assert jkattn.fused_mha_token_major(jq, jq, jq, NH,
                                        mask=jnp.asarray(mask)) is None


def test_cpu_wrappers_count_no_launch():
    (q, _), = _arrays(5, "fp32", (1, S_K, NH * HD))
    before = (kattn.fused_sdpa.launches, kattn.fused_mha_token_major.launches)
    kattn.fused_sdpa(q, q, q)
    kattn.fused_mha_token_major(q, q, q, NH)
    assert (kattn.fused_sdpa.launches,
            kattn.fused_mha_token_major.launches) == before


@pytest.mark.parametrize("S,tensor_cores", [
    (1, False), (5, False), (8, False), (16, False), (31, False), (32, True),
    (64, True), (100, True), (144, True), (576, True)])
def test_sdpa_body_by_length(S, tensor_cores):
    """attn_sdpa's dispatch by S alone, the rule the card runs (PERF.md's
    sweep of S put the threshold at 32 tokens: the warp-row body is the
    faster at 16 and below, the tensor cores from 32 up): the temporal rows
    (S = 5) keep the warp-row body, the spatial (144) and VAE (576) rows
    take the tensor cores."""
    assert kattn.SDPA_TENSOR_CORES_MIN_S == 32
    assert kattn.sdpa_tensor_cores(S) is tensor_cores


@pytest.mark.parametrize("S,body", [
    (5, 0), (31, 0), (32, 1), (48, 1), (100, 1), (143, 1), (144, 1),
    (145, 1), (288, 1), (575, 1), (576, 2), (577, 2)])
def test_sdpa_f32_body_by_length(S, body):
    """The fp32 form's body by S alone: warp rows below the tensor-core
    rule's 32 tokens; the tiled body's 48-row tiles (48-key tiles, K and V
    of a head whole in shared memory at the spatial S = 144) below 576
    tokens, its 128-row tiles (64-key tiles through the ring) from 576 (the
    VAE's S: 5 query tiles a head, the last half full)."""
    assert kattn.SDPA_F32_WIDE_MIN_S == 576
    assert kattn.sdpa_f32_body(S) == body
    assert (body > 0) == kattn.sdpa_tensor_cores(S)


def test_sdpa_f32_tiles_match_the_kernel_source():
    """The query rows of each tiled form (F32_ROWS_BY_BODY) are the
    kernel's: row groups times rows a thread (csrc/attn_sdpa.cu SdpaF32,
    attn_sdpa_f32_tile_kernel's shape for body 1; SdpaF32Wide,
    attn_sdpa_f32_wide_kernel's for body 2), each launched by its body."""
    import re

    from gtax_torch.kernels import build

    src = (build.CSRC / "attn_sdpa.cu").read_text()
    narrow = re.search(r"struct SdpaF32 \{\s*static constexpr int RG = "
                       r"(\d+),.*?static constexpr int TR = (\d+);", src,
                       re.S)
    wide = re.search(r"struct SdpaF32Wide \{\s*static constexpr int RG = "
                     r"(\d+), TR = (\d+),", src)
    for body, m in ((1, narrow), (2, wide)):
        assert int(m.group(1)) * int(m.group(2)) \
            == kattn.F32_ROWS_BY_BODY[body]
    assert re.search(r"if \(body == 1\)\s*return launch_f32_tile<HD>", src)
    assert re.search(r"if \(body == 2\)\s*return launch_f32_wide<HD>", src)


def test_token_rows_per_body():
    """A q/k/v column slice of a fused qkv row is read in place by both
    bodies; a slice 4 bytes past a 16-byte boundary only by the warp-row
    body (4-byte reads): the tensor-core body (16-byte reads) gets a dense
    copy, as does a slice whose token stride is no multiple of 8."""
    qkv = torch.zeros((2, 5, 3 * 64 + 8), dtype=torch.bfloat16)
    assert qkv.data_ptr() % 16 == 0
    q = qkv[..., 64:128]
    for align in (2, 8):
        t, ld = kattn._token_rows(q, 5, 64, align)
        assert t is q and ld == 200
    off = qkv[..., 2:66]
    t, ld = kattn._token_rows(off, 5, 64, 2)
    assert t is off and ld == 200
    t, ld = kattn._token_rows(off, 5, 64, 8)
    assert t is not off and ld == 64 and torch.equal(t, off)
    odd = torch.zeros((2, 5, 3 * 64 + 2), dtype=torch.bfloat16)[..., :64]
    assert kattn._token_rows(odd, 5, 64, 2)[1] == 194
    assert kattn._token_rows(odd, 5, 64, 8)[1] == 64


def test_token_rows_fp32():
    """The fp32 form's alignment follows the element size: the tiled body
    reads 16 bytes (4 fp32: ld a multiple of 4, the pointer 16-byte
    aligned), warp rows 8 (2 fp32). A q/k/v column slice of a fused fp32
    qkv row is read in place by both; a slice 8 bytes past a 16-byte
    boundary only by the warp rows."""
    assert kattn._align(True, torch.float32) == 4
    assert kattn._align(False, torch.float32) == 2
    assert kattn._align(True, torch.bfloat16) == 8
    assert kattn._align(False, torch.bfloat16) == 2
    qkv = torch.zeros((2, 5, 3 * 64 + 4), dtype=torch.float32)
    assert qkv.data_ptr() % 16 == 0
    q = qkv[..., 64:128]
    for tiled in (False, True):
        t, ld = kattn._token_rows(q, 5, 64, kattn._align(tiled, q.dtype))
        assert t is q and ld == 196
    off = qkv[..., 2:66]
    t, ld = kattn._token_rows(off, 5, 64, 2)
    assert t is off and ld == 196
    t, ld = kattn._token_rows(off, 5, 64, 4)
    assert t is not off and ld == 64 and torch.equal(t, off)


def test_division_by_reciprocal_rounds_as_division():
    """The tensor-core attention's p = e / l (csrc/attn_frame.cuh
    div_rn_by): q = RN(e r) with r = RN(1 / l), then RN(q + RN(e - q l) r),
    each bracket one fp32 rounding (an FMA's), equals IEEE division for a
    softmax numerator e in [2**-96, 1] and row sum l in [1, 4096]; the
    kernel divides outright below 2**-96 and takes e = 0 as is. Emulated
    in float64, where the products are exact, over a million random fp32
    bit patterns of each."""
    gen = np.random.default_rng(12)
    n = 1_000_000
    lo, one = (np.array([2.0**-96, 1.0], np.float32).view(np.int32))
    e = gen.integers(lo, one + 1, n).astype(np.int32).view(np.float32)
    l_lo, l_hi = np.array([1.0, 4096.0], np.float32).view(np.int32)
    l = gen.integers(l_lo, l_hi, n).astype(np.int32).view(np.float32)
    r = np.float32(1) / l
    q = e * r
    rem = (e.astype(np.float64) - l.astype(np.float64) * q).astype(
        np.float32)
    got = (q.astype(np.float64) + rem.astype(np.float64) * r).astype(
        np.float32)
    np.testing.assert_array_equal(got, e / l)


# ------------------------------------------- nn.attention, per backend

D = NH * HD
GRID = (3, 4)  # an H x W token grid


def _attn_params(seed, dtype, bias):
    gen = np.random.default_rng(seed)
    tdt, jdt = DTYPES[dtype]

    def lin(din, dout, with_bias):
        p = {"kernel": (gen.standard_normal((din, dout)) * 0.1).astype(
            np.float32)}
        if with_bias:
            p["bias"] = (gen.standard_normal(dout) * 0.1).astype(np.float32)
        return p

    p = {"qkv": lin(D, 3 * D, bias), "out": lin(D, D, True)}
    tp = {k: {n: torch.from_numpy(a) for n, a in d.items()}
          for k, d in p.items()}
    jp = jax.tree.map(jnp.asarray, p)
    return tp, jp


def _freqs(rows_shape, rot, seed=6):
    f = np.random.default_rng(seed).standard_normal(
        (*rows_shape, rot)).astype(np.float32)
    return torch.from_numpy(f), jnp.asarray(f)


def _under(backend, fn):
    with jattn.backend_scope(backend):
        return fn()


BACKENDS2 = ["xla", "pallas"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", BACKENDS2)
def test_sdpa_matches_gtax(backend, dtype):
    (q, jq), (k, jk), (v, jv) = _arrays(7, dtype, *[(2, NH, S_K, HD)] * 3)
    mask = MASKS["keys"][0]
    got = attn.sdpa(q, k, v, mask=torch.tensor(mask), causal=True,
                    backend=backend)
    ref = _under(backend, lambda: jattn.sdpa(jq, jk, jv,
                                             mask=jnp.asarray(mask),
                                             causal=True))
    check(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", BACKENDS2)
def test_spatial_axial_attention_matches_gtax(backend, dtype):
    tp, jp = _attn_params(8, dtype, bias=False)
    (x, jx), = _arrays(8, dtype, (2, 3, *GRID, D))
    tf, jf = _freqs(GRID, HD)
    got = attn.spatial_axial_attention(tp, x, tf, NH, DTYPES[dtype][0],
                                       backend=backend)
    ref = _under(backend, lambda: jattn.spatial_axial_attention(
        jp, jx, jf, NH, DTYPES[dtype][1]))
    check(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("valid", ["none", "slots", "batch"])
@pytest.mark.parametrize("backend", BACKENDS2)
def test_temporal_axial_attention_matches_gtax(backend, valid, dtype):
    """valid None or (T,) takes the token-major kernel under `pallas`; a
    (B, T) mask takes the plain path there, as in gtax."""
    T = 5
    tp, jp = _attn_params(9, dtype, bias=False)
    (x, jx), = _arrays(9, dtype, (2, T, *GRID, D))
    tf, jf = _freqs((T,), HD)
    v = {"none": None, "slots": [False, True, True, True, True],
         "batch": [[False, True, True, True, True], [True] * T]}[valid]
    before = kattn.fused_mha_token_major.launches
    got = attn.temporal_axial_attention(
        tp, x, tf, NH, None if v is None else torch.tensor(v),
        DTYPES[dtype][0], backend=backend)
    ref = _under(backend, lambda: jattn.temporal_axial_attention(
        jp, jx, jf, NH, None if v is None else jnp.asarray(v),
        DTYPES[dtype][1]))
    check(got, ref, dtype)
    assert kattn.fused_mha_token_major.launches == before  # CPU: no launch


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", BACKENDS2)
def test_vae_frame_attention_matches_gtax(backend, dtype):
    tp, jp = _attn_params(10, dtype, bias=True)
    (x, jx), = _arrays(10, dtype, (3, GRID[0] * GRID[1], D))
    tf, jf = _freqs(GRID, HD // 2)
    got = attn.vae_frame_attention(tp, x, tf, NH, GRID, DTYPES[dtype][0],
                                   backend=backend)
    ref = _under(backend, lambda: jattn.vae_frame_attention(
        jp, jx, jf, NH, GRID, DTYPES[dtype][1]))
    check(got, ref, dtype)


def test_backend_is_an_argument_not_a_global():
    """The port has no process-wide backend: an unknown name raises, and a
    call under one backend leaves gtax's global (and every other call)
    alone."""
    with pytest.raises(ValueError, match="backend"):
        attn.check_backend("flash")
    (q, _), = _arrays(11, "fp32", (1, NH, S_K, HD))
    a = attn.sdpa(q, q, q, backend="pallas")
    b = attn.sdpa(q, q, q, backend="xla")
    assert jattn.get_backend() == "xla"
    check(a, b, "fp32")


# ------------------------------------------------ dit_apply, per backend

BACKENDS = ["xla", "pallas", "fused", "fused_mlp", "fused_all"]


@pytest.fixture(scope="module")
def bridged():
    jcfg, jparams = _gtax_debug_params()
    return jcfg, jparams, dit.DiT_debug(), port.dit_from_gtax(jparams)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_dit_apply_backends_match_gtax(bridged, backend, dtype):
    """gtax's _block_apply picks each branch's path by the backend; so does
    the port's dit_apply. fp32 at gtax's parity tolerance (2e-4 absolute,
    1e-4 relative), bf16 (params cast for inference on both sides) at
    2**-6 of the largest output."""
    jcfg, jparams, cfg, params = bridged
    tdt, jdt = DTYPES[dtype]
    jp = jax.tree.map(jnp.asarray, jparams)
    if dtype == "bf16":
        params = dit.cast_params_for_inference(params, tdt)
        jp = jdit.cast_params_for_inference(
            jdit.unstack_for_inference(jp, jcfg), jdt)
    x, t, a = _window(12)
    valid = [False, True, True, True, True]
    got = dit.dit_apply(params, cfg, torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(a), valid, compute_dtype=tdt,
                        backend=backend)
    ref = _under(backend, lambda: jdit.dit_apply(
        jp, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(a),
        jnp.asarray(valid), compute_dtype=jdt))
    if dtype == "fp32":
        assert_close(got, ref, atol=2e-4, rtol=1e-4)
    else:
        check(got, ref, dtype)


def test_dit_apply_rejects_unknown_backend(bridged):
    _, _, cfg, params = bridged
    x, t, a = _window(13)
    with pytest.raises(ValueError, match="backend"):
        dit.dit_apply(params, cfg, torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(a), compute_dtype=torch.float32,
                      backend="flash")


# ---------------------------------------------------- the unfused VAE

@pytest.fixture(scope="module")
def vae_bridged():
    jcfg = jvae.VAE_debug()
    jp = jvae.vae_init(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(lambda l: l + 0.01 if l.ndim == 1 else l, jp)
    return jcfg, jp, vae.VAE_debug(), port.vae_from_gtax(
        jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", BACKENDS2)
def test_unfused_vae_matches_gtax(vae_bridged, backend, dtype):
    """vae_encode / vae_decode with fused=False (gtax's default) under the
    backend's attention, against gtax's: fp32 at gtax's parity tolerance,
    bf16 at 2**-6 of the largest output. The port's bf16 params are cast
    for inference (kernels bf16, LayerNorms and biases fp32, as gtax keeps
    them)."""
    jcfg, jp, cfg, params = vae_bridged
    tdt, jdt = DTYPES[dtype]
    if dtype == "bf16":
        params = vae.cast_params_for_inference(params, tdt)
    gen = np.random.default_rng(14)
    img = gen.uniform(-1, 1, (2, 3, 48, 64)).astype(np.float32)
    z = gen.standard_normal((2, cfg.seq_len, cfg.latent_dim)).astype(
        np.float32)
    m, lv = vae.vae_encode(params, cfg, torch.from_numpy(img), tdt,
                           backend=backend)
    jm, jl = _under(backend, lambda: jvae.vae_encode(jp, jcfg,
                                                     jnp.asarray(img), jdt))
    pix = vae.vae_decode(params, cfg, torch.from_numpy(z), tdt,
                         backend=backend)
    jpix = _under(backend, lambda: jvae.vae_decode(jp, jcfg, jnp.asarray(z),
                                                   jdt))
    for got, ref in ((m, jm), (lv, jl), (pix, jpix)):
        if dtype == "fp32":
            assert_close(got, ref, atol=2e-4, rtol=1e-4)
        else:
            check(got, ref, dtype)
