"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (sm_90a) and skips without
one. The file imports neither JAX nor gtax, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Inputs are full-width DiT-S/2 and ViT-L/20 shapes at two frames per call.
Both sides compute in bf16 with fp32 accumulation; they differ only in
summation order, which can flip a bf16 rounding of an intermediate or of
the output. Tolerance: 2**-6 of the output's largest magnitude (four bf16
ulps at the top of its range). The int8 branches (W8A8) are held to the
same bound: there the summation order can also flip an int8 rounding of
an activation, which moves its row's outputs by less than that. Their
int8 parts (quant_rows, the grouped int8 GEMM) agree bit for bit.
"""

import numpy as np
import pytest
import torch

from gtax_torch.core import rope
from gtax_torch.kernels import block, build, quant, vae_block

D, H, HD = 1024, 16, 64
S_DIT, S_VAE = 144, 576


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from gtax_torch.utils.platform import strict_matmul

    strict_matmul()
    return torch.device("cuda")


def _rand(gen, shape, std=1.0, dtype=torch.bfloat16, device="cuda"):
    a = gen.standard_normal(shape).astype(np.float32) * std
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _close(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    tol = 2.0**-6 * max(1.0, ref.float().abs().max().item())
    assert torch.isfinite(got.float()).all()
    assert err <= tol, (err, tol)
    return err


def _branch_inputs(gen, N, S):
    x = _rand(gen, (N, S, D))
    mods = _rand(gen, (N, 6 * D), 0.5)  # split views, as dit_cond gives
    shift, scale, gate = mods[:, :D], mods[:, D:2 * D], mods[:, 2 * D:3 * D]
    return x, shift, scale, gate


def _spatial_freqs():
    f = rope.axial_freqs(rope.pixel_freqs(HD // 2, 256.0), (9, 16),
                         pixel=True)
    return f.reshape(S_DIT, HD).cuda()


def _temporal_freqs(T):
    return rope.temporal_rope_freqs(torch.arange(T),
                                    rope.lang_freqs(HD)).cuda()


def test_spatial_branch_kernel(cuda):
    gen = np.random.default_rng(0)
    x, sh, sc, g = _branch_inputs(gen, 2, S_DIT)
    qkv_w, out_w = _rand(gen, (D, 3 * D), 0.02), _rand(gen, (D, D), 0.02)
    out_b = _rand(gen, (D,), 0.02)
    f = _spatial_freqs()
    before = block.fused_spatial_branch.launches
    got = block.fused_spatial_branch(x, sh, sc, g, qkv_w, out_w, out_b, f, H)
    torch.cuda.synchronize()
    assert block.fused_spatial_branch.launches == before + 1
    _close(got, block.spatial_branch_plain(x, sh, sc, g, qkv_w, out_w, out_b,
                                           f, H))


def test_mlp_branch_kernel(cuda):
    gen = np.random.default_rng(1)
    x, sh, sc, g = _branch_inputs(gen, 2, S_DIT)
    w1, w2 = _rand(gen, (D, 4 * D), 0.02), _rand(gen, (4 * D, D), 0.02)
    b1, b2 = _rand(gen, (4 * D,), 0.02), _rand(gen, (D,), 0.02)
    got = block.fused_mlp_branch(x, sh, sc, g, w1, b1, w2, b2)
    _close(got, block.mlp_branch_plain(x, sh, sc, g, w1, b1, w2, b2))


@pytest.mark.parametrize("valid", [None, [False, True, True, True, True]])
def test_temporal_branch_kernel_emit_kv(cuda, valid):
    gen = np.random.default_rng(2)
    T = 5
    x, sh, sc, g = _branch_inputs(gen, 2 * T, S_DIT)
    qkv_w, out_w = _rand(gen, (D, 3 * D), 0.02), _rand(gen, (D, D), 0.02)
    out_b = _rand(gen, (D,), 0.02, torch.float32)
    f = _temporal_freqs(T)
    args = (x, sh, sc, g, qkv_w, out_w, out_b, f, valid, H, T)
    got = block.fused_temporal_branch(*args, emit_kv=True)
    ref = block.temporal_branch_plain(*args, emit_kv=True)
    for a, b in zip(got, ref):
        _close(a, b)
    _close(block.fused_temporal_branch(*args), ref[0])


def test_temporal_step_kernel(cuda):
    gen = np.random.default_rng(3)
    B, n_ctx = 2, 4
    x, sh, sc, g = _branch_inputs(gen, B, S_DIT)
    qkv_w, out_w = _rand(gen, (D, 3 * D), 0.02), _rand(gen, (D, D), 0.02)
    out_b = _rand(gen, (D,), 0.02)
    k_ctx = _rand(gen, (B * n_ctx * S_DIT, D))
    v_ctx = _rand(gen, (B * n_ctx * S_DIT, D))
    valid = torch.tensor([False, False, True, True, True])
    args = (x, sh, sc, g, qkv_w, out_w, out_b, k_ctx, v_ctx,
            _temporal_freqs(n_ctx + 1), valid, H, n_ctx)
    _close(block.fused_temporal_step(*args),
           block.temporal_step_plain(*args))


def test_vae_block_kernel(cuda):
    gen = np.random.default_rng(4)
    x = _rand(gen, (2, S_VAE, D))
    ones = torch.ones(D, device="cuda")
    ln = [ones + _rand(gen, (D,), 0.1, torch.float32),
          _rand(gen, (D,), 0.1, torch.float32)] * 2
    f = rope.axial_freqs(rope.pixel_freqs(HD // 4, 576.0), (18, 32),
                         pixel=True).reshape(S_VAE, HD // 2).cuda()
    args = (x, ln[0], ln[1], _rand(gen, (D, 3 * D), 0.03),
            _rand(gen, (3 * D,), 0.02, torch.float32),
            _rand(gen, (D, D), 0.03), _rand(gen, (D,), 0.02, torch.float32),
            ln[2], ln[3], _rand(gen, (D, 4 * D), 0.03),
            _rand(gen, (4 * D,), 0.02, torch.float32),
            _rand(gen, (4 * D, D), 0.02),
            _rand(gen, (D,), 0.02, torch.float32), f, H)
    _close(vae_block.fused_vae_block(*args), vae_block.vae_block_plain(*args))


def test_wrappers_reject_what_kernels_do_not_take(cuda):
    gen = np.random.default_rng(5)
    x, sh, sc, g = _branch_inputs(gen, 1, S_DIT)
    w1 = _rand(gen, (D, 4 * D), 0.02)
    b1 = _rand(gen, (4 * D,), 0.02)
    w2, b2 = _rand(gen, (4 * D, D), 0.02), _rand(gen, (D,), 0.02)
    with pytest.raises(ValueError, match="bf16"):
        block.fused_mlp_branch(x.float(), sh, sc, g, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="MLP width"):
        block.fused_mlp_branch(x, sh, sc, g, w1[:, :96], b1[:96], w2[:96],
                               b2)
    qkv_w, out_w = _rand(gen, (D, 3 * D), 0.02), _rand(gen, (D, D), 0.02)
    with pytest.raises(ValueError, match="head dim"):
        block.fused_spatial_branch(x, sh, sc, g, qkv_w, out_w, b2,
                                   _spatial_freqs(), 4)


# ------------------------------------------------------------ int8 (W8A8)

def _qweight(gen, shape, std):
    return quant.quantize_weight(_rand(gen, shape, std))


def test_int8_parts_bit_equal(cuda):
    """quant_rows and the K-grouped int8 GEMM (fc2's form: 8 groups of
    512) against the plain versions, bit for bit."""
    gen = np.random.default_rng(10)
    a = _rand(gen, (2 * S_DIT, 4 * D), 1.0, torch.float32)
    q, s = quant._quant_rows_cuda(a, 512)
    pq, ps = quant.quant_rows(a, 512)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    w_q, w_s = _qweight(gen, (4 * D, D), 0.02)
    out = torch.empty((2 * S_DIT, D), dtype=torch.float32, device="cuda")
    quant._gemm_s8(q, s, w_q, w_s, out, quant.EPI_F32)
    acc = torch.zeros_like(out)
    for g in range(8):
        cols = slice(g * 512, (g + 1) * 512)
        acc = acc + quant.mm_int(q[:, cols], w_q[cols]) * s[:, g:g + 1]
    assert torch.equal(out, acc * w_s.reshape(-1))


def test_spatial_branch_q_kernel(cuda):
    gen = np.random.default_rng(11)
    x, sh, sc, g = _branch_inputs(gen, 2, S_DIT)
    args = (x, sh, sc, g, *_qweight(gen, (D, 3 * D), 0.02),
            *_qweight(gen, (D, D), 0.02), _rand(gen, (D,), 0.02),
            _spatial_freqs(), H)
    before = quant.fused_spatial_branch_q.launches
    got = quant.fused_spatial_branch_q(*args)
    torch.cuda.synchronize()
    assert quant.fused_spatial_branch_q.launches == before + 1
    _close(got, quant.spatial_branch_q_plain(*args))


def test_mlp_branch_q_kernel(cuda):
    gen = np.random.default_rng(12)
    x, sh, sc, g = _branch_inputs(gen, 2, S_DIT)
    args = (x, sh, sc, g, *_qweight(gen, (D, 4 * D), 0.02),
            _rand(gen, (4 * D,), 0.02), *_qweight(gen, (4 * D, D), 0.02),
            _rand(gen, (D,), 0.02))
    _close(quant.fused_mlp_branch_q(*args), quant.mlp_branch_q_plain(*args))


@pytest.mark.parametrize("valid", [None, [False, True, True, True, True]])
def test_temporal_branch_q_kernel_emit_kv(cuda, valid):
    gen = np.random.default_rng(13)
    T = 5
    x, sh, sc, g = _branch_inputs(gen, 2 * T, S_DIT)
    args = (x, sh, sc, g, *_qweight(gen, (D, 3 * D), 0.02),
            *_qweight(gen, (D, D), 0.02),
            _rand(gen, (D,), 0.02, torch.float32), _temporal_freqs(T), valid,
            H, T)
    got = quant.fused_temporal_branch_q(*args, emit_kv=True)
    ref = quant.temporal_branch_q_plain(*args, emit_kv=True)
    for a, b in zip(got, ref):
        _close(a, b)


def test_temporal_step_q_kernel(cuda):
    gen = np.random.default_rng(14)
    B, n_ctx = 2, 4
    x, sh, sc, g = _branch_inputs(gen, B, S_DIT)
    args = (x, sh, sc, g, *_qweight(gen, (D, 3 * D), 0.02),
            *_qweight(gen, (D, D), 0.02), _rand(gen, (D,), 0.02),
            _rand(gen, (B * n_ctx * S_DIT, D)),
            _rand(gen, (B * n_ctx * S_DIT, D)), _temporal_freqs(n_ctx + 1),
            torch.tensor([False, False, True, True, True]), H, n_ctx)
    _close(quant.fused_temporal_step_q(*args),
           quant.temporal_step_q_plain(*args))


@pytest.mark.parametrize("epi", ["gelu", "gated"])
@pytest.mark.parametrize("splits", [1, 2])
def test_int8_gemm_second_store_bit_equal(cuda, epi, splits):
    """gemm_s8's emit_train store (C2 = bf16(y + bias), before the GELU or
    the gate), from the unit's epilogue (one K chunk) and from the split
    sum's slices (two), bit-equal to the plain arithmetic; C bit-equal to
    the call without it."""
    gen = np.random.default_rng(16)
    M, K = 2 * S_DIT, D
    N = 4 * D if epi == "gelu" else D
    a = _rand(gen, (M, K), 1.0, torch.float32)
    q, s = quant._quant_rows_cuda(a, K)
    w_q, w_s = _qweight(gen, (K, N), 0.02)
    b = _rand(gen, (N,), 0.02, torch.float32)
    kw = {"bias": b, "k_chunk": K // splits}
    if epi == "gelu":
        e, dt = quant.EPI_BIAS_GELU_F32, torch.float32
    else:
        e, dt = quant.EPI_BIAS_GATED, torch.bfloat16
        kw.update(resid=_rand(gen, (M, N)), gate=_rand(gen, (2, N), 0.5),
                  S=S_DIT)
    out, ref = (torch.empty((M, N), dtype=dt, device="cuda")
                for _ in range(2))
    out2 = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    quant._gemm_s8(q, s, w_q, w_s, out, e, out2=out2, **kw)
    quant._gemm_s8(q, s, w_q, w_s, ref, e, **kw)
    u = quant.mm_int(q, w_q) * s * w_s.reshape(-1) + b
    assert torch.equal(out2, u.bfloat16())
    assert torch.equal(out, ref)


def _stream_too(monkeypatch, fn, args, kw, got):
    """The same call on the weight-streaming tile (quant.S8_TRAIN_ROWS past
    its rows): every output bit-equal to got's."""
    monkeypatch.setattr(quant, "S8_TRAIN_ROWS", 1 << 30)
    for a, b in zip(got, fn(*args, **kw)):
        assert torch.equal(a, b)
    monkeypatch.undo()


@pytest.mark.parametrize("kind", ["spatial", "temporal", "temporal_padded",
                                  "mlp", "spatial B=16", "temporal B=16",
                                  "mlp B=16"])
def test_int8_emit_train_kernels(cuda, kind, monkeypatch):
    """The emit_train mode of the int8 wrappers (int8-forward training):
    every residual against the plain version's, and the output bit-equal
    to the call without emit_train. At B=16 (11,520 rows: the int8 GEMM's
    training form, gemm_s8_train, two launches a call) every output is
    also bit-equal to the weight-streaming tile's."""
    gen = np.random.default_rng(17)
    train = kind.endswith("B=16")
    kind = kind.split()[0]
    if kind == "mlp":
        x, sh, sc, g = _branch_inputs(gen, 80 if train else 2, S_DIT)
        args = (x, sh, sc, g, *_qweight(gen, (D, 4 * D), 0.02),
                _rand(gen, (4 * D,), 0.02, torch.float32),
                *_qweight(gen, (4 * D, D), 0.02),
                _rand(gen, (D,), 0.02, torch.float32))
        fn, plain = quant.fused_mlp_branch_q, quant.mlp_branch_q_plain
    else:
        T = 5
        N = (80 if train else 2) if kind == "spatial" else (
            16 if train else 2) * T
        x, sh, sc, g = _branch_inputs(gen, N, S_DIT)
        w = (*_qweight(gen, (D, 3 * D), 0.02), *_qweight(gen, (D, D), 0.02),
             _rand(gen, (D,), 0.02, torch.float32))
        if kind == "spatial":
            args = (x, sh, sc, g, *w, _spatial_freqs(), H)
            fn, plain = (quant.fused_spatial_branch_q,
                         quant.spatial_branch_q_plain)
        else:
            valid = ([False, True, True, True, True]
                     if kind.endswith("padded") else None)
            args = (x, sh, sc, g, *w, _temporal_freqs(T), valid, H, T)
            fn, plain = (quant.fused_temporal_branch_q,
                         quant.temporal_branch_q_plain)
    before = quant.gemm_s8_train.launches
    got = fn(*args, emit_train=True)
    rows = x.shape[0] * x.shape[1]
    assert quant.gemm_s8_train.launches == before + 2 * (
        rows >= quant.S8_TRAIN_ROWS)
    ref = plain(*args, emit_train=True)
    assert len(got) == len(ref) == (3 if kind == "mlp" else 5)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b)
    assert torch.equal(got[0], fn(*args))
    if train:
        _stream_too(monkeypatch, fn, args, {"emit_train": True}, got)


def test_int8_wrappers_reject_what_kernels_do_not_take(cuda):
    gen = np.random.default_rng(15)
    x, sh, sc, g = _branch_inputs(gen, 1, S_DIT)
    w1_q, w1_s = _qweight(gen, (D, 4 * D), 0.02)
    w2_q, w2_s = _qweight(gen, (4 * D, D), 0.02)
    b1, b2 = _rand(gen, (4 * D,), 0.02), _rand(gen, (D,), 0.02)
    with pytest.raises(ValueError, match="int8"):
        quant.fused_mlp_branch_q(x, sh, sc, g, w1_q.float(), w1_s, b1, w2_q,
                                 w2_s, b2)
    with pytest.raises(ValueError, match="scales"):
        quant.fused_mlp_branch_q(x, sh, sc, g, w1_q, w1_s[:, :8], b1, w2_q,
                                 w2_s, b2)


# ------------------------------------------- paired int8 and attention


def _pair_weights(gen):
    return (*_qweight(gen, (D, 3 * D), 0.02), *_qweight(gen, (D, D), 0.02),
            _rand(gen, (D,), 0.02), *_qweight(gen, (D, 4 * D), 0.02),
            _rand(gen, (4 * D,), 0.02), *_qweight(gen, (4 * D, D), 0.02),
            _rand(gen, (D,), 0.02))


def _pair_inputs(gen, N):
    x = _rand(gen, (N, S_DIT, D))
    mods = _rand(gen, (N, 6 * D), 0.5)
    return (x, *(mods[:, i * D:(i + 1) * D] for i in range(6)),
            *_pair_weights(gen))


@pytest.mark.parametrize("N", [1, 2, 3, 4])
def test_spatial_pair_q_kernel(cuda, N):
    """One cooperative launch against the plain version, bit-equal to the
    two sequential int8 wrappers (the same device code) and to a second
    call, at 1-4 frames (the gate's range)."""
    from gtax_torch.kernels import pair

    gen = np.random.default_rng(30 + N)
    args = (*_pair_inputs(gen, N), _spatial_freqs(), H)
    before = pair.fused_spatial_pair_q.launches
    got = pair.fused_spatial_pair_q(*args)
    torch.cuda.synchronize()
    assert pair.fused_spatial_pair_q.launches == before + 1
    _close(got, pair.spatial_pair_q_plain(*args))
    x, sh1, sc1, g1, sh2, sc2, g2, *w = args[:-2]
    h = quant.fused_spatial_branch_q(x, sh1, sc1, g1, *w[:5], *args[-2:])
    assert torch.equal(got, quant.fused_mlp_branch_q(h, sh2, sc2, g2,
                                                     *w[5:]))
    assert torch.equal(got, pair.fused_spatial_pair_q(*args))


@pytest.mark.parametrize("B,valid", [(1, [False, True, True, True, True]),
                                     (2, None),
                                     (3, [False, True, True, True, True]),
                                     (4, None)])
def test_temporal_pair_q_kernel(cuda, B, valid):
    from gtax_torch.kernels import pair

    gen = np.random.default_rng(40 + B)
    n_ctx = 4
    inputs = _pair_inputs(gen, B)
    kc = _rand(gen, (B * n_ctx * S_DIT, D))
    vc = _rand(gen, (B * n_ctx * S_DIT, D))
    tail = (kc, vc, _temporal_freqs(n_ctx + 1), valid, H, n_ctx)
    got = pair.fused_temporal_pair_q(*inputs, *tail)
    _close(got, pair.temporal_pair_q_plain(*inputs, *tail))
    x, sh1, sc1, g1, sh2, sc2, g2, *w = inputs
    h = quant.fused_temporal_step_q(x, sh1, sc1, g1, *w[:5], *tail)
    assert torch.equal(got, quant.fused_mlp_branch_q(h, sh2, sc2, g2,
                                                     *w[5:]))
    assert torch.equal(got, pair.fused_temporal_pair_q(*inputs, *tail))


@pytest.mark.parametrize("n_live,valid", [
    (2, None), (3, [True, True, True, True, False]),
    (4, [False, False, True, True, True])])
def test_temporal_step_live_slots(cuda, n_live, valid):
    """The pipelined rollout's steps: n_live = P live frames over an
    n_ctx = 5 - P slot cache (a warm-up mask closes a context slot or a
    live slot not yet entered), bf16 #4 and int8 #6 against their plain
    versions; at n_live = 2 the int8 pair (#11) bit-equal to #6 + #9."""
    from gtax_torch.kernels import pair

    gen = np.random.default_rng(60 + n_live)
    n_ctx = 5 - n_live
    inputs = _pair_inputs(gen, n_live)
    x, sh1, sc1, g1, sh2, sc2, g2, *w = inputs
    kc = _rand(gen, (n_ctx * S_DIT, D))
    vc = _rand(gen, (n_ctx * S_DIT, D))
    tail = (kc, vc, _temporal_freqs(5), valid, H, n_ctx)
    bw = (_rand(gen, (D, 3 * D), 0.02), _rand(gen, (D, D), 0.02),
          _rand(gen, (D,), 0.02))
    args = (x, sh1, sc1, g1, *bw, *tail)
    _close(block.fused_temporal_step(*args, n_live=n_live),
           block.temporal_step_plain(*args, n_live=n_live))
    args_q = (x, sh1, sc1, g1, *w[:5], *tail)
    h = quant.fused_temporal_step_q(*args_q, n_live=n_live)
    _close(h, quant.temporal_step_q_plain(*args_q, n_live=n_live))
    if n_live <= pair.PAIR_MAX_FRAMES:
        got = pair.fused_temporal_pair_q(*inputs, *tail, n_live=n_live)
        _close(got, pair.temporal_pair_q_plain(*inputs, *tail,
                                               n_live=n_live))
        assert torch.equal(got, quant.fused_mlp_branch_q(h, sh2, sc2, g2,
                                                         *w[5:]))


@pytest.mark.parametrize("S,mask,causal", [
    (5, [False, True, True, True, True], True), (144, None, False),
    (576, None, False)])
def test_fused_sdpa_kernel(cuda, S, mask, causal):
    from gtax_torch.kernels import attention as kattn

    gen = np.random.default_rng(S)
    q, k, v = (_rand(gen, (2, 3, S, HD)) for _ in range(3))
    before = kattn.fused_sdpa.launches
    got = kattn.fused_sdpa(q, k, v, mask=mask, causal=causal)
    torch.cuda.synchronize()
    assert kattn.fused_sdpa.launches == before + 1
    bias = kattn.build_bias(S, mask, causal, "cuda")
    ref = kattn.sdpa_plain(*(t.reshape(-1, S, HD) for t in (q, k, v)), bias)
    _close(got, ref.reshape(got.shape))


@pytest.mark.parametrize("shape,mask", [
    ((2, S_DIT, D), None), ((2 * S_DIT, 5, D), "temporal"),
    ((2, S_VAE, D), None)], ids=["spatial", "temporal", "vae"])
def test_fused_mha_token_major_kernel(cuda, shape, mask):
    """Also reads q/k/v as strided column slices of one fused qkv row."""
    from gtax_torch.kernels import attention as kattn

    gen = np.random.default_rng(shape[1])
    S = shape[1]
    if mask == "temporal":
        valid = torch.tensor([False, True, True, True, True])
        mask = torch.tril(torch.ones(S, S, dtype=torch.bool)) & (
            valid[None, :] | torch.eye(S, dtype=torch.bool))
    qkv = _rand(gen, (*shape[:2], 3 * D))
    q, k, v = qkv.split(D, dim=-1)
    got = kattn.fused_mha_token_major(q, k, v, H, mask=mask)
    bias = kattn.build_bias(S, mask, False, "cuda")
    _close(got, kattn.mha_token_major_plain(q, k, v, bias, H))
    assert torch.equal(got, kattn.fused_mha_token_major(
        q.contiguous(), k.contiguous(), v.contiguous(), H, mask=mask))
    assert kattn.fused_mha_token_major(q, k, v, H,
                                       mask=torch.ones(2, S, S)) is None


# ------------------------------------------------------------- training

def _train_inputs(gen, N, kind):
    x, sh, sc, g = _branch_inputs(gen, N, S_DIT)
    if kind == "mlp":
        w = (_rand(gen, (D, 4 * D), 0.02), _rand(gen, (4 * D,), 0.02),
             _rand(gen, (4 * D, D), 0.02), _rand(gen, (D,), 0.02))
    else:
        w = (_rand(gen, (D, 3 * D), 0.02), _rand(gen, (D, D), 0.02),
             _rand(gen, (D,), 0.02, torch.float32))
    return (x, sh, sc, g, *w), _rand(gen, (N, S_DIT, D))


def test_emit_train_kernels(cuda):
    """The forward branches' emit_train residuals against the plain
    versions', and the output equal to the serving call's."""
    gen = np.random.default_rng(20)
    args, _ = _train_inputs(gen, 2, "spatial")
    f = _spatial_freqs()
    got = block.fused_spatial_branch(*args, f, H, emit_train=True)
    for a, b in zip(got, block.spatial_branch_plain(*args, f, H, True)):
        _close(a, b)
    assert torch.equal(got[0], block.fused_spatial_branch(*args, f, H))
    args, _ = _train_inputs(gen, 2, "mlp")
    got = block.fused_mlp_branch(*args, emit_train=True)
    for a, b in zip(got, block.mlp_branch_plain(*args, emit_train=True)):
        _close(a, b)
    assert torch.equal(got[0], block.fused_mlp_branch(*args))
    args, _ = _train_inputs(gen, 10, "temporal")
    tf = _temporal_freqs(5)
    valid = [False, True, True, True, True]
    got = block.fused_temporal_branch(*args, tf, valid, H, 5,
                                      emit_train=True)
    ref = block.temporal_branch_plain(*args, tf, valid, H, 5,
                                      emit_train=True)
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.parametrize("valid", [None, [False, True, True, True, True]])
def test_temporal_branch_bwd_kernel(cuda, valid):
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(21)
    T = 5
    args, ct = _train_inputs(gen, 2 * T, "temporal")
    tf = _temporal_freqs(T)
    _, *res = block.fused_temporal_branch(*args, tf, valid, H, T,
                                          emit_train=True)
    bargs = (*args[:6], tf, valid, *res, ct, H, T)
    before = backward.fused_temporal_branch_bwd.launches
    got = backward.fused_temporal_branch_bwd(*bargs)
    torch.cuda.synchronize()
    assert backward.fused_temporal_branch_bwd.launches == before + 1
    for a, b in zip(got, backward.temporal_branch_bwd_plain(*bargs)):
        _close(a, b)


@pytest.mark.parametrize("S,hd", [(S_DIT, HD), (S_DIT, 32), (100, HD),
                                  (100, 32), (176, HD)])
def test_spatial_branch_bwd_kernel(cuda, S, hd):
    """The spatial backward whole (its attention on the tensor cores) at the
    DiT's S = 144 with its rope table (the inputs of seed 22, as this test
    drew them before it took other shapes), and at a ragged S = 100, at 11
    row tiles (S = 176) and at 32 heads of 32 dims with random angles,
    against spatial_branch_bwd_plain; a second run is bit-equal to the
    first."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(22 if (S, hd) == (S_DIT, HD)
                                else 22 + S + hd)
    N, heads = 2, D // hd
    x, sh, sc, g = _branch_inputs(gen, N, S)
    w = (_rand(gen, (D, 3 * D), 0.02), _rand(gen, (D, D), 0.02),
         _rand(gen, (D,), 0.02, torch.float32))
    ct = _rand(gen, (N, S, D))
    if (S, hd) == (S_DIT, HD):
        f = _spatial_freqs()
    else:
        f = torch.from_numpy(gen.uniform(0, 6.3, (S, hd)).astype(
            np.float32)).cuda()
    args = (x, sh, sc, g, *w)
    _, *res = block.fused_spatial_branch(*args, f, heads, emit_train=True)
    bargs = (*args[:6], f, *res, ct, heads)
    got = backward.fused_spatial_branch_bwd(*bargs)
    for a, b in zip(got, backward.spatial_branch_bwd_plain(*bargs)):
        _close(a, b)
    for a, b in zip(got, backward.fused_spatial_branch_bwd(*bargs)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N", [2, 10])
def test_mlp_branch_bwd_kernel(cuda, N):
    """At 288 rows and at 1,440 (11.25 of the GEMM's 128-row tiles, so its
    last tile ragged); also: a second run is bit-equal to the first (no
    float atomics). The MLP's weight gradients take one row chunk at both
    on an H100 SXM: their 128 wide tiles fill its 132 SMs alone."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(23)
    args, ct = _train_inputs(gen, N, "mlp")
    _, h1, y = block.fused_mlp_branch(*args, emit_train=True)
    x, sh, sc, g, w1, _, w2, _ = args
    bargs = (x, sh, sc, g, w1, w2, h1, y, ct)
    got = backward.fused_mlp_branch_bwd(*bargs)
    for a, b in zip(got, backward.mlp_branch_bwd_plain(*bargs)):
        _close(a, b)
    for a, b in zip(got, backward.fused_mlp_branch_bwd(*bargs)):
        assert torch.equal(a, b)


def test_wgrad_split_rows_bit_equal_reduction(cuda):
    """The weight-gradient GEMM over ragged, split row chunks against the
    fp32 product of the same bf16 values."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(24)
    a, b = _rand(gen, (4000, 128)), _rand(gen, (4000, 64))
    splits, chunk = backward.wgrad_split(4000, 128, 64, a.device)
    assert splits > 1 and 4000 % chunk
    got = backward.wgrad(a, b)
    ref = backward.wgrad32(a, b)
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=1e-4)


# ------------------------------------------- the GEMM paths, one by one

def _gemm_ref(epi, acc, bias, x, gate, S, h1):
    """(C, C2) of each gemm_bf16 epilogue from the fp32 product acc."""
    from gtax_torch.kernels import backward
    from gtax_torch.kernels.vae_block import gelu_erf32

    bf = torch.bfloat16
    u = acc + bias.float()
    if epi == block.EPI_F32:
        return acc, None
    if epi == block.EPI_BF16:
        return acc.to(bf), None
    if epi == block.EPI_BIAS_BF16:
        return u.to(bf), None
    if epi in (block.EPI_BIAS_GELU_TANH, block.EPI_BIAS_GELU_TANH_H):
        return block.gelu_tanh32(u).to(bf), (
            u.to(bf) if epi == block.EPI_BIAS_GELU_TANH_H else None)
    if epi == block.EPI_BIAS_BF16_GELU:
        return gelu_erf32(u.to(bf).float()).to(bf), None
    if epi in (block.EPI_BIAS_GATED, block.EPI_BIAS_GATED_Y):
        g = gate.float().repeat_interleave(S, 0)[:len(u)]
        return (x.float() + g * u).to(bf), (
            u.to(bf) if epi == block.EPI_BIAS_GATED_Y else None)
    if epi == block.EPI_BIAS_BF16_RESID:
        return (x.float() + u.to(bf).float()).to(bf), None
    assert epi == block.EPI_DGELU
    val, grad = backward.gelu_tanh_val_grad32(h1.float())
    return (grad * acc).to(bf), val.to(bf)


EPILOGUES = [block.EPI_F32, block.EPI_BIAS_BF16, block.EPI_BIAS_GELU_TANH,
             block.EPI_BIAS_BF16_GELU, block.EPI_BIAS_GATED,
             block.EPI_BIAS_BF16_RESID, block.EPI_BF16,
             block.EPI_BIAS_GATED_Y, block.EPI_BIAS_GELU_TANH_H,
             block.EPI_DGELU]


@pytest.mark.parametrize("M", [144, 1000, 1440, 3472])
@pytest.mark.parametrize("trans_b,N", [(False, 3072), (True, 1024),
                                       (True, 4096), (False, 192)])
def test_gemm_bf16_layouts(cuda, M, trans_b, N):
    """Forward ((K, N) weights, N-major) and input-gradient (W (N, K),
    K-major) products at ragged row counts from a step's 144 to a VAE
    decode's 3,456 + 16, on 128x128 tiles and (from 1,440 rows at N=3072,
    1,000 at N=4096) 128x256 tiles; N=192 leaves a tile half empty."""
    gen = np.random.default_rng(M + N)
    K = 1024
    a = _rand(gen, (M, K))
    w = _rand(gen, (N, K) if trans_b else (K, N), 0.02)
    out = torch.empty((M, N), dtype=torch.float32, device="cuda")
    block.launch_gemm(a, w, out, M, N, K, block.EPI_F32, trans_b=trans_b)
    torch.cuda.synchronize()
    _close(out, block.mm32(a, w.t() if trans_b else w))


@pytest.mark.parametrize("N", [1024, 4096])
@pytest.mark.parametrize("epi", EPILOGUES)
def test_gemm_bf16_epilogues(cuda, epi, N):
    """Every epilogue at a ragged 1,440 + 16 rows, on 128x128 (N=1024) and
    128x256 (N=4096) tiles, with its second output and the gelu' column
    partials, one per 128-row tile."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(60 + epi)
    S, K = 144, 1024
    M = 10 * S + 16
    a, w = _rand(gen, (M, K)), _rand(gen, (K, N), 0.03)
    bias = _rand(gen, (N,), 0.1, torch.float32)
    x, h1 = _rand(gen, (M, N)), _rand(gen, (M, N))
    gate = _rand(gen, (-(-M // S), 2 * N), 0.5)[:, :N]
    acc = block.mm32(a, w)
    ref, ref2 = _gemm_ref(epi, acc, bias, x, gate, S, h1)
    tile = 128
    out = torch.empty((M, N), dtype=ref.dtype, device="cuda")
    out2 = None if ref2 is None else torch.empty_like(ref2)
    part = (torch.empty((backward.dgelu_partial_rows(M, tile), N),
                        device="cuda")
            if epi == block.EPI_DGELU else None)
    block.launch_gemm(a, w, out, M, N, K, epi, bias=bias, resid=x, gate=gate,
                      S=S, out2=out2, aux=h1, colsum=part)
    torch.cuda.synchronize()
    _close(out, ref)
    if ref2 is not None:
        _close(out2, ref2)
    if part is not None:
        _, grad = backward.gelu_tanh_val_grad32(h1.float())
        u = torch.zeros((part.shape[0] * tile, N), device="cuda")
        u[:M] = grad * acc
        _close(part, u.reshape(-1, tile, N).sum(1))


@pytest.mark.parametrize("N", [192, 512])
@pytest.mark.parametrize("M", [1000, 4000])
def test_wgrad_chunks_bit_equal(cuda, M, N):
    """The plan's one chunk (1,000 rows) and its ragged chunks reduced in
    order (4,000 rows: 5 and 4 on an H100), on 128x128 (N=192) and 128x256
    (N=512) tiles, against the fp32 product; a second run is bit-equal to
    the first."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(25)
    a, b = _rand(gen, (M, 1024)), _rand(gen, (M, N))
    splits, chunk = backward.wgrad_split(M, 1024, N, a.device)
    assert (splits == 1) == (M == 1000)
    assert splits == 1 or M % chunk  # the last chunk is ragged
    got = backward.wgrad(a, b)
    torch.testing.assert_close(got, backward.wgrad32(a, b), atol=1e-3,
                               rtol=1e-4)
    assert torch.equal(got, backward.wgrad(a, b))


@pytest.mark.parametrize("S", [S_DIT, S_VAE])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("qkv_f32", [True, False])
def test_attn_frame_kernel(cuda, S, hd, qkv_f32):
    """The tensor-core frame attention against the plain version: fp32 or
    bf16 qkv in, fp32 and bf16 out, full and partial rope, and the
    emit_train q/k/v outputs (the roped, cast values it attends with)."""
    gen = np.random.default_rng(S + hd)
    N, heads = 2, D // hd
    dt = torch.float32 if qkv_f32 else torch.bfloat16
    qkv = _rand(gen, (N * S, 3 * D), 1.0, dt)
    q, k, v = (t.reshape(N, S, heads, hd) for t in qkv.split(D, dim=-1))
    for rot, out_f32 in ((hd, True), (hd // 2, False), (hd, False)):
        f = torch.from_numpy(gen.uniform(0, 6.3, (S, rot)).astype(
            np.float32)).cuda()
        bf = torch.bfloat16
        qr, kr = (rope.apply_rotary_emb(f[:, None, :], t.float()).to(bf)
                  for t in (q, k))
        ref = block.attend_frames(qr, kr, v.to(bf), bf,
                                  torch.float32 if out_f32 else bf)
        out = torch.empty((N * S, D), device="cuda",
                          dtype=torch.float32 if out_f32 else bf)
        emitted = tuple(torch.empty((N * S, D), dtype=bf, device="cuda")
                        for _ in range(3))
        block.launch_attn_frame(qkv, f, out, N, S, D, heads, rot,
                                qkv_out=emitted)
        torch.cuda.synchronize()
        _close(out, ref.reshape(N * S, D))
        for got, want in zip(emitted, (qr, kr, v.to(bf))):
            _close(got, want.reshape(N * S, D))


# Rounding points of the tensor-core attention: the share of bf16 elements
# that differ from the plain version, and the largest difference over the
# largest magnitude, are held under these bounds (four times tighter than
# the 2**-6 of _close)
ROUNDING_SHARE = 0.01
ROUNDING_REL = 2.0**-8


def _vae_freqs():
    f = rope.axial_freqs(rope.pixel_freqs(HD // 4, 576.0), (18, 32),
                         pixel=True)
    return f.reshape(S_VAE, HD // 2).cuda()


@pytest.mark.parametrize("S", [S_DIT, S_VAE], ids=["dit", "vae"])
def test_attn_frame_rounding_points(cuda, S):
    """The frame attention on the model's own rope tables (the DiT's full
    spatial table on fp32 qkv at S=144, the VAE's partial one on bf16 qkv
    at S=576) against block.attend_frames over the plain-roped q/k: the
    bf16 output and the emitted q and k each stay under ROUNDING_SHARE
    differing elements and ROUNDING_REL of their largest magnitude."""
    from gtax_torch.utils.profiling import bf16_differences

    gen = np.random.default_rng(60 + S)
    N, bf = 2, torch.bfloat16
    dit = S == S_DIT
    f = _spatial_freqs() if dit else _vae_freqs()
    rot = f.shape[-1]
    qkv = _rand(gen, (N * S, 3 * D), 1.0, torch.float32 if dit else bf)
    q, k, v = (t.reshape(N, S, H, HD) for t in qkv.split(D, dim=-1))
    qr, kr = (rope.apply_rotary_emb(f[:, None, :], t.float()).to(bf)
              for t in (q, k))
    ref = block.attend_frames(qr, kr, v.to(bf), bf)
    out = torch.empty((N * S, D), dtype=bf, device="cuda")
    emitted = tuple(torch.empty((N * S, D), dtype=bf, device="cuda")
                    for _ in range(3))
    block.launch_attn_frame(qkv, f, out, N, S, D, H, rot, qkv_out=emitted)
    torch.cuda.synchronize()
    figures = {name: bf16_differences(got, want.reshape(N * S, D))
               for name, got, want in (("out", out, ref),
                                       ("q", emitted[0], qr),
                                       ("k", emitted[1], kr))}
    print(f"[rounding] attn_frame S={S} rot={rot}: " + ", ".join(
        f"{name} {share:.3e} differ, max {rel:.3e}"
        for name, (share, rel) in figures.items()))
    for name, (share, rel) in figures.items():
        assert share < ROUNDING_SHARE and rel <= ROUNDING_REL, (name, share,
                                                                rel)


# ------------------------------------------- attn_sdpa's two bodies


def _sdpa_mask(kind, S):
    """None, causal, gtax's temporal `valid | eye` mask with slot 0 padded,
    or a square mask whose row 1 attends nothing (its bias row all -1e30)."""
    if kind in ("none", "causal"):
        return None
    if kind == "temporal":
        valid = torch.ones(S, dtype=torch.bool)
        valid[0] = False
        return torch.tril(torch.ones(S, S, dtype=torch.bool)) & (
            valid[None, :] | torch.eye(S, dtype=torch.bool))
    mask = torch.ones(S, S, dtype=torch.bool)
    mask[1] = False
    return mask


def _sdpa_lengths():
    from gtax_torch.kernels import attention as kattn

    t = kattn.SDPA_TENSOR_CORES_MIN_S
    return sorted({5, 16, 100, 144, 576, t - 1, t})


@pytest.mark.parametrize("layout", ["heads_first", "token_major"])
@pytest.mark.parametrize("S", _sdpa_lengths())
def test_attn_sdpa_kernel(cuda, S, layout):
    """Both bodies of attn_sdpa (the threshold's two sides among the
    lengths; 100 is no multiple of 16 or 64) in both layouts, with no mask,
    causal, the temporal valid | eye mask and a fully masked row, against
    the plain version under the rounding-point bounds; the token-major q/k/v
    are strided views of one fused qkv row, bit-equal to contiguous copies;
    a second run is bit-equal to the first."""
    from gtax_torch.kernels import attention as kattn
    from gtax_torch.utils.profiling import bf16_differences

    gen = np.random.default_rng(70 + S)
    if layout == "heads_first":
        q, k, v = (_rand(gen, (2, 3, S, HD)) for _ in range(3))
    else:
        qkv = _rand(gen, (3, S, 3 * D))
        q, k, v = qkv.split(D, dim=-1)
    for kind in ("none", "causal", "temporal", "masked_row"):
        mask, causal = _sdpa_mask(kind, S), kind == "causal"
        bias = kattn.build_bias(S, mask, causal, "cuda")
        if layout == "heads_first":
            before = kattn.fused_sdpa.launches
            got = kattn.fused_sdpa(q, k, v, mask=mask, causal=causal)
            assert kattn.fused_sdpa.launches == before + 1
            ref = kattn.sdpa_plain(*(t.reshape(-1, S, HD) for t in (q, k, v)),
                                   bias).reshape(got.shape)
            again = kattn.fused_sdpa(q, k, v, mask=mask, causal=causal)
        else:
            got = kattn.fused_mha_token_major(q, k, v, H, mask=mask,
                                              causal=causal)
            ref = kattn.mha_token_major_plain(q, k, v, bias, H)
            again = kattn.fused_mha_token_major(
                q.contiguous(), k.contiguous(), v.contiguous(), H, mask=mask,
                causal=causal)
        torch.cuda.synchronize()
        _close(got, ref)
        share, rel = bf16_differences(got, ref)
        assert share < ROUNDING_SHARE and rel <= ROUNDING_REL, (kind, share,
                                                                rel)
        assert torch.equal(got, again), kind
        if kind == "masked_row":  # row 1 averages V uniformly
            mean = v.float().mean(-2)
            torch.testing.assert_close(got[..., 1, :].float(), mean,
                                       atol=2.0**-6 * mean.abs().max().item(),
                                       rtol=0)


def test_fully_masked_row_averages_v_card(cuda):
    """The card twin of tests/test_torch_attention.py's: a query row whose
    keys are all masked sees -1e30 everywhere and averages V uniformly, on
    both bodies (never -inf, never NaN)."""
    from gtax_torch.kernels import attention as kattn

    gen = np.random.default_rng(71)
    for S in (4, 144):
        q, k, v = (_rand(gen, (2, S, HD)) for _ in range(3))
        mask = torch.ones(S, S, dtype=torch.bool)
        mask[1] = False
        got = kattn.fused_sdpa(q, k, v, mask=mask)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        mean = v.float().mean(1)
        torch.testing.assert_close(got[:, 1].float(), mean,
                                   atol=2.0**-7 * mean.abs().max().item(),
                                   rtol=0)


# ------------------------------------- attn_frame_bwd on the tensor cores


def _frame_bwd_plain(q, k, v, dout, freqs, rot):
    """ao, dq, dk, dv of one frame attention backward over (N, S, H, d)
    bf16 residuals, the rope adjoint on the first rot dims (the plain
    version's arithmetic, backward._attention_bwd_plain)."""
    from gtax_torch.kernels import backward

    d = q.shape[-1]
    ao, dq, dk, dv = backward._attention_bwd_plain(
        q, k, v, dout, None, torch.bfloat16, 1.0 / d**0.5,
        ("nqhd", "nkhd", "nhqk"))
    f = freqs[:, None, :]

    def adj(u):
        return torch.cat([backward.rope_transpose32(f, u[..., :rot]),
                          u[..., rot:]], -1)

    return ao, adj(dq), adj(dk), dv


@pytest.mark.parametrize("S", [S_DIT, 100])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("partial", [False, True], ids=["full", "half"])
def test_attn_frame_bwd_kernel(cuda, S, hd, partial):
    """attn_frame_bwd alone (S = 144 and a ragged 100, head dims 32 and 64,
    the rope adjoint on all or half of a head's dims) against the plain
    backward's arithmetic: O and dq/dk/dv under _close and the rounding
    bounds of the forward; a second run is bit-equal to the first."""
    _check_frame_bwd(S, hd, partial)


@pytest.mark.parametrize("S,hd", [(176, 64), (192, 32)])
def test_attn_frame_bwd_past_nine_tiles(cuda, S, hd):
    """Frames longer than the DiT's nine 16-row tiles, up to the most whose
    block fits the shared memory, take the kernel's wider instantiation;
    one tile more is refused."""
    from gtax_torch.kernels import backward

    _check_frame_bwd(S, hd, True)
    S = S + 16
    dqkv = torch.empty((S, 3 * D), dtype=torch.bfloat16, device="cuda")
    t = torch.empty((S, D), dtype=torch.bfloat16, device="cuda")
    cs = torch.zeros((S, hd), device="cuda")
    with pytest.raises(RuntimeError, match="gtax_attn_frame_bwd"):
        backward.launch_attn_frame_bwd(t, t, t, t, cs, cs, dqkv, t, 1, S, D,
                                       D // hd, hd)


def _check_frame_bwd(S, hd, partial):
    """attn_frame_bwd on 3 frames of S tokens of random q, k, v, dO and
    rope angles against the plain backward, and a rerun bit-equal."""
    from gtax_torch.kernels import backward
    from gtax_torch.utils.profiling import bf16_differences

    gen = np.random.default_rng(S + hd + partial)
    N, heads = 3, D // hd
    rot = hd // 2 if partial else hd
    q, k, v, dout = (_rand(gen, (N, S, heads, hd)) for _ in range(4))
    freqs = torch.from_numpy(gen.uniform(0, 6.3, (S, rot)).astype(
        np.float32)).cuda()
    flat = [t.reshape(N * S, D) for t in (q, k, v, dout)]

    def run():
        dqkv = torch.empty((N * S, 3 * D), dtype=torch.bfloat16,
                           device="cuda")
        ao = torch.empty((N * S, D), dtype=torch.bfloat16, device="cuda")
        backward.launch_attn_frame_bwd(*flat, *backward.rope_tables(freqs),
                                       dqkv, ao, N, S, D, heads, rot)
        torch.cuda.synchronize()
        return ao, dqkv

    ao, dqkv = run()
    ref = _frame_bwd_plain(q, k, v, dout, freqs, rot)
    got = (ao, *dqkv.split(D, dim=-1))
    for name, a, b in zip(("ao", "dq", "dk", "dv"), got, ref):
        b = b.to(torch.bfloat16).reshape(N * S, D)
        _close(a, b)
        share, rel = bf16_differences(a, b)
        assert share < ROUNDING_SHARE and rel <= ROUNDING_REL, (name, share,
                                                                rel)
    ao2, dqkv2 = run()
    assert torch.equal(ao, ao2) and torch.equal(dqkv, dqkv2)


# --------------------------------- the serving step's weight streaming

SMALL_M = [1, 16, 143, 144, 145, 288]


@pytest.mark.parametrize("M", SMALL_M)
@pytest.mark.parametrize("epi", EPILOGUES)
def test_gemm_bf16_small_m(cuda, epi, M):
    """The small-M path (every row in one block of 64 columns, K in chunks
    whose fp32 partials the tile's last block adds in order) under every
    epilogue at ragged row counts, at fc2's N=1024, K=4096 (eight chunks),
    against the plain version, with its second output and the gelu'
    column partials; a second call gives the same bits."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(80 + epi)
    S, N, K = 144, 1024, 4096
    assert block.gemm_chunk(M, N, K, cuda) == 512
    a, w = _rand(gen, (M, K)), _rand(gen, (K, N), 0.02)
    bias = _rand(gen, (N,), 0.1, torch.float32)
    x, h1 = _rand(gen, (M, N)), _rand(gen, (M, N))
    gate = _rand(gen, (-(-M // S), 2 * N), 0.5)[:, :N]
    acc = block.mm32(a, w)
    ref, ref2 = _gemm_ref(epi, acc, bias, x, gate, S, h1)

    def call():
        out = torch.empty((M, N), dtype=ref.dtype, device="cuda")
        out2 = None if ref2 is None else torch.empty_like(ref2)
        part = (torch.empty((backward.dgelu_partial_rows(M, 128), N),
                            device="cuda")
                if epi == block.EPI_DGELU else None)
        block.launch_gemm(a, w, out, M, N, K, epi, bias=bias, resid=x,
                          gate=gate, S=S, out2=out2, aux=h1, colsum=part)
        torch.cuda.synchronize()
        return out, out2, part

    out, out2, part = call()
    _close(out, ref)
    if ref2 is not None:
        _close(out2, ref2)
    if part is not None:
        _, grad = backward.gelu_tanh_val_grad32(h1.float())
        u = torch.zeros((part.shape[0] * 128, N), device="cuda")
        u[:M] = grad * acc
        _close(part, u.reshape(-1, 128, N).sum(1))
    for got, again in zip((out, out2, part), call()):
        assert got is None or torch.equal(got, again)


@pytest.mark.parametrize("M", SMALL_M)
@pytest.mark.parametrize("trans_b,N,K", [(False, 3072, 1024),
                                         (False, 1024, 1024),
                                         (True, 4096, 1024),
                                         (True, 1024, 4096)])
def test_gemm_bf16_small_m_layouts(cuda, M, trans_b, N, K):
    """Both weight layouts on the small-M path at 1, 2, 4 and 8 chunks
    (the most it takes) where the grid fits on the card at once (the
    launch is cooperative), and the tiled path, against the fp32
    product."""
    gen = np.random.default_rng(M + N + K)
    a = _rand(gen, (M, K))
    w = _rand(gen, (N, K) if trans_b else (K, N), 0.02)
    ref = block.mm32(a, w.t() if trans_b else w)
    fits = [c for c in (K, K // 2, K // 4, K // 8)
            if c == K or N // 64 * (K // c) <= block.sm_count(cuda)]
    assert len(fits) >= 2
    for chunk in (0, *fits):
        out = torch.empty((M, N), dtype=torch.float32, device="cuda")
        block.launch_gemm(a, w, out, M, N, K, block.EPI_F32,
                          trans_b=trans_b, k_chunk=chunk)
        torch.cuda.synchronize()
        _close(out, ref)


@pytest.mark.parametrize("M", SMALL_M)
@pytest.mark.parametrize("group", [None, 512], ids=["ungrouped", "grouped"])
def test_gemm_s8_units(cuda, M, group):
    """The int8 weight-streaming tile at ragged rows, one K group (K=1024,
    in 1, 2, 4 and 8 chunks) and fc2's eight (K=4096, groups of 512, a
    chunk each), at the plan's chunk and the others: bit-equal to the
    plain product (int32 sums are exact; the groups fold in order), and a
    second call too."""
    gen = np.random.default_rng(90 + M)
    N, K = 1024, 4096 if group else 1024
    G = group or K
    q, sa = quant.quant_rows(_rand(gen, (M, K), 1.0, torch.float32), G)
    w_q, w_s = _qweight(gen, (K, N), 0.02)
    assert quant.is_card_layout(w_q)
    ref = quant.s8_fold_plain(q, sa, w_q, w_s)
    for chunk in ((None, 512) if group else (None, 128, 256, 512, 1024)):
        out = torch.empty((M, N), dtype=torch.float32, device="cuda")
        quant._gemm_s8(q, sa, w_q, w_s, out, quant.EPI_F32, k_chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), chunk
        again = torch.empty_like(out)
        quant._gemm_s8(q, sa, w_q, w_s, again, quant.EPI_F32, k_chunk=chunk)
        assert torch.equal(out, again), chunk


@pytest.mark.parametrize("M", [1, 143, 288])
def test_gemm_s8_epilogues(cuda, M):
    """The int8 tile's GELU (fc1) and gated-residual (out-projection, fc2)
    epilogues on split chunks against the plain version's."""
    gen = np.random.default_rng(95 + M)
    S, N, K = 144, 1024, 1024
    q, sa = quant.quant_rows(_rand(gen, (M, K), 1.0, torch.float32), K)
    w_q, w_s = _qweight(gen, (K, N), 0.02)
    b = _rand(gen, (N,), 0.1, torch.float32)
    x = _rand(gen, (M, N))
    gate = _rand(gen, (-(-M // S), 2 * N), 0.5)[:, :N]
    y = quant.s8_fold_plain(q, sa, w_q, w_s) + b
    out = torch.empty((M, N), dtype=torch.float32, device="cuda")
    quant._gemm_s8(q, sa, w_q, w_s, out, quant.EPI_BIAS_GELU_F32, bias=b,
                   k_chunk=256)
    _close(out, block.gelu_tanh32(y))
    res = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    quant._gemm_s8(q, sa, w_q, w_s, res, quant.EPI_BIAS_GATED, bias=b,
                   resid=x, gate=gate, S=S, k_chunk=256)
    g = gate.float().repeat_interleave(S, 0)[:M]
    _close(res, (x.float() + g * y).to(torch.bfloat16))


TRAIN_M = [1440, 11520, 11519]


@pytest.mark.parametrize("M", TRAIN_M)
@pytest.mark.parametrize("groups", [1, 8])
@pytest.mark.parametrize("epi", range(8))
def test_gemm_s8_train_bit_equal(cuda, epi, groups, M):
    """The int8 GEMM's training form (gemm_s8_train) against the
    weight-streaming tile (form="stream", its plan's K chunks), bit for
    bit, for the epilogues it builds (C and the second output C2) at one
    K group (K=1024, 128 x 256 tiles) and at fc2's eight (K=4096 in groups
    of 512, 128 x 128), at 1,440 and 11,520 rows and a ragged 11,519; the
    product also bit-equal to its plain version (s8_fold_plain). A
    combination it builds no kernel for (EPI_F32 with several groups, a
    GELU epilogue without fc1's requantization) raises, at the wrapper
    and at the C entry."""
    gen = np.random.default_rng(600 + 10 * epi + groups)
    f32, bf = torch.float32, torch.bfloat16
    N, K = 1024, 4096 if groups > 1 else 1024
    G = K // groups
    q, sa = quant.quant_rows(_rand(gen, (M, K), 1.0, f32), G)
    w_q, w_s = _qweight(gen, (K, N), 0.02)
    kw = {"bias": _rand(gen, (N,), 0.1, f32)} if epi else {}
    if epi in (quant.EPI_BIAS_GATED, quant.EPI_BIAS_GATED_F32,
               quant.EPI_BIAS_GATED_F32_Y):
        dt = bf if epi == quant.EPI_BIAS_GATED else f32
        kw.update(resid=_rand(gen, (M, N), 1.0, dt),
                  gate=_rand(gen, (-(-M // S_DIT), 2 * N), 0.5, dt)[:, :N],
                  S=S_DIT)
    c2 = {1: bf, 2: bf, 3: bf, 5: f32, 6: f32, 7: f32}.get(epi)
    built = quant.s8_train_builds(epi, groups, False)
    assert built == (epi in quant.S8_TRAIN_GATED
                     or (epi == quant.EPI_F32 and groups == 1))
    outs = []
    for form in ("stream", "train"):
        out = torch.empty((M, N), dtype=bf if epi == 2 else f32,
                          device="cuda")
        out2 = None if c2 is None else torch.empty((M, N), dtype=c2,
                                                   device="cuda")
        before = quant.gemm_s8_train.launches
        if form == "train" and not built:
            with pytest.raises(ValueError, match="no kernel"):
                quant._gemm_s8(q, sa, w_q, w_s, out, epi, out2=out2,
                               form=form, **kw)
            C, b, b32, r, g, gs = quant._epi_args(
                out, kw.get("bias"), kw.get("resid"), kw.get("gate"))
            with pytest.raises(RuntimeError, match="CUDA error"):
                build.launch(
                    "gtax_gemm_s8_train", q.data_ptr(), w_q.data_ptr(), C,
                    None if out2 is None else out2.data_ptr(),
                    sa.data_ptr(), G, w_s.data_ptr(), b, b32, r, g, gs, M,
                    N, K, kw.get("S", 1), epi, None, None,
                    torch.cuda.current_stream().cuda_stream)
            assert quant.gemm_s8_train.launches == before
            continue
        quant._gemm_s8(q, sa, w_q, w_s, out, epi, out2=out2, form=form,
                       **kw)
        assert quant.gemm_s8_train.launches == before + (form == "train")
        outs.append((out, out2))
    torch.cuda.synchronize()
    for out, out2 in outs[1:]:
        assert torch.equal(out, outs[0][0])
        assert out2 is None or torch.equal(out2, outs[0][1])
    if epi == quant.EPI_F32:
        assert torch.equal(outs[0][0], quant.s8_fold_plain(q, sa, w_q, w_s))


@pytest.mark.parametrize("M", TRAIN_M)
@pytest.mark.parametrize("epi", [1, 3, 5, 6])
def test_gemm_s8_train_fc1_requant(cuda, epi, M):
    """fc1's training form with the requantization of its GELU rows in its
    epilogue (a cluster of two 128 x 256 tiles a 512-column group) bit for
    bit against the streaming tile's GELU epilogue then quant_rows: hq,
    hs and h1 = y + b (bf16 for epilogues 1 and 3, also without it; fp32
    for 5 and 6); within one int8 step of fc1_quant_plain's arithmetic
    (the card's tanhf / erfcf against torch's GELU)."""
    gen = np.random.default_rng(640 + M + epi)
    f32 = torch.float32
    K, N, G = D, 4 * D, 512
    q, sa = quant.quant_rows(_rand(gen, (M, K), 1.0, f32), K)
    w_q, w_s = _qweight(gen, (K, N), 0.02)
    b = _rand(gen, (N,), 0.1, f32)
    c2 = f32 if epi in (5, 6) else torch.bfloat16
    h = torch.empty((M, N), dtype=f32, device="cuda")
    h1 = torch.empty((M, N), dtype=c2, device="cuda")
    quant._gemm_s8(q, sa, w_q, w_s, h, epi, bias=b, out2=h1, form="stream")
    ref = (h1, *quant._quant_rows_cuda(h, G))
    for emit in (True, False) if c2 != f32 else (True,):
        got1 = torch.empty_like(h1) if emit else None
        before = quant.gemm_s8_train.launches
        hq, hs = quant._fc1_quant_cuda(q, sa, w_q, w_s, b, epi, got1, G)
        torch.cuda.synchronize()
        assert quant.gemm_s8_train.launches == before + 1
        assert torch.equal(hq, ref[1]) and torch.equal(hs, ref[2]), emit
        assert got1 is None or torch.equal(got1, ref[0])
    u = quant.s8_fold_plain(q, sa, w_q, w_s) + b
    pq, ps = quant.requant_plain(u, epi in (1, 5), G)
    assert (hq.int() - pq.int()).abs().max().item() <= 1
    torch.testing.assert_close(hs, ps, rtol=1e-6, atol=0)


def test_gemm_s8_train_refuses(cuda):
    """A product the training form builds no kernel for raises: EPI_F32 and
    fc1's requantization over several K groups (the wrapper's check), K
    groups with a k_chunk, and at the C entry N that is no multiple of the
    tile and the fused requantization over several K groups
    (cudaErrorInvalidValue)."""
    gen = np.random.default_rng(660)
    M, K, N = 1440, 4096, 1024
    q, sa = quant.quant_rows(_rand(gen, (M, K), 1.0, torch.float32), 512)
    w_q, w_s = _qweight(gen, (K, N), 0.02)
    out = torch.empty((M, N), dtype=torch.float32, device="cuda")
    hq = torch.empty((M, N), dtype=torch.int8, device="cuda")
    hs = torch.empty((M, N // 512), dtype=torch.float32, device="cuda")
    b = _rand(gen, (N,), 0.1, torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        quant.gemm_s8_train(q, sa, w_q, w_s, out, quant.EPI_F32)
    with pytest.raises(ValueError, match="no kernel"):
        quant.gemm_s8_train(q, sa, w_q, w_s, None, quant.EPI_BIAS_GELU_F32,
                            bias=b, hq=hq, hs=hs)
    with pytest.raises(ValueError, match="k_chunk"):
        quant._gemm_s8(q, sa, w_q, w_s, out, quant.EPI_F32, form="train",
                       k_chunk=512)
    common = (q.data_ptr(), w_q.data_ptr())
    for n, epi, quant_out in ((N - 64, quant.EPI_BIAS_GATED_F32, False),
                              (N, quant.EPI_BIAS_GELU_F32, True)):
        gated = None if quant_out else out.data_ptr()
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.launch(
                "gtax_gemm_s8_train", *common,
                None if quant_out else out.data_ptr(), None, sa.data_ptr(),
                512, w_s.data_ptr(), b.data_ptr(), 1, gated, gated, N, M, n,
                K, 1, epi, hq.data_ptr() if quant_out else None,
                hs.data_ptr() if quant_out else None,
                torch.cuda.current_stream().cuda_stream)


def test_int8_wrappers_take_the_card_layout(cuda):
    """quantize_weight on the card stores the int8 kernel column-major (the
    values and shape unchanged); a row-major kernel is refused, not
    transposed per call."""
    gen = np.random.default_rng(16)
    w = _rand(gen, (D, 4 * D), 0.02)
    q, s = quant.quantize_weight(w)
    assert quant.is_card_layout(q) and q.shape == (D, 4 * D)
    assert torch.equal(q, torch.round(w.float() / s).to(torch.int8))
    assert quant.card_layout(q).data_ptr() == q.data_ptr()  # no copy
    x, sh, sc, g = _branch_inputs(gen, 1, S_DIT)
    w2_q, w2_s = _qweight(gen, (4 * D, D), 0.02)
    b1, b2 = _rand(gen, (4 * D,), 0.02), _rand(gen, (D,), 0.02)
    with pytest.raises(ValueError, match="column-major"):
        quant.fused_mlp_branch_q(x, sh, sc, g, q.contiguous(), s, b1, w2_q,
                                 w2_s, b2)


# --------------------------------------- the bf16 step's attention branches


def _attention_branch(kind, N, seed):
    """(wrapper, plain, args) of fused_spatial_branch over N frames, or of
    fused_temporal_step over B=N elements of a 4-frame cache (slot 0
    padded), at DiT-S/2's widths."""
    gen = np.random.default_rng(seed + N)
    x, sh, sc, g = _branch_inputs(gen, N, S_DIT)
    w = (_rand(gen, (D, 3 * D), 0.02), _rand(gen, (D, D), 0.02),
         _rand(gen, (D,), 0.02))
    if kind == "spatial":
        return (block.fused_spatial_branch, block.spatial_branch_plain,
                (x, sh, sc, g, *w, _spatial_freqs(), H))
    n_ctx = 4
    kc, vc = (_rand(gen, (N * n_ctx * S_DIT, D)) for _ in range(2))
    return (block.fused_temporal_step, block.temporal_step_plain,
            (x, sh, sc, g, *w, kc, vc, _temporal_freqs(n_ctx + 1),
             [False] + [True] * n_ctx, H, n_ctx))


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
@pytest.mark.parametrize("N", [1, 2, 3, 4])
def test_attention_branch_frames(cuda, kind, N):
    """#1 and #4 at 1-4 frames (ln_mod, the qkv GEMM, the attention, the
    out-projection: four launches) against their plain versions; two
    calls give the same bits."""
    from gtax_torch.kernels import build

    fn, plain, args = _attention_branch(kind, N, 150)
    got = fn(*args)
    names = []
    real = build.launch

    def spy(name, *a, **kw):
        names.append(name)
        return real(name, *a, **kw)

    build.launch = spy
    try:
        again = fn(*args)
    finally:
        build.launch = real
    torch.cuda.synchronize()
    _close(got, plain(*args))
    assert torch.equal(got, again)
    attn = "gtax_attn_frame" if kind == "spatial" else "gtax_attn_temporal"
    assert names == ["gtax_ln_mod", "gtax_gemm_bf16", attn, "gtax_gemm_bf16"]


@pytest.mark.parametrize("S", [S_DIT, 80, 112])
@pytest.mark.parametrize("hd", [32, 64])
def test_attn_frame_query_tiles_bit_equal(cuda, S, hd):
    """One frame takes the smallest query tile of three or more whole
    warps that covers it (48 rows at a denoise step's 144 tokens, 80, 112),
    as many frames as fill the card with 128-row tiles take those: each
    frame's output and emitted q/k/v are the same bits either way."""
    gen = np.random.default_rng(170 + hd + S)
    heads = D // hd
    N = -(-block.sm_count(cuda) // (-(-S // 128) * heads))
    qkv = _rand(gen, (N * S, 3 * D), 1.0, torch.float32)
    f = torch.from_numpy(gen.uniform(0, 6.3, (S, hd)).astype(
        np.float32)).cuda()

    def run(rows):
        n = rows.shape[0] // S
        out = torch.empty((n * S, D), dtype=torch.bfloat16, device="cuda")
        emitted = tuple(torch.empty_like(out) for _ in range(3))
        block.launch_attn_frame(rows, f, out, n, S, D, heads, hd,
                                qkv_out=emitted)
        return (out, *emitted)

    whole = run(qkv)
    for n in range(N):
        part = run(qkv[n * S:(n + 1) * S].contiguous())
        torch.cuda.synchronize()
        for a, b in zip(whole, part):
            assert torch.equal(a[n * S:(n + 1) * S], b), n


# ------------------------------ the temporal branch's full window in bf16

def _rope_qkv_fp32_product(mod, qkv_w, freqs, B, n_q, q_off, S, heads):
    """q, k, v as the fp32 qkv product (EPI_F32) through attn_temporal's
    own rope and rounding (its emitted q/k/v): the path the rope epilogue
    replaced."""
    M = mod.shape[0]
    qkv = torch.empty((M, 3 * D), dtype=torch.float32, device="cuda")
    block.launch_gemm(mod, qkv_w, qkv, M, 3 * D, D, block.EPI_F32)
    out = torch.empty((M, D), dtype=torch.bfloat16, device="cuda")
    q, k, v = (torch.empty_like(out) for _ in range(3))
    ctx = None
    if q_off:
        ctx = torch.zeros((B * q_off * S, D), dtype=torch.bfloat16,
                          device="cuda")
    block.launch_attn_temporal(qkv, freqs, out, B, n_q, q_off, S, D, heads,
                               (1 << (n_q + q_off)) - 1, ctx, ctx, (k, v), q)
    return q, k, v, qkv


@pytest.mark.parametrize("mode", ["window", "prefill", "step", "random"])
@pytest.mark.parametrize("T", [1, 3, 5, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_gemm_rope_qkv_bit_equal(cuda, hd, T, mode):
    """The qkv GEMM's rope epilogue gives the bits of the EPI_F32 product
    through attn_temporal's rope and rounding: every row's window slot
    (full window of B=2 and one prefill window, B=1; the step's live frame
    at slot T - 1; the model's tables and a table of unrelated angles),
    hd 32/64/128. Also against rope_qkv_plain on the same fp32 product."""
    gen = np.random.default_rng(180 + hd + T)
    heads = D // hd
    B, n_q, q_off = {"window": (2, T, 0), "prefill": (1, T, 0),
                     "step": (2, 1, T - 1), "random": (2, T, 0)}[mode]
    if mode == "random":
        f = torch.from_numpy(gen.uniform(-7, 7, (T, hd)).astype(
            np.float32)).cuda()
    else:
        f = rope.temporal_rope_freqs(torch.arange(T),
                                     rope.lang_freqs(hd)).cuda()
    M = B * n_q * S_DIT
    mod = _rand(gen, (M, D))
    w = _rand(gen, (D, 3 * D), 0.05)
    got = tuple(torch.empty((M, D), dtype=torch.bfloat16, device="cuda")
                for _ in range(3))
    block.launch_gemm_rope_qkv(mod, w, *got, f, S_DIT, n_q, q_off, hd)
    *ref, qkv = _rope_qkv_fp32_product(mod, w, f, B, n_q, q_off, S_DIT,
                                       heads)
    plain = block.rope_qkv_plain(qkv, f, S_DIT, n_q, q_off, torch.bfloat16)
    torch.cuda.synchronize()
    for name, a, b, p in zip("qkv", got, ref, plain):
        assert torch.equal(a, b), (name, (a != b).float().mean().item())
        _close(a, p)


@pytest.mark.parametrize("valid", [None, [False, True, True, True, True,
                                          True, True, True]])
@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_attn_temporal_window_kernel(cuda, hd, T, valid):
    """attn_temporal_window (16-byte lanes, T a template parameter)
    against block.attend_temporal on the same bf16 q, k, v: within 2**-6
    of the largest magnitude, and its summation order (a score's eight
    products in a lane, then the head's lanes) within the frame
    attention's rule (ROUNDING_SHARE of elements differ, by at most
    ROUNDING_REL of the largest magnitude); the figures printed (-s)."""
    from gtax_torch.utils.profiling import bf16_differences

    gen = np.random.default_rng(190 + hd + T)
    heads, B = D // hd, 2
    v = None if valid is None else valid[:T]
    q, k, vv = (_rand(gen, (B * T * S_DIT, D)) for _ in range(3))
    out = torch.empty_like(q)
    block.launch_attn_window(q, k, vv, out, B, T, S_DIT, D, heads,
                             block.valid_bits(v, T))
    shape = (B, T, S_DIT, heads, hd)
    ref = block.attend_temporal(
        q.reshape(shape), k.reshape(shape), vv.reshape(shape),
        block.temporal_bias(v, T, "cuda"), torch.bfloat16).reshape(out.shape)
    torch.cuda.synchronize()
    _close(out, ref)
    share, rel = bf16_differences(out, ref)
    print(f"[rounding] attn_temporal_window hd={hd} T={T} valid={v}: "
          f"{share:.3e} of elements differ, max diff {rel:.3e}")
    assert share <= ROUNDING_SHARE and rel <= ROUNDING_REL, (share, rel)


@pytest.mark.parametrize("T,hd", [(1, 64), (3, 32), (5, 64), (8, 128)])
def test_temporal_branch_bwd_windows(cuda, T, hd):
    """The temporal backward (attn_temporal_bwd's T instantiations) against
    its plain version at windows of 1-8 frames and hd 32/64/128, slot 0
    padded; given the forward's mod rows it gives the same bits as
    without them."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(200 + T + hd)
    heads = D // hd
    args, ct = _train_inputs(gen, 2 * T, "temporal")
    f = rope.temporal_rope_freqs(torch.arange(T), rope.lang_freqs(hd)).cuda()
    valid = [False] + [True] * (T - 1) if T > 1 else None
    _, *res, mod = block.fused_temporal_branch(
        *args, f, valid, heads, T, emit_train=True, emit_mod=True)
    bargs = (*args[:6], f, valid, *res, ct, heads, T)
    got = backward.fused_temporal_branch_bwd(*bargs, mod=mod)
    again = backward.fused_temporal_branch_bwd(*bargs)
    torch.cuda.synchronize()
    for a, b, p in zip(got, again,
                       backward.temporal_branch_bwd_plain(*bargs)):
        assert torch.equal(a, b)
        _close(a, p)


def test_temporal_window_launches(cuda):
    """The full window runs ln_mod, the rope qkv GEMM, attn_temporal_window
    and the out-projection; its emitted q/k/v are the attention's inputs
    and its K/V cache (emit_kv) the same bits as emit_train's k, v."""
    from gtax_torch.kernels import build

    gen = np.random.default_rng(210)
    T = 5
    args, _ = _train_inputs(gen, 2 * T, "temporal")
    f = _temporal_freqs(T)
    names = []
    real = build.launch

    def spy(name, *a, **kw):
        names.append(name)
        return real(name, *a, **kw)

    build.launch = spy
    try:
        tr = block.fused_temporal_branch(*args, f, None, H, T,
                                         emit_train=True)
    finally:
        build.launch = real
    kv = block.fused_temporal_branch(*args, f, None, H, T, emit_kv=True)
    torch.cuda.synchronize()
    assert names == ["gtax_ln_mod", "gtax_gemm_rope_qkv",
                     "gtax_attn_temporal_window", "gtax_gemm_bf16"]
    assert torch.equal(kv[0], tr[0])
    assert torch.equal(kv[1], tr[2]) and torch.equal(kv[2], tr[3])


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """The trainer's full state on the card through write_state /
    read_state: the masters come back in place, bit for bit; the optimizer's
    moments in their dtypes (mu bf16) and its count; the CUDA generator's
    state, so the draws after the load are the draws after the save."""
    from gtax_torch.train import checkpoint as ckpt
    from gtax_torch.train.optim import leaves, make_optimizer

    gen = np.random.default_rng(0)
    params = {"blocks": [{"w": _rand(gen, (64, 32), dtype=torch.float32)}
                         for _ in range(2)],
              "final": {"b": _rand(gen, (32,), dtype=torch.float32)}}
    opt, _ = make_optimizer(params, 1e-3, 1e-4, 1, 10,
                            mu_dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(3)
    for _ in range(2):
        opt.step([torch.randn(p.shape, generator=g, device="cuda")
                  for p in opt.params])
    path = str(tmp_path / "state_2")
    ckpt.write_state(path, params, opt, g, 2)
    want = (ckpt.flat(params), opt.state_dict())
    want = ({k: v.clone() for k, v in want[0].items()},
            {n: {k: v.clone() for k, v in want[1][n].items()}
             for n in ("mu", "nu")})
    draw = torch.randn(1000, generator=g, device="cuda")
    with torch.no_grad():
        for t in [p for _, p in leaves(params)] + opt.mu + opt.nu:
            t.zero_()
    opt.count = 0
    g.manual_seed(99)
    masters = [p for _, p in leaves(params)]
    meta = ckpt.read_state(path, params, opt, g)
    assert meta["global_step"] == 2 and opt.count == 2
    assert all(a is b for a, (_, b) in zip(masters, leaves(params)))
    for k, v in ckpt.flat(params).items():
        assert v.is_cuda and torch.equal(v, want[0][k]), k
    for name in ("mu", "nu"):
        for k, v in opt.state_dict()[name].items():
            assert v.is_cuda and v.dtype == want[1][name][k].dtype
            assert torch.equal(v, want[1][name][k]), (name, k)
    assert all(m.dtype == torch.bfloat16 for m in opt.mu)
    assert torch.equal(torch.randn(1000, generator=g, device="cuda"), draw)


# ---------------------------------------------- fp32 forms (#1-#5)
#
# The fp32 branches against their plain versions in fp32 on the card
# (torch.matmul under strict_matmul: full fp32, no TF32). Both sides
# compute every value in fp32 and differ only in summation order and in
# the last bits of expf / sincosf / erfc: 1e-4 of the plain output's
# largest magnitude.

F32_TOL = 1e-4


def _close32(got, ref):
    assert got.dtype == ref.dtype == torch.float32
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    tol = F32_TOL * ref.abs().max().item()
    assert err <= tol, (err, tol)
    return err


def _f32_case(kind, gen):
    """(wrapper, plain, args, kwargs) of one fp32 branch at the main-path
    shape: the step (1 frame), the prefill (4 frames) or the VAE (2
    frames)."""
    f32 = torch.float32

    def r(shape, std=1.0):
        return _rand(gen, shape, std, f32)

    if kind.startswith("vae"):  # 2 frames; the encode's 4, the decode's 6
        frames = {"vae": 2, "vae_n4": 4, "vae_n6": 6}[kind]
        ones = torch.ones(D, device="cuda")
        ln = [ones + r((D,), 0.1), r((D,), 0.1)] * 2
        f = rope.axial_freqs(rope.pixel_freqs(HD // 4, 576.0), (18, 32),
                             pixel=True).reshape(S_VAE, HD // 2).cuda()
        args = (r((frames, S_VAE, D)), ln[0], ln[1], r((D, 3 * D), 0.03),
                r((3 * D,), 0.02), r((D, D), 0.03), r((D,), 0.02), ln[2],
                ln[3], r((D, 4 * D), 0.03), r((4 * D,), 0.02),
                r((4 * D, D), 0.02), r((D,), 0.02), f, H)
        return vae_block.fused_vae_block, vae_block.vae_block_plain, args, {}
    # the training step's B=16: 80 frames, 11,520 rows
    N = {"temporal": 4, "step": 2, "mlp_tanh_b16": 80,
         "mlp_erf_b16": 80}.get(kind, 1)
    x = r((N, S_DIT, D))
    mods = r((N, 6 * D), 0.5)
    head = (x, mods[:, :D], mods[:, D:2 * D], mods[:, 2 * D:3 * D])
    if kind.startswith("mlp"):
        args = (*head, r((D, 4 * D), 0.02), r((4 * D,), 0.02),
                r((4 * D, D), 0.02), r((D,), 0.02))
        kw = {"approx_gelu": kind.startswith("mlp_tanh")}
        return block.fused_mlp_branch, block.mlp_branch_plain, args, kw
    attn = (r((D, 3 * D), 0.02), r((D, D), 0.02), r((D,), 0.02))
    if kind == "spatial":
        return (block.fused_spatial_branch, block.spatial_branch_plain,
                (*head, *attn, _spatial_freqs(), H), {})
    if kind == "temporal":
        return (block.fused_temporal_branch, block.temporal_branch_plain,
                (*head, *attn, _temporal_freqs(4), [False, True, True, True],
                 H, 4), {"emit_kv": True})
    B, n_live, n_ctx = 1, N, 4 - N + 1  # a P=2 step: two live frames
    kc, vc = r((B * n_ctx * S_DIT, D)), r((B * n_ctx * S_DIT, D))
    T = n_ctx + n_live
    return (block.fused_temporal_step, block.temporal_step_plain,
            (*head, *attn, kc, vc, _temporal_freqs(T),
             [False] + [True] * (T - 1), H, n_ctx), {"n_live": n_live})


@pytest.mark.parametrize("kind", ["spatial", "mlp_tanh", "mlp_erf",
                                  "temporal", "step", "vae", "vae_n4",
                                  "vae_n6"])
def test_fp32_branch_kernels(cuda, kind):
    """Each fp32 branch (#1-#5) launches its kernels once and agrees with
    its plain version within F32_TOL; two calls give the same bits (split
    K's partials added in chunk order, no atomics). #5 also at the VAE
    encode's 4 frames and the decode's 6 (2,304 and 3,456 rows: the
    forward's k-major form, fc1's GELU rows stored transposed for fc2)."""
    gen = np.random.default_rng({"spatial": 300, "mlp_tanh": 301,
                                 "mlp_erf": 302, "temporal": 303,
                                 "step": 304, "vae": 305, "vae_n4": 306,
                                 "vae_n6": 307}[kind])
    fn, plain, args, kw = _f32_case(kind, gen)
    before = fn.launches
    got = fn(*args, **kw)
    again = fn(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b, c in zip(got, ref, again):
        _close32(a, b)
        assert torch.equal(a, c)


EPILOGUES_F32 = [block.EPI_F32, block.EPI_BIAS_BF16, block.EPI_BIAS_GELU_TANH,
                 block.EPI_BIAS_GELU_ERF, block.EPI_BIAS_BF16_GELU,
                 block.EPI_BIAS_GATED, block.EPI_BIAS_BF16_RESID]


@pytest.mark.parametrize("M", [144, 200, 288, 576, 719, 3472, 2310, 11520,
                               1440])
@pytest.mark.parametrize("epi", EPILOGUES_F32)
def test_gemm_f32_epilogues(cuda, epi, M):
    """gemm_f32 against the fp32 product (torch.matmul, no TF32) through
    each epilogue stored unrounded, at a step's 144 and 288 rows, 200 (the
    last 48-row tile ragged), a prefill's 576 and 719 (the last row below
    720) on the serving form (48 x 64 tiles, K split over a cluster), and
    from 720 rows on the forward's k-major
    form (128x128 tiles, two an SM, A copied transposed): 3,456 + 16
    (unsplit), 2,310 (the last row tile ragged, K split over 152 tiles),
    training at B=2's 1,440 (K split over 96 tiles) and the training
    step's 11,520 at K = 4,096 (split into 4); N of 1,000 and 3,000 leave
    a tile's columns ragged."""
    from gtax_torch.kernels.vae_block import gelu_erf32

    gen = np.random.default_rng(310 + epi + M)
    S, N = 144, 3000 if M == 3472 else 1000
    K = 4096 if M == 11520 else 1024
    f32 = torch.float32
    a, w = _rand(gen, (M, K), 1.0, f32), _rand(gen, (K, N), 0.03, f32)
    bias = _rand(gen, (N,), 0.1, f32)
    x = _rand(gen, (M, N), 1.0, f32)
    gate = _rand(gen, (-(-M // S), 2 * N), 0.5, f32)[:, :N]
    u = block.mm32(a, w) + bias
    ref = {block.EPI_F32: u - bias, block.EPI_BIAS_BF16: u,
           block.EPI_BIAS_GELU_TANH: block.gelu_tanh32(u),
           block.EPI_BIAS_GELU_ERF: block.gelu_exact32(u),
           block.EPI_BIAS_BF16_GELU: gelu_erf32(u),
           block.EPI_BIAS_GATED:
               x + gate.repeat_interleave(S, 0)[:M] * u,
           block.EPI_BIAS_BF16_RESID: x + u}[epi]
    out = torch.empty((M, N), dtype=f32, device="cuda")
    block.launch_gemm_f32(a, w, out, M, N, K, epi, bias=bias, resid=x,
                          gate=gate, S=S)
    torch.cuda.synchronize()
    _close32(out, ref)
    # the plan splits K but at 3,472 rows (672 tiles, K of 32 steps);
    # unsplit and split agree, and each is bit-stable
    chunk = block.f32_plan(M, N, K, a.device)
    assert (chunk < K) == (M != 3472), chunk
    one = torch.empty_like(out)
    block.launch_gemm_f32(a, w, one, M, N, K, epi, bias=bias, resid=x,
                          gate=gate, S=S, k_chunk=K)
    again = torch.empty_like(out)
    block.launch_gemm_f32(a, w, again, M, N, K, epi, bias=bias, resid=x,
                          gate=gate, S=S)
    torch.cuda.synchronize()
    _close32(one, ref)
    assert torch.equal(again, out)


@pytest.mark.parametrize("M", [288, 432, 576, 700])
@pytest.mark.parametrize("N,K,epi", [
    (3072, 1024, block.EPI_F32),               # qkv
    (1024, 1024, block.EPI_BIAS_BF16_RESID),   # the out-projection
    (4096, 1024, block.EPI_BIAS_GELU_TANH),    # fc1
    (1024, 4096, block.EPI_BIAS_GATED),        # fc2
])
def test_gemm_f32_forms_below_720(cuda, M, N, K, epi):
    """Below 720 rows the three forms of the fp32 forward (the serving
    form, the k-major one and the persistent one, each at its own plan's
    chunks) against the fp32 product, each bit-stable; a call with no form
    given takes block.f32_form's (k-major from 432 rows for qkv, fc1 and
    fc2, not for the out-projection; the persistent form below 432) and
    gives that form's bits; and the rope epilogue on its two forms at the
    prefill's 576 rows."""
    gen = np.random.default_rng(318 + M + N + K)
    S, f32 = 144, torch.float32
    a, w = _rand(gen, (M, K), 1.0, f32), _rand(gen, (K, N), 0.03, f32)
    bias = _rand(gen, (N,), 0.1, f32)
    x = _rand(gen, (M, N), 1.0, f32)
    gate = _rand(gen, (-(-M // S), N), 0.5, f32)
    u = block.mm32(a, w) + bias
    ref = {block.EPI_F32: u - bias, block.EPI_BIAS_BF16_RESID: x + u,
           block.EPI_BIAS_GELU_TANH: block.gelu_tanh32(u),
           block.EPI_BIAS_GATED:
               x + gate.repeat_interleave(S, 0)[:M] * u}[epi]
    outs = {}
    for form in (block.F32_FORM_SERVE, block.F32_FORM_K_MAJOR,
                 block.F32_FORM_PERSIST):
        chunk = block.f32_plan(M, N, K, a.device, form=form)
        got, again = (torch.empty((M, N), dtype=f32, device="cuda")
                      for _ in range(2))
        for out in (got, again):
            block.launch_gemm_f32(a, w, out, M, N, K, epi, bias=bias,
                                  resid=x, gate=gate, S=S, k_chunk=chunk,
                                  fwd=form)
        torch.cuda.synchronize()
        _close32(got, ref)
        assert torch.equal(got, again)
        outs[form] = got
    default = torch.empty_like(ref)
    block.launch_gemm_f32(a, w, default, M, N, K, epi, bias=bias, resid=x,
                          gate=gate, S=S)
    torch.cuda.synchronize()
    assert torch.equal(default, outs[block.f32_form(M, N, K)])
    if M == 576 and N == 3072:  # the prefill's rope product
        f = rope.temporal_rope_freqs(torch.arange(4),
                                     rope.lang_freqs(64)).cuda()
        want = block.rope_qkv_plain(block.mm32(a, w), f, S, 4, 0, f32)
        for fwd in (False, True):
            qkv = tuple(torch.empty((M, K), dtype=f32, device="cuda")
                        for _ in range(3))
            block.launch_gemm_f32_rope_qkv(a, w, *qkv, f, S, 4, 0, 64,
                                           fwd=fwd)
            torch.cuda.synchronize()
            for g, r in zip(qkv, want):
                _close32(g, r)


@pytest.mark.parametrize("M", [144, 200, 288, 431])
@pytest.mark.parametrize("epi", EPILOGUES_F32)
def test_gemm_f32_persist(cuda, epi, M):
    """The fp32 forward's persistent form (gemm_f32_persist_kernel: one
    round of blocks walking (tile, K chunk) units, split tiles summed
    through a workspace in chunk order) through each serving epilogue
    stored unrounded, at a step's 144 and 288 rows, 200 and 431 (the last
    48-row tile ragged) and N = 1,000 (the last 128-column tile ragged):
    within F32_TOL of the fp32 product at its plan's chunks; two calls the
    same bits; the same bits on one block an SM as on the card's round;
    unsplit within F32_TOL; and at the serving form's chunks the serving
    form's bits (both add a chunk's products in K order, then the chunks
    in order)."""
    from gtax_torch.kernels.vae_block import gelu_erf32

    gen = np.random.default_rng(330 + epi + M)
    S, N, K, f32 = 144, 1000, 1024, torch.float32
    a, w = _rand(gen, (M, K), 1.0, f32), _rand(gen, (K, N), 0.03, f32)
    bias = _rand(gen, (N,), 0.1, f32)
    x = _rand(gen, (M, N), 1.0, f32)
    gate = _rand(gen, (-(-M // S), 2 * N), 0.5, f32)[:, :N]
    u = block.mm32(a, w) + bias
    ref = {block.EPI_F32: u - bias, block.EPI_BIAS_BF16: u,
           block.EPI_BIAS_GELU_TANH: block.gelu_tanh32(u),
           block.EPI_BIAS_GELU_ERF: block.gelu_exact32(u),
           block.EPI_BIAS_BF16_GELU: gelu_erf32(u),
           block.EPI_BIAS_GATED:
               x + gate.repeat_interleave(S, 0)[:M] * u,
           block.EPI_BIAS_BF16_RESID: x + u}[epi]
    persist = block.F32_FORM_PERSIST
    sms = block.sm_count(a.device)
    chunk = block.f32_plan(M, N, K, a.device, form=persist)
    assert chunk < K
    kw = dict(bias=bias, resid=x, gate=gate, S=S, fwd=persist)

    def run(**more):
        out = torch.empty((M, N), dtype=f32, device="cuda")
        block.launch_gemm_f32(a, w, out, M, N, K, epi, **{**kw, **more})
        return out

    got, again = run(), run()
    one_an_sm = run(blocks=sms)
    unsplit = run(k_chunk=K)
    serve_chunk = block.f32_serve_chunk(M, N, K, sms)
    at_serve = run(k_chunk=serve_chunk)
    serve = run(k_chunk=serve_chunk, fwd=block.F32_FORM_SERVE)
    torch.cuda.synchronize()
    _close32(got, ref)
    _close32(unsplit, ref)
    assert torch.equal(got, again)
    assert torch.equal(got, one_an_sm)
    assert torch.equal(at_serve, serve)


@pytest.mark.parametrize("n_ctx", [1, 2, 3, 4])
@pytest.mark.parametrize("n_live", [1, 2, 4])
def test_fp32_temporal_step_windows(cuda, n_ctx, n_live):
    """#4 fused_temporal_step in fp32 (its products on the persistent
    form, attn_temporal_f32 over the fp32 cache) against
    temporal_step_plain within F32_TOL at n_ctx 1-4 context frames and
    n_live 1, 2, 4 live frames (the exact step, and the pipelined
    rollout's), slot 0 closed where the window has more than one slot;
    two calls give the same bits."""
    gen = np.random.default_rng(340 + 8 * n_ctx + n_live)
    f32 = torch.float32

    def r(shape, std=1.0):
        return _rand(gen, shape, std, f32)

    T = n_ctx + n_live
    mods = r((n_live, 3 * D), 0.5)
    args = (r((n_live, S_DIT, D)), mods[:, :D], mods[:, D:2 * D],
            mods[:, 2 * D:], r((D, 3 * D), 0.02), r((D, D), 0.02),
            r((D,), 0.02), r((n_ctx * S_DIT, D)), r((n_ctx * S_DIT, D)),
            _temporal_freqs(T), [False] + [True] * (T - 1) if T > 1
            else None, H, n_ctx)
    got = block.fused_temporal_step(*args, n_live=n_live)
    again = block.fused_temporal_step(*args, n_live=n_live)
    ref = block.temporal_step_plain(*args, n_live=n_live)
    torch.cuda.synchronize()
    _close32(got, ref)
    assert torch.equal(got, again)


@pytest.mark.parametrize("M,N,K,epi", [
    (2310, 1008, 1024, block.EPI_BIAS_GELU_TANH),   # ragged M, ldc 2,312;
    #                                                 K split (152 tiles)
    (2310, 4096, 1024, block.EPI_BIAS_BF16_GELU),   # the VAE's fc1 form
    (11520, 4096, 1024, block.EPI_BIAS_GELU_TANH_H),  # #2's fc1 at B=16
    (11520, 1040, 4096, block.EPI_BIAS_GELU_ERF),   # K split (810 tiles)
])
def test_gemm_f32_fwd_k_major(cuda, M, N, K, epi):
    """The forward from 720 rows with A handed over k-major (lda) and C
    stored transposed (ldc, a GELU epilogue; the second output row-major):
    the same bits as the row-major call (A copied transposed by the entry
    point, the same chunks), the transposed rows past M zero; and fc2's
    read of that C k-major equals the row-major product's bits."""
    gen = np.random.default_rng(315 + M + N + K)
    f32 = torch.float32
    ld = block.f32_fwd_ld(f32, M, N, K)
    a, w = _rand(gen, (M, K), 1.0, f32), _rand(gen, (K, N), 0.03, f32)
    bias = _rand(gen, (N,), 0.1, f32)
    two = epi in block.TWO_OUTPUTS
    rows, rows2 = (torch.empty((M, N), dtype=f32, device="cuda")
                   for _ in range(2))
    block.launch_gemm_f32(a, w, rows, M, N, K, epi, bias=bias,
                          out2=rows2 if two else None)
    at = torch.zeros((K, ld), dtype=f32, device="cuda")
    at[:, :M] = a.t()
    cols = torch.full((N, ld), float("nan"), dtype=f32, device="cuda")
    cols2 = torch.empty_like(rows2)
    block.launch_gemm_f32(at, w, cols, M, N, K, epi, bias=bias,
                          out2=cols2 if two else None, lda=ld, ldc=ld)
    torch.cuda.synchronize()
    assert torch.equal(cols[:, :M].t(), rows)
    assert not cols[:, M:].any()
    if two:
        assert torch.equal(cols2, rows2)
    # the next product reads the transposed rows k-major
    w2 = _rand(gen, (N, 64), 0.03, f32)
    want, got = (torch.empty((M, 64), dtype=f32, device="cuda")
                 for _ in range(2))
    block.launch_gemm_f32(rows, w2, want, M, 64, N, block.EPI_F32)
    block.launch_gemm_f32(cols, w2, got, M, 64, N, block.EPI_F32, lda=ld)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("T,n_q,q_off", [(4, 4, 0), (5, 1, 4), (8, 8, 0)])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_gemm_f32_rope_qkv(cuda, hd, T, n_q, q_off):
    """The fp32 rope epilogue against rope_qkv_plain on the fp32 product:
    every row's window slot (a prefill window, a step's live slot, eight
    frames)."""
    gen = np.random.default_rng(320 + hd + T)
    f32 = torch.float32
    f = rope.temporal_rope_freqs(torch.arange(T), rope.lang_freqs(hd)).cuda()
    M = 2 * n_q * S_DIT
    mod, w = _rand(gen, (M, D), 1.0, f32), _rand(gen, (D, 3 * D), 0.05, f32)
    got = tuple(torch.empty((M, D), dtype=f32, device="cuda")
                for _ in range(3))
    block.launch_gemm_f32_rope_qkv(mod, w, *got, f, S_DIT, n_q, q_off, hd)
    ref = block.rope_qkv_plain(block.mm32(mod, w), f, S_DIT, n_q, q_off, f32)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        _close32(a, b)


def _roped_f32(qkv, f, N, S, heads, hd, rot):
    """The plain fp32 rope of qkv's q and k on the first rot dims of each
    head, and its v, each (N, S, heads, hd)."""
    from gtax_torch.core.rope import apply_rotary_emb

    q, k, v = (t.reshape(N, S, heads, hd) for t in qkv.split(heads * hd,
                                                            dim=-1))

    def rot_(t):
        return torch.cat([apply_rotary_emb(f[:, None, :], t[..., :rot]),
                          t[..., rot:]], -1)

    return rot_(q), rot_(k), v


@pytest.mark.parametrize("store", [False, True], ids=["serve", "store"])
@pytest.mark.parametrize("S", [48, 96, 100, 143, S_DIT, 145, S_VAE])
@pytest.mark.parametrize("hd,rot", [(32, 32), (32, 16), (64, 64), (64, 32),
                                    (128, 128), (128, 64)])
def test_attn_frame_f32_kernel(cuda, S, hd, rot, store):
    """attn_frame_f32 (a rope pass, then the attention: up to 144 tokens a
    head's keys whole and one softmax pass, past them 64-key tiles and an
    online softmax) against the plain fp32 attention with rope on the
    first rot dims, at the rule's query tile; S = 100, 143 and 145 leave
    the last tiles ragged. store: the emit_train form, whose q/k/v outputs
    are the roped q and k (within F32_TOL of the plain rope) and the v
    (bit for bit), and whose output is the serving form's bits."""
    gen = np.random.default_rng(330 + S + hd + rot)
    N, heads, f32 = 2, D // hd, torch.float32
    qkv = _rand(gen, (N * S, 3 * D), 1.0, f32)
    f = torch.from_numpy(gen.uniform(-30, 30, (S, rot)).astype(
        np.float32)).cuda()
    out = torch.empty((N * S, D), dtype=f32, device="cuda")
    emitted = tuple(torch.empty_like(out) for _ in range(3)) if store \
        else None
    block.launch_attn_frame_f32(qkv, f, out, N, S, D, heads, rot,
                                qkv_out=emitted)
    q, k, v = _roped_f32(qkv, f, N, S, heads, hd, rot)
    ref = block.attend_frames(q, k, v, f32).reshape(N * S, D)
    torch.cuda.synchronize()
    _close32(out, ref)
    if store:
        serve = torch.empty_like(out)
        block.launch_attn_frame_f32(qkv, f, serve, N, S, D, heads, rot)
        torch.cuda.synchronize()
        assert torch.equal(out, serve)
        _close32(emitted[0], q.reshape(N * S, D))
        _close32(emitted[1], k.reshape(N * S, D))
        assert torch.equal(emitted[2], v.reshape(N * S, D))


@pytest.mark.parametrize("S", [S_DIT, 100, S_VAE])
@pytest.mark.parametrize("hd", [32, 64])
def test_attn_frame_f32_query_tiles_bit_equal(cuda, S, hd):
    """The fp32 frame attention's rows are the same bits at every query
    tile of S's kind: one frame alone (the rule's tile for one frame)
    against many frames (its tile for many), and every tile forced on the
    many frames; the emit_train form's q/k/v too."""
    gen = np.random.default_rng(175 + hd + S)
    heads = D // hd
    N = 8
    qkv = _rand(gen, (N * S, 3 * D), 1.0, torch.float32)
    rot = hd if S == S_DIT else hd // 2
    f = torch.from_numpy(gen.uniform(0, 6.3, (S, rot)).astype(
        np.float32)).cuda()
    whole_kind = S <= block.F32_WHOLE_KEYS

    def run(rows, shape=None):
        n = rows.shape[0] // S
        out = torch.empty((n * S, D), dtype=torch.float32, device="cuda")
        emitted = tuple(torch.empty_like(out) for _ in range(3))
        block.launch_attn_frame_f32(rows, f, out, n, S, D, heads, rot,
                                    qkv_out=emitted, shape=shape)
        return (out, *emitted)

    slots = block.f32_frame_slots(cuda)
    assert (block.f32_frame_shape(S, heads, 1, slots)
            != block.f32_frame_shape(S, heads, N, slots)) or not whole_kind
    whole = run(qkv)
    for n in range(N):
        part = run(qkv[n * S:(n + 1) * S].contiguous())
        torch.cuda.synchronize()
        for a, b in zip(whole, part):
            assert torch.equal(a[n * S:(n + 1) * S], b), n
    for i, (kind, _, _) in enumerate(block.F32_FRAME_SHAPES):
        if kind == whole_kind:
            forced = run(qkv, i)
            torch.cuda.synchronize()
            for a, b in zip(whole, forced):
                assert torch.equal(a, b), i


@pytest.mark.parametrize("valid", [None, [False, True, True, True, True,
                                          True, True, True]])
@pytest.mark.parametrize("T", [1, 2, 5, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_attn_temporal_f32_kernels(cuda, hd, T, valid):
    """attn_temporal_window_f32 (four dims a lane) against attend_temporal
    in fp32, and attn_temporal_f32's step and #4's attn_step_f32 over an
    fp32 cache: the last frame of the window from the cached first T - 1
    equals the window's last frame within F32_TOL."""
    gen = np.random.default_rng(340 + hd + T)
    heads, B, f32 = D // hd, 2, torch.float32
    v = None if valid is None else valid[:T]
    q, k, vv = (_rand(gen, (B * T * S_DIT, D), 1.0, f32) for _ in range(3))
    out = torch.empty_like(q)
    bits = block.valid_bits(v, T)
    block.launch_attn_window(q, k, vv, out, B, T, S_DIT, D, heads, bits)
    shape = (B, T, S_DIT, heads, hd)
    ref = block.attend_temporal(
        q.reshape(shape), k.reshape(shape), vv.reshape(shape),
        block.temporal_bias(v, T, "cuda"), f32).reshape(out.shape)
    torch.cuda.synchronize()
    _close32(out, ref)
    if T == 1:
        return
    # the step: the last frame's q, k, v as fp32 qkv rows with zero rope
    # angles (the window's rows are post-rope already)
    rows = lambda t: t.reshape(B, T, S_DIT, D)  # noqa: E731
    qkv = torch.cat([rows(t)[:, -1] for t in (q, k, vv)], -1).reshape(
        B * S_DIT, 3 * D).contiguous()
    kc, vc = (rows(t)[:, :-1].reshape(-1, D).contiguous() for t in (k, vv))
    step = torch.empty((B * S_DIT, D), dtype=f32, device="cuda")
    zeros = torch.zeros((T, hd), dtype=f32, device="cuda")
    block.launch_attn_temporal_f32(qkv, zeros, step, B, 1, T - 1, S_DIT, D,
                                   heads, bits, kc, vc)
    step4 = torch.empty_like(step)  # #4's fp32 step body
    block.launch_attn_step_f32(qkv, zeros, step4, B, 1, T - 1, S_DIT, D,
                               heads, bits, kc, vc)
    torch.cuda.synchronize()
    _close32(step, rows(ref)[:, -1].reshape(B * S_DIT, D))
    _close32(step4, rows(ref)[:, -1].reshape(B * S_DIT, D))


def test_fp32_refusals_on_the_card(cuda):
    """An fp32 x with bf16 weights raises ValueError as any dtype mismatch
    does (fp32 emit_train is taken: test_fp32_emit_train_kernels), and so
    does an fp32 backward given a bf16 residual."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(350)
    fn, _, args, kw = _f32_case("mlp_tanh", gen)
    with pytest.raises(ValueError, match="w1"):
        fn(*args[:4], args[4].bfloat16(), *args[5:])
    _, h1, y = fn(*args, emit_train=True)
    x, sh, sc, g, w1, _, w2, _ = args
    with pytest.raises(ValueError, match="h1"):
        backward.fused_mlp_branch_bwd(x, sh, sc, g, w1, w2, h1.bfloat16(), y,
                                      torch.ones_like(x))


def test_fp32_kernels_use_no_tensor_cores(cuda):
    """The fp32 kernels, the training ones included (gemm_f32's training
    epilogues are instantiations of its two forward forms, its trans_b and
    wgrad forms of gemm_f32_bwd_kernel; the serving rows' forms
    gemm_f32_serve_kernel and gemm_f32_persist_kernel, the `pallas`
    attention's tiled forms
    attn_sdpa_f32_tile_kernel and _wide_kernel, and the frame attention's
    rope pass and its query tiles' bodies among them), are FFMA only:
    cuobjdump's SASS of the built library has no HMMA or HGMMA (any type,
    TF32 included) in them, and FFMAs, each kernel named here found by
    name; the fp32 pairs hold the int8 tensor cores' IGMMA and no HMMA /
    HGMMA but the compiler's no-op GMMA (an HGMMA into RZ from a zero descriptor that ptxas emits
    with an injected warpgroup.arrive, as in the int8 GEMM); the bf16
    kernels' HGMMA is there, as a control."""
    import re
    import shutil
    import subprocess

    noop = re.compile(r"HGMMA\.\S+ RZ, gdesc\[URZ\], RZ, !UPT")

    def computing(f):
        return [line for line in f.splitlines()
                if ("HMMA" in line or "HGMMA" in line)
                and not noop.search(line)]

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.build())],
                          capture_output=True, text=True, check=True).stdout
    funcs = sass.split("Function : ")[1:]
    names = ("attn_frame_f32_kernel", "attn_rope_f32_kernel",
             "attn_window_f32_kernel",
             "attn_temporal_f32_kernel", "ln_mod_kernelIf",
             "attn_sdpa_rows_f32_kernel", "attn_sdpa_f32_tile_kernel",
             "attn_sdpa_f32_wide_kernel", "attn_frame_bwd_f32_q",
             "attn_frame_bwd_f32_k", "attn_temporal_bwd_f32_kernel",
             "gate_bwd_kernelIfE", "ln_mod_bwd_kernelILi16EfE",
             "gemm_f32_bwd_kernel", "gemm_f32_fwd_kernel",
             "gemm_f32_serve_kernel", "gemm_f32_persist_kernel",
             "attn_step_f32_kernel")
    heads = [f.split("\n", 1)[0] for f in funcs]
    assert all(any(n in h for h in heads) for n in names), [
        n for n in names if not any(n in h for h in heads)]
    f32 = [f for f in funcs if any(n in f.split("\n", 1)[0] for n in names)]
    pairs = [f for f in funcs
             if re.search(r"pair_q_kernelILi\d+ELb\dELb\dEfE",
                          f.split("\n", 1)[0])]
    assert len(f32) >= len(names) and len(pairs) == 8
    for f in f32:
        assert "HMMA" not in f and "HGMMA" not in f, f.split("\n", 1)[0]
    for f in pairs:
        assert not computing(f), computing(f)[:3]
        assert "IGMMA" in f, f.split("\n", 1)[0]
    assert any("FFMA" in f for f in f32)
    assert any(computing(f) for f in funcs)


# ------------------------------------------- the exact GELU (#2, #9-#11)

@pytest.mark.parametrize("emit_train", [False, True])
def test_mlp_branch_exact_gelu_kernel(cuda, emit_train):
    """bf16 #2 with approx_gelu=False (EPI_BIAS_GELU_ERF, and its _H form
    under emit_train) against the plain version: 2**-6 of the largest
    magnitude; the default unchanged by the flag."""
    gen = np.random.default_rng(360)
    x, sh, sc, g = _branch_inputs(gen, 2, S_DIT)
    w1, w2 = _rand(gen, (D, 4 * D), 0.02), _rand(gen, (4 * D, D), 0.02)
    b1, b2 = _rand(gen, (4 * D,), 0.02), _rand(gen, (D,), 0.02)
    args = (x, sh, sc, g, w1, b1, w2, b2)
    kw = {"approx_gelu": False, "emit_train": emit_train}
    got = block.fused_mlp_branch(*args, **kw)
    ref = block.mlp_branch_plain(*args, **kw)
    for a, b in zip(got if emit_train else (got,),
                    ref if emit_train else (ref,)):
        _close(a, b)
    tanh = block.fused_mlp_branch(*args)
    assert torch.equal(tanh, block.fused_mlp_branch(*args, approx_gelu=True))
    assert not torch.equal(tanh, got[0] if emit_train else got)


def test_int8_exact_gelu_kernels(cuda):
    """#9 with approx_gelu=False against its plain version (2**-6); #10 and
    #11 in that mode bit-equal to #7 / #6 + #9 with the same flag."""
    gen = np.random.default_rng(361)
    x, sh, sc, g = _branch_inputs(gen, 1, S_DIT)
    w = _pair_weights(gen)
    aw, mw = w[:5], w[5:]
    args = (x, sh, sc, g, *mw)
    _close(quant.fused_mlp_branch_q(*args, approx_gelu=False),
           quant.mlp_branch_q_plain(*args, approx_gelu=False))
    from gtax_torch.kernels import pair

    x, sh1, sc1, g1, sh2, sc2, g2 = _pair_inputs(gen, 1)[:7]
    f = _spatial_freqs()
    got = pair.fused_spatial_pair_q(x, sh1, sc1, g1, sh2, sc2, g2, *aw, *mw,
                                    f, H, approx_gelu=False)
    h = quant.fused_spatial_branch_q(x, sh1, sc1, g1, *aw, f, H)
    assert torch.equal(got, quant.fused_mlp_branch_q(
        h, sh2, sc2, g2, *mw, approx_gelu=False))
    n_ctx, valid = 4, [False, True, True, True, True]
    kc = _rand(gen, (n_ctx * S_DIT, D))
    vc = _rand(gen, (n_ctx * S_DIT, D))
    tf = _temporal_freqs(n_ctx + 1)
    got = pair.fused_temporal_pair_q(x, sh1, sc1, g1, sh2, sc2, g2, *aw, *mw,
                                     kc, vc, tf, valid, H, n_ctx,
                                     approx_gelu=False)
    h = quant.fused_temporal_step_q(x, sh1, sc1, g1, *aw, kc, vc, tf, valid,
                                    H, n_ctx)
    assert torch.equal(got, quant.fused_mlp_branch_q(
        h, sh2, sc2, g2, *mw, approx_gelu=False))


# ------------------- fp32 int8 and fp32 `pallas` (#6-#11, #15 and #16)

def _f32_q_case(kind, gen, frames=None):
    """(wrapper, plain, args, kwargs) of one int8 branch at x.dtype =
    float32 (gtax serves fp32 with int8): fp32 activations, adaLN rows,
    biases and context cache, the int8 weights quantized from bf16 draws;
    frames: N (the temporal branch's in windows of 4), else the step's."""
    f32 = torch.float32
    N = frames or {"temporal": 4, "step": 2}.get(kind, 1)
    x = _rand(gen, (N, S_DIT, D), 1.0, f32)
    mods = _rand(gen, (N, 6 * D), 0.5, f32)
    head = (x, mods[:, :D], mods[:, D:2 * D], mods[:, 2 * D:3 * D])
    if kind.startswith("mlp"):
        args = (*head, *_qweight(gen, (D, 4 * D), 0.02),
                _rand(gen, (4 * D,), 0.02, f32),
                *_qweight(gen, (4 * D, D), 0.02), _rand(gen, (D,), 0.02, f32))
        return (quant.fused_mlp_branch_q, quant.mlp_branch_q_plain, args,
                {"approx_gelu": kind == "mlp_tanh"})
    attn = (*_qweight(gen, (D, 3 * D), 0.02), *_qweight(gen, (D, D), 0.02),
            _rand(gen, (D,), 0.02, f32))
    if kind == "spatial":
        return (quant.fused_spatial_branch_q, quant.spatial_branch_q_plain,
                (*head, *attn, _spatial_freqs(), H), {})
    if kind == "temporal":
        return (quant.fused_temporal_branch_q, quant.temporal_branch_q_plain,
                (*head, *attn, _temporal_freqs(4), [False, True, True, True],
                 H, 4), {"emit_kv": True})
    n_live, n_ctx = N, 3  # a P=2 step: two live frames over three
    kc = _rand(gen, (n_ctx * S_DIT, D), 1.0, f32)
    vc = _rand(gen, (n_ctx * S_DIT, D), 1.0, f32)
    return (quant.fused_temporal_step_q, quant.temporal_step_q_plain,
            (*head, *attn, kc, vc, _temporal_freqs(5),
             [False, True, True, True, True], H, n_ctx), {"n_live": n_live})


@pytest.mark.parametrize("kind", ["spatial", "mlp_tanh", "mlp_erf",
                                  "temporal", "step"])
def test_int8_f32_kernels(cuda, kind):
    """#6-#9 at x.dtype = float32 against their plain versions: every output
    (the prefill's fp32 K/V cache included) fp32 and within 2**-6 of its
    largest magnitude (the int8 rule: a summation order can flip an int8
    rounding of an activation); one launch counted a call; two calls give
    the same bits."""
    gen = np.random.default_rng({"spatial": 370, "mlp_tanh": 371,
                                 "mlp_erf": 372, "temporal": 373,
                                 "step": 374}[kind])
    fn, plain, args, kw = _f32_q_case(kind, gen)
    before = fn.launches
    got, again = fn(*args, **kw), fn(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b, c in zip(got, ref, again):
        assert a.dtype == b.dtype == torch.float32
        _close(a, b)
        assert torch.equal(a, c)


def test_int8_f32_parts(cuda):
    """The fp32 int8 parts alone: ln_mod's int8 mode over fp32 rows bit-equal
    to quant_rows of the plain fp32 modulate wherever no row's int8 rounding
    sits on a tie, and gemm_s8's fp32 gated epilogue bit-equal to the plain
    x + gate * (y + b) over the same int8 rows."""
    gen = np.random.default_rng(375)
    f32 = torch.float32
    x, sh, sc, g = (_rand(gen, (2, S_DIT, D), 1.0, f32),
                    *(_rand(gen, (2, D), 0.5, f32) for _ in range(3)))
    q, s = quant._ln_mod_q(x, sh, sc)
    pq, ps = quant.quant_rows(block.modulated32(x, sh, sc).reshape(-1, D))
    assert (q.int() - pq.int()).abs().max().item() <= 1
    assert (q != pq).float().mean().item() < 1e-3
    torch.testing.assert_close(s, ps, rtol=1e-6, atol=0)
    w_q, w_s = _qweight(gen, (D, D), 0.02)
    b = _rand(gen, (D,), 0.02, f32)
    out = torch.empty_like(x)
    quant._gemm_s8(q, s, w_q, w_s, out, quant.EPI_BIAS_GATED_F32, bias=b,
                   resid=x, gate=g, S=S_DIT)
    y = quant.mm_int(q, w_q) * s * w_s.reshape(-1) + b
    ref = (x.reshape(-1, D) + g.repeat_interleave(S_DIT, 0) * y).reshape(
        x.shape)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("approx_gelu", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("kind,N", [("spatial", 1), ("spatial", 2),
                                    ("temporal", 1), ("temporal", 2)])
def test_int8_f32_pairs_bit_equal(cuda, kind, N, approx_gelu):
    """#10 and #11 at x.dtype = float32 (csrc/pair_q_f32.cu): against the
    plain version within 2**-6, bit-equal to the fp32 sequential wrappers
    (#7 + #9, #6 + #9) in both GELU modes, and to a second call."""
    from gtax_torch.kernels import pair

    gen = np.random.default_rng(380 + N + 10 * (kind == "temporal"))
    f32 = torch.float32
    x = _rand(gen, (N, S_DIT, D), 1.0, f32)
    mods = _rand(gen, (N, 6 * D), 0.5, f32)
    vec = (x, *(mods[:, i * D:(i + 1) * D] for i in range(6)))
    aw = (*_qweight(gen, (D, 3 * D), 0.02), *_qweight(gen, (D, D), 0.02),
          _rand(gen, (D,), 0.02, f32))
    mw = (*_qweight(gen, (D, 4 * D), 0.02), _rand(gen, (4 * D,), 0.02, f32),
          *_qweight(gen, (4 * D, D), 0.02), _rand(gen, (D,), 0.02, f32))
    kw = {"approx_gelu": approx_gelu}
    x, sh1, sc1, g1, sh2, sc2, g2 = vec
    if kind == "spatial":
        tail = (_spatial_freqs(), H)
        fn, plain = pair.fused_spatial_pair_q, pair.spatial_pair_q_plain
        h = quant.fused_spatial_branch_q(x, sh1, sc1, g1, *aw, *tail)
        extra = {}
    else:
        n_ctx = 4 if N == 1 else 3
        kc = _rand(gen, (n_ctx * S_DIT, D), 1.0, f32)
        vc = _rand(gen, (n_ctx * S_DIT, D), 1.0, f32)
        T = n_ctx + N
        tail = (kc, vc, _temporal_freqs(T), [False] + [True] * (T - 1), H,
                n_ctx)
        fn, plain = pair.fused_temporal_pair_q, pair.temporal_pair_q_plain
        extra = {"n_live": N}
        h = quant.fused_temporal_step_q(x, sh1, sc1, g1, *aw, *tail, **extra)
    seq = quant.fused_mlp_branch_q(h, sh2, sc2, g2, *mw, **kw)
    before = fn.launches
    got = fn(*vec, *aw, *mw, *tail, **extra, **kw)
    again = fn(*vec, *aw, *mw, *tail, **extra, **kw)
    ref = plain(*vec, *aw, *mw, *tail, **extra, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2 and got.dtype == torch.float32
    _close(got, ref)
    assert torch.equal(got, seq)
    assert torch.equal(got, again)


def test_int8_f32_pair_grid(cuda):
    """The fp32 pair's cooperative grid is its own instantiation's (its
    registers and shared memory): a positive count the card holds at once,
    and the fp32 spatial unit's K and V tiles inside the GEMM ring."""
    from gtax_torch.kernels import pair

    for temporal in (False, True):
        n = pair.grid_blocks(temporal, HD, S_DIT, D, torch.float32)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert 0 < n <= 2 * sms, (temporal, n)


@pytest.mark.parametrize("kind", ["spatial", "mlp_tanh", "mlp_erf",
                                  "temporal", "spatial B=16",
                                  "mlp_tanh B=16", "mlp_erf B=16",
                                  "temporal B=16"])
def test_int8_f32_emit_train_kernels(cuda, kind, monkeypatch):
    """fp32 emit_train through the int8 wrappers (#7-#9, int8-forward
    training at compute_dtype float32): every residual fp32 and within
    2**-6 of the plain version's largest magnitude (the int8 rule); the
    output bit-equal to the call without emit_train (gemm_s8's epilogues
    5-7 and the attention's q/k/v stores change no value); two calls give
    the same bits. At 80 frames (11,520 rows, gemm_s8_train) every output
    is also bit-equal to the weight-streaming tile's."""
    train = kind.endswith("B=16")
    kind = kind.split()[0]
    gen = np.random.default_rng({"spatial": 376, "mlp_tanh": 377,
                                 "mlp_erf": 378, "temporal": 379}[kind]
                                + 10 * train)
    fn, plain, args, kw = _f32_q_case(kind, gen, 80 if train else None)
    kw = {k: v for k, v in kw.items() if k != "emit_kv"}
    got = fn(*args, **kw, emit_train=True)
    again = fn(*args, **kw, emit_train=True)
    ref = plain(*args, **kw, emit_train=True)
    serve = fn(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], serve)
    for a, b, c in zip(got, ref, again):
        assert a.dtype == b.dtype == torch.float32
        _close(a, b)
        assert torch.equal(a, c)
    if train:
        _stream_too(monkeypatch, fn, args, {**kw, "emit_train": True}, got)


@pytest.mark.parametrize("hd", [32, HD])
@pytest.mark.parametrize("layout", ["heads_first", "token_major"])
@pytest.mark.parametrize("S", [5, 31, 32, 48, 96, 100, 143, S_DIT, 145,
                               288, S_VAE, 577])
def test_attn_sdpa_f32_kernel(cuda, S, layout, hd):
    """#15 / #16 in fp32 (attn_sdpa's fp32 form: warp rows below
    SDPA_TENSOR_CORES_MIN_S, the tiled SIMT body from it: 48-row tiles over
    48-key tiles to 144 tokens, 128-row tiles over 64-key tiles above, so
    S = 48, 96, 143, 144 and 145, 288, 576, 577 sit on and beside the
    tiles' edges) at head dims 32 and 64, with no mask, causal, the
    temporal valid | eye mask and a fully masked row, within F32_TOL of
    the plain fp32 version; the token-major q/k/v are strided views of one
    fused qkv row, bit-equal to contiguous copies (and the heads-first
    call to a second call); fp32 out."""
    from gtax_torch.kernels import attention as kattn

    gen = np.random.default_rng(390 + S + hd)
    f32 = torch.float32
    heads = D // HD  # 16 heads of 64, or of 32 over half the width
    width = heads * hd
    if layout == "heads_first":
        q, k, v = (_rand(gen, (2, 3, S, hd), 1.0, f32) for _ in range(3))
    else:
        qkv = _rand(gen, (3, S, 3 * width), 1.0, f32)
        q, k, v = qkv.split(width, dim=-1)
    for kind in ("none", "causal", "temporal", "masked_row"):
        mask, causal = _sdpa_mask(kind, S), kind == "causal"
        bias = kattn.build_bias(S, mask, causal, "cuda")
        if layout == "heads_first":
            before = kattn.fused_sdpa.launches
            got = kattn.fused_sdpa(q, k, v, mask=mask, causal=causal)
            assert kattn.fused_sdpa.launches == before + 1
            ref = kattn.sdpa_plain(*(t.reshape(-1, S, hd) for t in (q, k, v)),
                                   bias).reshape(got.shape)
            again = kattn.fused_sdpa(q, k, v, mask=mask, causal=causal)
        else:
            got = kattn.fused_mha_token_major(q, k, v, heads, mask=mask,
                                              causal=causal)
            ref = kattn.mha_token_major_plain(q, k, v, bias, heads)
            again = kattn.fused_mha_token_major(
                q.contiguous(), k.contiguous(), v.contiguous(), heads,
                mask=mask, causal=causal)
        torch.cuda.synchronize()
        assert got.dtype == f32
        _close32(got, ref)
        assert torch.equal(got, again), kind


# ------------------------------- fp32 training (#1-#3, #7-#9 emit_train,
# the backwards #12-#14): every value fp32, held to F32_TOL of the plain
# version's largest magnitude; the backwards bit-equal across two calls

@pytest.mark.parametrize("kind", ["spatial", "mlp_tanh", "mlp_erf",
                                  "temporal", "mlp_tanh_b16",
                                  "mlp_erf_b16"])
def test_fp32_emit_train_kernels(cuda, kind):
    """#1-#3 emit_train in fp32 against their plain versions (every
    residual fp32, F32_TOL); the output bit-equal to the serving call's
    (the stores of attn_frame_f32 and gemm_f32's _Y / _H epilogues change
    no value); two calls give the same bits. #2 also at the training
    step's B=16 (11,520 rows: the forward's k-major form, fc1's GELU rows
    stored transposed for fc2, fc2's K split)."""
    gen = np.random.default_rng({"spatial": 400, "mlp_tanh": 401,
                                 "mlp_erf": 402, "temporal": 403,
                                 "mlp_tanh_b16": 404,
                                 "mlp_erf_b16": 405}[kind])
    fn, plain, args, kw = _f32_case(kind, gen)
    kw = {k: v for k, v in kw.items() if k != "emit_kv"}
    got = fn(*args, **kw, emit_train=True)
    again = fn(*args, **kw, emit_train=True)
    ref = plain(*args, **kw, emit_train=True)
    serve = fn(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], serve)
    for a, b, c in zip(got, ref, again):
        _close32(a, b)
        assert torch.equal(a, c)


@pytest.mark.parametrize("M,N,K", [(288, 1000, 1024), (1440, 1000, 1024),
                                   (3472, 1000, 1024), (200, 1000, 4096),
                                   (11520, 1020, 4096), (11520, 4092, 1024),
                                   (195, 1000, 1024), (4805, 1020, 1024)])
def test_gemm_f32_train_epilogues(cuda, M, N, K):
    """gemm_f32's training forms against the fp32 products: the _Y / _H
    epilogues' two outputs (split K at 288 rows, unsplit on the 128x128
    tiles at 3,472), dY @ W^T (trans_b, EPI_F32, split and unsplit: the
    backward tile's K chunks at 200 rows), and the gelu' epilogue
    (trans_b, one pass) with its 64-row column sums; M and N off the
    128-row tile (the last tile ragged in both), K = 4,096 against N ~
    1,024 and the reverse at the training step's 11,520 rows; M not a
    multiple of 4 (trans_b's transposed copy of dY padded to 4 rows; K
    split at 195 rows, one pass at 4,805); each bit-stable."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(410 + M + N + K)
    S, f32 = 144, torch.float32
    a, w = _rand(gen, (M, K), 1.0, f32), _rand(gen, (K, N), 0.03, f32)
    bias = _rand(gen, (N,), 0.1, f32)
    x = _rand(gen, (M, N), 1.0, f32)
    gate = _rand(gen, (-(-M // S), 2 * N), 0.5, f32)[:, :N]
    u = block.mm32(a, w) + bias
    refs = {block.EPI_BIAS_GATED_Y: x + gate.repeat_interleave(S, 0)[:M] * u,
            block.EPI_BIAS_GELU_TANH_H: block.gelu_tanh32(u),
            block.EPI_BIAS_GELU_ERF_H: block.gelu_exact32(u)}
    for epi, ref in refs.items():
        outs = []
        for k_chunk in (None, K, None):
            out, out2 = (torch.empty((M, N), dtype=f32, device="cuda")
                         for _ in range(2))
            block.launch_gemm_f32(a, w, out, M, N, K, epi, bias=bias,
                                  resid=x, gate=gate, S=S, k_chunk=k_chunk,
                                  out2=out2)
            outs.append((out, out2))
        torch.cuda.synchronize()
        for out, out2 in outs:
            _close32(out, ref)
            _close32(out2, u)
        assert torch.equal(outs[0][0], outs[2][0])
        assert torch.equal(outs[0][1], outs[2][1])
    # dY @ W^T: W (N, K) read from its rows
    dy, wt = _rand(gen, (M, K), 1.0, f32), _rand(gen, (N, K), 0.03, f32)
    ref = block.mm32(dy, wt.t())
    for k_chunk in (None, K):
        out = torch.empty((M, N), dtype=f32, device="cuda")
        block.launch_gemm_f32(dy, wt, out, M, N, K, block.EPI_F32,
                              k_chunk=k_chunk, trans_b=True)
        torch.cuda.synchronize()
        _close32(out, ref)
    # gelu': u = gelu'(h1) * (dY @ W^T), gelu(h1), the slabs' column sums
    h1 = _rand(gen, (M, N), 1.0, f32)
    ha32, gp32 = backward.gelu_tanh_val_grad32(h1)
    du = gp32 * ref
    res = []
    for _ in range(2):
        out, out2 = (torch.empty((M, N), dtype=f32, device="cuda")
                     for _ in range(2))
        part = torch.empty((-(-M // block.F32_SLAB), N), dtype=f32,
                           device="cuda")
        block.launch_gemm_f32(dy, wt, out, M, N, K, block.EPI_DGELU,
                              out2=out2, aux=h1, colsum=part, trans_b=True)
        res.append((out, out2, backward.reduce_rows(part)))
    torch.cuda.synchronize()
    _close32(res[0][0], du)
    _close32(res[0][1], ha32)
    _close32(res[0][2], du.sum(0))
    assert all(torch.equal(p, q) for p, q in zip(*res))


@pytest.mark.parametrize("M,Ka,N", [(4000, 128, 64), (1440, 1024, 1024),
                                    (11520, 1024, 3072), (2000, 196, 260),
                                    (11520, 4096, 1024), (11520, 1024, 4096)])
def test_gemm_f32_wgrad(cuda, M, Ka, N):
    """The fp32 weight gradient (A^T @ B in row chunks, the last ragged at
    4,000 and 2,000 rows; one chunk's partial or reduce_rows in chunk
    order) against the fp32 product, Ka and N off the 128 tile at 2,000
    rows, Ka = 4,096 against N = 1,024 and the reverse at 11,520; a second
    call bit-equal; every chunk count 1-8 of 16-row steps (a short last
    chunk at most) within the tolerance too."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(420 + M + Ka)
    f32 = torch.float32
    a, b = _rand(gen, (M, Ka), 1.0, f32), _rand(gen, (M, N), 1.0, f32)
    got, again = backward.wgrad(a, b), backward.wgrad(a, b)
    torch.cuda.synchronize()
    ref = backward.wgrad32(a, b)
    _close32(got, ref)
    assert torch.equal(got, again)
    for s in range(1, 9):
        chunk = -(-(-(-M // s)) // 16) * 16
        splits = -(-M // chunk)
        part = torch.empty((splits, Ka, N), dtype=f32, device="cuda")
        build.launch("gtax_gemm_f32_wgrad", a.data_ptr(), b.data_ptr(),
                     part.data_ptr(), M, Ka, N, chunk,
                     torch.cuda.current_stream().cuda_stream)
        _close32(part[0] if splits == 1 else backward.reduce_rows(part), ref)


def _train_inputs_f32(gen, N, kind):
    """_train_inputs in fp32: x, the split adaLN rows, weights, biases and
    the cotangent."""
    f32 = torch.float32
    x = _rand(gen, (N, S_DIT, D), 1.0, f32)
    mods = _rand(gen, (N, 6 * D), 0.5, f32)
    head = (x, mods[:, :D], mods[:, D:2 * D], mods[:, 2 * D:3 * D])
    if kind == "mlp":
        w = (_rand(gen, (D, 4 * D), 0.02, f32),
             _rand(gen, (4 * D,), 0.02, f32),
             _rand(gen, (4 * D, D), 0.02, f32), _rand(gen, (D,), 0.02, f32))
    else:
        w = (_rand(gen, (D, 3 * D), 0.02, f32), _rand(gen, (D, D), 0.02, f32),
             _rand(gen, (D,), 0.02, f32))
    return (*head, *w), _rand(gen, (N, S_DIT, D), 1.0, f32)


@pytest.mark.parametrize("kind,N", [("spatial", 2), ("spatial", 10),
                                    ("temporal", 10), ("mlp", 2),
                                    ("mlp", 10), ("spatial", 80),
                                    ("mlp", 80)])
def test_fp32_backward_kernels(cuda, kind, N):
    """#12-#14 in fp32 over their fp32 forwards' residuals against the
    plain backwards (every gradient within F32_TOL of its largest
    magnitude); a second call gives the same bits; one launch counted a
    call."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(430 + N + len(kind))
    args, ct = _train_inputs_f32(gen, N, kind)
    if kind == "mlp":
        _, h1, y = block.fused_mlp_branch(*args, emit_train=True)
        x, sh, sc, g, w1, _, w2, _ = args
        fn = backward.fused_mlp_branch_bwd
        plain = backward.mlp_branch_bwd_plain
        bargs, kw = (x, sh, sc, g, w1, w2, h1, y, ct), {}
    elif kind == "spatial":
        f = _spatial_freqs()
        _, *res = block.fused_spatial_branch(*args, f, H, emit_train=True)
        fn = backward.fused_spatial_branch_bwd
        plain = backward.spatial_branch_bwd_plain
        bargs, kw = (*args[:6], f, *res, ct, H), {}
    else:
        T, valid = 5, [False, True, True, True, True]
        f = _temporal_freqs(T)
        _, *res, mod = block.fused_temporal_branch(
            *args, f, valid, H, T, emit_train=True, emit_mod=True)
        fn = backward.fused_temporal_branch_bwd
        plain = backward.temporal_branch_bwd_plain
        bargs, kw = (*args[:6], f, valid, *res, ct, H, T), {"mod": mod}
    before = fn.launches
    got, again = fn(*bargs, **kw), fn(*bargs, **kw)
    ref = plain(*bargs)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    for a, b, c in zip(got, ref, again):
        assert a.dtype == torch.float32
        _close32(a, b)
        assert torch.equal(a, c)


@pytest.mark.parametrize("S,hd,partial", [(S_DIT, 64, False),
                                          (S_DIT, 32, True), (100, 64, True),
                                          (176, 64, False), (192, 32, True),
                                          (256, 64, True), (432, 64, False),
                                          (528, 32, True)])
def test_attn_frame_bwd_f32_kernel(cuda, S, hd, partial):
    """attn_frame_bwd_f32 alone (two passes over 48-row tiles) against the
    plain backward's arithmetic in fp32: at the DiT's S = 144, a ragged
    100 (and 176, 192, 256, each off the 48-row tile), the bf16 kernel's
    limits (176 at hd 64, 192 at 32) and its own (432 at hd 64, 528 at
    32; one token more is refused: pass 1's scores of one tile more do not
    fit); a second run is bit-equal to the first."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(440 + S + hd + partial)
    N, heads, f32 = 3, D // hd, torch.float32
    rot = hd // 2 if partial else hd
    q, k, v, dout = (_rand(gen, (N, S, heads, hd), 1.0, f32)
                     for _ in range(4))
    freqs = torch.from_numpy(gen.uniform(0, 6.3, (S, rot)).astype(
        np.float32)).cuda()
    flat = [t.reshape(N * S, D) for t in (q, k, v, dout)]

    def run():
        dqkv = torch.empty((N * S, 3 * D), dtype=f32, device="cuda")
        ao = torch.empty((N * S, D), dtype=f32, device="cuda")
        backward.launch_attn_frame_bwd(*flat, *backward.rope_tables(freqs),
                                       dqkv, ao, N, S, D, heads, rot)
        torch.cuda.synchronize()
        return ao, dqkv

    ao, dqkv = run()
    d = hd
    ref = backward._attention_bwd_plain(q, k, v, dout, None, f32, 1.0 / d**0.5,
                                        ("nqhd", "nkhd", "nhqk"))
    f = freqs[:, None, :]

    def adj(u):
        return torch.cat([backward.rope_transpose32(f, u[..., :rot]),
                          u[..., rot:]], -1)

    ref = (ref[0], adj(ref[1]), adj(ref[2]), ref[3])
    for a, b in zip((ao, *dqkv.split(D, dim=-1)), ref):
        _close32(a, b.reshape(N * S, D).float())
    ao2, dqkv2 = run()
    assert torch.equal(ao, ao2) and torch.equal(dqkv, dqkv2)
    if (S, hd) in ((432, 64), (528, 32)):  # one key tile more: no room
        S2 = S + 1
        t = torch.empty((S2, D), dtype=f32, device="cuda")
        cs = torch.zeros((S2, hd), device="cuda")
        with pytest.raises(RuntimeError, match="gtax_attn_frame_bwd_f32"):
            backward.launch_attn_frame_bwd(
                t, t, t, t, cs, cs,
                torch.empty((S2, 3 * D), dtype=f32, device="cuda"), t, 1,
                S2, D, heads, hd)


@pytest.mark.parametrize("T,hd", [(1, 64), (3, 32), (5, 64), (8, 128)])
def test_temporal_branch_bwd_f32_windows(cuda, T, hd):
    """The fp32 temporal backward (attn_temporal_bwd_f32's T
    instantiations, four fp32 dims a lane) against its plain version at
    windows of 1-8 frames and hd 32/64/128, slot 0 padded; given the
    forward's mod rows, the same bits as without them."""
    from gtax_torch.kernels import backward

    gen = np.random.default_rng(450 + T + hd)
    heads = D // hd
    args, ct = _train_inputs_f32(gen, 2 * T, "temporal")
    f = rope.temporal_rope_freqs(torch.arange(T), rope.lang_freqs(hd)).cuda()
    valid = [False] + [True] * (T - 1) if T > 1 else None
    _, *res, mod = block.fused_temporal_branch(
        *args, f, valid, heads, T, emit_train=True, emit_mod=True)
    bargs = (*args[:6], f, valid, *res, ct, heads, T)
    got = backward.fused_temporal_branch_bwd(*bargs, mod=mod)
    again = backward.fused_temporal_branch_bwd(*bargs)
    torch.cuda.synchronize()
    for a, b, p in zip(got, again,
                       backward.temporal_branch_bwd_plain(*bargs)):
        assert torch.equal(a, b)
        _close32(a, p)


# ------------------------------------------------- the compiled rollout

@pytest.fixture(scope="module")
def graph_base():
    """The seeded fp32 generator the modes serve (rollout_graphs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from gtax_torch.tools import rollout_graphs
    from gtax_torch.utils.platform import strict_matmul

    strict_matmul()
    return rollout_graphs.base_generator()


@pytest.mark.parametrize("label", ["bf16", "bf16-fused_all", "int8",
                                   "int8-seq", "fp32", "fp32-int8", "pallas",
                                   "xla", "fused_mlp", "no-cond-cache",
                                   "stacked"])
def test_graphed_rollout_bit_equal_to_eager(graph_base, label):
    """Each mode's compiled rollout at depth 2 (4 noise steps, two frames):
    the first graphed rollout (its first frame the capture's warm-up),
    and the replays after it, bit-equal to the eager rollout; two graphed
    rollouts bit-equal; an eager frame makes no host sync."""
    from gtax_torch.tools import rollout_graphs

    gen = rollout_graphs.mode_generator(graph_base, label, 2, 4)
    summary = rollout_graphs.graph_turns(
        gen, label, rollout_graphs.rollout_inputs(graph_base))
    assert summary["captured_here"]
    (stats,) = summary["graphs"]
    assert stats["nodes"] is None or stats["nodes"] > 0
