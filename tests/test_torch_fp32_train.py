"""float32 training on the card, the parts that run without one: the fp32
weight gradient's row split, and which kernels the training wrappers launch
for fp32 tensors, with what buffers. A stand-in card (meta tensors, whose
device is not the CPU, so the wrappers take their kernel path) records every
launch instead of making it; the kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py). The fp32 emit_train forwards and
backwards against gtax are tests/test_torch_backward.py's (its DTYPES).
"""

import pytest
import torch

from gtax_torch.kernels import backward, block, build, quant

F32 = torch.float32


@pytest.mark.parametrize("M,Ka,N,splits,chunk", [
    (11520, 1024, 1024, 4, 2880),   # B=16: dW_out, 32 tiles x 4 chunks
    (11520, 1024, 3072, 4, 2880),   # dW_qkv: 96 tiles x 4 chunks
    (11520, 1024, 4096, 1, 11520),  # dW1: 128 tiles, one wave of 132
    (11520, 4096, 1024, 1, 11520),  # dW2: 128 tiles, one wave
    (1440, 1024, 1024, 2, 720),     # B=2: two chunks of at least 512 rows
    (1000, 1024, 1024, 1, 1008),    # one chunk, rounded up to whole steps
    (2000, 64, 64, 3, 672),         # a ragged last chunk (656 rows)
])
def test_wgrad_f32_plan(M, Ka, N, splits, chunk):
    """The fp32 weight gradient's row chunks on 132 SMs: wgrad_plan's
    fastest count (at most 8, each of at least 512 rows and whole 16-row
    steps) on the backward tile, 128x256 at one block an SM; the chunks
    cover the rows once."""
    got = backward.wgrad_f32_plan(M, Ka, N, 132)
    assert got == (splits, chunk)
    assert chunk % block.F32_K_STEP == 0
    assert (splits - 1) * chunk < M <= splits * chunk
    assert splits <= backward.WGRAD_MAX_SPLITS


def test_bwd_tile_constants_match_the_kernel_source():
    """block's constants of gemm_f32's backward tile are the kernel's
    (csrc/gemm_f32.cu): the EPI_F32 tile's rows and columns and its
    blocks an SM, the 16-row step a chunk is made of, and the gelu'
    partials' 64-row slab; the attention backward's 48-row tile
    (csrc/attn_bwd.cu) divides the DiT's 144-token frame."""
    import re

    src = (build.CSRC / "gemm_f32.cu").read_text()

    def const(pattern):
        return int(re.search(pattern, src).group(1))

    assert const(r"constexpr int kBwdTile = (\d+);") == block.F32_BWD_TILE
    shape = re.search(r"struct BwdShape \{\s*static constexpr int TW = (\d+), "
                      r"KS = (\d+), STAGES = \d+, BLOCKS = (\d+);", src)
    assert int(shape.group(1)) == block.F32_BWD_TILE_N
    assert int(shape.group(2)) % block.F32_K_STEP == 0
    assert int(shape.group(3)) == block.F32_BWD_BLOCKS
    assert const(r"constexpr int BK = (\d+);") == block.F32_K_STEP
    assert "m0 / 64 + slab" in src and block.F32_SLAB == 64
    assert block.F32_BWD_TILE % block.F32_SLAB == 0
    attn = (build.CSRC / "attn_bwd.cu").read_text()
    tile = int(re.search(r"constexpr int kFBTile = (\d+);", attn).group(1))
    assert 144 % tile == 0


@pytest.mark.parametrize("M,k_chunk,floats", [
    (16, 64, 64 * (16 + 32)),                 # one pass: the two copies
    (15, 64, 64 * (16 + 32)),                 # dY's copy padded to 16 rows
    (195, 32, 64 * (196 + 32) + 2 * 195 * 32),  # two chunks' partials after
])
def test_trans_b_workspace(M, k_chunk, floats):
    """gemm_f32's trans_b workspace: the transposed copies of dY (M, K),
    its rows rounded up to a multiple of 4, and of W (N, K), then one
    (M, N) partial a K chunk where K is split; M need not be a multiple
    of 4."""
    a = torch.empty((M, 64), dtype=F32, device="meta")
    got, part = block._f32_split(a, M, 32, 64, k_chunk, trans_b=True)
    assert got == k_chunk
    assert part.dtype == F32 and part.numel() == floats


@pytest.mark.parametrize("M,N,K,lda,k_chunk,floats", [
    (2304, 64, 64, 0, 64, 64 * 2304),             # a's transposed copy
    (2306, 64, 64, 2308, 64, 0),                  # a handed over k-major
    (3456, 64, 4096, 0, 704, 4096 * 3456 + 6 * 3456 * 64),  # then 6 partials
    (700, 64, 64, 0, 64, 0),                      # below 720 rows: none
])
def test_fwd_workspace(M, N, K, lda, k_chunk, floats):
    """gemm_f32's forward workspace from 720 rows: a's transposed copy,
    its rows rounded up to a multiple of 4 (none where lda hands a over
    k-major), then one (M, N) partial for each of ceil(K / k_chunk)
    chunks where K is split."""
    a = torch.empty((M, K), dtype=F32, device="meta")
    got, part = block._f32_split(a, M, N, K, k_chunk, lda=lda)
    assert got == k_chunk
    assert (part is None) == (floats == 0)
    assert part is None or part.numel() == floats


@pytest.fixture
def card(monkeypatch):
    """A stand-in card: every kernel launch is recorded by its entry point's
    name (and gemm_f32's and gemm_s8's epilogues with their outputs' dtypes)
    instead of made, the checks that need a CUDA tensor pass, and the card
    has 132 SMs."""
    calls, gemms = [], []
    monkeypatch.setattr(build, "launch",
                        lambda name, *a, lib=None: calls.append(name))
    for mod in (block, backward, quant):
        monkeypatch.setattr(mod, "_stream", lambda t: 0)
        monkeypatch.setattr(mod, "_need", lambda cond, what: None)
    monkeypatch.setattr(block, "sm_count", lambda device: 132)
    monkeypatch.setattr(quant, "s8_chunk", lambda M, N, K, group, sms: K)
    f32_gemm, s8_gemm = block.launch_gemm_f32, quant._gemm_s8
    frame = block.launch_attn_frame_f32
    temporal = block.launch_attn_temporal_f32

    def gemm_f32(a, w, out, M, N, K, epi, **kw):
        out2 = kw.get("out2")
        gemms.append(("f32", epi, out.dtype, out2 is not None and out2.dtype,
                      kw.get("trans_b", False)))
        return f32_gemm(a, w, out, M, N, K, epi, **kw)

    def gemm_s8(a, sa, w_q, w_s, out, epi, **kw):
        out2 = kw.get("out2")
        gemms.append(("s8", epi, out.dtype, out2 is not None and out2.dtype,
                      False))
        return s8_gemm(a, sa, w_q, w_s, out, epi, **kw)

    def attn_frame_f32(*a, qkv_out=None):
        gemms.append(("frame", qkv_out is not None
                      and {t.dtype for t in qkv_out}))
        return frame(*a, qkv_out=qkv_out)

    def attn_temporal_f32(*a, **kw):  # kv_out: the 13th argument
        q_out, kv_out = kw.get("q_out"), a[12] if len(a) > 12 else None
        gemms.append(("temporal", q_out is not None
                      and {t.dtype for t in (q_out, *kv_out)}))
        return temporal(*a, **kw)

    monkeypatch.setattr(block, "launch_gemm_f32", gemm_f32)
    monkeypatch.setattr(quant, "_gemm_s8", gemm_s8)
    monkeypatch.setattr(block, "launch_attn_frame_f32", attn_frame_f32)
    monkeypatch.setattr(block, "launch_attn_temporal_f32", attn_temporal_f32)
    return calls, gemms


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


N_, S_, D_, H_, T_ = 4, 16, 64, 2, 2  # frames, tokens, width, heads, window


def _branch():
    return (_meta(N_, S_, D_), *(_meta(N_, D_) for _ in range(3)))


def _attn_weights():
    return _meta(D_, 3 * D_), _meta(D_, D_), _meta(D_)


def _q_weights(din, dout):
    return _meta(din, dout, dtype=torch.int8), _meta(dout)


@pytest.mark.parametrize("kind", ["spatial", "temporal", "mlp"])
def test_fp32_emit_train_dispatch(card, kind):
    """fp32 emit_train of #1-#3 reaches the fp32 kernels: the attention's
    (or the rope product's) fp32 q/k/v stores, gemm_f32's emit_train
    epilogues with an fp32 second output; every residual fp32."""
    calls, gemms = card
    x, sh, sc, g = _branch()
    if kind == "spatial":
        out = block.fused_spatial_branch(x, sh, sc, g, *_attn_weights(),
                                         _meta(S_, D_ // H_), H_,
                                         emit_train=True)
        want = {"gtax_ln_mod", "gtax_gemm_f32", "gtax_attn_frame_f32"}
        assert ("frame", {F32}) in gemms
        assert ("f32", block.EPI_BIAS_GATED_Y, F32, F32, False) in gemms
    elif kind == "temporal":
        out = block.fused_temporal_branch(
            x, sh, sc, g, *_attn_weights(), _meta(T_, D_ // H_), None, H_,
            T_, emit_train=True, emit_mod=True)
        want = {"gtax_ln_mod", "gtax_gemm_f32_rope_qkv",
                "gtax_attn_temporal_window_f32", "gtax_gemm_f32"}
        assert ("f32", block.EPI_BIAS_GATED_Y, F32, F32, False) in gemms
    else:
        out = block.fused_mlp_branch(x, sh, sc, g, _meta(D_, 4 * D_),
                                     _meta(4 * D_), _meta(4 * D_, D_),
                                     _meta(D_), emit_train=True)
        want = {"gtax_ln_mod", "gtax_gemm_f32"}
        assert ("f32", block.EPI_BIAS_GELU_TANH_H, F32, F32, False) in gemms
        assert ("f32", block.EPI_BIAS_GATED_Y, F32, F32, False) in gemms
    assert set(calls) == want
    assert all(t.dtype == F32 for t in out)


@pytest.mark.parametrize("kind", ["spatial", "temporal", "mlp"])
def test_fp32_int8_emit_train_dispatch(card, kind):
    """fp32 emit_train of #7-#9 (int8_forward at compute_dtype float32):
    gemm_s8's fp32 emit_train epilogues (5-7) with fp32 h1 and y, and the
    fp32 attention kernels' q/k/v stores; every residual fp32."""
    calls, gemms = card
    x, sh, sc, g = _branch()
    if kind == "mlp":
        out = quant.fused_mlp_branch_q(x, sh, sc, g,
                                       *_q_weights(D_, 4 * D_), _meta(4 * D_),
                                       *_q_weights(4 * D_, D_), _meta(D_),
                                       emit_train=True)
        assert ("s8", quant.EPI_BIAS_GELU_F32_H, F32, F32, False) in gemms
    else:
        w = (*_q_weights(D_, 3 * D_), *_q_weights(D_, D_), _meta(D_))
        if kind == "spatial":
            out = quant.fused_spatial_branch_q(x, sh, sc, g, *w,
                                               _meta(S_, D_ // H_), H_,
                                               emit_train=True)
            assert ("frame", {F32}) in gemms
        else:
            out = quant.fused_temporal_branch_q(x, sh, sc, g, *w,
                                                _meta(T_, D_ // H_), None, H_,
                                                T_, emit_train=True)
            assert ("temporal", {F32}) in gemms
    assert ("s8", quant.EPI_BIAS_GATED_F32_Y, F32, F32, False) in gemms
    assert "gtax_gemm_s8" in calls
    assert all(t.dtype == F32 for t in out)


@pytest.mark.parametrize("kind", ["spatial", "temporal", "mlp"])
def test_fp32_backward_dispatch(card, kind):
    """The fp32 backwards #12-#14 launch only fp32 kernels and allocate
    their buffers in x's dtype: gate_bwd_f32 / ln_mod_bwd_f32, gemm_f32
    with trans_b (EPI_F32, and gelu' with its fp32 dh1 and gelu(h1)),
    gemm_f32_wgrad, and the fp32 attention backward."""
    calls, gemms = card
    x, sh, sc, g = _branch()
    ct, y = _meta(N_, S_, D_), _meta(N_, S_, D_)
    if kind == "mlp":
        grads = backward.fused_mlp_branch_bwd(
            x, sh, sc, g, _meta(D_, 4 * D_), _meta(4 * D_, D_),
            _meta(N_, S_, 4 * D_), y, ct)
        attn = set()
        assert ("f32", block.EPI_DGELU, F32, F32, True) in gemms
    else:
        qkv_w, out_w, _ = _attn_weights()
        res = tuple(_meta(N_, S_, D_) for _ in range(3))
        if kind == "spatial":
            grads = backward.fused_spatial_branch_bwd(
                x, sh, sc, g, qkv_w, out_w, _meta(S_, D_ // H_), *res, y, ct,
                H_)
            attn = {"gtax_attn_frame_bwd_f32"}
        else:
            grads = backward.fused_temporal_branch_bwd(
                x, sh, sc, g, qkv_w, out_w, _meta(T_, D_ // H_), None, *res,
                y, ct, H_, T_)
            attn = {"gtax_attn_temporal_bwd_f32"}
        assert ("f32", block.EPI_F32, F32, False, True) in gemms
    assert set(calls) == {"gtax_gate_bwd_f32", "gtax_reduce_rows",
                          "gtax_gemm_f32", "gtax_gemm_f32_wgrad",
                          "gtax_ln_mod", "gtax_ln_mod_bwd_f32", *attn}
    assert all(e[0] == "f32" and e[4] for e in gemms)  # every product: W^T
    assert all(t.dtype == F32 for t in grads)


@pytest.mark.parametrize("kind,frames", [("mlp", 16), ("mlp", 4),
                                         ("vae", 4), ("vae", 1)])
def test_fp32_fc1_stores_fc2_operand_k_major(card, monkeypatch, kind,
                                            frames):
    """fp32 from 720 rows (16 DiT frames of 144, 4 VAE frames of 576; not
    4 DiT frames or 1 VAE frame, 576 rows):
    fc1 stores its GELU rows transposed, (H, M rounded up to 4), and fc2
    reads them k-major with that stride (#2 fused_mlp_branch emit_train,
    #5 fused_vae_block); below it, both stay row-major (lda = ldc = 0)."""
    from gtax_torch.kernels import vae_block

    _, gemms = card
    strides, inner = [], block.launch_gemm_f32

    def gemm_f32(a, w, out, M, N, K, epi, **kw):
        rows = out.numel() // out.shape[-1]  # (frames, S, D): as (M, D)
        strides.append((epi, (rows, out.shape[-1]), kw.get("lda", 0),
                        kw.get("ldc", 0)))
        return inner(a, w, out, M, N, K, epi, **kw)

    monkeypatch.setattr(block, "launch_gemm_f32", gemm_f32)
    D, Hd = 64, 256
    if kind == "mlp":
        S = 144
        x = _meta(frames, S, D)
        block.fused_mlp_branch(x, *(_meta(frames, D) for _ in range(3)),
                               _meta(D, Hd), _meta(Hd), _meta(Hd, D),
                               _meta(D), emit_train=True)
        fc1, fc2 = block.EPI_BIAS_GELU_TANH_H, block.EPI_BIAS_GATED_Y
    else:
        S = 576
        x = _meta(frames, S, D)
        vae_block.fused_vae_block(
            x, _meta(D), _meta(D), _meta(D, 3 * D), _meta(3 * D),
            _meta(D, D), _meta(D), _meta(D), _meta(D), _meta(D, Hd),
            _meta(Hd), _meta(Hd, D), _meta(D), _meta(S, 16), 2)
        fc1, fc2 = block.EPI_BIAS_BF16_GELU, block.EPI_BIAS_BF16_RESID
    M = frames * S
    ld = M if M >= block.F32_FWD_ROWS else 0
    assert (fc1, (Hd, ld) if ld else (M, Hd), 0, ld) in strides
    assert (fc2, (M, D), ld, 0) in strides
