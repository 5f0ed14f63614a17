"""float32 on the card: what the serving and training entry points take
there, through the checks that take the device type (so they run without
a card), and the fp32 forms' dispatch tables. The fp32 kernels
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py);
here the CPU runs fp32 through the plain versions
(tests/test_torch_serving.py holds that rollout against gtax's, int8 and
`pallas` included).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gtax_torch import serving
from gtax_torch.kernels import block, build, quant
from gtax_torch.models import dit as dit_mod
from gtax_torch.train import trainer

KW = dict(dtype="float32", noise_steps=3, dit_model="DiT-debug",
          vae_model="vae-debug")


@pytest.mark.parametrize("backend", ["fused", "fused_all", "xla",
                                     "fused_mlp"])
@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_fp32_serving_taken(backend, device_type):
    """fp32 under the fused backends (the fp32 kernels) and the unfused
    ones (torch's fp32 products) passes the check on either device."""
    cfg = serving.ServingConfig(**KW, attention_backend=backend)
    serving._check_slice(cfg, device_type)


@pytest.mark.parametrize("field,value", [("quantize", "int8"),
                                         ("attention_backend", "pallas")])
def test_fp32_refusals_left_on_the_card(field, value):
    """None is left: fp32 + int8 (the int8 kernels' fp32 forms) and fp32 +
    `pallas` (the fp32 form of its attention kernels) pass the check on
    either device, as bf16 does."""
    for dtype in ("float32", "bfloat16"):
        cfg = serving.ServingConfig(**{**KW, "dtype": dtype, field: value})
        for device_type in ("cpu", "cuda"):
            serving._check_slice(cfg, device_type)


def test_fp32_refusal_reaches_the_generator():
    """VideoGenerator checks with its own device: on the CPU the fp32 int8
    generator builds, its params quantized from the fp32 ones (not cast)."""
    cfg = serving.ServingConfig(**KW, quantize="int8")
    gen = serving.VideoGenerator.load("", "", cfg, device="cpu")
    assert gen._dtype == torch.float32
    qkv = gen.dit_params["blocks"][0]["s_attn"]["qkv"]
    assert qkv["kernel_q"].dtype == torch.int8
    assert gen.dit_params["blocks"][0]["s_attn"]["out"]["bias"].dtype == (
        torch.float32)


@pytest.mark.parametrize("dtype,device_type", [
    (torch.float32, "cuda"), (torch.bfloat16, "cuda"),
    (torch.float32, "cpu"), (torch.bfloat16, "cpu")])
def test_fp32_training_taken_on_both_devices(dtype, device_type):
    """The trainer's compute dtype: bf16 and fp32 train on the card (the
    training kernels' bf16 and fp32 forms) and on the CPU (the plain
    versions)."""
    trainer.check_compute_dtype(dtype, device_type)


def test_fp32_entry_points_bound():
    """Every fp32 kernel's C entry point has its ctypes signature, with as
    many arguments as csrc/ declares (the library is built on the card):
    the fp32 GEMM's (and its rope form's) with the training epilogues'
    outputs, trans_b and the forward's form (fwd_form; the fp32 GEMM's
    also with the persistent form's blocks and counters), the
    frame attention's with its q/k/v stores, its workspace and its query
    tile, the temporal one's with the
    full window's fp32 Q/K/V outputs, #4's fp32 step attention's, the fp32
    pairs', the fp32 `pallas`
    attention's, and the fp32 training kernels' (the weight gradient, the
    row-wise and attention backwards)."""
    want = {"gtax_gemm_f32": 25, "gtax_gemm_f32_rope_qkv": 16,
            "gtax_attn_frame_f32": 14,
            "gtax_attn_temporal_window_f32": 11,
            "gtax_attn_temporal_f32": 16, "gtax_attn_step_f32": 13,
            "gtax_pair_q_f32": 49,
            "gtax_pair_q_f32_blocks": 4, "gtax_attn_sdpa_f32": 16,
            "gtax_gemm_f32_wgrad": 8, "gtax_gate_bwd_f32": 11,
            "gtax_ln_mod_bwd_f32": 12, "gtax_attn_frame_bwd_f32": 15,
            "gtax_attn_temporal_bwd_f32": 14}
    src = "".join(p.read_text() for p in build.sources())
    for name, n in want.items():
        assert len(build.SIGNATURES[name]) == n, name
        assert f"GTAX_ENTRY {name}(" in src, name
    # the pair's exact-GELU flag and the fp32 attention's query tile sit
    # before its stream
    assert len(build.SIGNATURES["gtax_pair_q"]) == 49
    for name in want:
        params = src.split(f"GTAX_ENTRY {name}(", 1)[1].split(")", 1)[0]
        if "GTAX_PAIR_PARAMS" not in params:
            assert params.count(",") + 1 == want[name], name


def test_fp32_epilogue_table():
    """gemm_f32 takes the epilogues #1-#5 store in fp32, the emit_train ones
    with their second output, and gelu' with trans_b (the backward); it
    refuses an epilogue it does not take (EPI_BF16, a bf16 store), a second
    output missing or unasked for, gelu' without trans_b, and trans_b with
    a bias epilogue."""
    assert set(block.F32_EPILOGUES) == {
        block.EPI_F32, block.EPI_BIAS_BF16, block.EPI_BIAS_GELU_TANH,
        block.EPI_BIAS_GELU_ERF, block.EPI_BIAS_BF16_GELU,
        block.EPI_BIAS_GATED, block.EPI_BIAS_BF16_RESID,
        block.EPI_BIAS_GATED_Y, block.EPI_BIAS_GELU_TANH_H,
        block.EPI_BIAS_GELU_ERF_H, block.EPI_DGELU}
    assert set(block.TWO_OUTPUTS) == {
        block.EPI_BIAS_GATED_Y, block.EPI_BIAS_GELU_TANH_H,
        block.EPI_BIAS_GELU_ERF_H, block.EPI_DGELU}
    out2 = _meta(1, 4)
    for epi, kw in ((block.EPI_BF16, {}),
                    (block.EPI_BIAS_GATED_Y, {}),
                    (block.EPI_BIAS_GATED, {"out2": out2}),
                    (block.EPI_DGELU, {"out2": out2}),
                    (block.EPI_BIAS_GATED, {"trans_b": True})):
        with pytest.raises(ValueError, match="no epilogue"):
            block.launch_gemm_f32(None, None, None, 1, 4, 16, epi, **kw)


@pytest.mark.parametrize("M,N,K,chunk", [
    (144, 1024, 1024, 64),    # the step's out-projection: 24 tiles x 16
    (144, 1024, 4096, 192),   # the step's fc2: 24 tiles x 22
    (288, 1024, 4096, 384),   # two frames' fc2: 48 tiles x 11
    (576, 1024, 4096, 704),   # the prefill's fc2, k-major: 6 chunks
    (576, 1024, 1024, 512),   # its out-projection, serving: 192 tiles x 2
    (144, 3072, 1024, 160),   # qkv: 72 tiles x 7 (the last chunk 64)
    (288, 3072, 1024, 352),   # two frames' qkv: 144 tiles x 3
    (288, 4096, 1024, 512),   # two frames' fc1: 192 tiles x 2
    (576, 3072, 1024, 512),   # the prefill's qkv, k-major: 120 tiles x 2
    (576, 4096, 1024, 352),   # its fc1: 160 tiles, 3 chunks of 11 steps
    (720, 3072, 1024, 352),   # five frames: 144 tiles, 3 chunks of 11 steps
    (2304, 3072, 1024, 1024),  # the VAE encode's qkv: 432 tiles, K of 32
    (3456, 4096, 1024, 1024),  # the VAE decode's fc1: 864 tiles
    (3456, 1024, 4096, 704),   # its fc2: 216 tiles of 128 steps, 6 chunks
    (144, 1024, 1040, 96),    # K of 65 granules: 11 chunks, the last 80
])
def test_f32_split_plan(M, N, K, chunk):
    """gemm_f32's K chunk on 132 SMs, on the form block.f32_form picks. On
    the persistent form (below 432 rows; 48 x 128 tiles, four blocks an
    SM): f32_persist_chunk's, chunks of whole 16-row granules, the last
    one short, at most 32. On the serving form (48 x 64 tiles, K over a
    cluster): the fewest whole-step chunks dividing K, at most 8 and at
    most 32 steps of 16 deep, whose blocks give 2.5 an SM (330), else the
    most there are. On the
    forward's k-major form (block.f32_fwd_form: from 720 rows, from 432
    for qkv, fc1 and fc2; two blocks an SM): unsplit where K is at most 32
    steps of 32 and the tiles fill the 264 slots, else the count of at
    most 8 chunks of whole 32-row steps (the last one short) with the
    fewest wave-steps."""
    got = block.f32_chunk(M, N, K, 132)
    assert got == chunk
    form = block.f32_form(M, N, K)
    if form == block.F32_FORM_K_MAJOR:
        assert got == K or got % block.F32_FWD_K_STEP == 0
        assert -(-K // got) <= block.F32_MAX_SPLITS
    elif form == block.F32_FORM_PERSIST:
        assert got % block.F32_K_STEP == 0
        assert -(-K // got) <= block.F32_PERSIST_MAX_SPLITS
    else:
        assert K % got == 0 and got % block.F32_K_STEP == 0
        assert K // got <= block.F32_MAX_SPLITS


def test_f32_fwd_constants_match_the_kernel_source():
    """block's constants of gemm_f32's forward k-major form are the
    kernel's (csrc/gemm_f32.cu FwdShape): the tile's rows (kBwdTile) and
    columns, its 32-row step and its blocks an SM; the kernel runs where
    the caller's rule (block.f32_fwd_form) asks for it, from F32_FWD_ROWS
    rows."""
    import re

    src = (build.CSRC / "gemm_f32.cu").read_text()
    shape = re.search(r"struct FwdShape \{\s*static constexpr int TW = (\d+), "
                      r"KS = (\d+), STAGES = \d+, BLOCKS = (\d+);", src)
    assert int(shape.group(1)) == block.F32_FWD_TILE
    assert int(shape.group(2)) == block.F32_FWD_K_STEP
    assert int(shape.group(3)) == block.F32_FWD_BLOCKS
    assert int(re.search(r"constexpr int kBwdTile = (\d+);", src).group(1)) \
        == block.F32_FWD_TILE
    assert "const bool fwd = !trans_b && fwd_form == kFormKMajor;" in src
    forms = re.search(r"constexpr int kFormServe = (\d+), kFormKMajor = "
                      r"(\d+), kFormPersist = (\d+);", src)
    assert tuple(int(g) for g in forms.groups()) == (
        block.F32_FORM_SERVE, block.F32_FORM_K_MAJOR, block.F32_FORM_PERSIST)
    assert not block.f32_fwd_form(block.F32_FWD_ROWS - 1, 1024, 1024)
    assert block.f32_fwd_form(block.F32_FWD_ROWS, 1024, 1024)
    assert block.F32_FWD_K_STEP % block.F32_K_STEP == 0


@pytest.mark.parametrize("M,N,K,k_major", [
    (144, 3072, 1024, False),  # a denoise step: the serving form
    (288, 4096, 1024, False),
    (431, 1024, 4096, False),
    (432, 3072, 1024, True),   # three frames' qkv, fc1 and fc2: k-major
    (432, 1024, 4096, True),
    (576, 4096, 1024, True),   # the prefill's
    (576, 1024, 1024, False),  # but its out-projection
    (719, 1024, 1024, False),
    (720, 1024, 1024, True),   # five frames: every product
    (700, 64, 64, False),
])
def test_f32_fwd_form(M, N, K, k_major):
    """Which form of gemm_f32's forward a product runs on: the k-major
    form from F32_FWD_ROWS (720) rows, and from F32_FWD_ROWS_WIDE (432)
    for products of at least F32_FWD_WIDE_WEIGHTS (3 Mi) weights: qkv,
    fc1 and fc2 at D = 1,024, not the out-projection; and, where fc1 and
    fc2 both run k-major, fc1's GELU rows are stored k-major for fc2."""
    assert block.f32_fwd_form(M, N, K) == k_major
    want = -(-M // 4) * 4 if k_major else 0
    assert block.f32_fwd_ld(torch.float32, M, N, K) == want


@pytest.mark.parametrize("M", [1, 144, 200, 288, 576, 719])
@pytest.mark.parametrize("N,K", [(1024, 1024), (3072, 1024), (4096, 1024),
                                 (1024, 4096), (1000, 1040)])
def test_f32_serve_plan(M, N, K):
    """The serving form's plan (f32_serve_chunk) on 132 SMs: its K chunks
    (K / chunk of them, whole 16-row steps) cover K once, in order; their
    count, the cluster's size, is at most F32_MAX_CLUSTER (8); a chunk is
    at most F32_SERVE_SPLIT_STEPS steps deep and its blocks give
    F32_SERVE_FILL an SM unless no count of at most 8 does; its 48-row
    tiles cover the rows, the last one holding at least one. Counts picked
    by hand at a denoise step's 144 rows: qkv 4, out-projection and fc2 8,
    fc1 2; at 288: qkv and fc1 2, out-projection 4, fc2 8."""
    chunk = block.f32_serve_chunk(M, N, K, 132)
    splits = K // chunk
    assert splits * chunk == K and chunk % block.F32_K_STEP == 0
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert 1 <= splits <= block.F32_MAX_CLUSTER == 8
    row_tiles = -(-M // block.F32_SERVE_TILE)
    assert (row_tiles - 1) * block.F32_SERVE_TILE < M \
        <= row_tiles * block.F32_SERVE_TILE
    blocks = row_tiles * -(-N // block.F32_SERVE_TILE_N) * splits
    most = max(s for s in range(1, 9) if (K // block.F32_K_STEP) % s == 0)
    deep = chunk // block.F32_K_STEP <= block.F32_SERVE_SPLIT_STEPS
    assert (blocks >= block.F32_SERVE_FILL * 132 and deep) or splits == most
    picked = {144: {(1024, 1024): 8, (3072, 1024): 4, (4096, 1024): 2,
                    (1024, 4096): 8},
              288: {(1024, 1024): 4, (3072, 1024): 2, (4096, 1024): 2,
                    (1024, 4096): 8}}
    if (N, K) in picked.get(M, {}):
        assert splits == picked[M][N, K]


def test_f32_serve_constants_match_the_kernel_source():
    """block's constants of gemm_f32's serving form are the kernel's
    (csrc/gemm_f32.cu kServe*): the tile's rows and columns, its blocks an
    SM and the largest cluster; it runs where the caller asks for the
    serving form, and its k-step is a multiple of the K granule (BK)."""
    import re

    src = (build.CSRC / "gemm_f32.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)[,;]", src).group(1))

    assert const("kServeTile") == block.F32_SERVE_TILE
    assert const("kServeTN") == block.F32_SERVE_TILE_N
    assert const("kServeBlocks") == block.F32_SERVE_BLOCKS
    assert const("kServeMaxCluster") == block.F32_MAX_CLUSTER
    assert const("BK") == block.F32_K_STEP
    assert const("kServeKS") % const("BK") == 0
    assert const("kServeTile") // const("kServeRG") in (4, 8)
    assert "if (form == kFormServe) return launch_serve<EPI>" in src


def test_f32_persist_constants_match_the_kernel_source():
    """block's constants of gemm_f32's persistent form are the library's
    (csrc/gemm_f32.cu GTAX_PERSIST_* defaults): the tile's rows (rows a
    thread x row groups) and columns (64 a float4 column group), its
    k-step and its blocks an SM (the launch bounds the one-round grid
    counts on); the K granule is the C entry's, and a split unit's partial
    is one tile."""
    import re

    src = (build.CSRC / "gemm_f32.cu").read_text()

    def macro(name):
        return int(re.search(rf"#define GTAX_PERSIST_{name} (\d+)",
                             src).group(1))

    assert macro("R") * macro("RG") == block.F32_PERSIST_TILE
    assert 64 * macro("CJ") == block.F32_PERSIST_TILE_N
    assert macro("KS") == block.F32_PERSIST_K_STEP
    assert macro("BLOCKS") == block.F32_PERSIST_BLOCKS
    assert block.F32_PERSIST_K_STEP % block.F32_K_STEP == 0
    assert "__launch_bounds__(kPersistThreads, kPersistBlocks)" in src
    assert "attr[0].id = cudaLaunchAttributeCooperative;" in src
    assert "if (form == kFormPersist)" in src


@pytest.mark.parametrize("M,N,K", [
    (144, 3072, 1024), (144, 1024, 1024), (144, 4096, 1024),
    (144, 1024, 4096), (288, 3072, 1024), (288, 1024, 1024),
    (288, 4096, 1024), (288, 1024, 4096), (200, 1000, 1040),
    (431, 1000, 1024), (48, 128, 32)])
def test_f32_persist_units_cover_once(M, N, K):
    """The persistent form's units at its plan's chunks (block.
    f32_persist_schedule, the kernel's schedule) cover every (row, column,
    k) of the product once: their tiles cover the rows and columns, each
    tile's chunks cover K in order without overlap, and no unit is dealt
    twice; a block takes units G apart (G the grid)."""
    chunk = block.f32_persist_chunk(M, N, K, 132)
    blocks = block.f32_persist_grid(M, N, K, chunk, 132)
    sched = block.f32_persist_schedule(M, N, K, chunk, blocks)
    assert len(sched) == blocks
    units = [u for mine, _ in sched for u in mine]
    assert len(units) == len(set(units)) == block.f32_persist_units(
        M, N, K, chunk)
    tm, tn = block.F32_PERSIST_TILE, block.F32_PERSIST_TILE_N
    covered = np.zeros((-(-M // tm), -(-N // tn), K), dtype=np.int32)
    for m0, n0, k0, k1 in units:
        assert m0 % tm == 0 and n0 % tn == 0 and m0 < M and n0 < N
        assert k0 < k1 <= K and k0 % block.F32_K_STEP == 0
        covered[m0 // tm, n0 // tn, k0:k1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("M,N,K", [
    (144, 3072, 1024), (144, 1024, 1024), (288, 1024, 4096),
    (200, 1000, 1040)])
@pytest.mark.parametrize("blocks", [None, 132, 37])
def test_f32_persist_chunks_summed_in_order(M, N, K, blocks):
    """Each split tile's fix-up jobs split its rows between them, each row
    once, and sum its chunks' partials in chunk order (K ranges ascending,
    each one chunk), whichever blocks made them: the jobs' rows and
    orders are the same on the plan's grid, one block an SM (132) and a
    grid of 37 blocks, so an element's sum does not depend on the grid."""
    chunk = block.f32_persist_chunk(M, N, K, 132)
    splits = -(-K // chunk)
    assert splits > 1
    grid = blocks or block.f32_persist_grid(M, N, K, chunk, 132)
    sched = block.f32_persist_schedule(M, N, K, chunk, grid)
    want = [(z * chunk, min(K, (z + 1) * chunk)) for z in range(splits)]
    rows = {}
    for _, jobs in sched:
        for m0, n0, r0, r1, order in jobs:
            assert order == want
            for r in range(r0, min(r1, block.F32_PERSIST_TILE)):
                assert (m0, n0, r) not in rows
                rows[m0, n0, r] = True
    tiles = (-(-M // block.F32_PERSIST_TILE)
             * -(-N // block.F32_PERSIST_TILE_N))
    assert len(rows) == tiles * block.F32_PERSIST_TILE
    base = block.f32_persist_schedule(M, N, K, chunk,
                                      block.f32_persist_grid(M, N, K, chunk,
                                                             132))
    assert sorted(j[:4] for _, js in sched for j in js) == sorted(
        j[:4] for _, js in base for j in js)


@pytest.mark.parametrize("M", [144, 288])
@pytest.mark.parametrize("N,K", [(3072, 1024), (1024, 1024), (4096, 1024),
                                 (1024, 4096)])
def test_f32_persist_grid_is_one_round(M, N, K):
    """At a denoise step's 144 and 288 rows the persistent form launches at
    most one round of resident blocks (F32_PERSIST_BLOCKS an SM on 132
    SMs: 528), every block with a unit, and a whole number an SM where
    there are units for all (the kernel's cooperative launch refuses a
    grid past the card's round)."""
    chunk = block.f32_persist_chunk(M, N, K, 132)
    units = block.f32_persist_units(M, N, K, chunk)
    grid = block.f32_persist_grid(M, N, K, chunk, 132)
    assert grid == min(units, block.F32_PERSIST_BLOCKS * 132)
    assert grid <= 528 and (grid == units or grid == 528)
    sched = block.f32_persist_schedule(M, N, K, chunk, grid)
    assert all(mine for mine, _ in sched)


# the persistent form's chunk counts at the step's products, the fastest
# or within 6% of it in `gemm_sweep.py --persist-shapes` (PERF.md section
# 6, PR 22 run 9): 144 rows qkv 7, the out-projection 16, fc1 4 (each the
# fastest), fc2 22 (16 fastest, 0.0410 against 0.0417 ms); 288 rows qkv 3
# (7, 0.0646 against 0.0656), the out-projection 11 (8, 0.0258 against
# 0.0274), fc1 2, fc2 11 (8, 0.0695 against 0.0707)
@pytest.mark.parametrize("M,N,K,splits", [
    (144, 3072, 1024, 7), (144, 1024, 1024, 16), (144, 4096, 1024, 4),
    (144, 1024, 4096, 22), (288, 3072, 1024, 3), (288, 1024, 1024, 11),
    (288, 4096, 1024, 2), (288, 1024, 4096, 11)])
def test_f32_form_rule_follows_the_sweep(M, N, K, splits):
    """The fp32 forward's form at the step's products is the persistent
    one (faster than the serving form at each of them in `gemm_sweep.py
    --f32 --forms`), at the chunk counts its plan models from the sweep;
    from 432 rows the forms stay: k-major for qkv, fc1 and fc2, serving
    for the out-projection below 720."""
    assert block.f32_form(M, N, K) == block.F32_FORM_PERSIST
    assert -(-K // block.f32_persist_chunk(M, N, K, 132)) == splits
    assert block.f32_form(432, N, K) == (
        block.F32_FORM_K_MAJOR if N * K >= block.F32_FWD_WIDE_WEIGHTS
        else block.F32_FORM_SERVE)
    assert block.f32_form(720, N, K) == block.F32_FORM_K_MAJOR


@pytest.mark.parametrize("n_frames,S", [(1, 144), (4, 144), (80, 144),
                                         (6, 576)])
def test_f32_frame_shape_rule(n_frames, S):
    """The fp32 frame attention's query tile (block.f32_frame_shape) at the
    main path's calls, 16 heads on 132 SMs (two blocks an SM): a tile of
    S's kind (whole keys up to 144 tokens, the ring past them) whose tiles
    cover S once, at most one ragged tile past S; at one frame the units
    reach the SM count, or are the most that any tile of that kind runs in
    one round of the SMs; the fp32 pair's pick (its 132-block grid, a unit
    a block at a time) is the same rule's on that grid, and fills it in
    one round where a tile can."""
    from gtax_torch.kernels import pair

    heads, sms = 16, 132
    shape = block.f32_frame_shape(S, heads, n_frames,
                                  block.F32_FRAME_BLOCKS * sms)
    whole, _, _ = block.F32_FRAME_SHAPES[shape]
    assert whole == (S <= block.F32_WHOLE_KEYS)
    rows = block.f32_frame_rows(shape)
    tiles = -(-S // rows)
    assert (tiles - 1) * rows < S <= tiles * rows
    kind = [i for i, sh in enumerate(block.F32_FRAME_SHAPES)
            if sh[0] == whole]
    if n_frames == 1:
        units = [-(-S // block.f32_frame_rows(i)) * heads for i in kind]
        one_round = max([u for u in units if u <= sms], default=0)
        assert tiles * heads >= sms or tiles * heads == one_round
    at = pair.attn_shape(False, torch.float32, S, heads, n_frames, sms)
    assert at == block.f32_frame_shape(S, heads, n_frames, sms)
    pair_units = -(-S // block.f32_frame_rows(at)) * heads * n_frames
    if any(2 * sms <= 3 * -(-S // block.f32_frame_rows(i)) * heads
           * n_frames <= 3 * sms for i in kind):
        assert 2 * sms <= 3 * pair_units <= 3 * sms
    assert pair.attn_shape(True, torch.float32, S, heads, n_frames, sms) == 0
    assert pair.attn_shape(False, torch.bfloat16, S, heads, n_frames,
                           sms) == 0


def test_f32_frame_step_fills_the_card():
    """A denoise step's one frame of 144 tokens at 16 heads runs on 96-144
    units (not the 48 of 48-row tiles): on the card's 132 SMs and in the
    fp32 pair's 132-block grid."""
    from gtax_torch.kernels import pair

    for shape in (block.f32_frame_shape(144, 16, 1,
                                        block.F32_FRAME_BLOCKS * 132),
                  pair.attn_shape(False, torch.float32, 144, 16, 1, 132)):
        assert 96 <= -(-144 // block.f32_frame_rows(shape)) * 16 <= 144


def test_f32_frame_shapes_match_the_kernel_source():
    """block's list of the fp32 frame attention's query tiles is the
    kernel's, index for index (csrc/attn_f32.cuh GTAX_F32_FRAME_SHAPES:
    F32Whole<HD, rows a thread, row groups> and F32Ring<HD, row groups> of
    4 rows a thread), the list the fp32 pair dispatches on too
    (csrc/pair_q.cuh); the whole bodies' key count is F32_WHOLE_KEYS, 16
    lanes by kF32WholeKC."""
    import re

    src = (build.CSRC / "attn_f32.cuh").read_text()
    pair_src = (build.CSRC / "pair_q.cuh").read_text()

    def shapes(text, macro):
        body = text.split(f"#define {macro}(X)", 1)[1].split("\n\n", 1)[0]
        out = {}
        for i, kind, args in re.findall(
                r"X\((\d+), F32(Whole|Ring)<HD, ([\d, ]+)>\)", body):
            a = [int(x) for x in args.split(",")]
            out[int(i)] = ((True, a[0], a[1]) if kind == "Whole"
                           else (False, 4, a[0]))
        return out

    kernel = shapes(src, "GTAX_F32_FRAME_SHAPES")
    assert kernel == dict(enumerate(block.F32_FRAME_SHAPES))
    assert int(re.search(r"kF32FrameShapes = (\d+);", src).group(1)) \
        == len(block.F32_FRAME_SHAPES)
    ring = re.search(r"struct F32Ring \{\s*static constexpr int RG = RG_, "
                     r"TR = (\d+),", src)
    assert int(ring.group(1)) == 4
    kc = int(re.search(r"kF32WholeKC = (\d+);", src).group(1))
    assert 16 * kc == block.F32_WHOLE_KEYS
    assert "GTAX_F32_FRAME_SHAPES(GTAX_CASE)" in pair_src


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name", ["fused_spatial_branch_q",
                                  "fused_mlp_branch_q",
                                  "fused_temporal_branch_q"])
def test_int8_f32_emit_train_refused_off_the_cpu(name):
    """fp32 emit_train through the int8 wrappers (int8-forward training's
    forward at compute_dtype float32) takes the card path for any tensor
    not on the CPU, passes the dtype check as bf16 does and reaches the
    CUDA checks, which a stand-in device fails (ValueError naming the CUDA
    kernel path) before any kernel."""
    D = 64
    fn = getattr(quant, name)
    for dtype in (torch.float32, torch.bfloat16):
        x = _meta(2, 8, D, dtype=dtype)
        vec = tuple(_meta(2, D, dtype=dtype) for _ in range(3))
        tail = {"fused_spatial_branch_q": (None,) * 6 + (2,),
                "fused_mlp_branch_q": (None,) * 6,
                "fused_temporal_branch_q": (None,) * 7 + (2, 2)}[name]
        with pytest.raises(ValueError, match="CUDA kernel path"):
            fn(x, *vec, *tail, emit_train=True)


def test_int8_forward_trainer_refused_in_fp32_on_the_card(monkeypatch):
    """The int8-forward trainer on the card takes compute_dtype float32 as
    it takes bf16: the config passes check_slice and the device's dtype
    check (a stand-in for the card's device: the check needs its type
    only)."""
    monkeypatch.setattr(trainer, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    cfg = trainer.TrainingConfig(dit_model="DiT-debug", vae_model="vae-debug",
                                 vae_checkpoint="", compute_dtype="float32",
                                 attention_backend="fused_all",
                                 int8_forward=True, use_wandb=False)
    trainer.check_slice(cfg)
    trainer.check_compute_dtype(getattr(torch, cfg.compute_dtype),
                                trainer.resolve_device().type)


def test_int8_prefill_cache_fp32():
    """An fp32 int8 dit_prefill emits its K/V cache in fp32 (gtax's emit_kv
    at x.dtype = float32: the cast to x.dtype is a no-op), the cache the
    fp32 step reads; the step over it agrees with the full window's last
    frame within 2**-6 of its largest magnitude (the int8 rule)."""
    cfg = dit_mod.DiT_debug()
    params = dit_mod.dit_init(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    params = dit_mod.unstack_for_inference(params, cfg)
    for bp in params["blocks"]:  # nonzero adaLN heads: blocks that act
        for head in ("s_adaln", "t_adaln"):
            k = bp[head]["kernel"]
            bp[head]["kernel"] = torch.randn(k.shape, generator=g) * 0.02
    params = dit_mod.quantize_for_inference(params)
    rng = np.random.default_rng(2)
    T, f32 = cfg.max_frames, torch.float32
    x = torch.from_numpy(rng.standard_normal(
        (1, T, cfg.in_channels, cfg.input_h, cfg.input_w)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, (1, T)))
    a = torch.from_numpy(rng.standard_normal(
        (1, T, cfg.external_cond_dim)).astype(np.float32))
    valid = [False] + [True] * (T - 1)
    with torch.no_grad():
        mods = dit_mod.dit_cond(params, cfg, t, a, f32)
        rows = {"blocks": [{k: m[:, :T - 1] for k, m in b.items()}
                           for b in mods["blocks"]],
                "final": mods["final"][:, :T - 1]}
        kv = dit_mod.dit_prefill(params, cfg, x[:, :T - 1], rows,
                                 valid[:T - 1], f32)
        last = {"blocks": [{k: m[:, T - 1:] for k, m in b.items()}
                           for b in mods["blocks"]],
                "final": mods["final"][:, T - 1:]}
        step = dit_mod.dit_apply_step(params, cfg, x[:, T - 1:], kv, last,
                                      valid, f32)
        full = dit_mod.dit_apply(params, cfg, x, t, a, valid,
                                 compute_dtype=f32, mods=mods)
    S = cfg.grid_h * cfg.grid_w
    for k, v in kv:
        assert k.dtype == v.dtype == f32
        assert k.shape == v.shape == ((T - 1) * S, cfg.hidden_size)
    ref = full[:, T - 1:]
    err = (step - ref).abs().max().item()
    assert err <= 2.0**-6 * ref.abs().max().item(), err
